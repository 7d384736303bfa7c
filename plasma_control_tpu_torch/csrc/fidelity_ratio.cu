// The fidelity guard's statistic in one launch (sm_90a): kernel 8.
//
// No TPU kernel corresponds to it. The JAX package computes the guard's ratio
// with XLA ops (control/mpc.py::_fidelity_ratio), and so did the port, op by
// op: cos and sin of the full state's positions, the three-term recurrence to
// Km modes, 2 Km reductions and about ten ops on the (Km,) sums, some 121
// small device ops per guarded solve at Km = 16, each over at most 400 KB.
// This kernel computes the same ratio on CUDA tensors
// (ops/kernels/fidelity_ratio.py), once per guarded solve:
//   c_m = sum_p cos(m k1 x_p), s_m = sum_p sin(m k1 x_p), m = 1..Km,
//   modal_m = (n0^2 / N) (c_m^2 + s_m^2) / k_m^2,
//   ratio = frac sum_m max(modal_m - n0^2 / k_m^2, 0) / injected,
// with the plan's particle fraction frac and the injected noise power a host
// constant, and writes that one float.
//
// What bounds it on the H100: latency. It reads 4N bytes and does N (6 Km + 1)
// operations: at the twin slice (N = 100000, Km = 16) 0.4 MB, 0.12 us at 3.35
// TB/s, and 9.7 MFLOP, 0.14 us at 67 TFLOP/s; at the grid slice (N = 5000) a
// twentieth of that. What a launch costs is its start and a reduction across
// CTAs. The design's answer is one pass and one reduction:
//  * G CTAs (ops/kernels/fidelity_ratio.py::launch_ctas: about 1024 particles
//    per CTA, at most 264) stride over x; each thread takes sincosf(k1 x) and
//    kernel 1's recurrence (add_harmonics, spectral_horizon.cuh) and keeps the
//    2 MODES partial sums in registers, MODES = 8 or 16 at compile time; Km >
//    16 runs blocks of 16 modes, one pass over x per block
//    (add_block_harmonics), as kernel 1 does, so every Km <= 64 takes one of
//    two code paths;
//  * per CTA and block of modes: kernel 1's warp reduce-scatter, the warps'
//    sums added in warp order into the CTA's partials, written to a (sums, G)
//    buffer;
//  * across CTAs: each CTA fences its writes and draws a ticket (one integer
//    atomicAdd); the CTA that draws the last adds every CTA's partials in
//    index order (one warp per sum: lane l takes CTAs l, l + 32, ... in turn,
//    then a fixed butterfly), so the result does not depend on which CTA
//    finished last. No float atomics: two launches give equal bits, and a
//    captured graph replays them. Its warp 0 forms the modal powers, clamps
//    and adds them (a butterfly), and lane 0 writes the ratio and resets the
//    ticket counter for the next launch.
// The counter is one per device in this library, so the launches of one
// device must not run concurrently (the port launches on one stream).
// The sums are added in another order than torch.sum's, so the ratio matches
// the op-by-op version to float32's rounding, not bitwise.

#include "spectral_horizon.cuh"

// Passed by value from ops/kernels/_build.py::FidelityParams (same layout).
struct FidelityParams {
  int n, x_st, km;  // particles, stride of x, modes
  float c_ang;      // k1 = 2 pi / L
  float scale;      // n0^2 / N
  float n0sq;       // n0^2
  float frac;       // the plan's particle fraction
  float injected;   // the injected noise power, > 0
  float k2[kMaxModes];  // k_m^2, m = 1..Km
};

namespace {

constexpr int kMaxCtas = 264;

// CTAs of the running launch that have written their partials.
__device__ unsigned int g_tickets;

template <int MODES>
__global__ void __launch_bounds__(kThreads)
fidelity_ratio_kernel(const float* __restrict__ x, float* __restrict__ partials,
                      float* __restrict__ out, const FidelityParams p) {
  constexpr int kV = 2 * MODES;  // cos sums at [0, MODES), sin sums at [MODES, 2 MODES)
  __shared__ float red[kWarps][kV];
  __shared__ float totals[kMaxBlocks * kSums];
  __shared__ int last;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int ctas = gridDim.x;
  const int nb = (p.km + MODES - 1) / MODES;

  // ---- the CTA's partial sums, one pass over x per block of modes ---------
  for (int blk = 0; blk < nb; ++blk) {
    float v[kV];
#pragma unroll
    for (int j = 0; j < kV; ++j) v[j] = 0.0f;
    for (int i = blockIdx.x * kThreads + threadIdx.x; i < p.n; i += ctas * kThreads) {
      float sn, cn;
      sincosf(p.c_ang * x[(size_t)i * p.x_st], &sn, &cn);
      if constexpr (MODES == kBlockModes)
        add_block_harmonics(cn, sn, kBlockModes * blk, v);
      else
        add_harmonics<MODES>(cn, sn, v);
    }
    const float part = warp_reduce_scatter<MODES>(v);
    if (lane < kV) red[warp][lane] = part;
    __syncthreads();
    if (threadIdx.x < kV) {
      float acc = 0.0f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) acc += red[w][threadIdx.x];
      partials[(size_t)(blk * kV + threadIdx.x) * ctas + blockIdx.x] = acc;
    }
    __syncthreads();  // red is written again by the next block
  }

  // ---- the last CTA to finish adds every CTA's partials in index order ----
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(&g_tickets, 1u) == static_cast<unsigned>(ctas - 1);
  __syncthreads();
  if (!last) return;
  __threadfence();
  for (int j = warp; j < nb * kV; j += kWarps) {
    const float* row = partials + (size_t)j * ctas;
    float acc = 0.0f;
    for (int g = lane; g < ctas; g += 32) acc += __ldcg(row + g);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (lane == 0) totals[j] = acc;
  }
  __syncthreads();
  if (warp != 0) return;
  float e = 0.0f;
  for (int m = lane; m < p.km; m += 32) {
    const int at = (m / MODES) * kV + m % MODES;
    const float c = totals[at], s = totals[at + MODES];
    const float modal = p.scale * (c * c + s * s) / p.k2[m];
    e += fmaxf(modal - p.n0sq / p.k2[m], 0.0f);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) e += __shfl_xor_sync(0xffffffffu, e, off);
  if (lane == 0) {
    *out = (p.frac * e) / p.injected;
    g_tickets = 0;
  }
}

bool valid_fidelity(const FidelityParams& p, int ctas) {
  return p.n >= 1 && p.x_st >= 1 && p.km >= 1 && p.km <= kMaxModes && p.injected > 0.0f &&
         ctas >= 1 && ctas <= kMaxCtas;
}

}  // namespace

extern "C" {

// x: (n,) at stride x_st; partials: (ceil(km / MODES) * 2 MODES, ctas) floats,
// MODES = 8 for km <= 8, else 16; out: one float, the ratio. ctas <= 264.
int pct_fidelity_ratio(const float* x, float* partials, float* out, FidelityParams p, int ctas,
                       cudaStream_t stream) {
  if (!valid_fidelity(p, ctas)) return static_cast<int>(cudaErrorInvalidValue);
  if (p.km <= 8)
    fidelity_ratio_kernel<8><<<ctas, kThreads, 0, stream>>>(x, partials, out, p);
  else
    fidelity_ratio_kernel<kBlockModes><<<ctas, kThreads, 0, stream>>>(x, partials, out, p);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
