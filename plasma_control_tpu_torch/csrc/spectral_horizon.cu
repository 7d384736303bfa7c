// The spectral planner's whole horizon in one launch (sm_90a).
//
// Replaces the Pallas TPU kernel fused_spectral_horizon / _kernel of
// plasma_control_tpu/ops/pallas/spectral_horizon.py. For each of K candidate
// drive sequences it rolls the shared particle state (x0, v0) H steps through
// the gridless low-mode PIC model (staggered KDK with merged half-kicks,
// Chebyshev harmonic recurrence, per-mode Poisson solve) and writes the
// post-drift field energy of every step: pe (K, H).
//
// Bound on the H100: arithmetic. A solve is K*H*N particle-steps of about
// 10*Km operations each (one harmonic recurrence, mode sums and field
// evaluation: ~1.2 GFLOP at K=384, H=6, N=5000, Km=8), against 40 KB of
// particle state and 25 KB of coefficients in. This kernel runs the
// recurrence twice per particle-step (pass 2 below), ~14*Km operations and
// ~1.4 GFLOP there: that second pass is its overhead, traded for keeping no
// per-particle harmonics. The design keeps every byte of state on chip:
//  * one CTA per candidate (K=384 CTAs);
//  * the candidate's particle state lives in shared memory for all H steps,
//    one array per quantity so that neighbouring threads hit neighbouring
//    banks: the base-harmonic phasor (c1, s1) and the staggered velocity vh
//    for the "rot" drift (12 B per particle, 60 KB at N=5000: three CTAs per
//    SM), plus x for "trig" (16 B). Threads stride over the particles, so
//    there is no mask and no padding. A first version kept each thread's
//    particles in registers with the particles-per-thread count as a
//    template parameter: it spilled at N=5000, fit one CTA per SM and took
//    six minutes to compile;
//  * the TPU kernel reduces mode by mode over a full VMEM row (2*Km
//    reductions per step). Here pass 1 accumulates all 2*Km partial sums per
//    thread in registers and ONE block reduction (warp shuffles, then shared
//    memory) gives every c_m, s_m; pass 2 reruns the recurrence and applies
//    the field. That is two barriers per step. Keeping the Km harmonics per
//    particle instead would need 2*Km*N floats of shared memory.
// The prologue's mode sums at x0 are the same for every candidate; each CTA
// recomputes them (one extra pass of H+1).
//
// Large N: when the state does not fit one CTA's shared memory (above 14448
// particles for trig, 19264 for rot), the same body keeps it in a global
// scratch of (3 or 4) x N floats per candidate that the wrapper allocates
// (template flag GLOBAL). Each thread still touches only its own particles,
// so the scratch needs no extra barrier; it is read and written once per pass
// and mostly misses L2 at config-4's N = 100 000 (460-615 MB for K = 384).
// One CTA per candidate stays: a split of a candidate over a thread-block
// cluster with DSMEM reductions is later speed work.
//
// Twin-corrected variant (template flag CORRECTED; the TPU kernel's
// `corrected` path, spectral_horizon.py:198-205, 289-292): with the (H, Km)
// noise-correction targets tc, ts of control/mpc.py::twin_targets, the energy
// of step t is sum_m ((c_m - tc[t,m])^2 + (s_m - ts[t,m])^2) / k_m^2 instead of
// sum_m (c_m^2 + s_m^2) / k_m^2. Only thread 0's energy sum changes: two
// subtractions per mode and step, and 2*H*Km floats read from global memory
// (L2-resident, the same for every candidate; H is unbounded, so they do not
// go into the by-value SpectralParams). The rollout, the reductions and the
// state are those of the plain variant, so the corrected kernel is bound by
// the same arithmetic: at the twin slice's plan model (K=1024, H=10, Km=16,
// N=10000) the function needs ~19 GFLOP per solve, 0.28 ms at the card's
// 67 TFLOP/s fp32 (~27 GFLOP as written, with the second recurrence). Its
// 120 KB (rot) or 160 KB (trig) of state per candidate leave room for one
// CTA per SM, 8 of 64 warps, so latency, not the FMA rate, sets its time.
//
// Semantics follow the TPU kernel term by term: the prologue is an un-merged
// half kick with g_m and u_0; every step uses 2*g_m and pair_t = u_t + u_{t+1};
// PE comes from the post-drift, pre-kick mode sums. Constants arrive in fp32,
// rounded from the same float64 values as there.

#include <cuda_runtime.h>

constexpr int kMaxModes = 16;

// Passed by value from ops/kernels/_build.py::SpectralParams (same layout).
// Outside the anonymous namespace: the extern "C" entry point takes it.
struct SpectralParams {
  int k, h, km, n;
  float dt, half_dt, length, inv_l, c_ang, c_ang_dt, pe_scale;
  float g[kMaxModes];       // 2 n0 / (N k_m)
  float inv_k2[kMaxModes];  // 1 / k_m^2
};

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

struct Reduction {
  float red[kWarps][2 * kMaxModes];  // per-warp partial (c_m, s_m)
  float sums[2 * kMaxModes];         // block totals (c_m, s_m)
  float coef[2 * kMaxModes];         // field coefficients (pc_m, ps_m)
};

// Adds cos(m k1 x), sin(m k1 x), m = 1..km, of one particle to the thread's
// partial mode sums: f((m+1)t) = 2 cos(t) f(mt) - f((m-1)t).
__device__ __forceinline__ void add_harmonics(float c1, float s1, int km,
                                              float (&cs)[kMaxModes],
                                              float (&ss)[kMaxModes]) {
  const float twoc = c1 + c1;
  float cp2 = 1.0f, sp2 = 0.0f, cp = c1, sp = s1;
#pragma unroll
  for (int m = 0; m < kMaxModes; ++m) {
    if (m < km) {
      if (m > 0) {
        const float cn = twoc * cp - cp2;
        const float sn = twoc * sp - sp2;
        cp2 = cp;
        cp = cn;
        sp2 = sp;
        sp = sn;
      }
      cs[m] += cp;
      ss[m] += sp;
    }
  }
}

// sum_m pc_m cos(m k1 x) + ps_m sin(m k1 x) for one particle, same recurrence.
__device__ __forceinline__ float eval_harmonics(float c1, float s1, int km,
                                                const float* coef) {
  const float twoc = c1 + c1;
  float cp2 = 1.0f, sp2 = 0.0f, cp = c1, sp = s1;
  float acc = 0.0f;
#pragma unroll
  for (int m = 0; m < kMaxModes; ++m) {
    if (m < km) {
      if (m > 0) {
        const float cn = twoc * cp - cp2;
        const float sn = twoc * sp - sp2;
        cp2 = cp;
        cp = cn;
        sp2 = sp;
        sp = sn;
      }
      acc = acc + coef[m] * cp + coef[kMaxModes + m] * sp;
    }
  }
  return acc;
}

// Block-reduces the partial sums; thread m < km then forms
//   pc_m = scale g_m s_m + uc_m,   ps_m = -(scale g_m c_m) + us_m.
// Two barriers. Afterwards r.sums and r.coef hold the totals and the field.
__device__ __forceinline__ void reduce_modes(float (&cs)[kMaxModes], float (&ss)[kMaxModes],
                                             const SpectralParams& p, float scale,
                                             const float* uc, const float* us, Reduction& r) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int m = 0; m < kMaxModes; ++m) {
    if (m < p.km) {
      float c = cs[m], s = ss[m];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        c += __shfl_xor_sync(0xffffffffu, c, off);
        s += __shfl_xor_sync(0xffffffffu, s, off);
      }
      if (lane == 0) {
        r.red[warp][m] = c;
        r.red[warp][kMaxModes + m] = s;
      }
    }
  }
  __syncthreads();
  if (threadIdx.x < p.km) {
    const int m = threadIdx.x;
    float c = 0.0f, s = 0.0f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      c += r.red[w][m];
      s += r.red[w][kMaxModes + m];
    }
    r.sums[m] = c;
    r.sums[kMaxModes + m] = s;
    r.coef[m] = scale * (p.g[m] * s) + uc[m];
    r.coef[kMaxModes + m] = -(scale * (p.g[m] * c)) + us[m];
  }
  __syncthreads();
}

// Device pointers of one launch: x0, v0 (n,); u0c, u0s (k, km); pair_c, pair_s
// (k, h*km); tc, ts (h*km) targets of the corrected variant, else null;
// pe (k, h); scratch (k, (3 + !rot) * n) or null (state in shared memory).
struct Buffers {
  const float *x0, *v0, *u0c, *u0s, *pair_c, *pair_s, *tc, *ts;
  float *pe, *scratch;
};

template <bool ROT, bool GLOBAL, bool CORRECTED>
__global__ void __launch_bounds__(kThreads)
spectral_horizon_kernel(const Buffers b, const SpectralParams p) {
  __shared__ Reduction r;
  extern __shared__ float smem_state[];
  const float* __restrict__ x0 = b.x0;
  const float* __restrict__ v0 = b.v0;
  const int n = p.n, km = p.km, k = blockIdx.x;
  float* state = GLOBAL ? b.scratch + (size_t)k * (ROT ? 3 : 4) * n : smem_state;
  float* c1 = state;          // cos(k1 x)
  float* s1 = state + n;      // sin(k1 x)
  float* vh = state + 2 * n;  // staggered velocity
  float* x = state + 3 * n;   // position (trig drift only)

  float cs[kMaxModes], ss[kMaxModes];

  // ---- prologue: un-merged half kick at the shared x0 ----------------------
#pragma unroll
  for (int m = 0; m < kMaxModes; ++m) cs[m] = ss[m] = 0.0f;
  for (int q = threadIdx.x; q < n; q += kThreads) {
    const float xq = x0[q];
    float sn, cn;
    sincosf(p.c_ang * xq, &sn, &cn);
    c1[q] = cn;
    s1[q] = sn;
    vh[q] = v0[q];
    if (!ROT) x[q] = xq;
    add_harmonics(cn, sn, km, cs, ss);
  }
  reduce_modes(cs, ss, p, 1.0f, b.u0c + (size_t)k * km, b.u0s + (size_t)k * km, r);
  for (int q = threadIdx.x; q < n; q += kThreads)
    vh[q] = vh[q] + p.half_dt * (-eval_harmonics(c1[q], s1[q], km, r.coef));

  // ---- H merged-kick steps, state resident for the whole horizon ----------
  for (int t = 0; t < p.h; ++t) {
#pragma unroll
    for (int m = 0; m < kMaxModes; ++m) cs[m] = ss[m] = 0.0f;
    for (int q = threadIdx.x; q < n; q += kThreads) {
      float cn, sn;
      if (ROT) {
        // drift as a small-angle rotation of the carried phasor
        const float d = p.c_ang_dt * vh[q];
        const float d2 = d * d;
        const float cd = 1.0f + d2 * (-0.5f + d2 * (float)(1.0 / 24.0));
        const float sd = d * (1.0f + d2 * ((float)(-1.0 / 6.0) + d2 * (float)(1.0 / 120.0)));
        const float co = c1[q], so = s1[q];
        cn = co * cd - so * sd;
        sn = so * cd + co * sd;
      } else {
        float xq = x[q] + p.dt * vh[q];
        xq = xq - p.length * floorf(xq * p.inv_l);
        x[q] = xq;
        sincosf(p.c_ang * xq, &sn, &cn);
      }
      c1[q] = cn;
      s1[q] = sn;
      add_harmonics(cn, sn, km, cs, ss);
    }
    const size_t col = ((size_t)k * p.h + t) * km;
    reduce_modes(cs, ss, p, 2.0f, b.pair_c + col, b.pair_s + col, r);
    if (threadIdx.x == 0) {
      float acc = 0.0f;
      for (int m = 0; m < km; ++m) {
        float c = r.sums[m], s = r.sums[kMaxModes + m];
        if (CORRECTED) {  // the phasor relative to the zero-drive twin's target
          c = c - b.tc[t * km + m];
          s = s - b.ts[t * km + m];
        }
        acc = acc + (c * c + s * s) * p.inv_k2[m];
      }
      b.pe[(size_t)k * p.h + t] = p.pe_scale * acc;
    }
    for (int q = threadIdx.x; q < n; q += kThreads)
      vh[q] = vh[q] + p.half_dt * (-eval_harmonics(c1[q], s1[q], km, r.coef));
  }
}

template <bool ROT, bool GLOBAL, bool CORRECTED>
int launch(const Buffers& b, const SpectralParams& p, cudaStream_t stream) {
  const size_t smem = GLOBAL ? 0 : (ROT ? 3 : 4) * sizeof(float) * (size_t)p.n;
  auto* kernel = spectral_horizon_kernel<ROT, GLOBAL, CORRECTED>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<p.k, kThreads, smem, stream>>>(b, p);
  return static_cast<int>(cudaGetLastError());
}

template <bool ROT, bool GLOBAL>
int launch_variant(const Buffers& b, const SpectralParams& p, cudaStream_t stream) {
  return b.tc ? launch<ROT, GLOBAL, true>(b, p, stream) : launch<ROT, GLOBAL, false>(b, p, stream);
}

template <bool ROT>
int launch_placement(const Buffers& b, const SpectralParams& p, cudaStream_t stream) {
  return b.scratch ? launch_variant<ROT, true>(b, p, stream)
                   : launch_variant<ROT, false>(b, p, stream);
}

}  // namespace

extern "C" {

// x0, v0: (n,); u0c, u0s: (k, km); pair_c, pair_s: (k, h*km); pe: (k, h).
// tc, ts: (h, km) targets of the twin-corrected energy, both null for the
// plain energy. scratch: null keeps each candidate's state in
// (3 + !rot) * 4 * n bytes of shared memory (a launch beyond the card's
// shared memory is refused and reported); otherwise a (k, (3 + !rot) * n)
// float buffer that holds it in global memory. km <= 16.
int pct_spectral_horizon(const float* x0, const float* v0, const float* u0c, const float* u0s,
                         const float* pair_c, const float* pair_s, const float* tc,
                         const float* ts, float* pe, float* scratch, SpectralParams p, int rot,
                         cudaStream_t stream) {
  if (p.km < 1 || p.km > kMaxModes || p.k < 1 || p.h < 1 || p.n < 1 || (!tc != !ts))
    return static_cast<int>(cudaErrorInvalidValue);
  const Buffers b{x0, v0, u0c, u0s, pair_c, pair_s, tc, ts, pe, scratch};
  return rot ? launch_placement<true>(b, p, stream) : launch_placement<false>(b, p, stream);
}

}  // extern "C"
