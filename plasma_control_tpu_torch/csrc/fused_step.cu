// The grid planner's fused kernels (sm_90a): one whole leapfrog planning step,
// and the whole K x H KDK horizon in one launch, explicit or with merged
// half-kicks.
//
// Replaces the Pallas TPU kernels of experiments/pallas_fused_step.py:
//  * leapfrog_kernel      <- _fused_impl / _kernel (public fused_leapfrog_step):
//    drift(dt/2), deposit, circulant Poisson solve, gather, kick(dt), drift(dt/2),
//    and with `exact` a second deposit + solve at the post-step positions;
//  * horizon_kernel<false> <- fused_kdk_horizon / _kdk_kernel: explicit KDK,
//    two gathers per step around one weight evaluation;
//  * horizon_kernel<true>  <- fused_packed_horizon / _packed_kernel: the same
//    contract with the two half-kicks that straddle a step boundary merged
//    into one gather of 2 E_self + u_t + u_{t+1}, and no kick after the last
//    step (the staggered KDK of control/mpc.py::_horizon_cost_kdk).
// Both horizon kernels return 0.5 * sum(E_self^2) * dx after every step; the
// caller applies electric_energy's N/L rescale.
//
// Bound on the H100: latency and barriers, not bytes or flops. At the grid
// planner's shapes (K = 512 candidates, H = 10, N = 1250 plan particles,
// M = 64 plan cells) a solve is K*H*N = 6.4 M particle-steps of ~40 flops
// (two 4-tap shape evaluations, one gather, one deposit) plus K*H
// (M x M) solves = 21 MFLOP, against 10 KB of initial state and 1.3 MB of
// drive fields in and 20 KB of energies out. The design:
//  * one CTA of 256 threads per candidate (kernel 4: per batch row); x and
//    v (vh) live in shared memory for the whole step or horizon, 8 B per
//    particle (10 KB at N = 1250), so a step touches no device memory but
//    the drive field. Each thread strides over its own particles, so no
//    barrier guards the state. Where 8 N bytes do not fit beside the mesh
//    arrays, the state lives in a global scratch of (K, 2, N) floats that
//    the wrapper allocates (kernel 4: in its outputs x', v');
//  * the deposit is cic.cu's: each particle evaluates its shape function on
//    the cells b-1 .. b+2 (shape.cuh, all three interpolation kinds) and
//    adds into a shared-memory histogram of M floats; two histograms
//    alternate so that one is cleared while the other is deposited;
//  * the Poisson solve (n - n0) @ e_op_t runs in the kernel's own body (the
//    TPU kernel does it on its MXU): thread j sums column j over the M
//    cells, with e_op_t in shared memory when M*M*4 bytes fit (16 KB at
//    M = 64) and read from global memory (L2) otherwise;
//  * the gather and kick read the summed mesh field from shared memory. The
//    kick of step t and the drift and deposit of step t+1 run in ONE pass
//    over the particles, so a step costs two barriers: after the deposit and
//    after the solve. The TPU kernels' single (N, M) weight tile per step
//    becomes a 4-tap evaluation that the gather repeats at the same
//    position (cheaper than keeping 4 weights and cells per particle).
// The TPU's lane packing of 128 // M candidates per vector row (kernel 6)
// has no counterpart here: a CTA holds one candidate, and the M-wide mesh
// arrays cost threads, not lanes. So kernels 5 and 6 share one body and
// differ only in the merged kick (template flag MERGED). At K = 512 each
// SM holds ~4 CTAs of 27 KB; with only ~5 particles per thread per step,
// the ~4 + M cycles of barrier, solve and reduction per step dominate.
//
// Semantics follow the TPU kernels: positions wrap to [0, L) after every
// drift (fmodf, as torch.remainder / jnp.mod), the density is normalised by
// n0 L / N / dx, PE is taken from the post-drift field. Sums run in another
// order than on the TPU or in the plain PyTorch versions; shared-memory
// atomics make the deposit's order vary from run to run.

#include <cuda_runtime.h>

#include "shape.cuh"

// Passed by value from ops/kernels/_build.py::GridParams (same layout).
struct GridParams {
  int n, m, h;   // particles, mesh cells, horizon (kernel 4: 1)
  int kind;      // 0 cic, 1 tsc, 2 tsc_standard
  float dt, half_dt, length, inv_dx, norm, n0, half_dx;
};

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float wrap_pos(float x, float length) {
  const float r = fmodf(x, length);
  return r < 0.0f ? r + length : r;
}

__device__ __forceinline__ void deposit(float x, float* hist, const GridParams& p) {
  const pct::Taps t = pct::taps(x * p.inv_dx, p.m, p.kind);
#pragma unroll
  for (int o = 0; o < 4; ++o)
    if (t.w[o] != 0.0f) atomicAdd(&hist[t.cell[o]], t.w[o]);
}

__device__ __forceinline__ float gather(const pct::Taps& t, const float* f) {
  float acc = 0.0f;
#pragma unroll
  for (int o = 0; o < 4; ++o) acc += t.w[o] * f[t.cell[o]];
  return acc;
}

// E_self[j] = sum_i (hist[i] * norm - n0) * e_op_t[i, j]
__device__ __forceinline__ float solve(const float* hist, const float* eop, int j,
                                       const GridParams& p) {
  float acc = 0.0f;
  for (int i = 0; i < p.m; ++i) acc += (hist[i] * p.norm - p.n0) * eop[(size_t)i * p.m + j];
  return acc;
}

// Copies e_op_t into shared memory (when it is kept there) and clears both
// histograms. Returns the pointer the solve reads.
__device__ __forceinline__ const float* setup(const float* eop_g, float* eop_s, float* hist,
                                              const GridParams& p) {
  for (int j = threadIdx.x; j < 2 * p.m; j += kThreads) hist[j] = 0.0f;
  if (eop_s == nullptr) return eop_g;
  for (int i = threadIdx.x; i < p.m * p.m; i += kThreads) eop_s[i] = eop_g[i];
  return eop_s;
}

// Shared memory: hist[2][M], e[M], fa[M], fb[M], then e_op_t (M*M) if it is
// kept there, then x and v (2N) if the state is kept there.
__host__ __device__ inline size_t shared_floats(const GridParams& p, bool eop_smem,
                                                bool state_smem) {
  return 5 * (size_t)p.m + (eop_smem ? (size_t)p.m * p.m : 0) +
         (state_smem ? 2 * (size_t)p.n : 0);
}

__global__ void __launch_bounds__(kThreads)
leapfrog_kernel(const float* __restrict__ x, const float* __restrict__ v,
                const float* __restrict__ e_ext, const float* __restrict__ eop_g,
                float* __restrict__ xo, float* __restrict__ vo, float* __restrict__ eo,
                const GridParams p, int exact, int eop_smem, int state_smem) {
  extern __shared__ float smem[];
  const int n = p.n, m = p.m, row = blockIdx.x;
  float* hist = smem;  // [2][M]
  float* f = smem + 2 * m;
  float* tail = smem + 5 * m;
  const float* eop = setup(eop_g, eop_smem ? tail : nullptr, hist, p);
  if (eop_smem) tail += (size_t)m * m;
  const size_t off = (size_t)row * n;
  // half-step state: in shared memory, or in this row of the outputs
  float* xs = state_smem ? tail : xo + off;
  float* vs = state_smem ? tail + n : vo + off;
  __syncthreads();

  for (int q = threadIdx.x; q < n; q += kThreads) {
    const float vq = v[off + q];
    const float xh = wrap_pos(x[off + q] + p.half_dt * vq, p.length);
    xs[q] = xh;
    vs[q] = vq;
    deposit(xh, hist, p);
  }
  __syncthreads();

  for (int j = threadIdx.x; j < m; j += kThreads) {
    const float es = solve(hist, eop, j, p);
    f[j] = es + e_ext[(size_t)row * m + j];
    if (!exact) eo[(size_t)row * m + j] = es;
  }
  __syncthreads();

  for (int q = threadIdx.x; q < n; q += kThreads) {
    const float xh = xs[q];
    const pct::Taps t = pct::taps(xh * p.inv_dx, m, p.kind);
    const float vn = vs[q] + p.dt * (-gather(t, f));
    const float xn = wrap_pos(xh + p.half_dt * vn, p.length);
    xo[off + q] = xn;
    vo[off + q] = vn;
    if (exact) deposit(xn, hist + m, p);
  }
  if (!exact) return;
  __syncthreads();
  for (int j = threadIdx.x; j < m; j += kThreads) eo[(size_t)row * m + j] = solve(hist + m, eop, j, p);
}

template <bool MERGED>
__global__ void __launch_bounds__(kThreads)
horizon_kernel(const float* __restrict__ x0, const float* __restrict__ v0,
               const float* __restrict__ u, const float* __restrict__ eop_g,
               float* __restrict__ pe, float* __restrict__ scratch, const GridParams p,
               int eop_smem) {
  extern __shared__ float smem[];
  const int n = p.n, m = p.m, h = p.h, k = blockIdx.x;
  float* hist = smem;  // [2][M], alternating between steps
  float* e = smem + 2 * m;
  float* fa = smem + 3 * m;  // MERGED: 2 E + u_t + u_{t+1}; else E + u_t (kick 2 of step t)
  float* fb = smem + 4 * m;  // explicit only: E + u_{t+1} (kick 1 of step t+1)
  float* tail = smem + 5 * m;
  const float* eop = setup(eop_g, eop_smem ? tail : nullptr, hist, p);
  if (eop_smem) tail += (size_t)m * m;
  float* xs = scratch ? scratch + (size_t)k * 2 * n : tail;
  float* vs = xs + n;
  const float* uk = u + (size_t)k * h * m;
  __syncthreads();

  // prologue: this candidate's copy of the shared state, deposited at x0
  for (int q = threadIdx.x; q < n; q += kThreads) {
    const float xq = x0[q];
    xs[q] = xq;
    vs[q] = v0[q];
    deposit(xq, hist, p);
  }
  __syncthreads();
  for (int j = threadIdx.x; j < m; j += kThreads) (MERGED ? fa : fb)[j] = solve(hist, eop, j, p) + uk[j];
  __syncthreads();

  for (int t = 0; t < h; ++t) {
    float* cur = hist + ((t + 1) & 1) * m;
    // kick(s) at the current positions, drift, deposit: one pass
    for (int q = threadIdx.x; q < n; q += kThreads) {
      float xq = xs[q], vq = vs[q];
      const pct::Taps tp = pct::taps(xq * p.inv_dx, m, p.kind);
      if (MERGED) {
        vq = vq + p.half_dt * (-gather(tp, fa));
      } else {
        if (t > 0) vq = vq + p.half_dt * (-gather(tp, fa));
        vq = vq + p.half_dt * (-gather(tp, fb));
      }
      xq = wrap_pos(xq + p.dt * vq, p.length);
      xs[q] = xq;
      vs[q] = vq;
      deposit(xq, cur, p);
    }
    __syncthreads();
    for (int j = threadIdx.x; j < m; j += kThreads) {
      const float es = solve(cur, eop, j, p);
      e[j] = es;
      if (t + 1 < h) {
        const float ut = uk[(size_t)t * m + j], un = uk[(size_t)(t + 1) * m + j];
        if (MERGED) {
          fa[j] = 2.0f * es + ut + un;
        } else {
          fa[j] = es + ut;
          fb[j] = es + un;
        }
      }
    }
    // the other histogram was last read by the previous step's solve
    for (int j = threadIdx.x; j < m; j += kThreads) hist[(t & 1) * m + j] = 0.0f;
    __syncthreads();
    if (threadIdx.x == 0) {
      float acc = 0.0f;
      for (int j = 0; j < m; ++j) acc += e[j] * e[j];
      pe[(size_t)k * h + t] = p.half_dx * acc;
    }
  }
}

template <typename Kernel>
cudaError_t allow_shared(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

}  // namespace

extern "C" {

// x, v: (b, n); e_ext: (b, m); eop_t: (m, m) = e_op.T; outputs xo, vo (b, n)
// and eo (b, m). state_smem = 0 keeps the half-step state in xo, vo.
int pct_fused_leapfrog_step(const float* x, const float* v, const float* e_ext,
                            const float* eop_t, float* xo, float* vo, float* eo, int b,
                            GridParams p, int exact, int eop_smem, int state_smem,
                            cudaStream_t stream) {
  if (b < 1 || p.n < 1 || p.m < 1) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = sizeof(float) * shared_floats(p, eop_smem, state_smem);
  cudaError_t err = allow_shared(leapfrog_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  leapfrog_kernel<<<b, kThreads, smem, stream>>>(x, v, e_ext, eop_t, xo, vo, eo, p, exact,
                                                  eop_smem, state_smem);
  return static_cast<int>(cudaGetLastError());
}

// x0, v0: (n,) shared initial state; u: (k, h, m) drive fields; eop_t:
// (m, m); pe: (k, h). scratch: null keeps each candidate's state in shared
// memory, else a (k, 2, n) float buffer. merged selects kernel 6 over 5.
int pct_grid_horizon(const float* x0, const float* v0, const float* u, const float* eop_t,
                     float* pe, float* scratch, int k, GridParams p, int merged, int eop_smem,
                     cudaStream_t stream) {
  if (k < 1 || p.n < 1 || p.m < 1 || p.h < 1) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = sizeof(float) * shared_floats(p, eop_smem, scratch == nullptr);
  cudaError_t err = merged ? allow_shared(horizon_kernel<true>, smem)
                           : allow_shared(horizon_kernel<false>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (merged)
    horizon_kernel<true><<<k, kThreads, smem, stream>>>(x0, v0, u, eop_t, pe, scratch, p, eop_smem);
  else
    horizon_kernel<false><<<k, kThreads, smem, stream>>>(x0, v0, u, eop_t, pe, scratch, p, eop_smem);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
