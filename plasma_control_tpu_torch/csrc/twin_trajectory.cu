// The twin-corrected solve's targets in one launch (sm_90a): kernel 7.
//
// No TPU kernel corresponds to it. The JAX package computes these targets
// with XLA ops (control/mpc.py::twin_targets, _twin_mode_traj), and so did the
// port, op by op: about 2800 small device ops per solve at the twin slice
// (Km=16, H=10), each over 10000 floats, which held three quarters of that
// controller's step. This kernel computes the same function on CUDA tensors
// (ops/kernels/twin_trajectory.py), once per solve:
//  1. the full state's mode sums C_m, S_m (m = 1..Km, the Chebyshev
//     recurrence from the base harmonic) and each mode's noise fraction
//     rho_m = 1 - lambda_m, lambda_m = r^2 sig2 / (r^2 sig2 + n (1 - r)),
//     sig2 = max(C_m^2 + S_m^2 - N, 0), r = n / N;
//  2. the zero-drive twin of the plan state (n particles): the un-merged half
//     kick at x0 with coefficients (g s0, -g c0), then H merged-kick steps,
//     each an exact trig drift (x + dt vh wrapped into [0, L), sincos), the
//     mode sums (c_t, s_t) and a kick with (2 g s_t, -2 g c_t). The drift is
//     trig whatever the plan's spectral_drift says: the twin and the
//     corrected cost are defined on it;
//  3. tc[t, m] = rho_m c_t,m and ts[t, m] = rho_m s_t,m, (H, Km) each.
//
// What bounds it on the H100: latency. The work is small (twin slice: one
// pass over N=100000 and H+1 passes over n=10000 particles at 16 modes, 28
// MFLOP, 0.41 us at 67 TFLOP/s; 0.48 MB, 0.14 us at 3.35 TB/s), but
// step t+1 needs step t's mode sums over every particle, so the horizon is a
// chain of H+1 reductions across the whole plan state, each a few us of
// barriers and cross-CTA reads. The design runs that chain on ONE
// thread-block cluster of C CTAs (C up to 16, the non-portable size kernel 1
// uses), so that each reduction is one cluster barrier and reads of the
// peers' shared memory (DSMEM) rather than a kernel boundary:
//  * it is kernel 1's trig body (spectral_horizon.cuh, whose device helpers
//    it calls unchanged) at one candidate with zero drive and the mode sums
//    written out: CTA r holds plan particles [r S, (r + 1) S), S = ceil(n /
//    C), as (c1, s1, vh, x) in its shared memory for the whole horizon, or
//    in a global scratch row where 16 B * S exceeds it (n > 230016 at C=16);
//  * per step one drift-and-harmonics pass, one cluster reduction of the
//    2 Km sums (reduce_modes: warp reduce-scatter, the CTA's partials in a
//    double-buffered slot, the cluster's slots added in rank order 0..C-1),
//    one Clenshaw kick pass; Km > 16 runs blocks of 16 modes as
//    horizon_blocks does (one more pass over the stored phasors and one
//    more reduction per block), so every Km <= 64 takes one code path;
//  * the full state's sums come first, from the same cluster: one pass over
//    full_x per block of modes (read in place at its stride), reduced the
//    same way; warp 0 turns them into rho_m, kept in shared memory for the
//    writes. Rank 0's warp 0 writes tc, ts.
// C is chosen in ops/kernels/twin_trajectory.py::launch_geometry from N and
// n (the smallest power of two that leaves at most 2048 particles of the
// larger state per CTA). Measured on an NVIDIA H100 80GB HBM3 at 700 W
// (PERF.md §6): 0.037 ms per launch at the twin slice on C=16 (0.30 ms on
// C=1), where the ~2720 ops it replaced took ~4.4 ms of device time. No atomics: the sums are added in a fixed order, so
// two launches give bitwise equal targets, and a captured graph replays them.
// The sums are in another order than torch.sum's, so the targets match the
// op-by-op version to float32's rounding, not bitwise.

#include "spectral_horizon.cuh"

// Passed by value from ops/kernels/_build.py::TwinParams (same layout). In
// s: h, km, n (plan particles), x_st, cluster, dt, half_dt, length, inv_l,
// c_ang and g; k = 1 and ka = 0 (no drive).
struct TwinParams {
  SpectralParams s;
  int n_full, xf_st;  // the full state's particles and stride
  float n_full_f;     // N in sig2 = max(C^2 + S^2 - N, 0)
  float r2, noise;    // r^2 and n (1 - r)
};

namespace {

struct TwinBuffers {
  const float *xf, *x0, *v0;  // full_x (n_full,) at xf_st; x0, v0 (n,) at x_st
  float *tc, *ts;             // (h, km) each
  float* scratch;             // (cluster, 4 S) or null: the state in shared memory
};

// Static shared memory: the reduction, the field coefficients of every block
// of modes, and warp 0's noise fractions (thread j of block b: rho of its mode).
struct TwinShared {
  Reduction r;
  BlockCoefs coefs;
  float rho[kMaxBlocks][kSums];
};

// Every block's sums v of one pass (block 0's already in v; further blocks
// from the stored phasors) through the cluster reduction into coefs; with
// tc, ts set (rank 0), warp 0 writes the sums times rho into row t.
__device__ __forceinline__ void reduce_blocks(float (&v)[kSums], const float* c1, const float* s1,
                                              int cnt, int nb, float scale, int& phase,
                                              const SpectralParams& p, TwinShared& sh, float* tc,
                                              float* ts, int t) {
  for (int blk = 0; blk < nb; ++blk) {
    const Own o = own_coef(blk);
    if (blk > 0) block_sums(c1, s1, cnt, blk, v);
    const float total = reduce_modes<kBlockModes>(v, phase++, scale, 0.0f, o, p, sh.r,
                                                  sh.coefs[blk]);
    if (tc && threadIdx.x < kSums && o.m < p.km)  // thread j < 16: s_m, else c_m
      (o.sine_coef ? tc : ts)[t * p.km + o.m] = sh.rho[blk][threadIdx.x] * total;
  }
}

__global__ void __launch_bounds__(kThreads, 1)
twin_trajectory_kernel(const TwinBuffers b, const TwinParams tp) {
  __shared__ __align__(16) TwinShared sh;
  extern __shared__ float smem_state[];
  const SpectralParams& p = tp.s;
  const int rank = cluster_rank();
  const int nb = (p.km + kBlockModes - 1) / kBlockModes;
  int phase = 0;
  float v[kSums];

  // ---- the full state's mode sums and each mode's noise fraction ----------
  {
    const int slice = (tp.n_full + p.cluster - 1) / p.cluster;
    const int lo = min(rank * slice, tp.n_full);
    const int cnt = min(slice, tp.n_full - lo);
    const float* __restrict__ xf = b.xf + (size_t)lo * tp.xf_st;
    for (int blk = 0; blk < nb; ++blk) {
#pragma unroll
      for (int j = 0; j < kSums; ++j) v[j] = 0.0f;
      for (int i = threadIdx.x; i < cnt; i += kThreads) {
        float sn, cn;
        sincosf(p.c_ang * xf[(size_t)i * tp.xf_st], &sn, &cn);
        add_block_harmonics(cn, sn, kBlockModes * blk, v);
      }
      const Own o = own_coef(blk);
      const float total =
          reduce_modes<kBlockModes>(v, phase++, 0.0f, 0.0f, o, p, sh.r, sh.r.coef);
      // the mode's other sum from the partner lane: c_m and s_m on both
      const float other = __shfl_xor_sync(0xffffffffu, total, kBlockModes);
      if (threadIdx.x < kSums) {
        const float c = o.sine_coef ? total : other;
        const float s = o.sine_coef ? other : total;
        const float sig2 = fmaxf(c * c + s * s - tp.n_full_f, 0.0f);
        sh.rho[blk][threadIdx.x] = 1.0f - (tp.r2 * sig2) / (tp.r2 * sig2 + tp.noise);
      }
    }
  }

  // ---- the zero-drive twin of the plan state --------------------------------
  const int slice = (p.n + p.cluster - 1) / p.cluster;
  const int lo = min(rank * slice, p.n);
  const int cnt = min(slice, p.n - lo);
  const float* __restrict__ x0 = b.x0 + (size_t)lo * p.x_st;
  const float* __restrict__ v0 = b.v0 + (size_t)lo * p.x_st;
  float* state = b.scratch ? b.scratch + (size_t)blockIdx.x * 4 * slice : smem_state;
  float* c1 = state;              // cos(k1 x)
  float* s1 = state + slice;      // sin(k1 x)
  float* vh = state + 2 * slice;  // staggered velocity
  float* x = state + 3 * slice;   // position
  float* tc = rank == 0 ? b.tc : nullptr;

  // prologue: the un-merged half kick at x0
#pragma unroll
  for (int j = 0; j < kSums; ++j) v[j] = 0.0f;
  for (int i = threadIdx.x; i < cnt; i += kThreads) {
    float sn, cn;
    load_particle<false>(i, x0, v0, p, c1, s1, vh, x, cn, sn);
    add_harmonics<kBlockModes>(cn, sn, v);
  }
  reduce_blocks(v, c1, s1, cnt, nb, 1.0f, phase, p, sh, nullptr, nullptr, 0);
  for (int i = threadIdx.x; i < cnt; i += kThreads)
    vh[i] = vh[i] + p.half_dt * (-clenshaw_blocks(c1[i], s1[i], sh.coefs, nb));

  // H merged-kick steps; the last one's kick moves nothing that is written
  for (int t = 0; t < p.h; ++t) {
#pragma unroll
    for (int j = 0; j < kSums; ++j) v[j] = 0.0f;
    for (int i = threadIdx.x; i < cnt; i += kThreads) {
      float cn, sn;
      drift<false>(i, c1, s1, vh, x, p, cn, sn);
      add_harmonics<kBlockModes>(cn, sn, v);
    }
    reduce_blocks(v, c1, s1, cnt, nb, 2.0f, phase, p, sh, tc, b.ts, t);
    if (t + 1 < p.h)
      for (int i = threadIdx.x; i < cnt; i += kThreads)
        vh[i] = vh[i] + p.half_dt * (-clenshaw_blocks(c1[i], s1[i], sh.coefs, nb));
  }
  // no CTA leaves while another may still read its slot
  cluster_sync();
}

cudaError_t configure_twin() {
  // per device: the shared-memory limit and clusters beyond the portable 8
  static int done_for = -1;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || done_for == dev) return err;
  err = cudaFuncSetAttribute(twin_trajectory_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             232448 - (int)sizeof(TwinShared));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(twin_trajectory_kernel,
                               cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err == cudaSuccess) done_for = dev;
  return err;
}

// One cluster of p.cluster CTAs; dynamic shared memory: the CTA's slice of
// the plan state, none with the global scratch.
int launch_twin(const TwinBuffers& b, const TwinParams& tp, bool global, cudaStream_t stream,
                int* max_clusters) {
  cudaError_t err = configure_twin();
  if (err != cudaSuccess) return static_cast<int>(err);
  const SpectralParams& p = tp.s;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3(p.cluster);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = global ? 0 : 4 * sizeof(float) * ((p.n + p.cluster - 1) / p.cluster);
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (max_clusters)
    return static_cast<int>(cudaOccupancyMaxActiveClusters(max_clusters, twin_trajectory_kernel,
                                                            &cfg));
  err = cudaLaunchKernelEx(&cfg, twin_trajectory_kernel, b, tp);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

bool valid_twin(const TwinParams& tp) {
  const SpectralParams& p = tp.s;
  return p.km >= 1 && p.km <= kMaxModes && p.h >= 1 && p.n >= 1 && p.x_st >= 1 &&
         tp.n_full >= 1 && tp.xf_st >= 1 && p.cluster >= 1 && p.cluster <= kMaxCluster;
}

}  // namespace

extern "C" {

// xf: (n_full,) at stride xf_st; x0, v0: (n,) at stride x_st; tc, ts: (h, km).
// scratch: null keeps each CTA's slice of the plan state, 16 * ceil(n /
// cluster) bytes, in shared memory; otherwise a (cluster, 4 * ceil(n /
// cluster)) float buffer that holds it in global memory. km <= 64,
// cluster <= 16.
int pct_twin_trajectory(const float* xf, const float* x0, const float* v0, float* tc, float* ts,
                        float* scratch, TwinParams tp, cudaStream_t stream) {
  if (!valid_twin(tp)) return static_cast<int>(cudaErrorInvalidValue);
  return launch_twin(TwinBuffers{xf, x0, v0, tc, ts, scratch}, tp, scratch != nullptr, stream,
                     nullptr);
}

// How many clusters of the launch that pct_twin_trajectory would make with
// these arguments can be resident on the card at once; 0 means none fits.
int pct_twin_max_clusters(TwinParams tp, int global, int* max_clusters) {
  if (!valid_twin(tp)) return static_cast<int>(cudaErrorInvalidValue);
  return launch_twin(TwinBuffers{}, tp, global != 0, nullptr, max_clusters);
}

}  // extern "C"
