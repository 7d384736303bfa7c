// The grid planner's fused kernels (sm_90a): one whole leapfrog planning step,
// and the whole K x H KDK horizon in one launch, explicit or with merged
// half-kicks.
//
// Replaces the Pallas TPU kernels of experiments/pallas_fused_step.py:
//  * leapfrog_rows_kernel, leapfrog_kernel <- _fused_impl / _kernel (public
//    fused_leapfrog_step):
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
// What bounds them on the H100: instruction issue. At the grid planner's
// shapes (K = 512 candidates, H = 10, N = 1250 plan particles, M = 64 plan
// cells) a solve is K*H*N = 6.4 M particle-steps of ~45 operations plus K*H
// (M x M) solves, 0.33 GFLOP (bound 0.005 ms at 67 TFLOP/s), against 1.3 MB
// of drive fields in and 20 KB of energies out. The SM holds 4 CTAs and
// issues ~3 of its 4 warp instructions per cycle; clock64() stamps per CTA
// put 59 % of the time in the particle pass, 25 % in the solves, 14 % in the
// prologue and 0.3 % waiting at barriers (kernel_experiments.py stamps). A
// particle takes 88 of the 179 instructions of the pass's loop (CIC, merged
// kick; kernel_experiments.py sass, the path counted in the listing). Kernel
// 6 takes 0.043 ms per launch, kernel 5 0.046 (NVIDIA H100 80GB HBM3,
// 700 W; PERF.md §6). Kernel 4 is one step, not a horizon: at the grid
// slice's leapfrog shape (B = 512 rows, N = 1250, M = 64) it moves 10.5 MB
// (bound 0.0031 ms) and one CTA per row took 0.0108 ms, the latency of each
// CTA's serial chain: e_op_t copied into shared memory with an integer
// divide per element (16 KB a row), then x, v loaded one particle at a time
// between the deposits, pass, solve, pass, solve. leapfrog_rows_kernel
// instead runs rows over a persistent grid (ops/kernels/fused_step.py::
// _row_grid: as few rows per CTA as one wave of resident CTAs allows), e_op_t
// staged once per CTA by cp.async, 16 B per copy, the row's x, v (at most
// 8 particles per thread) loaded at once into registers, where the
// half-step state stays between the two passes, and the next row's loads in
// flight during this row's solves (N <= 2048, M <= 256 with e_op_t in
// shared memory; elsewhere leapfrog_kernel, one CTA per row). The design of
// the others:
//  * one CTA of 256 threads per candidate (kernel 4: per batch row); x and
//    v (vh) live in shared memory for the whole step or horizon, 8 B per
//    particle (10 KB at N = 1250), so a step touches no device memory but
//    the drive field. Each thread strides over its own particles, so no
//    barrier guards the state. Where 8 N bytes do not fit beside the mesh
//    arrays, the state lives in a global scratch of (K, 2, N) floats that
//    the wrapper allocates (kernel 4: in its outputs x', v'). A template flag
//    (SMEM) compiles the case where the state and e_op_t both live in shared
//    memory with shared-memory addressing. Beyond M = 3631 cells the mesh
//    arrays alone exceed a CTA's shared memory (64 M + 32 bytes); there
//    they live in a per-CTA global scratch that the wrapper allocates
//    (template flag GMESH), with the state and e_op_t, and the deposit's
//    atomics and the solve go through L2. Below that the layout and the bits
//    are unchanged. 128 threads per CTA ran 12 % slower (0.0485 against
//    0.0432 ms, kernel_experiments.py variants);
//  * the interpolation kind is a template argument (shape.cuh::Taps): CIC
//    evaluates its 2 taps that can carry weight, the two TSC kinds 3, each
//    weight bit for bit as the 4-tap evaluation computes it; cells wrap by a
//    compare and an add, positions without fmodf on [-L, 2L), where that is
//    exact. Keeping the taps of a deposit in shared memory for the next
//    step's gather ran 2 % slower and was left out;
//  * the deposit adds fixed-point weights (integer counts, shape.cuh) to a
//    shared-memory histogram of M cells, so its sum is bitwise the same
//    whatever order the atomics run in: two launches give the same energies.
//    Two histograms alternate, so that one is cleared while the other is
//    deposited;
//  * the Poisson solve E = (n norm - n0) @ e_op_t runs in the kernel (the TPU
//    kernel does it on its MXU), spread over all 8 warps: each warp converts
//    the counts to densities in its own row of shared memory, takes 8 columns
//    at a time, its lanes split the rows 4 ways (rows r, r+4, ...), and two
//    shuffles add the 4 partial sums in a fixed order. e_op_t lives in shared
//    memory with a row stride of M + 8 (mod 32), so that the warp's 32 reads
//    fall in 32 banks, when it fits (18 KB at M = 64), else in global memory
//    (L2);
//  * the field energy 0.5 dx sum E^2 is reduced by shuffles within each warp
//    and summed over the 8 warps in warp order by one thread during the next
//    step's particle pass;
//  * the kick of step t and the drift and deposit of step t+1 run in ONE pass
//    over the particles, and the next step's drive fields are staged in
//    shared memory during it, so a step costs two barriers: after the deposit
//    and after the solve.
// The TPU's lane packing of 128 // M candidates per vector row (kernel 6)
// has no counterpart here: a CTA holds one candidate, and the M-wide mesh
// arrays cost threads, not lanes. So kernels 5 and 6 share one body and
// differ only in the merged kick (template flag MERGED).
//
// Semantics follow the TPU kernels: positions wrap to [0, L) after every
// drift (torch.remainder's arithmetic), the density is normalised by
// n0 L / N / dx, PE is taken from the post-drift field. Sums run in another
// order than on the TPU or in the plain PyTorch versions, the same order in
// every launch.

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
constexpr int kWarps = kThreads / 32;
constexpr int kSharedBytes = 232448;  // one CTA's dynamic shared memory on Hopper

// Row stride of e_op_t in shared memory: M rounded up to 8 mod 32 words, so
// that lanes (r, jj) reading rows r + 4k of columns jg + jj hit 32 banks.
__host__ __device__ inline int eop_stride(int m) { return m + ((8 - m % 32) + 32) % 32; }

// The mesh arrays in 4-byte words: hist[2][2M] (fixed-point counts), fa, fb,
// ua, ub (M each), one row of M densities per warp, kWarps energy partials.
__host__ __device__ inline size_t mesh_words(const GridParams& p) {
  return (8 + kWarps) * (size_t)p.m + kWarps;
}

// Shared memory in 4-byte words: the mesh arrays, then e_op_t (M rows of
// eop_stride(M)) if it is kept there, then x and v (2N) if the state is kept
// there; nothing when the mesh arrays live in a global scratch of
// mesh_words per CTA (mesh_smem false: beyond M = 3631, where they alone
// exceed a CTA's shared memory), and with them the state and e_op_t.
// ops/kernels/fused_step.py::_layout mirrors this.
__host__ __device__ inline size_t shared_words(const GridParams& p, bool mesh_smem,
                                               bool eop_smem, bool state_smem) {
  if (!mesh_smem) return 0;
  return mesh_words(p) + (eop_smem ? (size_t)p.m * eop_stride(p.m) : 0) +
         (state_smem ? 2 * (size_t)p.n : 0);
}

// The mesh arrays (and where kept, e_op_t and the state) of one CTA, in
// shared memory or, for GMESH, in the CTA's rows of the global scratch.
struct Smem {
  unsigned* hist;            // [2][2M]: two fixed-point histograms (shape.cuh)
  float *fa, *fb;            // fields the gathers read
  float *ua, *ub;            // drive fields u_t, u_{t+1} of the step being solved
  float* rho;                // this warp's densities [M]
  float* pe_part;            // [kWarps]
  float* eop;                // [M][eop_stride(M)], or null: read from global memory
  float* state;              // x [N], v [N], or null
};

__device__ __forceinline__ Smem carve(float* base, const GridParams& p, bool eop_smem,
                                      bool state_smem) {
  const int m = p.m;
  Smem s;
  s.hist = reinterpret_cast<unsigned*>(base);
  float* f = base + 4 * m;
  s.fa = f;
  s.fb = f + m;
  s.ua = f + 2 * m;
  s.ub = f + 3 * m;
  s.rho = f + (4 + (threadIdx.x >> 5)) * m;
  s.pe_part = f + (4 + kWarps) * m;
  float* tail = s.pe_part + kWarps;
  s.eop = eop_smem ? tail : nullptr;
  if (eop_smem) tail += (size_t)m * eop_stride(m);
  s.state = state_smem ? tail : nullptr;
  return s;
}

// Clears both histograms and copies e_op_t into shared memory when it is
// kept there.
__device__ __forceinline__ void setup(const float* eop_g, const Smem& s, const GridParams& p) {
  for (int j = threadIdx.x; j < 4 * p.m; j += kThreads) s.hist[j] = 0u;
  if (s.eop == nullptr) return;
  const int ld = eop_stride(p.m);
  for (int idx = threadIdx.x; idx < p.m * p.m; idx += kThreads) {
    const int i = idx / p.m;
    s.eop[(size_t)i * ld + (idx - i * p.m)] = eop_g[idx];
  }
}

// E_j = sum_i (count_i 2^-32 norm - n0) * e_op_t[i, j] for every column j,
// over all warps (see the note at the top). emit(j, E_j) runs once per
// column, in lane j % 8 of its warp. Returns the thread's sum of E_j^2 over
// the columns it emitted (0 in lanes 8..31).
// SPLIT: hist holds split counts (add_split below) rather than fixed_count's
// carried words; either way each cell's count is the same integer.
template <bool SPLIT = false, class Emit>
__device__ __forceinline__ float solve(const unsigned* hist, const float* eop, int ld,
                                       float* rho, const GridParams& p, Emit emit) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, m = p.m;
  const float norm = p.norm * pct::kFixedStep;
  for (int i = lane; i < m; i += 32) {
    const long long count =
        SPLIT ? static_cast<long long>(static_cast<int>(hist[m + i])) * 65536LL + hist[i]
              : pct::fixed_count(hist[i], hist[m + i]);
    rho[i] = static_cast<float>(count) * norm - p.n0;
  }
  __syncwarp();
  const int r = lane >> 3, jj = lane & 7;
  float e2 = 0.0f;
  for (int jg = warp * 8; jg < m; jg += kWarps * 8) {
    const int j = jg + jj;
    float acc = 0.0f;
    if (j < m) {
#pragma unroll 4
      for (int i = r; i < m; i += 4) acc = fmaf(rho[i], eop[(size_t)i * ld + j], acc);
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 8);
    acc += __shfl_xor_sync(0xffffffffu, acc, 16);
    if (r == 0 && j < m) {
      emit(j, acc);
      e2 = fmaf(acc, acc, e2);
    }
  }
  return e2;
}

// The warp's share of sum E^2 (lanes 0..7, in a fixed order) to pe_part[warp].
__device__ __forceinline__ void energy_partial(float e2, float* pe_part) {
  e2 += __shfl_xor_sync(0xffffffffu, e2, 1);
  e2 += __shfl_xor_sync(0xffffffffu, e2, 2);
  e2 += __shfl_xor_sync(0xffffffffu, e2, 4);
  if ((threadIdx.x & 31) == 0) pe_part[threadIdx.x >> 5] = e2;
}

__device__ __forceinline__ float energy(const float* pe_part, const GridParams& p) {
  float acc = pe_part[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) acc += pe_part[w];
  return p.half_dx * acc;
}

// WRAPPED: x in [0, L] (wrap_pos's result); else any x.
template <int KIND, bool WRAPPED>
__device__ __forceinline__ void deposit_at(float x, unsigned* hist, const GridParams& p) {
  pct::deposit(pct::taps<KIND, WRAPPED>(x * p.inv_dx, p.m), hist, p.m);
}

// SMEM: the particle state and e_op_t both in shared memory (so the compiler
// addresses them as shared); otherwise each where the launch put it. GMESH:
// the mesh arrays in the CTA's rows of `mesh`, the state and e_op_t in
// global memory too.
template <int KIND, bool SMEM, bool GMESH>
__global__ void __launch_bounds__(kThreads)
leapfrog_kernel(const float* __restrict__ x, const float* __restrict__ v,
                const float* __restrict__ e_ext, const float* __restrict__ eop_g,
                float* __restrict__ xo, float* __restrict__ vo, float* __restrict__ eo,
                float* __restrict__ mesh, const GridParams p, int exact, int eop_smem,
                int state_smem) {
  extern __shared__ __align__(16) float smem[];
  const int n = p.n, m = p.m, row = blockIdx.x;
  float* base = GMESH ? mesh + (size_t)row * mesh_words(p) : smem;
  const Smem s = carve(base, p, SMEM || eop_smem, SMEM || state_smem);
  setup(eop_g, s, p);
  const float* eop = SMEM || eop_smem ? s.eop : eop_g;
  const int ld = SMEM || eop_smem ? eop_stride(m) : m;
  const size_t off = (size_t)row * n;
  // half-step state: in shared memory, or in this row of the outputs
  float* xs = SMEM || state_smem ? s.state : xo + off;
  float* vs = SMEM || state_smem ? s.state + n : vo + off;
  const float* er = e_ext + (size_t)row * m;
  float* eor = eo + (size_t)row * m;
  __syncthreads();

  for (int q = threadIdx.x; q < n; q += kThreads) {
    const float vq = v[off + q];
    const float xh = pct::wrap_pos(x[off + q] + p.half_dt * vq, p.length);
    xs[q] = xh;
    vs[q] = vq;
    deposit_at<KIND, true>(xh, s.hist, p);
  }
  __syncthreads();
  solve(s.hist, eop, ld, s.rho, p, [&](int j, float es) {
    s.fa[j] = es + er[j];
    if (!exact) eor[j] = es;
  });
  __syncthreads();

  for (int q = threadIdx.x; q < n; q += kThreads) {
    const float xh = xs[q];
    const float vn = vs[q] + p.dt * (-pct::gather(pct::taps<KIND, true>(xh * p.inv_dx, m), s.fa));
    const float xn = pct::wrap_pos(xh + p.half_dt * vn, p.length);
    xo[off + q] = xn;
    vo[off + q] = vn;
    if (exact) deposit_at<KIND, true>(xn, s.hist + 2 * m, p);
  }
  if (!exact) return;
  __syncthreads();
  solve(s.hist + 2 * m, eop, ld, s.rho, p, [&](int j, float es) { eor[j] = es; });
}

// ---- kernel 4 over a persistent grid: rows per CTA, state in registers ---
// Where a row's particles fit kRowQ per thread and e_op_t fits in shared
// memory beside the mesh arrays, each CTA takes rows blockIdx.x, blockIdx.x
// + gridDim.x, ... in turn: e_op_t is staged once per CTA (cp.async, 16 B
// per copy where the rows allow it), the half-step state stays in the
// registers of the thread that owns the particle (particles threadIdx.x +
// 256 j, the same in both passes), and the next row's x, v and drive are
// loaded during this row's solves and second pass.
constexpr int kRowQ = 8;  // particles per thread held in registers
constexpr int kRowParticles = kRowQ * kThreads;

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(d), "l"(src) : "memory");
}

// Starts the copy of e_op_t (M x M) into rows of eop_stride(M) floats of
// shared memory; cp_async_wait then a barrier make it visible.
__device__ __forceinline__ void stage_eop(const float* __restrict__ eop_g, float* eop, int m) {
  const int ld = eop_stride(m);
  if (m % 4 == 0 && (reinterpret_cast<size_t>(eop_g) & 15) == 0) {
    const int q = m / 4;  // 16-byte copies per row
    for (int idx = threadIdx.x; idx < m * q; idx += kThreads) {
      const int i = idx / q, c = 4 * (idx - i * q);
      cp_async16(eop + (size_t)i * ld + c, eop_g + (size_t)i * m + c);
    }
  } else {
    for (int i = threadIdx.x >> 5; i < m; i += kWarps)
      for (int j = threadIdx.x & 31; j < m; j += 32)
        cp_async4(eop + (size_t)i * ld + j, eop_g + (size_t)i * m + j);
  }
  asm volatile("cp.async.commit_group;" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_all;" ::: "memory");
}

// The rows kernel's deposit. A tap's fixed-point count v = rint(w 2^28)
// (shape.cuh) goes in two parts, v & 0xffff to hist[c] and v >> 16
// (arithmetic) to hist[m + c], both by reductions that return nothing, so
// no thread waits on an atomic: a cell's count is sum(lo) + 2^16 sum(hi),
// the same integer as fixed_count's carried words hold (neither part can
// overflow for N <= kRowParticles). The position is scaled with __fmul_rn,
// so that the compiler cannot fuse the scaling into the taps' offsets: the
// weights are those of leapfrog_kernel, bit for bit.
__device__ __forceinline__ void add_split(unsigned* hist, int m, int c, float w) {
  const int v = __float2int_rn(w * pct::kFixedOne);
  atomicAdd(&hist[c], static_cast<unsigned>(v) & 0xffffu);
  atomicAdd(reinterpret_cast<int*>(hist) + m + c, v >> 16);
}

template <int KIND>
__device__ __forceinline__ pct::Taps<KIND> row_taps(float x, const GridParams& p) {
  return pct::taps<KIND, true>(__fmul_rn(x, p.inv_dx), p.m);
}

template <int KIND>
__device__ __forceinline__ void deposit_split(float x, unsigned* hist, const GridParams& p) {
  const pct::Taps<KIND> t = row_taps<KIND>(x, p);
#pragma unroll
  for (int o = 0; o < pct::Taps<KIND>::kCount; ++o) add_split(hist, p.m, t.cell[o], t.w[o]);
  if (KIND == 1 && t.edge_w != 0.0f) add_split(hist, p.m, t.edge_cell, t.edge_w);
}

// Row `row`'s particles of this thread (threadIdx.x + 256 j, j < kRowQ) and
// its drive at cell threadIdx.x (M <= kThreads on this path).
__device__ __forceinline__ void load_row(const float* __restrict__ x, const float* __restrict__ v,
                                         const float* __restrict__ e_ext, int row,
                                         const GridParams& p, float (&xr)[kRowQ],
                                         float (&vr)[kRowQ], float& er) {
  const size_t off = (size_t)row * p.n;
#pragma unroll
  for (int j = 0; j < kRowQ; ++j) {
    const int q = threadIdx.x + j * kThreads;
    if (q < p.n) {
      xr[j] = x[off + q];
      vr[j] = v[off + q];
    }
  }
  er = threadIdx.x < p.m ? e_ext[(size_t)row * p.m + threadIdx.x] : 0.0f;
}

// Per row: pass 1 (drift, deposit into histogram 0), solve 1 (the kick-stage
// field plus the drive into fa), pass 2 (gather, kick, drift, store x', v',
// with `exact` deposit into histogram 1), solve 2. Histogram 0 is cleared in
// pass 2, after solve 1 read it; histogram 1 in the next row's pass 1, after
// solve 2 read it. Four barriers per row (three without `exact`). The same
// particle arithmetic, the same integer counts per cell and the same solve
// as leapfrog_kernel: the outputs are bitwise the same.
template <int KIND>
__global__ void __launch_bounds__(kThreads)
leapfrog_rows_kernel(const float* __restrict__ x, const float* __restrict__ v,
                     const float* __restrict__ e_ext, const float* __restrict__ eop_g,
                     float* __restrict__ xo, float* __restrict__ vo, float* __restrict__ eo,
                     const GridParams p, int b, int exact) {
  extern __shared__ __align__(16) float smem[];
  const int n = p.n, m = p.m;
  const Smem s = carve(smem, p, true, false);
  const int ld = eop_stride(m);
  unsigned* hist0 = s.hist;
  unsigned* hist1 = s.hist + 2 * m;
  stage_eop(eop_g, s.eop, m);
  for (int j = threadIdx.x; j < 2 * m; j += kThreads) hist0[j] = 0u;
  float xr[kRowQ], vr[kRowQ], er;
  int row = blockIdx.x;
  if (row < b) load_row(x, v, e_ext, row, p, xr, vr, er);
  __syncthreads();

  for (; row < b; row += gridDim.x) {
    const size_t off = (size_t)row * n;
    float* eor = eo + (size_t)row * m;
    float xh[kRowQ], vc[kRowQ];
#pragma unroll
    for (int j = 0; j < kRowQ; ++j) {
      const int q = threadIdx.x + j * kThreads;
      if (q < n) {
        vc[j] = vr[j];
        xh[j] = pct::wrap_pos(xr[j] + p.half_dt * vr[j], p.length);
        deposit_split<KIND>(xh[j], hist0, p);
      }
    }
    if (threadIdx.x < m) s.ua[threadIdx.x] = er;
    for (int j = threadIdx.x; j < 2 * m; j += kThreads) hist1[j] = 0u;
    // the next row's particles and drive, in flight through this row's work
    if (row + (int)gridDim.x < b) load_row(x, v, e_ext, row + gridDim.x, p, xr, vr, er);
    cp_async_wait();
    __syncthreads();
    solve<true>(hist0, s.eop, ld, s.rho, p, [&](int j, float es) {
      s.fa[j] = es + s.ua[j];
      if (!exact) eor[j] = es;
    });
    __syncthreads();

#pragma unroll
    for (int j = 0; j < kRowQ; ++j) {
      const int q = threadIdx.x + j * kThreads;
      if (q < n) {
        const float vn = vc[j] + p.dt * (-pct::gather(row_taps<KIND>(xh[j], p), s.fa));
        const float xn = pct::wrap_pos(xh[j] + p.half_dt * vn, p.length);
        xo[off + q] = xn;
        vo[off + q] = vn;
        if (exact) deposit_split<KIND>(xn, hist1, p);
      }
    }
    for (int j = threadIdx.x; j < 2 * m; j += kThreads) hist0[j] = 0u;
    if (exact) {
      __syncthreads();
      solve<true>(hist1, s.eop, ld, s.rho, p, [&](int j, float es) { eor[j] = es; });
    }
    __syncthreads();
  }
}

template <bool MERGED, int KIND, bool SMEM, bool GMESH>
__global__ void __launch_bounds__(kThreads)
horizon_kernel(const float* __restrict__ x0, const float* __restrict__ v0,
               const float* __restrict__ u, const float* __restrict__ eop_g,
               float* __restrict__ pe, float* __restrict__ scratch, float* __restrict__ mesh,
               const GridParams p, int eop_smem) {
  extern __shared__ __align__(16) float smem[];
  const int n = p.n, m = p.m, h = p.h, k = blockIdx.x;
  // MERGED: fa = 2 E + u_t + u_{t+1}; else fa = E + u_t (kick 2 of step t),
  // fb = E + u_{t+1} (kick 1 of step t+1)
  float* base = GMESH ? mesh + (size_t)k * mesh_words(p) : smem;
  const Smem s = carve(base, p, SMEM || eop_smem, SMEM || scratch == nullptr);
  setup(eop_g, s, p);
  const float* eop = SMEM || eop_smem ? s.eop : eop_g;
  const int ld = SMEM || eop_smem ? eop_stride(m) : m;
  float* xs = SMEM || scratch == nullptr ? s.state : scratch + (size_t)k * 2 * n;
  float* vs = xs + n;
  const float* uk = u + (size_t)k * h * m;
  for (int j = threadIdx.x; j < m; j += kThreads) s.ua[j] = uk[j];
  __syncthreads();

  // prologue: this candidate's copy of the shared state, deposited at x0
  for (int q = threadIdx.x; q < n; q += kThreads) {
    const float xq = x0[q];
    xs[q] = xq;
    vs[q] = v0[q];
    deposit_at<KIND, false>(xq, s.hist, p);
  }
  __syncthreads();
  float* f0 = MERGED ? s.fa : s.fb;
  solve(s.hist, eop, ld, s.rho, p, [&](int j, float es) { f0[j] = es + s.ua[j]; });
  __syncthreads();

  for (int t = 0; t < h; ++t) {
    unsigned* cur = s.hist + ((t + 1) & 1) * 2 * m;
    // the drive fields this step's solve adds, and the last step's energy
    if (t + 1 < h)
      for (int j = threadIdx.x; j < m; j += kThreads) {
        s.ua[j] = uk[(size_t)t * m + j];
        s.ub[j] = uk[(size_t)(t + 1) * m + j];
      }
    if (t > 0 && threadIdx.x == 0) pe[(size_t)k * h + t - 1] = energy(s.pe_part, p);
    // kick(s) at the current positions, drift, deposit: one pass
    for (int q = threadIdx.x; q < n; q += kThreads) {
      float xq = xs[q], vq = vs[q];
      const pct::Taps<KIND> tp = pct::taps<KIND, true>(xq * p.inv_dx, m);
      if (MERGED) {
        vq = vq + p.half_dt * (-pct::gather(tp, s.fa));
      } else {
        if (t > 0) vq = vq + p.half_dt * (-pct::gather(tp, s.fa));
        vq = vq + p.half_dt * (-pct::gather(tp, s.fb));
      }
      xq = pct::wrap_pos(xq + p.dt * vq, p.length);
      xs[q] = xq;
      vs[q] = vq;
      deposit_at<KIND, true>(xq, cur, p);
    }
    __syncthreads();
    const float e2 = solve(cur, eop, ld, s.rho, p, [&](int j, float es) {
      if (t + 1 < h) {
        const float ut = s.ua[j], un = s.ub[j];
        if (MERGED) {
          s.fa[j] = 2.0f * es + ut + un;
        } else {
          s.fa[j] = es + ut;
          s.fb[j] = es + un;
        }
      }
    });
    // the other histogram was last read by the previous step's solve
    for (int j = threadIdx.x; j < 2 * m; j += kThreads) s.hist[(t & 1) * 2 * m + j] = 0u;
    energy_partial(e2, s.pe_part);
    __syncthreads();
  }
  if (threadIdx.x == 0) pe[(size_t)k * h + h - 1] = energy(s.pe_part, p);
}

// Per device and instantiation: allow one CTA all of Hopper's dynamic shared
// memory (the launch asks for what it needs).
template <typename Kernel>
cudaError_t configure(Kernel kernel, int& done_for) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || done_for == dev) return err;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSharedBytes);
  if (err == cudaSuccess) done_for = dev;
  return err;
}

template <int KIND, bool SMEM, bool GMESH>
cudaError_t launch_leapfrog(const float* x, const float* v, const float* e_ext,
                            const float* eop_t, float* xo, float* vo, float* eo, float* mesh,
                            int b, const GridParams& p, int exact, int eop_smem, int state_smem,
                            cudaStream_t stream) {
  static int done_for = -1;
  cudaError_t err = configure(leapfrog_kernel<KIND, SMEM, GMESH>, done_for);
  if (err != cudaSuccess) return err;
  const size_t smem = sizeof(float) * shared_words(p, !GMESH, eop_smem, state_smem);
  leapfrog_kernel<KIND, SMEM, GMESH><<<b, kThreads, smem, stream>>>(
      x, v, e_ext, eop_t, xo, vo, eo, mesh, p, exact, eop_smem, state_smem);
  return cudaGetLastError();
}

template <int KIND>
cudaError_t leapfrog_placement(const float* x, const float* v, const float* e_ext,
                               const float* eop_t, float* xo, float* vo, float* eo, float* mesh,
                               int b, const GridParams& p, int exact, int eop_smem,
                               int state_smem, cudaStream_t stream) {
  if (mesh)
    return launch_leapfrog<KIND, false, true>(x, v, e_ext, eop_t, xo, vo, eo, mesh, b, p, exact,
                                              eop_smem, state_smem, stream);
  return eop_smem && state_smem
             ? launch_leapfrog<KIND, true, false>(x, v, e_ext, eop_t, xo, vo, eo, mesh, b, p,
                                                  exact, eop_smem, state_smem, stream)
             : launch_leapfrog<KIND, false, false>(x, v, e_ext, eop_t, xo, vo, eo, mesh, b, p,
                                                   exact, eop_smem, state_smem, stream);
}

// The rows kernel's shared memory: the mesh arrays and e_op_t.
inline size_t rows_smem(const GridParams& p) {
  return sizeof(float) * shared_words(p, true, true, false);
}

// grid CTAs of leapfrog_rows_kernel over b rows; with ctas, instead of the
// launch, how many of its CTAs fit one SM.
template <int KIND>
cudaError_t launch_rows(const float* x, const float* v, const float* e_ext, const float* eop_t,
                        float* xo, float* vo, float* eo, int b, int grid, const GridParams& p,
                        int exact, cudaStream_t stream, int* ctas) {
  static int done_for = -1;
  cudaError_t err = configure(leapfrog_rows_kernel<KIND>, done_for);
  if (err != cudaSuccess) return err;
  if (ctas)
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(ctas, leapfrog_rows_kernel<KIND>,
                                                         kThreads, rows_smem(p));
  leapfrog_rows_kernel<KIND><<<grid, kThreads, rows_smem(p), stream>>>(x, v, e_ext, eop_t, xo, vo,
                                                                       eo, p, b, exact);
  return cudaGetLastError();
}

cudaError_t rows_kind(const float* x, const float* v, const float* e_ext, const float* eop_t,
                      float* xo, float* vo, float* eo, int b, int grid, const GridParams& p,
                      int exact, cudaStream_t stream, int* ctas) {
  switch (p.kind) {
    case 0: return launch_rows<0>(x, v, e_ext, eop_t, xo, vo, eo, b, grid, p, exact, stream, ctas);
    case 1: return launch_rows<1>(x, v, e_ext, eop_t, xo, vo, eo, b, grid, p, exact, stream, ctas);
    default: return launch_rows<2>(x, v, e_ext, eop_t, xo, vo, eo, b, grid, p, exact, stream, ctas);
  }
}

// The rows kernel takes a row: N <= kRowParticles, M <= kThreads cells and
// the mesh arrays and e_op_t in one CTA's shared memory.
bool rows_fit(const GridParams& p) {
  return p.n <= kRowParticles && p.m <= kThreads && rows_smem(p) <= (size_t)kSharedBytes;
}

template <bool MERGED, int KIND, bool SMEM, bool GMESH>
cudaError_t launch_horizon(const float* x0, const float* v0, const float* u, const float* eop_t,
                           float* pe, float* scratch, float* mesh, int k, const GridParams& p,
                           int eop_smem, cudaStream_t stream) {
  static int done_for = -1;
  cudaError_t err = configure(horizon_kernel<MERGED, KIND, SMEM, GMESH>, done_for);
  if (err != cudaSuccess) return err;
  const size_t smem = sizeof(float) * shared_words(p, !GMESH, eop_smem, scratch == nullptr);
  horizon_kernel<MERGED, KIND, SMEM, GMESH><<<k, kThreads, smem, stream>>>(
      x0, v0, u, eop_t, pe, scratch, mesh, p, eop_smem);
  return cudaGetLastError();
}

template <bool MERGED, int KIND>
cudaError_t horizon_placement(const float* x0, const float* v0, const float* u,
                              const float* eop_t, float* pe, float* scratch, float* mesh, int k,
                              const GridParams& p, int eop_smem, cudaStream_t stream) {
  if (mesh)
    return launch_horizon<MERGED, KIND, false, true>(x0, v0, u, eop_t, pe, scratch, mesh, k, p,
                                                     eop_smem, stream);
  return eop_smem && scratch == nullptr
             ? launch_horizon<MERGED, KIND, true, false>(x0, v0, u, eop_t, pe, scratch, mesh, k,
                                                         p, eop_smem, stream)
             : launch_horizon<MERGED, KIND, false, false>(x0, v0, u, eop_t, pe, scratch, mesh,
                                                          k, p, eop_smem, stream);
}

template <bool MERGED>
cudaError_t horizon_kind(const float* x0, const float* v0, const float* u, const float* eop_t,
                         float* pe, float* scratch, float* mesh, int k, const GridParams& p,
                         int eop_smem, cudaStream_t stream) {
  switch (p.kind) {
    case 0: return horizon_placement<MERGED, 0>(x0, v0, u, eop_t, pe, scratch, mesh, k, p, eop_smem, stream);
    case 1: return horizon_placement<MERGED, 1>(x0, v0, u, eop_t, pe, scratch, mesh, k, p, eop_smem, stream);
    case 2: return horizon_placement<MERGED, 2>(x0, v0, u, eop_t, pe, scratch, mesh, k, p, eop_smem, stream);
    default: return cudaErrorInvalidValue;
  }
}

// mesh: the global scratch of the mesh arrays, or null (shared memory). With
// it, the state and e_op_t live in global memory too.
bool valid(const GridParams& p, const float* mesh, bool eop_smem, bool state_smem) {
  if (p.n < 1 || p.m < 1 || p.h < 1 || p.kind < 0 || p.kind > 2) return false;
  if (mesh) return !eop_smem && !state_smem;
  return sizeof(float) * shared_words(p, true, eop_smem, state_smem) <= (size_t)kSharedBytes;
}

}  // namespace

extern "C" {

// x, v: (b, n); e_ext: (b, m); eop_t: (m, m) = e_op.T; outputs xo, vo (b, n)
// and eo (b, m). grid > 0: leapfrog_rows_kernel on grid CTAs (mesh null,
// eop_smem = 1, state_smem = 0; see rows_fit). Otherwise one CTA per row:
// state_smem = 0 keeps the half-step state in xo, vo; mesh null keeps the
// mesh arrays in shared memory, else a (b, mesh_words) float buffer holds
// them (eop_smem = state_smem = 0).
int pct_fused_leapfrog_step(const float* x, const float* v, const float* e_ext,
                            const float* eop_t, float* xo, float* vo, float* eo, float* mesh,
                            int b, int grid, GridParams p, int exact, int eop_smem,
                            int state_smem, cudaStream_t stream) {
  if (b < 1 || grid < 0 || !valid(p, mesh, eop_smem, state_smem))
    return static_cast<int>(cudaErrorInvalidValue);
  if (grid > 0) {
    if (mesh || !eop_smem || state_smem || !rows_fit(p))
      return static_cast<int>(cudaErrorInvalidValue);
    return static_cast<int>(
        rows_kind(x, v, e_ext, eop_t, xo, vo, eo, b, grid, p, exact, stream, nullptr));
  }
  cudaError_t err;
  switch (p.kind) {
    case 0: err = leapfrog_placement<0>(x, v, e_ext, eop_t, xo, vo, eo, mesh, b, p, exact, eop_smem, state_smem, stream); break;
    case 1: err = leapfrog_placement<1>(x, v, e_ext, eop_t, xo, vo, eo, mesh, b, p, exact, eop_smem, state_smem, stream); break;
    default: err = leapfrog_placement<2>(x, v, e_ext, eop_t, xo, vo, eo, mesh, b, p, exact, eop_smem, state_smem, stream); break;
  }
  return static_cast<int>(err);
}

// How many CTAs of leapfrog_rows_kernel fit one SM at these parameters (0
// where the rows kernel does not take them).
int pct_leapfrog_rows_ctas(GridParams p, int* ctas) {
  *ctas = 0;
  if (!valid(p, nullptr, 1, 0) || !rows_fit(p)) return 0;
  return static_cast<int>(
      rows_kind(nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, 0, 0, p, 0,
                nullptr, ctas));
}

// x0, v0: (n,) shared initial state, positions in [-L, 2L); u: (k, h, m)
// drive fields; eop_t: (m, m); pe: (k, h). scratch: null keeps each
// candidate's state in shared memory, else a (k, 2, n) float buffer. mesh:
// null keeps the mesh arrays in shared memory, else a (k, mesh_words) float
// buffer that holds them (with scratch set and eop_smem = 0). merged selects
// kernel 6 over 5.
int pct_grid_horizon(const float* x0, const float* v0, const float* u, const float* eop_t,
                     float* pe, float* scratch, float* mesh, int k, GridParams p, int merged,
                     int eop_smem, cudaStream_t stream) {
  if (k < 1 || !valid(p, mesh, eop_smem, scratch == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err =
      merged ? horizon_kind<true>(x0, v0, u, eop_t, pe, scratch, mesh, k, p, eop_smem, stream)
             : horizon_kind<false>(x0, v0, u, eop_t, pe, scratch, mesh, k, p, eop_smem, stream);
  return static_cast<int>(err);
}

}  // extern "C"
