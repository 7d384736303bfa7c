// Kernel 1, the spectral planner's horizon (sm_90a): the kernel and its
// launch, shared by spectral_horizon.cu (the rot drift and the C entry
// points) and spectral_horizon_trig.cu (the trig drift), which nvcc compiles
// side by side. The design note is at the top of spectral_horizon.cu.

#pragma once

#include <cuda_runtime.h>

constexpr int kMaxModes = 64;    // largest Km
constexpr int kBlockModes = 16;  // modes per block: one reduction's 2 x 16 sums

// Passed by value from ops/kernels/_build.py::SpectralParams (same layout).
// Outside the anonymous namespace: the extern "C" entry point takes it.
struct SpectralParams {
  int k, h, km, n;
  int ka, u_sk, u_sh;  // drive modes held by the caller, its K and H strides
  int x_st;            // stride of x0 and v0
  int cluster;         // CTAs per candidate
  float dt, half_dt, length, inv_l, c_ang, c_ang_dt, pe_scale;
  float g[kMaxModes];       // 2 n0 / (N k_m), 0 beyond Km
  float inv_k2[kMaxModes];  // 1 / k_m^2, 0 beyond Km
};

namespace pct_spectral {

// Device pointers of one launch: x0, v0 (n,) at stride x_st; uc, us: the
// drive's cosine and sine coefficients, element (k, t, m) at k*u_sk + t*u_sh
// + m for m < ka; tc, ts (h, km) targets of the corrected variant, else null;
// pe (k, h); scratch (k * cluster, (3 + !rot) * S) or null (state in shared
// memory).
struct Buffers {
  const float *x0, *v0, *uc, *us, *tc, *ts;
  float *pe, *scratch;
};

// Launch (or, with max_clusters, count how many clusters of the launch fit
// the card) for one drift: rot in spectral_horizon.cu, trig in
// spectral_horizon_trig.cu.
int launch_rot(const Buffers& b, const SpectralParams& p, cudaStream_t stream, int* max_clusters);
int launch_trig(const Buffers& b, const SpectralParams& p, cudaStream_t stream, int* max_clusters);

}  // namespace pct_spectral

namespace {

using pct_spectral::Buffers;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSums = 2 * kBlockModes;  // cos sums at [0, 16), sin sums at [16, 32)
constexpr int kMaxBlocks = kMaxModes / kBlockModes;
constexpr int kMaxCluster = 16;

struct Reduction {
  float red[kWarps][kSums];  // per-warp partial sums
  float slot[2][kSums];      // the CTA's partial sums, read by the cluster
  float coef[kSums];         // field coefficients (pc_m, ps_m), 0 beyond Km
};

// The blocked kernel's field coefficients, one row of kSums per block of
// kBlockModes modes (pc at [0, 16), ps at [16, 32)).
using BlockCoefs = float[kMaxBlocks][kSums];

// ---- thread-block cluster primitives (PTX, sm_90) -------------------------
__device__ __forceinline__ int cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return static_cast<int>(r);
}

// Every thread of every CTA of the cluster; orders shared-memory writes before
// it against reads after it, cluster-wide.
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n\tbarrier.cluster.wait.acquire.aligned;"
               ::: "memory");
}

// A float of CTA `rank`'s shared memory at the offset of `local` in ours.
__device__ __forceinline__ float load_rank(const float* local, int rank) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(local));
  unsigned remote;
  float v;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(remote) : "r"(addr), "r"(rank));
  asm volatile("ld.shared::cluster.f32 %0, [%1];" : "=f"(v) : "r"(remote) : "memory");
  return v;
}

// ---- per-particle arithmetic, MODES = 8 or 16 modes at compile time -------
// The loops run all MODES modes without a guard: guarded updates of the
// recurrence compile to predicated code with register moves that doubles the
// instruction count. Sums of modes Km..MODES-1 are never read; their field
// coefficients are 0, so the Clenshaw terms they add are exact zeros.

// Adds cos(m k1 x), sin(m k1 x), m = 1..MODES, of one particle to the
// thread's partial sums v (cos at [0, MODES), sin at [MODES, 2 MODES)):
// f((m+1)t) = 2 cos(t) f(mt) - f((m-1)t).
template <int MODES>
__device__ __forceinline__ void add_harmonics(float c1, float s1, float (&v)[2 * MODES]) {
  const float twoc = c1 + c1;
  float cp2 = 1.0f, sp2 = 0.0f, cp = c1, sp = s1;
  v[0] += cp;
  v[MODES] += sp;
#pragma unroll
  for (int m = 1; m < MODES; ++m) {
    const float cn = twoc * cp - cp2;
    const float sn = twoc * sp - sp2;
    cp2 = cp;
    cp = cn;
    sp2 = sp;
    sp = sn;
    v[m] += cp;
    v[MODES + m] += sp;
  }
}

// sum_m pc_m cos(m k1 x) + ps_m sin(m k1 x) by Clenshaw's recurrence
// b_m = a_m + 2 cos(k1 x) b_{m+1} - b_{m+2}; the cosine series is
// b_1 c1 - b_2, the sine series b_1 s1.
template <int MODES>
__device__ __forceinline__ float clenshaw(float c1, float s1, const float (&pc)[MODES],
                                          const float (&ps)[MODES]) {
  const float twoc = c1 + c1;
  float bc1 = 0.0f, bc2 = 0.0f, bs1 = 0.0f, bs2 = 0.0f;
#pragma unroll
  for (int m = MODES - 1; m >= 0; --m) {
    const float bc = fmaf(twoc, bc1, pc[m] - bc2);
    const float bs = fmaf(twoc, bs1, ps[m] - bs2);
    bc2 = bc1;
    bc1 = bc;
    bs2 = bs1;
    bs1 = bs;
  }
  return fmaf(bc1, c1, -bc2) + bs1 * s1;
}

// ---- Km > 16: blocks of 16 modes ------------------------------------------
// Block b holds modes 16 b + 1 .. 16 b + 16. Its sums come from one pass over
// the particles that runs the harmonic recurrence from mode 1 (the same
// arithmetic as one long recurrence) and adds only the block's 16 modes, so
// the thread keeps 32 partial sums whatever Km, and the state stays (c1, s1,
// vh[, x]).

// Adds cos(m k1 x), sin(m k1 x), m = first + 1 .. first + 16, to v.
__device__ __forceinline__ void add_block_harmonics(float c1, float s1, int first,
                                                    float (&v)[kSums]) {
  const float twoc = c1 + c1;
  float cp2 = 1.0f, sp2 = 0.0f, cp = c1, sp = s1;
  for (int m = 0; m < first; ++m) {
    const float cn = twoc * cp - cp2;
    const float sn = twoc * sp - sp2;
    cp2 = cp;
    cp = cn;
    sp2 = sp;
    sp = sn;
  }
  v[0] += cp;
  v[kBlockModes] += sp;
#pragma unroll
  for (int m = 1; m < kBlockModes; ++m) {
    const float cn = twoc * cp - cp2;
    const float sn = twoc * sp - sp2;
    cp2 = cp;
    cp = cn;
    sp2 = sp;
    sp = sn;
    v[m] += cp;
    v[kBlockModes + m] += sp;
  }
}

// Clenshaw's recurrence over the coefficients of blocks nb-1 .. 0, read from
// shared memory, its four chain values carried from block to block: the same
// arithmetic as clenshaw<16 nb>.
__device__ __forceinline__ float clenshaw_blocks(float c1, float s1, const BlockCoefs& coefs,
                                                 int nb) {
  const float twoc = c1 + c1;
  float bc1 = 0.0f, bc2 = 0.0f, bs1 = 0.0f, bs2 = 0.0f;
  for (int blk = nb - 1; blk >= 0; --blk) {
    const float4* a = reinterpret_cast<const float4*>(coefs[blk]);
    float pc[kBlockModes], ps[kBlockModes];
#pragma unroll
    for (int q = 0; q < kBlockModes / 4; ++q) {
      const float4 c = a[q], s = a[kBlockModes / 4 + q];
      pc[4 * q] = c.x;
      pc[4 * q + 1] = c.y;
      pc[4 * q + 2] = c.z;
      pc[4 * q + 3] = c.w;
      ps[4 * q] = s.x;
      ps[4 * q + 1] = s.y;
      ps[4 * q + 2] = s.z;
      ps[4 * q + 3] = s.w;
    }
#pragma unroll
    for (int m = kBlockModes - 1; m >= 0; --m) {
      const float bc = fmaf(twoc, bc1, pc[m] - bc2);
      const float bs = fmaf(twoc, bs1, ps[m] - bs2);
      bc2 = bc1;
      bc1 = bc;
      bs2 = bs1;
      bs1 = bs;
    }
  }
  return fmaf(bc1, c1, -bc2) + bs1 * s1;
}

// flag ? a : b in registers. Written as a C++ select of two array elements,
// the compiler selects their address instead and moves the array to local
// memory.
__device__ __forceinline__ float select(int flag, float a, float b) {
  float r;
  asm("{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %3, 0;\n\tselp.f32 %0, %1, %2, p;\n\t}"
      : "=f"(r) : "f"(a), "f"(b), "r"(flag));
  return r;
}

// One level of the warp reduce-scatter: lanes with bit HALF clear keep
// v[0, HALF) and send v[HALF, 2 HALF) to the partner lane, the others the
// reverse; then the next level. Levels are template arguments so that every
// index is a compile-time constant and v stays in registers.
template <int N, int HALF>
__device__ __forceinline__ void butterfly(float (&v)[N], int lane) {
  const int upper = lane & HALF;
#pragma unroll
  for (int j = 0; j < HALF; ++j) {
    const float send = select(upper, v[j], v[j + HALF]);
    const float keep = select(upper, v[j + HALF], v[j]);
    v[j] = keep + __shfl_xor_sync(0xffffffffu, send, HALF);
  }
  if constexpr (HALF > 1) butterfly<N, HALF / 2>(v, lane);
}

// Sums v[0 .. 2 MODES) over the warp; afterwards lane l holds the warp's
// total of value l mod 2 MODES: 2 MODES - 1 shuffles, then the lanes beyond
// 2 MODES fold in.
template <int MODES>
__device__ __forceinline__ float warp_reduce_scatter(float (&v)[2 * MODES]) {
  butterfly<2 * MODES, MODES>(v, threadIdx.x & 31);
  float total = v[0];
#pragma unroll
  for (int off = 2 * MODES; off < 32; off <<= 1) total += __shfl_xor_sync(0xffffffffu, total, off);
  return total;
}

// Thread j < 32 of warp 0 owns one field coefficient of each block of 16
// modes: in block b, pc_m (j = m - 16 b < 16), formed from the sine sum s_m,
// or ps_m (j = 16 + m - 16 b), from the cosine sum c_m.
struct Own {
  int m;           // its mode (0-based, 16 b + j mod 16)
  bool sine_coef;  // ps_m (true) or pc_m
  int src;         // slot of the mode sum it forms the coefficient from
};

__device__ __forceinline__ Own own_coef(int block) {
  const int j = threadIdx.x & (kBlockModes - 1);
  const bool sine_coef = threadIdx.x >= kBlockModes;
  return Own{kBlockModes * block + j, sine_coef, sine_coef ? j : kBlockModes + j};
}

// The drive term of the thread's coefficient at step t: u_t (prologue) or
// u_t + u_{t+1} (u_{H-1} twice in the last step); 0 for modes beyond Ka.
__device__ __forceinline__ float drive(const Own& o, int t, bool pair, const Buffers& b,
                                       const SpectralParams& p, int cand) {
  if (threadIdx.x >= kSums || o.m >= p.ka) return 0.0f;
  const float* u = (o.sine_coef ? b.us : b.uc) + (size_t)cand * p.u_sk + o.m;
  const float du = u[(size_t)t * p.u_sh];
  return pair ? u[(size_t)min(t + 1, p.h - 1) * p.u_sh] + du : du;
}

// The candidate's mode sums from every CTA's partial sums v, added in rank
// order 0..C-1, then the field coefficients pc_m = scale g_m s_m + du and
// ps_m = -(scale g_m c_m) + du into coef[0, 32) (0 beyond Km). One block
// barrier, one cluster barrier, one block barrier. Returns, on thread j < 32,
// the candidate's total of mode sum o.src (0 beyond Km). Consecutive calls
// alternate `phase` between the two slots.
template <int MODES>
__device__ __forceinline__ float reduce_modes(float (&v)[2 * MODES], int phase, float scale,
                                              float du, const Own& o, const SpectralParams& p,
                                              Reduction& r, float* coef_out) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const float part = warp_reduce_scatter<MODES>(v);
  if (lane < 2 * MODES) r.red[warp][lane < MODES ? lane : kBlockModes + lane - MODES] = part;
  __syncthreads();
  float* slot = r.slot[phase & 1];
  if (threadIdx.x < kSums && o.m < p.km) {
    float acc = 0.0f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) acc += r.red[w][threadIdx.x];
    slot[threadIdx.x] = acc;
  }
  cluster_sync();
  float total = 0.0f;
  if (threadIdx.x < kSums) {
    float coef = 0.0f;
    if (o.m < p.km) {
      const int c = p.cluster;
      float sums[kMaxCluster];
#pragma unroll
      for (int q = 0; q < kMaxCluster; ++q)
        if (q < c) sums[q] = load_rank(slot + o.src, q);
#pragma unroll
      for (int q = 0; q < kMaxCluster; ++q)
        if (q < c) total += sums[q];
      const float f = scale * (p.g[o.m] * total);
      coef = o.sine_coef ? -f + du : f + du;
    }
    coef_out[threadIdx.x] = coef;
  }
  __syncthreads();
  return total;
}

// The lane's term (c_m - tc_m)^2 / k_m^2 or (s_m - ts_m)^2 / k_m^2 of the
// energy (0 beyond Km).
__device__ __forceinline__ float energy_term(float total, float target, const Own& o,
                                             const SpectralParams& p) {
  const float d = total - target;
  return o.m < p.km ? (d * d) * p.inv_k2[o.m] : 0.0f;
}

// Warp 0 of rank 0: pe_scale * sum_m ((c_m - tc_m)^2 + (s_m - ts_m)^2) / k_m^2,
// the lanes' terms e summed by a butterfly in a fixed order.
__device__ __forceinline__ void write_energy(float e, const SpectralParams& p, float* pe) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) e += __shfl_xor_sync(0xffffffffu, e, off);
  if (threadIdx.x == 0) *pe = p.pe_scale * e;
}

template <int MODES>
__device__ __forceinline__ void load_coef(const Reduction& r, float (&pc)[MODES],
                                          float (&ps)[MODES]) {
#pragma unroll
  for (int m = 0; m < MODES; ++m) {
    pc[m] = r.coef[m];
    ps[m] = r.coef[kBlockModes + m];
  }
}

// Particle i's drift: its phasor (c1, s1) rotated by the small angle
// c_ang dt vh (rot), or recomputed at the wrapped position x + dt vh (trig);
// stores and returns the new phasor.
template <bool ROT>
__device__ __forceinline__ void drift(int i, float* c1, float* s1, const float* vh, float* x,
                                      const SpectralParams& p, float& cn, float& sn) {
  if (ROT) {
    const float d = p.c_ang_dt * vh[i];
    const float d2 = d * d;
    const float cd = 1.0f + d2 * (-0.5f + d2 * (float)(1.0 / 24.0));
    const float sd = d * (1.0f + d2 * ((float)(-1.0 / 6.0) + d2 * (float)(1.0 / 120.0)));
    const float co = c1[i], so = s1[i];
    cn = co * cd - so * sd;
    sn = so * cd + co * sd;
  } else {
    float xq = x[i] + p.dt * vh[i];
    xq = xq - p.length * floorf(xq * p.inv_l);
    x[i] = xq;
    sincosf(p.c_ang * xq, &sn, &cn);
  }
  c1[i] = cn;
  s1[i] = sn;
}

// The un-merged half kick's start at the shared x0: particle i's phasor,
// velocity (and position) into the state; returns the phasor.
template <bool ROT>
__device__ __forceinline__ void load_particle(int i, const float* __restrict__ x0,
                                              const float* __restrict__ v0,
                                              const SpectralParams& p, float* c1, float* s1,
                                              float* vh, float* x, float& cn, float& sn) {
  const float xq = x0[(size_t)i * p.x_st];
  sincosf(p.c_ang * xq, &sn, &cn);
  c1[i] = cn;
  s1[i] = sn;
  vh[i] = v0[(size_t)i * p.x_st];
  if (!ROT) x[i] = xq;
}

template <bool ROT, bool GLOBAL, bool CORRECTED, int MODES>
__device__ __forceinline__ void horizon(const Buffers& b, const SpectralParams& p, Reduction& r,
                                        float* smem_state) {
  const int rank = cluster_rank();
  const int cand = blockIdx.x / p.cluster;
  const int slice = (p.n + p.cluster - 1) / p.cluster;
  const int lo = min(rank * slice, p.n);
  const int cnt = min(slice, p.n - lo);
  const float* __restrict__ x0 = b.x0 + (size_t)lo * p.x_st;
  const float* __restrict__ v0 = b.v0 + (size_t)lo * p.x_st;
  float* state = GLOBAL ? b.scratch + (size_t)blockIdx.x * (ROT ? 3 : 4) * slice : smem_state;
  float* c1 = state;              // cos(k1 x)
  float* s1 = state + slice;      // sin(k1 x)
  float* vh = state + 2 * slice;  // staggered velocity
  float* x = state + 3 * slice;   // position (trig drift only)
  const Own o = own_coef(0);

  float v[2 * MODES];
  float pc[MODES], ps[MODES];

  // ---- prologue: un-merged half kick at the shared x0 ----------------------
  float du = drive(o, 0, false, b, p, cand);
#pragma unroll
  for (int j = 0; j < 2 * MODES; ++j) v[j] = 0.0f;
  for (int i = threadIdx.x; i < cnt; i += kThreads) {
    float sn, cn;
    load_particle<ROT>(i, x0, v0, p, c1, s1, vh, x, cn, sn);
    add_harmonics<MODES>(cn, sn, v);
  }
  reduce_modes<MODES>(v, 0, 1.0f, du, o, p, r, r.coef);
  load_coef<MODES>(r, pc, ps);
  for (int i = threadIdx.x; i < cnt; i += kThreads)
    vh[i] = vh[i] + p.half_dt * (-clenshaw<MODES>(c1[i], s1[i], pc, ps));

  // ---- H merged-kick steps, state resident for the whole horizon ----------
  for (int t = 0; t < p.h; ++t) {
    // the step's drive and target, loaded while the particles drift
    du = drive(o, t, true, b, p, cand);
    float target = 0.0f;
    if (CORRECTED && threadIdx.x < kSums && o.m < p.km)  // c_m - tc, s_m - ts
      target = (o.sine_coef ? b.tc : b.ts)[t * p.km + o.m];
#pragma unroll
    for (int j = 0; j < 2 * MODES; ++j) v[j] = 0.0f;
    for (int i = threadIdx.x; i < cnt; i += kThreads) {
      float cn, sn;
      drift<ROT>(i, c1, s1, vh, x, p, cn, sn);
      add_harmonics<MODES>(cn, sn, v);
    }
    const float total = reduce_modes<MODES>(v, t + 1, 2.0f, du, o, p, r, r.coef);
    load_coef<MODES>(r, pc, ps);
    if (rank == 0 && threadIdx.x < 32)
      write_energy(energy_term(total, target, o, p), p, b.pe + (size_t)cand * p.h + t);
    for (int i = threadIdx.x; i < cnt; i += kThreads)
      vh[i] = vh[i] + p.half_dt * (-clenshaw<MODES>(c1[i], s1[i], pc, ps));
  }
  // no CTA leaves while another may still read its slot
  cluster_sync();
}

// Adds block blk's harmonics of the thread's particles, at their stored
// phasors, to v (zeroed first).
__device__ __forceinline__ void block_sums(const float* c1, const float* s1, int cnt, int blk,
                                           float (&v)[kSums]) {
#pragma unroll
  for (int j = 0; j < kSums; ++j) v[j] = 0.0f;
  for (int i = threadIdx.x; i < cnt; i += kThreads)
    add_block_harmonics(c1[i], s1[i], kBlockModes * blk, v);
}

// horizon<..., 16> for Km > 16: the same steps with nb = ceil(Km / 16)
// blocks of modes. Per pass (prologue, then each step): the drift pass adds
// block 0's sums, one more pass over the stored phasors per further block,
// each block's sums through the cluster reduction in turn (the slots
// alternate from reduction to reduction, so one cluster barrier per block
// still suffices), its coefficients into coefs[blk]; then one field pass,
// Clenshaw over all blocks. Rank 0's warp 0 adds each block's energy terms
// per lane before the butterfly.
template <bool ROT, bool GLOBAL, bool CORRECTED>
__device__ __forceinline__ void horizon_blocks(const Buffers& b, const SpectralParams& p,
                                               Reduction& r, BlockCoefs& coefs,
                                               float* smem_state) {
  const int rank = cluster_rank();
  const int cand = blockIdx.x / p.cluster;
  const int slice = (p.n + p.cluster - 1) / p.cluster;
  const int lo = min(rank * slice, p.n);
  const int cnt = min(slice, p.n - lo);
  const float* __restrict__ x0 = b.x0 + (size_t)lo * p.x_st;
  const float* __restrict__ v0 = b.v0 + (size_t)lo * p.x_st;
  float* state = GLOBAL ? b.scratch + (size_t)blockIdx.x * (ROT ? 3 : 4) * slice : smem_state;
  float* c1 = state;
  float* s1 = state + slice;
  float* vh = state + 2 * slice;
  float* x = state + 3 * slice;
  const int nb = (p.km + kBlockModes - 1) / kBlockModes;
  int phase = 0;
  float v[kSums];

  // ---- prologue: un-merged half kick at the shared x0 ----------------------
#pragma unroll
  for (int j = 0; j < kSums; ++j) v[j] = 0.0f;
  for (int i = threadIdx.x; i < cnt; i += kThreads) {
    float sn, cn;
    load_particle<ROT>(i, x0, v0, p, c1, s1, vh, x, cn, sn);
    add_harmonics<kBlockModes>(cn, sn, v);
  }
  for (int blk = 0; blk < nb; ++blk) {
    const Own o = own_coef(blk);
    const float du = drive(o, 0, false, b, p, cand);
    if (blk > 0) block_sums(c1, s1, cnt, blk, v);
    reduce_modes<kBlockModes>(v, phase++, 1.0f, du, o, p, r, coefs[blk]);
  }
  for (int i = threadIdx.x; i < cnt; i += kThreads)
    vh[i] = vh[i] + p.half_dt * (-clenshaw_blocks(c1[i], s1[i], coefs, nb));

  // ---- H merged-kick steps -------------------------------------------------
  for (int t = 0; t < p.h; ++t) {
    float e = 0.0f;
    for (int blk = 0; blk < nb; ++blk) {
      const Own o = own_coef(blk);
      const float du = drive(o, t, true, b, p, cand);
      float target = 0.0f;
      if (CORRECTED && threadIdx.x < kSums && o.m < p.km)
        target = (o.sine_coef ? b.tc : b.ts)[t * p.km + o.m];
      if (blk == 0) {
#pragma unroll
        for (int j = 0; j < kSums; ++j) v[j] = 0.0f;
        for (int i = threadIdx.x; i < cnt; i += kThreads) {
          float cn, sn;
          drift<ROT>(i, c1, s1, vh, x, p, cn, sn);
          add_harmonics<kBlockModes>(cn, sn, v);
        }
      } else {
        block_sums(c1, s1, cnt, blk, v);
      }
      const float total = reduce_modes<kBlockModes>(v, phase++, 2.0f, du, o, p, r, coefs[blk]);
      if (rank == 0 && threadIdx.x < 32) e += energy_term(total, target, o, p);
    }
    if (rank == 0 && threadIdx.x < 32) write_energy(e, p, b.pe + (size_t)cand * p.h + t);
    for (int i = threadIdx.x; i < cnt; i += kThreads)
      vh[i] = vh[i] + p.half_dt * (-clenshaw_blocks(c1[i], s1[i], coefs, nb));
  }
  cluster_sync();
}

// Register budgets: three CTAs per SM (80 registers) for the rot drift with
// its state in shared memory; two for trig, whose sincosf needs more, and
// for the global scratch's 64-bit state pointers.
template <bool ROT, bool GLOBAL, bool CORRECTED>
__global__ void __launch_bounds__(kThreads, (ROT && !GLOBAL) ? 3 : 2)
spectral_horizon_kernel(const Buffers b, const SpectralParams p) {
  __shared__ __align__(16) Reduction r;
  extern __shared__ float smem_state[];
  if (p.km <= 8)
    horizon<ROT, GLOBAL, CORRECTED, 8>(b, p, r, smem_state);
  else
    horizon<ROT, GLOBAL, CORRECTED, kBlockModes>(b, p, r, smem_state);
}

// Km > 16 (horizon_blocks): two CTAs per SM, so that a block's 32
// coefficients fit in registers beside the field pass's chains.
template <bool ROT, bool GLOBAL, bool CORRECTED>
__global__ void __launch_bounds__(kThreads, 2)
spectral_horizon_blocks_kernel(const Buffers b, const SpectralParams p) {
  __shared__ __align__(16) Reduction r;
  __shared__ __align__(16) BlockCoefs coefs;
  extern __shared__ float smem_state[];
  horizon_blocks<ROT, GLOBAL, CORRECTED>(b, p, r, coefs, smem_state);
}

template <bool ROT, bool GLOBAL, bool CORRECTED, bool BLOCKS>
auto kernel_of() {
  if constexpr (BLOCKS)
    return spectral_horizon_blocks_kernel<ROT, GLOBAL, CORRECTED>;
  else
    return spectral_horizon_kernel<ROT, GLOBAL, CORRECTED>;
}

// Static shared memory of each kernel, beside which the state's dynamic
// share must fit (ops/kernels/spectral_horizon.py mirrors both sizes).
template <bool BLOCKS>
constexpr int static_bytes() {
  return (int)sizeof(Reduction) + (BLOCKS ? (int)sizeof(BlockCoefs) : 0);
}

template <bool ROT, bool GLOBAL, bool CORRECTED, bool BLOCKS>
cudaError_t configure() {
  // per device: the shared-memory limit and clusters beyond the portable 8
  static int done_for = -1;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || done_for == dev) return err;
  auto* kernel = kernel_of<ROT, GLOBAL, CORRECTED, BLOCKS>();
  const int max_dynamic = 232448 - static_bytes<BLOCKS>();
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, max_dynamic);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err == cudaSuccess) done_for = dev;
  return err;
}

inline size_t state_bytes(const SpectralParams& p, bool rot, bool global) {
  const size_t slice = (size_t)(p.n + p.cluster - 1) / p.cluster;
  return global ? 0 : (rot ? 3 : 4) * sizeof(float) * slice;
}

template <bool ROT, bool GLOBAL, bool CORRECTED, bool BLOCKS>
int launch(const Buffers& b, const SpectralParams& p, cudaStream_t stream, int* max_clusters) {
  cudaError_t err = configure<ROT, GLOBAL, CORRECTED, BLOCKS>();
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3(p.k * p.cluster);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = state_bytes(p, ROT, GLOBAL);
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  auto* kernel = kernel_of<ROT, GLOBAL, CORRECTED, BLOCKS>();
  if (max_clusters) {
    cfg.gridDim = dim3(p.cluster);
    return static_cast<int>(cudaOccupancyMaxActiveClusters(max_clusters, kernel, &cfg));
  }
  err = cudaLaunchKernelEx(&cfg, kernel, b, p);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <bool ROT, bool GLOBAL, bool CORRECTED>
int launch_modes(const Buffers& b, const SpectralParams& p, cudaStream_t stream, int* fit) {
  return p.km > kBlockModes ? launch<ROT, GLOBAL, CORRECTED, true>(b, p, stream, fit)
                            : launch<ROT, GLOBAL, CORRECTED, false>(b, p, stream, fit);
}

template <bool ROT, bool GLOBAL>
int launch_variant(const Buffers& b, const SpectralParams& p, cudaStream_t stream, int* fit) {
  return b.tc ? launch_modes<ROT, GLOBAL, true>(b, p, stream, fit)
              : launch_modes<ROT, GLOBAL, false>(b, p, stream, fit);
}

template <bool ROT>
int launch_placement(const Buffers& b, const SpectralParams& p, cudaStream_t stream, int* fit) {
  return b.scratch ? launch_variant<ROT, true>(b, p, stream, fit)
                   : launch_variant<ROT, false>(b, p, stream, fit);
}

inline bool valid(const SpectralParams& p) {
  return p.km >= 1 && p.km <= kMaxModes && p.ka >= 0 && p.ka <= p.km && p.k >= 1 && p.h >= 1 &&
         p.n >= 1 && p.x_st >= 1 && p.cluster >= 1 && p.cluster <= kMaxCluster;
}

}  // namespace
