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
// pe (k, h); scratch: null (the state in shared memory), or one row per CTA
// of the launch, (2 + rot) * S floats for each of its virtual ranks.
struct Buffers {
  const float *x0, *v0, *uc, *us, *tc, *ts;
  float *pe, *scratch;
};

// A launch's clusters: `clusters` clusters of `cluster` CTAs each.
struct Shape {
  int cluster, clusters;
};

// Launch (or, with max_clusters, count how many clusters of the launch fit
// the card) for one drift: rot in spectral_horizon.cu, trig in
// spectral_horizon_trig.cu.
int launch_rot(const Buffers& b, const SpectralParams& p, const Shape& s, cudaStream_t stream,
               int* max_clusters);
int launch_trig(const Buffers& b, const SpectralParams& p, const Shape& s, cudaStream_t stream,
                int* max_clusters);

}  // namespace pct_spectral

namespace {

using pct_spectral::Buffers;
using pct_spectral::Shape;

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

// The thread's sums v summed over its warp into red; a block barrier
// follows.
template <int MODES>
__device__ __forceinline__ void warp_partials(float (&v)[2 * MODES], float (&red)[kWarps][kSums]) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const float part = warp_reduce_scatter<MODES>(v);
  if (lane < 2 * MODES) red[warp][lane < MODES ? lane : kBlockModes + lane - MODES] = part;
}

// After the barrier: the warps' sums added in warp order, the partial sums of
// the CTA (or of one of its slices), into slot; nothing beyond Km.
__device__ __forceinline__ void rank_partial(const float (&red)[kWarps][kSums], float* slot,
                                             const Own& o, const SpectralParams& p) {
  if (threadIdx.x < kSums && o.m < p.km) {
    float acc = 0.0f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) acc += red[w][threadIdx.x];
    slot[threadIdx.x] = acc;
  }
}

// After the cluster barrier, thread j < 32's total of its mode sum o.src
// (o.m < Km): the p.cluster ranks' partial sums added in rank order, rank q
// read from CTA q / per, in the slot of local rank q mod per (local rank j's
// slot at part + j kSums).
__device__ __forceinline__ float rank_total(const float* part, const Own& o, int per,
                                            const SpectralParams& p) {
  const int c = p.cluster;
  float sums[kMaxCluster];
#pragma unroll
  for (int q = 0; q < kMaxCluster; ++q)
    if (q < c) sums[q] = load_rank(part + (q % per) * kSums + o.src, q / per);
  float total = 0.0f;
#pragma unroll
  for (int q = 0; q < kMaxCluster; ++q)
    if (q < c) total += sums[q];
  return total;
}

// Thread j < 32's field coefficient from its total (o.m < Km):
// pc_m = scale g_m s_m + du or ps_m = -(scale g_m c_m) + du.
__device__ __forceinline__ float field_coef(float total, float scale, float du, const Own& o,
                                            const SpectralParams& p) {
  const float f = scale * (p.g[o.m] * total);
  return o.sine_coef ? -f + du : f + du;
}

// Thread j < 32's total of its mode sum (rank_total) and its field
// coefficient (field_coef) into *coef; both 0 beyond Km.
__device__ __forceinline__ float total_and_coef(const float* part, int per, float scale, float du,
                                                const Own& o, const SpectralParams& p,
                                                float* coef) {
  float total = 0.0f;
  float c = 0.0f;
  if (o.m < p.km) {
    total = rank_total(part, o, per, p);
    c = field_coef(total, scale, du, o, p);
  }
  *coef = c;
  return total;
}

// The candidate's mode sums from every CTA's partial sums v, added in rank
// order 0..C-1, then the field coefficients into coef[0, 32) (0 beyond Km).
// One block barrier, one cluster barrier, one block barrier. Returns, on
// thread j < 32, the candidate's total of mode sum o.src (0 beyond Km).
// Consecutive calls alternate `phase` between the two slots.
template <int MODES>
__device__ __forceinline__ float reduce_modes(float (&v)[2 * MODES], int phase, float scale,
                                              float du, const Own& o, const SpectralParams& p,
                                              Reduction& r, float* coef_out) {
  warp_partials<MODES>(v, r.red);
  __syncthreads();
  float* slot = r.slot[phase & 1];
  rank_partial(r.red, slot, o, p);
  cluster_sync();
  float total = 0.0f;
  if (threadIdx.x < kSums) total = total_and_coef(slot, 1, scale, du, o, p, coef_out + threadIdx.x);
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

// The state in the cluster's shared memory (GLOBAL false): a drift pass with
// the mode sums, the cluster reduction, a field pass with the kick.
template <bool ROT, bool CORRECTED, int MODES>
__device__ __forceinline__ void horizon(const Buffers& b, const SpectralParams& p, Reduction& r,
                                        float* smem_state) {
  const int rank = cluster_rank();
  const int cand = blockIdx.x / p.cluster;
  const int slice = (p.n + p.cluster - 1) / p.cluster;
  const int lo = min(rank * slice, p.n);
  const int cnt = min(slice, p.n - lo);
  const float* __restrict__ x0 = b.x0 + (size_t)lo * p.x_st;
  const float* __restrict__ v0 = b.v0 + (size_t)lo * p.x_st;
  float* state = smem_state;
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
template <bool ROT, bool CORRECTED>
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
  float* state = smem_state;
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

// ---- the state in a global scratch (GLOBAL): one pass over it per step ----
// Step t's kick (Clenshaw at the field coefficients of step t-1, or of the
// prologue) and step t+1's drift and mode sums touch each particle in turn,
// with nothing between them that depends on another particle, so one pass
// does both: it reads a particle's state once, kicks, drifts, adds its
// harmonics and writes the state once. The state is (c1, s1, vh) for rot and
// (x, vh) for trig, whose phasor the pass recomputes from x by the same
// sincosf that first produced it. Step 0's pass reads x0, v0 instead (the
// prologue's kick), and the last step's pass writes nothing: the energy is
// taken before its kick. The particle-to-thread map (i = threadIdx.x + 256 j
// within the CTA's slice), each thread's order of accumulation and the
// reductions are those of horizon / horizon_blocks, and each particle's
// arithmetic is theirs, so every sum and every energy comes out the same.

// Step 0's pass reads x0, v0 (L2-resident, shared by every candidate), and
// the trig drift's passes its state, in batches of kBatch particles per
// thread, all loaded before any is computed.
constexpr int kBatch = 4;
// The rot drift's other passes keep kRing particles per thread in flight:
// each thread copies its own particles' state from the scratch into its
// slots of a shared-memory ring (cp.async, 4 B each, one group per particle)
// kRing particles ahead of the one it computes, so that no register holds a
// load in flight beside the 64 partial sums. (The trig drift's 8 B state
// took 1.46 ms through it against 1.28-1.29 ms by batched loads at
// N=320000, K=32, Km=16 on an H100.)
constexpr int kRing = 8;

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// Waits until the thread's oldest group but kRing - 1 has landed.
__device__ __forceinline__ void cp_async_wait_ring() {
  asm volatile("cp.async.wait_group %0;" ::"n"(kRing - 1) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;" ::: "memory");
}

// The ring: slot, array (c1, s1, vh), thread.
using Ring = float[kRing][3][kThreads];

// Adds cos(m k1 x), sin(m k1 x), m = first + 1 .. first + 32, of one particle
// to two blocks' partial sums: va (modes first + 1 .. first + 16) and vb (the
// next 16). One recurrence throughout, whose values are those of
// add_block_harmonics at first and at first + 16.
__device__ __forceinline__ void add_pair_harmonics(float c1, float s1, int first,
                                                   float (&va)[kSums], float (&vb)[kSums]) {
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
  va[0] += cp;
  va[kBlockModes] += sp;
#pragma unroll
  for (int m = 1; m < 2 * kBlockModes; ++m) {
    const float cn = twoc * cp - cp2;
    const float sn = twoc * sp - sp2;
    cp2 = cp;
    cp = cn;
    sp2 = sp;
    sp = sn;
    if (m < kBlockModes) {
      va[m] += cp;
      va[kBlockModes + m] += sp;
    } else {
      vb[m - kBlockModes] += cp;
      vb[m] += sp;
    }
  }
}

// The rot drift of a phasor (c, s) by the small angle c_ang dt vh: the
// arithmetic of drift<true>, on registers.
__device__ __forceinline__ void rotate(float vh, const SpectralParams& p, float& c, float& s) {
  const float d = p.c_ang_dt * vh;
  const float d2 = d * d;
  const float cd = 1.0f + d2 * (-0.5f + d2 * (float)(1.0 / 24.0));
  const float sd = d * (1.0f + d2 * ((float)(-1.0 / 6.0) + d2 * (float)(1.0 / 120.0)));
  const float co = c, so = s;
  c = co * cd - so * sd;
  s = so * cd + co * sd;
}

// Floats of a particle's state in the scratch: (c1, s1, vh) or (x, vh).
template <bool ROT>
__host__ __device__ constexpr int stream_floats() {
  return ROT ? 3 : 2;
}

// One virtual rank's slice of x0, v0 and of the state in the scratch.
struct Stream {
  const float* __restrict__ x0;
  const float* __restrict__ v0;
  float* __restrict__ a;  // rot: c1; trig: x
  float* __restrict__ b;  // rot: s1; trig: vh
  float* __restrict__ c;  // rot: vh
  int cnt;                // particles of the slice
};

// One particle of the fused pass (see above): its kick by the field of
// coefficients pc, ps in registers (MODES <= 16) or of nb blocks of them in
// shared memory (MODES 32), its drift, its harmonics of modes 1 .. MODES
// added to va (and modes 17 .. 32 to vb), its state stored unless `store` is
// false. (c, s) is its phasor, vh its velocity; xq its position (trig).
template <bool ROT, int MODES>
__device__ __forceinline__ void stream_particle(int i, float c, float s, float vh, float xq,
                                                const Stream& st, const SpectralParams& p,
                                                bool store,
                                                const float (&pc)[MODES <= 16 ? MODES : 1],
                                                const float (&ps)[MODES <= 16 ? MODES : 1],
                                                const BlockCoefs* coefs, int nb,
                                                float (&va)[MODES <= 16 ? 2 * MODES : kSums],
                                                float (&vb)[kSums]) {
  float f;
  if constexpr (MODES <= kBlockModes)
    f = clenshaw<MODES>(c, s, pc, ps);
  else
    f = clenshaw_blocks(c, s, *coefs, nb);
  vh = vh + p.half_dt * (-f);
  if (ROT) {
    rotate(vh, p, c, s);
  } else {
    xq = xq + p.dt * vh;
    xq = xq - p.length * floorf(xq * p.inv_l);
    sincosf(p.c_ang * xq, &s, &c);
  }
  if constexpr (MODES <= kBlockModes)
    add_harmonics<MODES>(c, s, va);
  else
    add_pair_harmonics(c, s, 0, va, vb);
  if (store) {
    if (ROT) {
      st.a[i] = c;
      st.b[i] = s;
      st.c[i] = vh;
    } else {
      st.a[i] = xq;
      st.b[i] = vh;
    }
  }
}

// A pass by batched loads: the phasors and velocities from x0, v0 (FIRST,
// step 0), else from the trig drift's state (x, vh).
template <bool ROT, bool FIRST, int MODES>
__device__ __forceinline__ void stream_direct(const Stream& st, const SpectralParams& p,
                                              bool store,
                                              const float (&pc)[MODES <= 16 ? MODES : 1],
                                              const float (&ps)[MODES <= 16 ? MODES : 1],
                                              const BlockCoefs* coefs, int nb,
                                              float (&va)[MODES <= 16 ? 2 * MODES : kSums],
                                              float (&vb)[kSums]) {
  static_assert(FIRST || !ROT, "the rot drift's state streams through the ring");
  for (int i0 = threadIdx.x; i0 < st.cnt; i0 += kBatch * kThreads) {
    float lx[kBatch], lv[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int i = i0 + u * kThreads;
      if (i < st.cnt) {
        lx[u] = FIRST ? st.x0[(size_t)i * p.x_st] : st.a[i];
        lv[u] = FIRST ? st.v0[(size_t)i * p.x_st] : st.b[i];
      }
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int i = i0 + u * kThreads;
      if (i >= st.cnt) break;
      float c, s;
      sincosf(p.c_ang * lx[u], &s, &c);
      stream_particle<ROT, MODES>(i, c, s, lv[u], lx[u], st, p, store, pc, ps, coefs, nb, va,
                                  vb);
    }
  }
}

// Starts the copy of particle i's state (c1, s1, vh), if it is the CTA's,
// into ring slot `slot`, as one group, empty or not, so that the groups
// count particles.
__device__ __forceinline__ void ring_fetch(Ring& ring, const Stream& st, int i, int slot) {
  if (i < st.cnt) {
    cp_async4(&ring[slot][0][threadIdx.x], st.a + i);
    cp_async4(&ring[slot][1][threadIdx.x], st.b + i);
    cp_async4(&ring[slot][2][threadIdx.x], st.c + i);
  }
  cp_async_commit();
}

// The rot drift's passes of steps 1 .. H-1: the state from the scratch
// through the ring. A thread reads only the slots it filled, so no barrier
// guards them; slot j mod kRing is refilled only after particle j has been
// computed from it.
template <int MODES>
__device__ __forceinline__ void stream_ring(Ring& ring, const Stream& st, const SpectralParams& p,
                                            bool store,
                                            const float (&pc)[MODES <= 16 ? MODES : 1],
                                            const float (&ps)[MODES <= 16 ? MODES : 1],
                                            const BlockCoefs* coefs, int nb,
                                            float (&va)[MODES <= 16 ? 2 * MODES : kSums],
                                            float (&vb)[kSums]) {
#pragma unroll
  for (int j = 0; j < kRing; ++j) ring_fetch(ring, st, threadIdx.x + j * kThreads, j);
  int slot = 0;
  for (int i = threadIdx.x; i < st.cnt; i += kThreads) {
    cp_async_wait_ring();
    stream_particle<true, MODES>(i, ring[slot][0][threadIdx.x], ring[slot][1][threadIdx.x],
                                 ring[slot][2][threadIdx.x], 0.0f, st, p, store, pc, ps, coefs,
                                 nb, va, vb);
    ring_fetch(ring, st, i + kRing * kThreads, slot);
    slot = slot + 1 == kRing ? 0 : slot + 1;
  }
  cp_async_wait_all();
}

// Blocks first / 16 and first / 16 + 1 (first >= 32) of the thread's
// particles' harmonics into va, vb (zeroed first), the phasors recomputed
// from x0 (PROLOGUE) or taken from the state this step's pass wrote: Km > 32,
// one more pass per further pair of blocks.
template <bool ROT, bool PROLOGUE>
__device__ __forceinline__ void stream_pair_sums(const Stream& st, const SpectralParams& p,
                                                 int first, float (&va)[kSums],
                                                 float (&vb)[kSums]) {
#pragma unroll
  for (int j = 0; j < kSums; ++j) va[j] = vb[j] = 0.0f;
  for (int i = threadIdx.x; i < st.cnt; i += kThreads) {
    float c, s;
    if (PROLOGUE || !ROT) {
      sincosf(p.c_ang * (PROLOGUE ? st.x0[(size_t)i * p.x_st] : st.a[i]), &s, &c);
    } else {
      c = st.a[i];
      s = st.b[i];
    }
    add_pair_harmonics(c, s, first, va, vb);
  }
}

// A block's drive term (and for the corrected energy its target) at step t
// or in the prologue, loaded before the pass whose sums it joins.
struct BlockIn {
  float du, target;
};

template <bool CORRECTED>
__device__ __forceinline__ BlockIn block_in(int blk, int t, bool prologue, const Buffers& b,
                                            const SpectralParams& p, int cand) {
  const Own o = own_coef(blk);
  BlockIn in{drive(o, t, !prologue, b, p, cand), 0.0f};
  if (CORRECTED && !prologue && threadIdx.x < kSums && o.m < p.km)  // c_m - tc, s_m - ts
    in.target = (o.sine_coef ? b.tc : b.ts)[t * p.km + o.m];
  return in;
}

// ---- persistent clusters over virtual ranks (GLOBAL) ----------------------
// p.cluster is the number V of virtual ranks: V slices of S = ceil(N / V)
// particles, whose partial sums are added in rank order q = 0..V-1 exactly
// as the V CTAs of a cluster of V add theirs. The launch's own (physical)
// cluster has C CTAs, C dividing V (a launch attribute, read here from
// %cluster_nctarank); CTA r owns virtual ranks r V/C .. (r + 1) V/C - 1 and
// works through them one at a time, each with the shared path's
// particle-to-thread map and order of accumulation, into one slot per
// virtual rank. The grid holds as many clusters as fit the card (at most
// K), and each walks the candidates cluster id, + clusters, ... over its own
// rows of the scratch. The first candidate of a cluster keeps the
// prologue's totals at the shared x0; every later one forms its prologue
// coefficients from them and its own drive, with reduce_modes's arithmetic.

__device__ __forceinline__ int cluster_ctas() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_nctarank;" : "=r"(r));
  return static_cast<int>(r);
}

__device__ __forceinline__ int cluster_index() {
  unsigned r;
  asm volatile("mov.u32 %0, %%clusterid.x;" : "=r"(r));
  return static_cast<int>(r);
}

__device__ __forceinline__ int cluster_count() {
  unsigned r;
  asm volatile("mov.u32 %0, %%nclusterid.x;" : "=r"(r));
  return static_cast<int>(r);
}

// The global path's reduction scratch, beside Reduction's coefficients.
struct StreamSums {
  float red[2][2][kWarps][kSums];        // a slice's per-warp sums: [slice parity][block of the pair]
  float part[2][2][kMaxCluster][kSums];  // its virtual ranks' sums: [phase parity][block][local rank]
  float x0_total[kMaxBlocks][kSums];     // thread j's totals at x0, one per block of modes
};

// Virtual rank q's slice of x0, v0 and of the state, held as local rank j of
// the CTA's scratch row.
template <bool ROT>
__device__ __forceinline__ Stream slice_stream(const Buffers& b, const SpectralParams& p, float* row,
                                               int q, int j, int slice) {
  const int lo = min(q * slice, p.n);
  float* state = row + (size_t)j * stream_floats<ROT>() * slice;
  return Stream{b.x0 + (size_t)lo * p.x_st, b.v0 + (size_t)lo * p.x_st, state,
                state + slice,   state + 2 * slice,        min(slice, p.n - lo)};
}

// The end of local rank j's share of a pass: its sums of block blk (va) and,
// with PAIR, of block blk + 1 (vb) into the phase's slots. One block
// barrier; the slice parity of red keeps the next slice's warps off the sums
// still being added.
template <int MODES, bool PAIR>
__device__ __forceinline__ void slice_end(float (&va)[2 * MODES], float (&vb)[kSums], int blk,
                                          int j, int phase, StreamSums& ss,
                                          const SpectralParams& p) {
  warp_partials<MODES>(va, ss.red[j & 1][0]);
  if (PAIR) warp_partials<kBlockModes>(vb, ss.red[j & 1][1]);
  __syncthreads();
  rank_partial(ss.red[j & 1][0], ss.part[phase & 1][0][j], own_coef(blk), p);
  if (PAIR) rank_partial(ss.red[j & 1][1], ss.part[phase & 1][1][j], own_coef(blk + 1), p);
}

// A phase's reduction after its slices: one cluster barrier; thread j < 32
// forms block blk's (and with PAIR, if the block exists, block blk + 1's)
// totals, field coefficients (into r.coef, or with PAIR coefs[blk],
// coefs[blk + 1]) and energy terms, added to e in block order. The drive and
// target are loaded here, before the barrier, so that no register holds
// them through the pass; the PROLOGUE's totals are kept for the cluster's
// later candidates. One block barrier.
template <bool CORRECTED, bool PAIR, bool PROLOGUE>
__device__ __forceinline__ void phase_reduce(int blk, int t, int cand, int phase, int per,
                                             const Buffers& b, const SpectralParams& p,
                                             Reduction& r, BlockCoefs* coefs, StreamSums& ss,
                                             float& e) {
  const float scale = PROLOGUE ? 1.0f : 2.0f;
  const bool two = PAIR && blk + 1 < (p.km + kBlockModes - 1) / kBlockModes;
  BlockIn ia{0.0f, 0.0f}, ib{0.0f, 0.0f};
  if (threadIdx.x < kSums) {
    ia = block_in<CORRECTED>(blk, t, PROLOGUE, b, p, cand);
    if (two) ib = block_in<CORRECTED>(blk + 1, t, PROLOGUE, b, p, cand);
  }
  cluster_sync();
  if (threadIdx.x < kSums) {
    const Own oa = own_coef(blk);
    const float ta = total_and_coef(ss.part[phase & 1][0][0], per, scale, ia.du, oa, p,
                                    (PAIR ? (*coefs)[blk] : r.coef) + threadIdx.x);
    e += energy_term(ta, ia.target, oa, p);
    if (PROLOGUE) ss.x0_total[blk][threadIdx.x] = ta;
    if (two) {
      const Own ob = own_coef(blk + 1);
      const float tb = total_and_coef(ss.part[phase & 1][1][0], per, scale, ib.du, ob, p,
                                      (*coefs)[blk + 1] + threadIdx.x);
      e += energy_term(tb, ib.target, ob, p);
      if (PROLOGUE) ss.x0_total[blk + 1][threadIdx.x] = tb;
    }
  }
  __syncthreads();
}

// The whole horizon of every candidate of the cluster with the state in the
// global scratch. MODES: 8 or 16 (Km <= 16: one reduction per step, the
// coefficients in registers) or 32 (Km > 16: blocks 0 and 1 summed in the
// fused pass, 64 partial sums per thread; blocks 2 and 3 of Km > 32 by one
// more pass per step over the state the fused pass wrote; Clenshaw over all
// blocks from shared memory, coefs). A phase (the prologue's or a step's
// reduction of one pair of blocks) runs the CTA's virtual ranks in turn, then
// one cluster barrier: the slots alternate from phase to phase, so slot
// phase mod 2 is next written after every CTA has passed the next phase's
// barrier, i.e. after it read this phase's slots. The loops are kept rolled:
// the fused pass holds 64 partial sums and a block's 32 coefficients, and
// what the loops around it keep live spills there.
template <bool ROT, bool CORRECTED, int MODES>
__device__ __forceinline__ void horizon_stream(const Buffers& b, const SpectralParams& p,
                                               Reduction& r, BlockCoefs* coefs, Ring& ring,
                                               StreamSums& ss) {
  constexpr bool kPairs = MODES > kBlockModes;
  constexpr int kRM = kPairs ? kBlockModes : MODES;  // modes of one reduction
  constexpr int kRegModes = kPairs ? 1 : MODES;
  const int rank = cluster_rank();
  const int per = p.cluster / cluster_ctas();
  const int slice = (p.n + p.cluster - 1) / p.cluster;
  float* row = b.scratch + (size_t)blockIdx.x * per * stream_floats<ROT>() * slice;
  const int nb = kPairs ? (p.km + kBlockModes - 1) / kBlockModes : 1;
  int phase = 0;
  float va[2 * kRM], vb[kSums];
  float pc[kRegModes], ps[kRegModes];

#pragma unroll 1
  for (int cand = cluster_index(); cand < p.k; cand += cluster_count()) {
    // ---- prologue: the mode sums at the shared x0, once per cluster -------
    // (the first candidate is told by the special register, not by a flag:
    // one more live register made the fused pass spill, 8 % slower on an H100)
    if (cand == cluster_index()) {
#pragma unroll 1
      for (int j = 0; j < per; ++j) {
        const Stream st = slice_stream<ROT>(b, p, row, rank * per + j, j, slice);
#pragma unroll
        for (int u = 0; u < 2 * kRM; ++u) va[u] = 0.0f;
#pragma unroll
        for (int u = 0; u < kSums; ++u) vb[u] = 0.0f;
        for (int i = threadIdx.x; i < st.cnt; i += kThreads) {
          float c, s;
          sincosf(p.c_ang * st.x0[(size_t)i * p.x_st], &s, &c);
          if constexpr (kPairs)
            add_pair_harmonics(c, s, 0, va, vb);
          else
            add_harmonics<MODES>(c, s, va);
        }
        slice_end<kRM, kPairs>(va, vb, 0, j, phase, ss, p);
      }
      float e = 0.0f;
      phase_reduce<CORRECTED, kPairs, true>(0, 0, cand, phase++, per, b, p, r, coefs, ss, e);
      if constexpr (kPairs) {
#pragma unroll 1
        for (int blk = 2; blk < nb; blk += 2) {
#pragma unroll 1
          for (int j = 0; j < per; ++j) {
            const Stream st = slice_stream<ROT>(b, p, row, rank * per + j, j, slice);
            stream_pair_sums<ROT, true>(st, p, kBlockModes * blk, va, vb);
            slice_end<kBlockModes, true>(va, vb, blk, j, phase, ss, p);
          }
          phase_reduce<CORRECTED, true, true>(blk, 0, cand, phase++, per, b, p, r, coefs, ss, e);
        }
      }
    } else {
      if (threadIdx.x < kSums) {
#pragma unroll 1
        for (int blk = 0; blk < nb; ++blk) {
          const Own o = own_coef(blk);
          (kPairs ? (*coefs)[blk] : r.coef)[threadIdx.x] =
              o.m < p.km ? field_coef(ss.x0_total[blk][threadIdx.x], 1.0f,
                                      drive(o, 0, false, b, p, cand), o, p)
                         : 0.0f;
        }
      }
      __syncthreads();
    }
    if constexpr (!kPairs) load_coef<MODES>(r, pc, ps);

    // ---- H steps, one pass over the state each ----------------------------
#pragma unroll 1
    for (int t = 0; t < p.h; ++t) {
      const bool store = t + 1 < p.h || nb > 2;
#pragma unroll 1
      for (int j = 0; j < per; ++j) {
        const Stream st = slice_stream<ROT>(b, p, row, rank * per + j, j, slice);
#pragma unroll
        for (int u = 0; u < 2 * kRM; ++u) va[u] = 0.0f;
#pragma unroll
        for (int u = 0; u < kSums; ++u) vb[u] = 0.0f;
        if (t == 0)
          stream_direct<ROT, true, MODES>(st, p, store, pc, ps, coefs, nb, va, vb);
        else if constexpr (ROT)
          stream_ring<MODES>(ring, st, p, store, pc, ps, coefs, nb, va, vb);
        else
          stream_direct<false, false, MODES>(st, p, store, pc, ps, coefs, nb, va, vb);
        slice_end<kRM, kPairs>(va, vb, 0, j, phase, ss, p);
      }
      float e = 0.0f;
      phase_reduce<CORRECTED, kPairs, false>(0, t, cand, phase++, per, b, p, r, coefs, ss, e);
      if constexpr (kPairs) {
#pragma unroll 1
        for (int blk = 2; blk < nb; blk += 2) {
#pragma unroll 1
          for (int j = 0; j < per; ++j) {
            const Stream st = slice_stream<ROT>(b, p, row, rank * per + j, j, slice);
            stream_pair_sums<ROT, false>(st, p, kBlockModes * blk, va, vb);
            slice_end<kBlockModes, true>(va, vb, blk, j, phase, ss, p);
          }
          phase_reduce<CORRECTED, true, false>(blk, t, cand, phase++, per, b, p, r, coefs, ss, e);
        }
      }
      if constexpr (!kPairs) load_coef<MODES>(r, pc, ps);
      if (rank == 0 && threadIdx.x < 32) write_energy(e, p, b.pe + (size_t)cand * p.h + t);
    }
  }
  // no CTA leaves while another may still read its slots
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
  if constexpr (GLOBAL) {
    __shared__ __align__(16) StreamSums ss;
    Ring& ring = *reinterpret_cast<Ring*>(smem_state);
    if (p.km <= 8)
      horizon_stream<ROT, CORRECTED, 8>(b, p, r, nullptr, ring, ss);
    else
      horizon_stream<ROT, CORRECTED, kBlockModes>(b, p, r, nullptr, ring, ss);
  } else {
    if (p.km <= 8)
      horizon<ROT, CORRECTED, 8>(b, p, r, smem_state);
    else
      horizon<ROT, CORRECTED, kBlockModes>(b, p, r, smem_state);
  }
}

// Km > 16 (horizon_blocks): two CTAs per SM, so that a block's 32
// coefficients fit in registers beside the field pass's chains.
template <bool ROT, bool GLOBAL, bool CORRECTED>
__global__ void __launch_bounds__(kThreads, 2)
spectral_horizon_blocks_kernel(const Buffers b, const SpectralParams p) {
  __shared__ __align__(16) Reduction r;
  __shared__ __align__(16) BlockCoefs coefs;
  extern __shared__ float smem_state[];
  if constexpr (GLOBAL) {
    __shared__ __align__(16) StreamSums ss;
    horizon_stream<ROT, CORRECTED, 2 * kBlockModes>(b, p, r, &coefs,
                                                    *reinterpret_cast<Ring*>(smem_state), ss);
  } else {
    horizon_blocks<ROT, CORRECTED>(b, p, r, coefs, smem_state);
  }
}

template <bool ROT, bool GLOBAL, bool CORRECTED, bool BLOCKS>
auto kernel_of() {
  if constexpr (BLOCKS)
    return spectral_horizon_blocks_kernel<ROT, GLOBAL, CORRECTED>;
  else
    return spectral_horizon_kernel<ROT, GLOBAL, CORRECTED>;
}

// Static shared memory of each kernel, beside which the state's dynamic
// share must fit (ops/kernels/spectral_horizon.py mirrors both sizes of the
// shared path), and with the state in the global scratch its StreamSums.
template <bool GLOBAL, bool BLOCKS>
constexpr int static_bytes() {
  return (int)sizeof(Reduction) + (BLOCKS ? (int)sizeof(BlockCoefs) : 0) +
         (GLOBAL ? (int)sizeof(StreamSums) : 0);
}

template <bool ROT, bool GLOBAL, bool CORRECTED, bool BLOCKS>
cudaError_t configure() {
  // per device: the shared-memory limit and clusters beyond the portable 8
  static int done_for = -1;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || done_for == dev) return err;
  auto* kernel = kernel_of<ROT, GLOBAL, CORRECTED, BLOCKS>();
  const int max_dynamic = 232448 - static_bytes<GLOBAL, BLOCKS>();
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, max_dynamic);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err == cudaSuccess) done_for = dev;
  return err;
}

// Dynamic shared memory of a launch: the CTA's slice of the state, or with
// the rot drift's state in the global scratch the ring its passes stream it
// through.
inline size_t state_bytes(const SpectralParams& p, bool rot, bool global) {
  const size_t slice = (size_t)(p.n + p.cluster - 1) / p.cluster;
  if (global) return rot ? sizeof(Ring) : 0;
  return (rot ? 3 : 4) * sizeof(float) * slice;
}

// A launch of `clusters` clusters of `cluster` CTAs: with the state in shared
// memory K clusters of p.cluster CTAs, with it in the global scratch up to K
// persistent clusters of a divisor of p.cluster (the virtual ranks).
template <bool ROT, bool GLOBAL, bool CORRECTED, bool BLOCKS>
int launch(const Buffers& b, const SpectralParams& p, const Shape& s, cudaStream_t stream,
           int* max_clusters) {
  cudaError_t err = configure<ROT, GLOBAL, CORRECTED, BLOCKS>();
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = s.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3(s.clusters * s.cluster);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = state_bytes(p, ROT, GLOBAL);
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  auto* kernel = kernel_of<ROT, GLOBAL, CORRECTED, BLOCKS>();
  if (max_clusters) {
    cfg.gridDim = dim3(s.cluster);
    return static_cast<int>(cudaOccupancyMaxActiveClusters(max_clusters, kernel, &cfg));
  }
  err = cudaLaunchKernelEx(&cfg, kernel, b, p);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <bool ROT, bool GLOBAL, bool CORRECTED>
int launch_modes(const Buffers& b, const SpectralParams& p, const Shape& s, cudaStream_t stream,
                 int* fit) {
  return p.km > kBlockModes ? launch<ROT, GLOBAL, CORRECTED, true>(b, p, s, stream, fit)
                            : launch<ROT, GLOBAL, CORRECTED, false>(b, p, s, stream, fit);
}

template <bool ROT, bool GLOBAL>
int launch_variant(const Buffers& b, const SpectralParams& p, const Shape& s, cudaStream_t stream,
                   int* fit) {
  return b.tc ? launch_modes<ROT, GLOBAL, true>(b, p, s, stream, fit)
              : launch_modes<ROT, GLOBAL, false>(b, p, s, stream, fit);
}

template <bool ROT>
int launch_placement(const Buffers& b, const SpectralParams& p, const Shape& s,
                     cudaStream_t stream, int* fit) {
  return b.scratch ? launch_variant<ROT, true>(b, p, s, stream, fit)
                   : launch_variant<ROT, false>(b, p, s, stream, fit);
}

inline bool valid(const SpectralParams& p) {
  return p.km >= 1 && p.km <= kMaxModes && p.ka >= 0 && p.ka <= p.km && p.k >= 1 && p.h >= 1 &&
         p.n >= 1 && p.x_st >= 1 && p.cluster >= 1 && p.cluster <= kMaxCluster;
}

// A launch shape for these parameters: in shared memory exactly K clusters of
// p.cluster CTAs; in the global scratch a divisor of p.cluster and 1..K
// clusters (at most K for an occupancy query, which takes one cluster).
inline bool valid_shape(const SpectralParams& p, const Shape& s, bool global) {
  if (!global) return s.cluster == p.cluster && (s.clusters == p.k || s.clusters == 0);
  return s.cluster >= 1 && p.cluster % s.cluster == 0 && s.clusters >= 0 && s.clusters <= p.k;
}

}  // namespace
