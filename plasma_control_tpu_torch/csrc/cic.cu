// CIC / shifted-TSC / textbook-TSC charge deposit and field gather (sm_90a).
//
// Replaces the Pallas TPU kernels of plasma_control_tpu/ops/pallas/cic_pallas.py
// (_deposit_impl / _deposit_kernel and _gather_impl / _gather_kernel). The TPU
// kernels evaluate the shape function densely over every (particle, cell) pair
// of a VMEM tile and reduce on the MXU, adding the tiles in a fixed order. Here
// each thread owns a particle and evaluates the shape function only on the
// cells around it that can carry weight (shape.cuh), so the result equals the
// dense sum cell by cell.
//
// What bounds them on the H100: at the control loop's shapes (N = 5000,
// M = 250: ~20 KB in, 1 KB out) nothing that scales with the work. A call
// is one device op of 1.5 us (gather) or 3.5-3.9 us (deposit) against 20-50
// us of host work around it, so each wrapper's host path (ops/kernels/cic.py)
// is one allocation and one launch. At the config-4 environment (N = 100000,
// M = 256) the deposit's time goes to its shared-memory atomics: 6.3 us on a
// cluster of 16 CTAs, 7.7 / 11.4 / 19.1 / 34.0 us on 8 / 4 / 2 / 1, against
// a 0.12 us bound on its 400 KB (NVIDIA H100 80GB HBM3, 700 W; chip_smoke.py,
// PERF.md §6).
//
// The deposit (deposit_kernel, the kind a template argument):
//  * one row (blockIdx.y) is one CTA of 1024 threads, or a thread-block
//    cluster of C CTAs when N is large (C a launch attribute, chosen by
//    ops/kernels/cic.py::deposit_cluster). CTA r of the cluster takes
//    particles [r*S, (r+1)*S), S = ceil(N / C), wraps each position itself
//    (shape.cuh::wrap_pos, the arithmetic of torch.remainder) and adds the
//    weights of its taps to a fixed-point histogram of M cells in its shared
//    memory (shape.cuh: 8 bytes a cell, 96 KB at the limit M = 12288);
//  * deterministic, as the TPU kernel's fixed tile order is: the counts are
//    integers, so the histogram is bitwise the same whatever order the
//    atomics run in, and whatever C. 64-bit shared atomics compile to a
//    compare-and-swap loop on Hopper (ATOMS.CAST.SPIN.64) that retries on
//    every collision, so a count is split over two 32-bit words that the
//    native ATOMS.ADD updates;
//  * after one cluster barrier, CTA r reads cells r*1024.., (r+C)*1024.. of
//    every CTA's histogram through distributed shared memory, adds the
//    counts, scales once (by 2^-28 and the caller's float32 `scale`,
//    n0 L / N / dx for ops/deposit.py::deposit's normalised density) and
//    writes the cells. Every cell of the row is written once, so the output
//    needs no memset, and a deposit is one device op. A second cluster
//    barrier keeps each CTA's shared memory alive until its peers have read
//    it.
//
// The gather (gather_kernel) takes positions as they are and wraps them with
// the same arithmetic, so the wrap launches nothing and matches the plain
// version bit for bit. It reads the field through a row stride, 0 when one
// (M,) field serves every batch row. What bounds it: the bytes, 8 per
// particle (one position in, one field value out; 8 MB at N = 1M, 2.4 us at
// 3.35 TB/s), and at the control loop's sizes the launch: the parent kernel,
// one particle per thread in ceil(N/256) CTAs, took 1.60 us at N = 5000,
// 1.95 us at N = 100000 and 7.0 us at N = 1M (PERF.md §6). The design:
//  * the kind is a template argument (each weight still shape_weight<KIND>
//    of its offset, all 4 taps: the same arithmetic, every bit unchanged,
//    tests/test_torch_kernels.py::test_gather_bits_unchanged), so a tap
//    costs no branch on the kind;
//  * each thread's first positions are loaded before the CTA stages the
//    row's field in shared memory, so the two latencies overlap;
//  * while ceil(N/256) CTAs per row fit the card at once, one position per
//    thread (gather_kernel<KIND, false>): 1.46 us at N = 5000, 1.86-1.94 us
//    at N = 100000. A float4 per thread there spread N = 5000 over 5 CTAs
//    and took 2.4 us;
//  * beyond, a grid of at most the card's resident CTAs (SMs times CTAs per
//    SM, gather_capacity) walks the row in float4 rounds
//    (gather_kernel<KIND, true>), every thread the same number, each next
//    round's load in flight while the current one is computed: 5.5 us at
//    N = 1M, 43 % of the bound, against 7.05 us for 3907 CTAs of one
//    position; two rounds in flight took 5.8 us (NVIDIA H100 80GB HBM3,
//    700 W; PERF.md §6). What holds it there is not measured. A scalar
//    head and tail around the row's 16-byte-aligned body, and the whole
//    row scalar where x and out differ in alignment.

#include <cuda_runtime.h>

#include "shape.cuh"

namespace {

constexpr int kThreads = 256;         // gather
constexpr int kDepositThreads = 1024;  // deposit
constexpr int kMaxCluster = 16;       // Hopper's largest (non-portable) cluster

__device__ __forceinline__ int cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return static_cast<int>(r);
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n\tbarrier.cluster.wait.acquire.aligned;"
               ::: "memory");
}

// The word of CTA `rank`'s shared memory at the offset of `local` in ours.
__device__ __forceinline__ unsigned load_rank(const unsigned* local, int rank) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(local));
  unsigned remote, v;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(remote) : "r"(addr), "r"(rank));
  asm volatile("ld.shared::cluster.u32 %0, [%1];" : "=r"(v) : "r"(remote) : "memory");
  return v;
}

template <int KIND>
__global__ void __launch_bounds__(kDepositThreads)
deposit_kernel(const float* __restrict__ x, float* __restrict__ out, int n, int m, float length,
               float inv_dx, float scale) {
  extern __shared__ unsigned hist[];  // fixed-point counts: low words [0, m), high [m, 2m)
  const int row = blockIdx.y, rank = cluster_rank(), c = gridDim.x;
  for (int j = threadIdx.x; j < 2 * m; j += kDepositThreads) hist[j] = 0u;
  __syncthreads();

  const int slice = (n + c - 1) / c;
  const int end = min(n, (rank + 1) * slice);
  const float* xr = x + (size_t)row * n;
#pragma unroll 4
  for (int q = rank * slice + threadIdx.x; q < end; q += kDepositThreads) {
    const float pos = pct::wrap_pos(xr[q], length) * inv_dx;
    pct::deposit<KIND>(pct::taps<KIND, true>(pos, m), hist, m);
  }
  cluster_sync();

  const double step = (double)scale * (double)pct::kFixedStep;
  float* o = out + (size_t)row * m;
  for (int j = rank * kDepositThreads + threadIdx.x; j < m; j += c * kDepositThreads) {
    long long s = 0;
    if (c == 1)
      s = pct::fixed_count(hist[j], hist[m + j]);
    else
      for (int r = 0; r < c; ++r)
        s += pct::fixed_count(load_rank(&hist[j], r), load_rank(&hist[m + j], r));
    o[j] = static_cast<float>(static_cast<double>(s) * step);
  }
  if (c > 1) cluster_sync();
}

template <int KIND>
cudaError_t configure_deposit() {
  // per device: shared memory beyond 48 KB and clusters beyond the portable 8
  static int done_for = -1;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || done_for == dev) return err;
  auto* kernel = deposit_kernel<KIND>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             2 * 12288 * (int)sizeof(unsigned));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err == cudaSuccess) done_for = dev;
  return err;
}

template <int KIND>
cudaError_t launch_deposit(const float* x, float* out, int b, int n, int m, float length,
                           float inv_dx, float scale, int cluster, cudaStream_t stream) {
  cudaError_t err = configure_deposit<KIND>();
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3(cluster, b);
  cfg.blockDim = dim3(kDepositThreads);
  cfg.dynamicSmemBytes = 2 * (size_t)m * sizeof(unsigned);
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, deposit_kernel<KIND>, x, out, n, m, length, inv_dx, scale);
}

// The field at one position x (any real value, wrapped as torch.remainder
// wraps it) from the row's staged field: 4 taps b-1 .. b+2 in increasing j,
// each weight shape_weight<KIND> of its offset, as the 4-tap dense sum.
template <int KIND>
__device__ __forceinline__ float gather_one(float xq, const float* e_row, int m, float length,
                                            float inv_dx) {
  const float pos = pct::wrap_pos(xq, length) * inv_dx;
  const int base = (int)floorf(pos);
  float acc = 0.0f;
#pragma unroll
  for (int o = -1; o <= 2; ++o) {
    const int j = base + o;
    acc += pct::shape_weight<KIND>(pos - (float)j) * e_row[pct::wrap_cell(j, m)];
  }
  return acc;
}

// VECTOR false: one position per thread and round (a grid of ceil(N / 256)
// CTAs per row is one round). VECTOR: float4 rounds over the row's
// 16-byte-aligned body, and a scalar head and tail around it (the whole row
// scalar where x and out differ in alignment). Either way the first
// positions are loaded before the field is staged, and each next round's
// before the current one is computed.
template <int KIND, bool VECTOR>
__global__ void __launch_bounds__(kThreads)
gather_kernel(const float* __restrict__ e, const float* __restrict__ x,
              float* __restrict__ out, int n, int m, int e_stride, float length,
              float inv_dx) {
  extern __shared__ float e_row[];
  const int row = blockIdx.y;
  const float* __restrict__ xr = x + (size_t)row * n;
  float* __restrict__ outr = out + (size_t)row * n;
  const float* __restrict__ src = e + (size_t)row * e_stride;
  const int tid = blockIdx.x * kThreads + threadIdx.x;
  const int stride = gridDim.x * kThreads;
  if (!VECTOR) {
    float xs = tid < n ? xr[tid] : 0.0f;
    for (int j = threadIdx.x; j < m; j += kThreads) e_row[j] = src[j];
    __syncthreads();
    for (int i = tid; i < n; i += stride) {
      const float next = i + stride < n ? xr[i + stride] : xs;
      outr[i] = gather_one<KIND>(xs, e_row, m, length, inv_dx);
      xs = next;
    }
    return;
  }
  const unsigned mis = static_cast<unsigned>(reinterpret_cast<size_t>(xr) & 15);
  const bool vec = mis == static_cast<unsigned>(reinterpret_cast<size_t>(outr) & 15);
  const int head = vec ? min(n, static_cast<int>(((16 - mis) & 15) / 4)) : n;
  const int n4 = (n - head) / 4;
  const float4* __restrict__ x4 = reinterpret_cast<const float4*>(xr + head);
  float4* __restrict__ o4 = reinterpret_cast<float4*>(outr + head);
  float4 q = tid < n4 ? x4[tid] : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  for (int j = threadIdx.x; j < m; j += kThreads) e_row[j] = src[j];
  __syncthreads();
  for (int i = tid; i < n4; i += stride) {
    const float4 next = i + stride < n4 ? x4[i + stride] : q;
    float4 r;
    r.x = gather_one<KIND>(q.x, e_row, m, length, inv_dx);
    r.y = gather_one<KIND>(q.y, e_row, m, length, inv_dx);
    r.z = gather_one<KIND>(q.z, e_row, m, length, inv_dx);
    r.w = gather_one<KIND>(q.w, e_row, m, length, inv_dx);
    o4[i] = r;
    q = next;
  }
  for (int i = tid; i < head; i += stride)
    outr[i] = gather_one<KIND>(xr[i], e_row, m, length, inv_dx);
  for (int i = head + 4 * n4 + tid; i < n; i += stride)
    outr[i] = gather_one<KIND>(xr[i], e_row, m, length, inv_dx);
}

// CTAs of gather_kernel<KIND, VECTOR> resident on the card at once with m
// cells of shared memory each: SMs times CTAs per SM; per device and m,
// cached.
template <int KIND, bool VECTOR>
cudaError_t gather_capacity(int m, int* ctas) {
  static int dev_c = -1, m_c = -1, cap = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev != dev_c || m != m_c) {
    int sms = 0, per = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per, gather_kernel<KIND, VECTOR>,
                                                          kThreads, m * sizeof(float));
    if (err != cudaSuccess) return err;
    cap = sms * per > 1 ? sms * per : 1;
    dev_c = dev;
    m_c = m;
  }
  *ctas = cap;
  return cudaSuccess;
}

// The launch: one position per thread in ceil(N / 256) CTAs per row while
// that grid fits the card at once (the control loop's env steps), where the
// most threads finish soonest; beyond, float4 rounds over a grid of at most
// the resident CTAs, every thread taking the same number of rounds.
template <int KIND>
cudaError_t launch_gather(const float* e, const float* x, float* out, int b, int n, int m,
                          int e_stride, float length, float inv_dx, cudaStream_t stream) {
  int cap = 0;
  cudaError_t err = gather_capacity<KIND, false>(m, &cap);
  if (err != cudaSuccess) return err;
  const long long scalar = (n + kThreads - 1) / kThreads;
  if (scalar * b <= cap) {
    gather_kernel<KIND, false><<<dim3(static_cast<unsigned>(scalar), b), kThreads,
                                 m * sizeof(float), stream>>>(e, x, out, n, m, e_stride, length,
                                                              inv_dx);
    return cudaGetLastError();
  }
  err = gather_capacity<KIND, true>(m, &cap);
  if (err != cudaSuccess) return err;
  const long long units = (n + 3) / 4;
  const long long per_row = cap / b > 1 ? cap / b : 1;
  const long long rounds = (units + kThreads * per_row - 1) / (kThreads * per_row);
  const long long ctas = (units + kThreads * rounds - 1) / (kThreads * rounds);
  gather_kernel<KIND, true><<<dim3(static_cast<unsigned>(ctas), b), kThreads, m * sizeof(float),
                              stream>>>(e, x, out, n, m, e_stride, length, inv_dx);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* pct_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// x: (b, n) positions, any real value, wrapped in the kernel; out: (b, m), every
// cell written: scale * (sum of shape weights). b <= 65535, 1 <= m <= 12288,
// cluster in 1 .. 16 CTAs per row.
int pct_cic_deposit(const float* x, float* out, int b, int n, int m, float length, float inv_dx,
                    float scale, int kind, int cluster, cudaStream_t stream) {
  if (b < 1 || b > 65535 || n < 0 || m < 1 || m > 12288 || cluster < 1 || cluster > kMaxCluster)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err;
  switch (kind) {
    case 0: err = launch_deposit<0>(x, out, b, n, m, length, inv_dx, scale, cluster, stream); break;
    case 1: err = launch_deposit<1>(x, out, b, n, m, length, inv_dx, scale, cluster, stream); break;
    case 2: err = launch_deposit<2>(x, out, b, n, m, length, inv_dx, scale, cluster, stream); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// e: the mesh field, row r at e + r * e_stride (0: one (m,) field for every
// row), m <= 12288; x: (b, n) positions, any real value; out: (b, n);
// b <= 65535, n >= 1.
int pct_cic_gather(const float* e, const float* x, float* out, int b, int n, int m,
                   int e_stride, float length, float inv_dx, int kind, cudaStream_t stream) {
  if (b < 1 || b > 65535 || n < 1 || m < 1 || m > 12288)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err;
  switch (kind) {
    case 0: err = launch_gather<0>(e, x, out, b, n, m, e_stride, length, inv_dx, stream); break;
    case 1: err = launch_gather<1>(e, x, out, b, n, m, e_stride, length, inv_dx, stream); break;
    case 2: err = launch_gather<2>(e, x, out, b, n, m, e_stride, length, inv_dx, stream); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(err);
}

}  // extern "C"
