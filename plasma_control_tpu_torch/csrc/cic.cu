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
// (M,) field serves every batch row, and each CTA stages its row's M floats in
// shared memory once.

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

__global__ void __launch_bounds__(kThreads)
gather_kernel(const float* __restrict__ e, const float* __restrict__ x,
              float* __restrict__ out, int n, int m, int e_stride, float length,
              float inv_dx, int kind) {
  extern __shared__ float e_row[];
  const int row = blockIdx.y;
  const float* src = e + (size_t)row * e_stride;
  for (int j = threadIdx.x; j < m; j += kThreads) e_row[j] = src[j];
  __syncthreads();
  const int p = blockIdx.x * kThreads + threadIdx.x;
  if (p >= n) return;
  const float pos = pct::wrap_pos(x[(size_t)row * n + p], length) * inv_dx;
  const int base = (int)floorf(pos);
  float acc = 0.0f;
#pragma unroll
  for (int o = -1; o <= 2; ++o) {
    const int j = base + o;
    acc += pct::shape_weight(pos - (float)j, kind) * e_row[pct::wrap_cell(j, m)];
  }
  out[(size_t)row * n + p] = acc;
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
// row), m <= 12288; x: (b, n) positions, any real value; out: (b, n).
int pct_cic_gather(const float* e, const float* x, float* out, int b, int n, int m,
                   int e_stride, float length, float inv_dx, int kind, cudaStream_t stream) {
  const dim3 grid((n + kThreads - 1) / kThreads, b);
  gather_kernel<<<grid, kThreads, m * sizeof(float), stream>>>(e, x, out, n, m, e_stride,
                                                               length, inv_dx, kind);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
