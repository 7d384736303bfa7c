// CIC / shifted-TSC / textbook-TSC charge deposit and field gather (sm_90a).
//
// Replaces the Pallas TPU kernels of plasma_control_tpu/ops/pallas/cic_pallas.py
// (_deposit_impl / _deposit_kernel and _gather_impl / _gather_kernel). The TPU
// kernels evaluate the shape function densely over every (particle, cell) pair
// of a VMEM tile and reduce on the MXU. Here each thread owns one particle and
// evaluates the same shape function only on the four cells b-1 .. b+2 around
// b = floor(x/dx), which cover the support of all three kinds (shifted TSC on
// [-1, 2), textbook TSC on |d| < 1.5), so the result equals the dense sum cell
// by cell.
//
// Bound on the H100: at the control loop's shapes (N = 5000, M = 250) both
// kernels move ~20 KB and run a few thousand threads, so they are bound by
// launch latency, not by bytes or flops. The design keeps them to one launch
// each: the deposit accumulates a block-private histogram of M floats in
// shared memory (1 KB at M = 250) and adds it to the output with one global
// atomic per nonzero cell, so global atomics scale with blocks x cells and not
// with particles. Atomic sums are not bitwise deterministic.
//
// Batches: (B, N) positions, one grid row (blockIdx.y) per batch row. The
// caller wraps positions to [0, L) and normalises the density, as the JAX
// package's ops/deposit.py does around its Pallas call.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

// Shape-function weight of a cell-unit offset d; the formulas of
// shape_weights_from_offset in ops/deposit.py (kind 0 cic, 1 tsc, 2 tsc_standard).
__device__ __forceinline__ float shape_weight(float d, int kind) {
  if (kind == 0) return fmaxf(0.0f, 1.0f - fabsf(d));
  if (kind == 1) {
    if (d >= 1.0f && d < 2.0f) {
      const float a = 2.5f - d;
      return 0.5f * (a * a);
    }
    if (d >= 0.0f && d < 1.0f) {
      const float a = d - 1.0f;
      return 0.75f - a * a;
    }
    if (d >= -1.0f && d < 0.0f) {
      const float a = d + 0.5f;
      return 0.5f * (a * a);
    }
    return 0.0f;
  }
  const float a = fabsf(d);
  if (a <= 0.5f) return 0.75f - a * a;
  if (a <= 1.5f) {
    const float b = 1.5f - a;
    return 0.5f * (b * b);
  }
  return 0.0f;
}

__device__ __forceinline__ int wrap_cell(int j, int m) {
  const int r = j % m;
  return r < 0 ? r + m : r;
}

__global__ void __launch_bounds__(kThreads)
deposit_kernel(const float* __restrict__ x, float* __restrict__ out, int n, int m,
               float inv_dx, int kind) {
  extern __shared__ float hist[];
  const int row = blockIdx.y;
  for (int j = threadIdx.x; j < m; j += blockDim.x) hist[j] = 0.0f;
  __syncthreads();

  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p < n) {
    const float pos = x[(size_t)row * n + p] * inv_dx;
    const int base = (int)floorf(pos);
#pragma unroll
    for (int o = -1; o <= 2; ++o) {
      const int j = base + o;
      const float w = shape_weight(pos - (float)j, kind);
      if (w != 0.0f) atomicAdd(&hist[wrap_cell(j, m)], w);
    }
  }
  __syncthreads();

  for (int j = threadIdx.x; j < m; j += blockDim.x) {
    const float h = hist[j];
    if (h != 0.0f) atomicAdd(&out[(size_t)row * m + j], h);
  }
}

__global__ void __launch_bounds__(kThreads)
gather_kernel(const float* __restrict__ e, const float* __restrict__ x,
              float* __restrict__ out, int n, int m, float inv_dx, int kind) {
  const int row = blockIdx.y;
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n) return;
  const float* e_row = e + (size_t)row * m;
  const float pos = x[(size_t)row * n + p] * inv_dx;
  const int base = (int)floorf(pos);
  float acc = 0.0f;
#pragma unroll
  for (int o = -1; o <= 2; ++o) {
    const int j = base + o;
    acc += shape_weight(pos - (float)j, kind) * e_row[wrap_cell(j, m)];
  }
  out[(size_t)row * n + p] = acc;
}

}  // namespace

extern "C" {

const char* pct_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// x: (b, n) positions in [0, L); out: (b, m) zero-filled by the caller.
int pct_cic_deposit(const float* x, float* out, int b, int n, int m, float inv_dx,
                    int kind, cudaStream_t stream) {
  const dim3 grid((n + kThreads - 1) / kThreads, b);
  deposit_kernel<<<grid, kThreads, m * sizeof(float), stream>>>(x, out, n, m, inv_dx, kind);
  return static_cast<int>(cudaGetLastError());
}

// e: (b, m) mesh field; x: (b, n) positions in [0, L); out: (b, n).
int pct_cic_gather(const float* e, const float* x, float* out, int b, int n, int m,
                   float inv_dx, int kind, cudaStream_t stream) {
  const dim3 grid((n + kThreads - 1) / kThreads, b);
  gather_kernel<<<grid, kThreads, 0, stream>>>(e, x, out, n, m, inv_dx, kind);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
