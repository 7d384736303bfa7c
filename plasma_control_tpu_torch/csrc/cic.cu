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
// deposit's caller wraps positions to [0, L) and normalises the density, as
// the JAX package's ops/deposit.py does around its Pallas call. The gather
// takes positions as they are and wraps them itself, with the arithmetic of
// torch.remainder on float32 (ATen's remainder kernel on the card and the CPU:
// fmodf, exact, then + L where the remainder is nonzero and of the other sign),
// so the wrap launches nothing and matches the plain version bit for bit. It
// reads the field through a row stride, 0 when one (M,) field serves every
// batch row, and each CTA stages its row's M floats in shared memory once.
// With a time of ~1.6 us on the device against tens of us of host work per
// call, the gather's wrapper (ops/kernels/cic.py) keeps its host path to
// checks, one output allocation and the launch.

#include <cuda_runtime.h>

#include "shape.cuh"

namespace {

using pct::shape_weight;
using pct::wrap_cell;

constexpr int kThreads = 256;

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
              float* __restrict__ out, int n, int m, int e_stride, float length,
              float inv_dx, int kind) {
  extern __shared__ float e_row[];
  const int row = blockIdx.y;
  const float* src = e + (size_t)row * e_stride;
  for (int j = threadIdx.x; j < m; j += kThreads) e_row[j] = src[j];
  __syncthreads();
  const int p = blockIdx.x * kThreads + threadIdx.x;
  if (p >= n) return;
  // torch.remainder(x, length) on float32
  float xw = fmodf(x[(size_t)row * n + p], length);
  if (xw != 0.0f && ((length < 0.0f) != (xw < 0.0f))) xw += length;
  const float pos = xw * inv_dx;
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
