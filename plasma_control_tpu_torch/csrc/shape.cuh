// Shape functions shared by the deposit/gather kernels (cic.cu) and the fused
// grid-planner kernels (fused_step.cu).
//
// Each particle touches only the four cells b-1 .. b+2 around b = floor(x/dx),
// which cover the support of all three kinds (shifted TSC on [-1, 2), textbook
// TSC on |d| < 1.5), so a 4-tap sum equals the dense sum over every cell.

#pragma once

#include <cuda_runtime.h>

namespace pct {

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

// Cell index of the tap o in -1 .. 2 at cell-unit position pos, and its weight.
struct Taps {
  int cell[4];
  float w[4];
};

__device__ __forceinline__ Taps taps(float pos, int m, int kind) {
  Taps t;
  const int base = (int)floorf(pos);
#pragma unroll
  for (int o = 0; o < 4; ++o) {
    const int j = base + o - 1;
    t.w[o] = shape_weight(pos - (float)j, kind);
    t.cell[o] = wrap_cell(j, m);
  }
  return t;
}

}  // namespace pct
