// Shape functions, wraps and fixed-point histograms shared by the deposit and
// gather kernels (cic.cu) and the fused grid-planner kernels (fused_step.cu).
//
// A particle at cell-unit position pos, b = floor(pos), has nonzero weight
// only on cells among b-1 .. b+2, which cover the support of all three kinds
// (shifted TSC on [-1, 2), textbook TSC on |d| <= 1.5), so a 4-tap sum equals
// the dense sum over every cell. Each weight is shape_weight(pos - (float)j)
// evaluated as written, so a kernel that skips a tap whose weight is exactly 0
// keeps every other weight bit for bit (Taps below).

#pragma once

#include <cuda_runtime.h>

namespace pct {

// Shape-function weight of a cell-unit offset d; the formulas of
// shape_weights_from_offset in ops/deposit.py (KIND 0 cic, 1 tsc, 2 tsc_standard).
template <int KIND>
__device__ __forceinline__ float shape_weight(float d) {
  if (KIND == 0) return fmaxf(0.0f, 1.0f - fabsf(d));
  if (KIND == 1) {
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

// j mod m in [0, m) for m > 0: a compare and an add for the taps of a wrapped
// position (b in [0, m], taps in [-1, m + 2]); the division only for cells
// further out, which a caller's unwrapped position can give.
__device__ __forceinline__ int wrap_cell(int j, int m) {
  if (j < 0)
    j += m;
  else if (j >= m)
    j -= m;
  if (static_cast<unsigned>(j) >= static_cast<unsigned>(m)) {
    j %= m;
    if (j < 0) j += m;
  }
  return j;
}

// j mod m for the taps of a wrapped position (j in [-1, 2m)): a compare and
// an add each way. A non-finite position, whose cell is garbage, still lands
// in [0, m).
__device__ __forceinline__ int wrap_near_cell(int j, int m) {
  j += j < 0 ? m : 0;
  j -= j >= m ? m : 0;
  return static_cast<int>(min(static_cast<unsigned>(j), static_cast<unsigned>(m - 1)));
}

// The cell after a wrapped cell c, wrapped.
__device__ __forceinline__ int next_cell(int c, int m) { return c + 1 == m ? 0 : c + 1; }

// torch.remainder(x, length) on float32 for length > 0 (ATen's kernel on the
// card and the CPU: fmodf, exact, then + length where the remainder is
// nonzero and negative), bit for bit, without fmodf where that is exact: on
// [0, L) it is x; on [L, 2L) fmodf gives x - L, which Sterbenz's lemma makes
// exact; on (-L, 0) fmodf gives x, so the result is x + L rounded once.
__device__ __forceinline__ float wrap_pos(float x, float length) {
  if (x >= 0.0f && x < length) return x;
  if (x >= length && x < 2.0f * length) return x - length;
  if (x < 0.0f && x > -length) return x + length;
  float r = fmodf(x, length);
  if (r != 0.0f && r < 0.0f) r += length;
  return r;
}

// The taps of one position that can carry weight, for a compile-time kind:
// cells first, first+1, ... (wrapped) and their weights, in increasing j.
//  * cic: b and b+1. Tap b-1 has d >= 1 and tap b+2 has d <= -1 after
//    rounding, so both weigh exactly 0.
//  * tsc (shifted): b-1, b, b+1, and b+2 only for b in {-1, 0}, where
//    pos - (b + 2) can round up to -1 (pos = 1 - 2^-24 gives d = -1, weight
//    0.125 on the dense path too); elsewhere that difference is exact and
//    below -1.
//  * tsc_standard: c-1, c, c+1 around c = b + (pos - b >= 0.5); the tap left
//    out has |d| >= 1.5 after rounding, weight exactly 0.
template <int KIND>
struct Taps {
  static constexpr int kCount = KIND == 0 ? 2 : 3;
  int cell[kCount];
  float w[kCount];
  int edge_cell;   // KIND 1: the fourth tap b+2, weight edge_w (0 unless b is -1 or 0)
  float edge_w;
};

// WRAPPED: pos = x / dx for x in [0, L] (b in [0, m]), as wrap_pos returns it.
template <int KIND, bool WRAPPED = false>
__device__ __forceinline__ Taps<KIND> taps(float pos, int m) {
  Taps<KIND> t;
  const float fb = floorf(pos);
  const int b = static_cast<int>(fb);
  int first = KIND == 0 ? b : b - 1;
  if (KIND == 2 && pos - fb >= 0.5f) first = b;
#pragma unroll
  for (int o = 0; o < Taps<KIND>::kCount; ++o)
    t.w[o] = shape_weight<KIND>(pos - static_cast<float>(first + o));
  t.cell[0] = WRAPPED ? wrap_near_cell(first, m) : wrap_cell(first, m);
#pragma unroll
  for (int o = 1; o < Taps<KIND>::kCount; ++o) t.cell[o] = next_cell(t.cell[o - 1], m);
  t.edge_w = 0.0f;
  t.edge_cell = 0;
  if (KIND == 1 && static_cast<unsigned>(b + 1) <= 1u) {
    t.edge_w = shape_weight<1>(pos - static_cast<float>(b + 2));
    t.edge_cell = next_cell(t.cell[2], m);
  }
  return t;
}

// sum_o w[o] * f[cell[o]], in increasing j
template <int KIND>
__device__ __forceinline__ float gather(const Taps<KIND>& t, const float* f) {
  float acc = t.w[0] * f[t.cell[0]];
#pragma unroll
  for (int o = 1; o < Taps<KIND>::kCount; ++o) acc += t.w[o] * f[t.cell[o]];
  if (KIND == 1 && t.edge_w != 0.0f) acc += t.edge_w * f[t.edge_cell];
  return acc;
}

// Fixed-point histograms. A weight w counts as rint(w * 2^28), and a cell
// holds the exact sum of its counts as a signed 64-bit integer, split into a
// low 32-bit word at hist[c] and a high word at hist[m + c]. Integer addition
// is associative, so a histogram is bitwise the same whatever order its adds
// run in; the quantisation, 2^-29 per tap, lies far below float32's rounding
// of a sum. Hopper's shared memory adds 32-bit integers natively (ATOMS.ADD)
// but 64-bit ones only in a compare-and-swap loop (ATOMS.CAST.SPIN.64), which
// stalls on every collision: so a tap adds its count to the low word and,
// where that add carries out (or a negative count borrows), +-1 to the high
// word. A cell's carries happen once per 16 units of weight.
constexpr float kFixedOne = 268435456.0f;  // 2^28
constexpr float kFixedStep = 1.0f / 268435456.0f;

// SIGNED: w may be negative (the shifted TSC kind); otherwise w >= 0.
template <bool SIGNED>
__device__ __forceinline__ void add_fixed(unsigned* hist, int m, int c, float w) {
  const int v = __float2int_rn(w * kFixedOne);  // |w| <= 1.125
  const unsigned u = static_cast<unsigned>(v);
  const unsigned old = atomicAdd(&hist[c], u);
  const int carry = (old + u < old ? 1 : 0) - (SIGNED && v < 0 ? 1 : 0);
  if (carry != 0) atomicAdd(reinterpret_cast<int*>(hist) + m + c, carry);
}

// The signed 64-bit sum of a cell from its two words.
__device__ __forceinline__ long long fixed_count(unsigned lo, unsigned hi) {
  return static_cast<long long>(static_cast<int>(hi)) * 4294967296LL + static_cast<long long>(lo);
}

// Adds the taps' weights of one position to a fixed-point histogram of m
// cells in shared memory (2m words).
template <int KIND>
__device__ __forceinline__ void deposit(const Taps<KIND>& t, unsigned* hist, int m) {
#pragma unroll
  for (int o = 0; o < Taps<KIND>::kCount; ++o) add_fixed<KIND == 1>(hist, m, t.cell[o], t.w[o]);
  if (KIND == 1 && t.edge_w != 0.0f) add_fixed<true>(hist, m, t.edge_cell, t.edge_w);
}

}  // namespace pct
