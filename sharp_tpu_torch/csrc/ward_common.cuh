// Pieces shared by the Ward kernels (ward_tile.cuh, which serial Ward and
// the ladder's tail share, and rnn_round.cu): the first-index argmin
// reductions, the storage types and the Lance-Williams ward.D update.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>

namespace sharp {

constexpr float kBig = 1e30f;  // sharp_tpu_torch.ops.distance.BIG

// Matrix storage: float32, or bfloat16 rounded to nearest even on store
// and read back as float32.
template <typename T>
struct Store;

template <>
struct Store<float> {
  __device__ static float load(float v) { return v; }
  __device__ static float put(float v) { return v; }
};

template <>
struct Store<__nv_bfloat16> {
  __device__ static float load(__nv_bfloat16 v) { return __bfloat162float(v); }
  __device__ static __nv_bfloat16 put(float v) { return __float2bfloat16_rn(v); }
};

// v as it reads back after a store in T
template <typename T>
__device__ __forceinline__ float stored(float v) {
  return Store<T>::load(Store<T>::put(v));
}

// (v, i) <- (v2, i2) if v2 is smaller, or equal with a smaller index;
// selects, not branches
__device__ __forceinline__ void arg_min(float& v, int& i, float v2, int i2) {
  const bool take = (v2 < v) | ((v2 == v) & (i2 < i));
  v = take ? v2 : v;
  i = take ? i2 : i;
}

// Order-preserving 32-bit key of a float: keys compare as the floats do,
// -0 taken as +0 and NaN above +inf.
__device__ __forceinline__ unsigned float_key(float v) {
  const unsigned b = __float_as_uint(v + 0.0f);
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

__device__ __forceinline__ float key_float(unsigned k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

// Warp-wide (value, index) argmin, smallest index on ties, the result in
// every lane: two redux.sync instructions, the least key, then the least
// index holding it.
__device__ __forceinline__ void warp_arg_min(float& v, int& i) {
  const unsigned k = float_key(v);
  const unsigned m = __reduce_min_sync(0xffffffffu, k);
  i = (int)__reduce_min_sync(0xffffffffu, k == m ? (unsigned)i : 0xffffffffu);
  v = key_float(m);
}

// (v, i) before or equal to (v2, i2) in (value, index) order
__device__ __forceinline__ bool lex_le(float v, int i, float v2, int i2) {
  return (v < v2) | ((v == v2) & (i <= i2));
}

// Insert (v, i) into a running first-index top-2 (v0, i0) <= (v1, i1).
__device__ __forceinline__ void top2_add(float& v0, int& i0, float& v1, int& i1, float v, int i) {
  const bool lt0 = (v < v0) | ((v == v0) & (i < i0));
  const bool lt1 = (v < v1) | ((v == v1) & (i < i1));
  v1 = lt0 ? v0 : (lt1 ? v : v1);
  i1 = lt0 ? i0 : (lt1 ? i : i1);
  v0 = lt0 ? v : v0;
  i0 = lt0 ? i : i0;
}

// The warp-wide first-index top-2 of every lane's top-2, in every lane:
// the least entry, then the least entry at another index.
__device__ __forceinline__ void warp_top2_redux(float& v0, int& i0, float& v1, int& i1) {
  float m = v0;
  int a = i0;
  warp_arg_min(m, a);
  float m2 = i0 == a ? v1 : v0;
  int a2 = i0 == a ? i1 : i0;
  warp_arg_min(m2, a2);
  v0 = m;
  i0 = a;
  v1 = m2;
  i1 = a2;
}

// ((ni + nk) * dik + (nj + nk) * djk - nk * h) / ((ni + nj) + nk), every
// operation rounded on its own (no fused multiply-add, IEEE division), in
// the association order of the plain PyTorch versions.
__device__ __forceinline__ float ward_lw(float dik, float djk, float h,
                                         float ni, float nj, float nk) {
  const float a = __fmul_rn(__fadd_rn(ni, nk), dik);
  const float b = __fmul_rn(__fadd_rn(nj, nk), djk);
  const float num = __fsub_rn(__fadd_rn(a, b), __fmul_rn(nk, h));
  const float den = __fadd_rn(__fadd_rn(ni, nj), nk);
  return __fdiv_rn(num, den);
}

}  // namespace sharp
