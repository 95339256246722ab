// Pieces shared by the serial Ward kernels (ward_serial.cu, rnn_tail.cu):
// the first-index argmin reductions and the Lance-Williams ward.D update.
#pragma once

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>

namespace sharp {

constexpr float kBig = 1e30f;  // sharp_tpu_torch.ops.distance.BIG

__device__ __forceinline__ void arg_min(float& v, int& i, float v2, int i2) {
  if (v2 < v || (v2 == v && i2 < i)) {
    v = v2;
    i = i2;
  }
}

// Warp-wide (value, index) argmin, smallest index on ties; lane 0 holds
// the result.
__device__ __forceinline__ void warp_arg_min(float& v, int& i) {
  for (int off = 16; off > 0; off >>= 1) {
    const float v2 = __shfl_down_sync(0xffffffffu, v, off);
    const int i2 = __shfl_down_sync(0xffffffffu, i, off);
    arg_min(v, i, v2, i2);
  }
}

// Block-wide (value, index) argmin, smallest index on ties. Every thread
// passes its partial and receives the block's result. red_v / red_i hold
// 33 slots; blockDim.x is a multiple of 32.
__device__ __forceinline__ void block_arg_min(float& v, int& i, float* red_v, int* red_i) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  warp_arg_min(v, i);
  if (lane == 0) {
    red_v[warp] = v;
    red_i[warp] = i;
  }
  __syncthreads();
  if (warp == 0) {
    v = lane < nwarps ? red_v[lane] : INFINITY;
    i = lane < nwarps ? red_i[lane] : INT_MAX;
    warp_arg_min(v, i);
    if (lane == 0) {
      red_v[32] = v;
      red_i[32] = i;
    }
  }
  __syncthreads();
  v = red_v[32];
  i = red_i[32];
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
