// One round of the reciprocal-NN ladder: the merged pairs' scatter and the
// next round's row cache, in one pass over the matrix, L lanes.
//
// Replaces the TPU kernel sharp_tpu/ops/linkage_pallas.py:_round_scatter_kernel,
// entry `rnn_round_scatter`. Output is identical to the plain version
// `rnn_round_scatter` (sharp_tpu_torch/ops/linkage.py). Per lane, with W
// (m, m) in float32 or bfloat16 storage, updated in place:
//   * a dying row r (a cluster merged away this round) becomes BIG;
//   * a survivor row r becomes rows[colslot[r], :];
//   * in every other row, column c becomes BIG if c is dying,
//     rows[colslot[c], r] if c is a survivor, and keeps W[r, c] otherwise
//     (dying columns are BIG in survivor rows too).
// Then rowmin[r] and rowarg[r] are the minimum of the stored row, compared
// in float32, and the first index that holds it (torch.min's tie rule and
// the JAX package's `first_argmin`); an all-BIG row gives index 0.
//
// What bounds it on an H100: bytes. Each element of W is read once and
// written once (2 x 1.34 GB per round at L = 80, m = 2048 in float32: 0.80 ms
// at 3.35 TB/s; half in bfloat16); rows and colslot add about 3%. The work
// per element is a few compares.
//
// Design:
//   * grid (m / 64 row strips, L), 256 threads (8 warps); a warp owns a row
//     at a time, 8 rows per warp, and reduces its (min, first index) with
//     shuffles alone;
//   * each block stages its lane's colslot and dying flags as one code per
//     column in shared memory (-2 dying, -1 untouched, s >= 0 survivor of
//     pair slot s; 4 m bytes) and the strip's columns of rows, rows[:, r0 +
//     j] for its 64 rows (P x 64 elements), so a survivor column costs a
//     shared-memory read;
//   * W and the survivor rows move in 16-byte vectors along c when m is a
//     multiple of the vector width and the pointers are aligned (scalar
//     otherwise);
//   * in place is safe: every element is read and then written by the same
//     thread, and fresh values come only from rows, never from W.
// Not carried over from the TPU kernel: the one-hot window contractions,
// the strip-major transposes and the 8-sublane row-cache outputs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

#include "ward_common.cuh"

namespace {

using sharp::arg_min;
using sharp::kBig;
using sharp::Store;
using sharp::warp_arg_min;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 64;  // rows of W per block

// VEC consecutive elements; one 16-byte access when VEC * sizeof(T) == 16
template <typename T, int VEC>
__device__ __forceinline__ void load_vec(const T* p, T (&x)[VEC]) {
  if constexpr (sizeof(T) * VEC == 16) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    memcpy(x, &u, 16);
  } else {
#pragma unroll
    for (int e = 0; e < VEC; ++e) x[e] = p[e];
  }
}

template <typename T, int VEC>
__device__ __forceinline__ void store_vec(T* p, const T (&x)[VEC]) {
  if constexpr (sizeof(T) * VEC == 16) {
    uint4 u;
    memcpy(&u, x, 16);
    *reinterpret_cast<uint4*>(p) = u;
  } else {
#pragma unroll
    for (int e = 0; e < VEC; ++e) p[e] = x[e];
  }
}

template <int VEC>
__device__ __forceinline__ void load_codes(const int* p, int (&cc)[VEC]) {
  if constexpr (VEC % 4 == 0) {
#pragma unroll
    for (int k = 0; k < VEC; k += 4) {
      const int4 q = *reinterpret_cast<const int4*>(p + k);
      cc[k] = q.x;
      cc[k + 1] = q.y;
      cc[k + 2] = q.z;
      cc[k + 3] = q.w;
    }
  } else {
#pragma unroll
    for (int e = 0; e < VEC; ++e) cc[e] = p[e];
  }
}

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
    rnn_round_kernel(T* __restrict__ W,                   // (L, m, m), updated in place
                     const T* __restrict__ rows,          // (L, P, m)
                     const int32_t* __restrict__ colslot, // (L, m)
                     const uint8_t* __restrict__ dying,   // (L, m) 0/1
                     float* __restrict__ rowmin,          // (L, m)
                     int64_t* __restrict__ rowarg,        // (L, m)
                     int m, int P) {
  extern __shared__ __align__(16) unsigned char smem[];
  int* code = reinterpret_cast<int*>(smem);   // m
  T* rcol = reinterpret_cast<T*>(code + m);   // P * kRows: rcol[s * kRows + j] = rows[s, r0 + j]

  const int lane_idx = blockIdx.y;
  const int r0 = blockIdx.x * kRows;
  const int nr = min(kRows, m - r0);
  const size_t lm = (size_t)lane_idx * m;
  const T* rows_l = rows + lm * P;

  for (int c = threadIdx.x; c < m; c += kThreads) {
    code[c] = dying[lm + c] ? -2 : colslot[lm + c];
  }
  for (int k = threadIdx.x; k < P * kRows; k += kThreads) {
    const int s = k / kRows;
    const int j = k - s * kRows;
    if (j < nr) rcol[k] = rows_l[(size_t)s * m + r0 + j];
  }
  __syncthreads();

  const T big = Store<T>::put(kBig);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int nvec = m / VEC;
  for (int j = warp; j < nr; j += kWarps) {
    const int r = r0 + j;
    const int cr = code[r];
    T* Wr = W + (lm + r) * m;
    const T* src = cr >= 0 ? rows_l + (size_t)cr * m : Wr;
    float v = INFINITY;
    int a = INT_MAX;
    for (int q = lane; q < nvec; q += 32) {
      const int c0 = q * VEC;
      T x[VEC];
      int cc[VEC];
      if (cr != -2) load_vec<T, VEC>(src + c0, x);
      load_codes<VEC>(code + c0, cc);
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        if (cr == -2 || cc[e] == -2) {
          x[e] = big;
        } else if (cr < 0 && cc[e] >= 0) {
          x[e] = rcol[cc[e] * kRows + j];
        }
        arg_min(v, a, Store<T>::load(x[e]), c0 + e);
      }
      store_vec<T, VEC>(Wr + c0, x);
    }
    warp_arg_min(v, a);
    if (lane == 0) {
      rowmin[lm + r] = v;
      rowarg[lm + r] = a;
    }
  }
}

template <typename T, int VEC>
int launch(void* W, const void* rows, const void* colslot, const void* dying, void* rowmin,
           void* rowarg, int L, int m, int P, cudaStream_t s) {
  const size_t smem = sizeof(int) * (size_t)m + sizeof(T) * (size_t)P * kRows;
  auto kernel = rnn_round_kernel<T, VEC>;
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((m + kRows - 1) / kRows, L);
  kernel<<<grid, kThreads, smem, s>>>((T*)W, (const T*)rows, (const int32_t*)colslot,
                                      (const uint8_t*)dying, (float*)rowmin, (int64_t*)rowarg,
                                      m, P);
  return (int)cudaGetLastError();
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

}  // namespace

extern "C" int sharp_rnn_round_launch(void* W, const void* rows, const void* colslot,
                                      const void* dying, void* rowmin, void* rowarg, int L,
                                      int m, int P, int store, void* stream) {
  if (L <= 0 || m <= 0) return 0;
  const cudaStream_t s = (cudaStream_t)stream;
  const bool vec_ok = aligned16(W) && aligned16(rows);
  if (store == 1) {
    if (vec_ok && m % 8 == 0) {
      return launch<__nv_bfloat16, 8>(W, rows, colslot, dying, rowmin, rowarg, L, m, P, s);
    }
    return launch<__nv_bfloat16, 1>(W, rows, colslot, dying, rowmin, rowarg, L, m, P, s);
  }
  if (vec_ok && m % 4 == 0) {
    return launch<float, 4>(W, rows, colslot, dying, rowmin, rowarg, L, m, P, s);
  }
  return launch<float, 1>(W, rows, colslot, dying, rowmin, rowarg, L, m, P, s);
}
