// Serial drain of the reciprocal-NN ladder's compacted subproblems, L lanes.
//
// Replaces the TPU kernel sharp_tpu/ops/linkage_pallas.py:_rnn_tail_kernel,
// entry `rnn_tail_pallas`. Each lane is a (Cn, Cn) matrix in float32 or
// bfloat16 storage with its live flags, cluster sizes, global indices and
// running recorded heights. The lane's n_alive - 1 merges are taken in the
// strict serial order of the full-argmin loop: the flat first-index minimum
// (smallest value, then row, then column) of the stored values. Merge t
// records (gidx[i], gidx[j]) and hrec = max(h, lasth[i], lasth[j]), which
// becomes lasth[i]. The Lance-Williams row is computed in float32 from the
// stored values and written back rounded to the storage type (bf16: round
// to nearest even), as the plain version `rnn_tail`
// (sharp_tpu_torch/ops/linkage.py) does; output is identical to it for
// t < n_alive - 1. Entries after a lane's last merge are written as zeros.
//
// What bounds it on an H100: the merges of a lane form a chain of dependent
// steps, each reading and writing O(Cn) words, so a lane is latency-bound.
// The TPU kernel re-scans the whole (L, Cn, Cn) block every step because a
// TPU core has no cheap per-lane dynamic indexing; here every lane runs on
// its own SM with its own control flow.
//
// Design (the scheme of ward_serial.cu, sharing ward_common.cuh):
//   * one thread block per lane; D stays in global memory, a working copy
//     the wrapper makes (80 lanes x 256 KB at Cn = 256 in f32 sit in the
//     50 MB L2; 256 KB is more than the 227 KB of shared memory a block
//     can have);
//   * shared memory holds the row-min cache, sizes, live flags, lasth, gidx
//     and the fresh row;
//   * the row-min cache is a lower bound on each live row's minimum:
//     every value written into a row is folded into its bound (no reliance
//     on Ward's reducibility, which bf16 rounding breaks). Pop the smallest
//     bound (first index on ties), recompute that row exactly, repeat until
//     the popped bound was exact: that gives the flat first-index argmin.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "ward_common.cuh"

namespace {

using sharp::arg_min;
using sharp::block_arg_min;
using sharp::kBig;
using sharp::Store;
using sharp::stored;
using sharp::ward_lw;
using sharp::warp_arg_min;

template <typename T>
__global__ void rnn_tail_kernel(T* __restrict__ D,                  // (L, Cn, Cn), updated in place
                                const float* __restrict__ alive,    // (L, Cn) 1/0
                                const float* __restrict__ sizes,    // (L, Cn)
                                const int32_t* __restrict__ gidx,   // (L, Cn)
                                const float* __restrict__ lasth,    // (L, Cn)
                                int32_t* __restrict__ mi,           // (L, Cn)
                                int32_t* __restrict__ mj,           // (L, Cn)
                                float* __restrict__ hh,             // (L, Cn)
                                int Cn) {
  extern __shared__ float smem[];
  float* rowmin = smem;                  // Cn
  float* sz = rowmin + Cn;               // Cn
  float* lh = sz + Cn;                   // Cn
  float* newrow = lh + Cn;               // Cn
  int* act = (int*)(newrow + Cn);        // Cn
  int* gi = act + Cn;                    // Cn
  float* red_v = (float*)(gi + Cn);      // 33
  int* red_i = (int*)(red_v + 33);       // 33
  __shared__ int n_alive;

  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = nt >> 5;
  const size_t base = (size_t)blockIdx.x * Cn;
  T* Dl = D + base * Cn;
  const float big = stored<T>(kBig);
  const T big_st = Store<T>::put(kBig);

  if (tid == 0) n_alive = 0;
  __syncthreads();
  int mine = 0;
  for (int k = tid; k < Cn; k += nt) {
    act[k] = alive[base + k] > 0.5f;
    sz[k] = sizes[base + k];
    lh[k] = lasth[base + k];
    gi[k] = gidx[base + k];
    mine += act[k];
    mi[base + k] = 0;
    mj[base + k] = 0;
    hh[base + k] = 0.0f;
  }
  atomicAdd(&n_alive, mine);
  __syncthreads();

  // exact initial row minima of the live rows, one warp per row
  for (int r = warp; r < Cn; r += nwarps) {
    float v = INFINITY;
    int a = INT_MAX;
    for (int c = lane; c < Cn; c += 32) arg_min(v, a, Store<T>::load(Dl[(size_t)r * Cn + c]), c);
    warp_arg_min(v, a);
    if (lane == 0) rowmin[r] = act[r] ? v : INFINITY;
  }
  __syncthreads();

  const int steps = n_alive - 1;
  for (int t = 0; t < steps; ++t) {
    // --- pop the smallest bound and revalidate until exact ---------------
    int i0, j0;
    float h;
    while (true) {
      float v = INFINITY;
      int r = INT_MAX;
      for (int k = tid; k < Cn; k += nt) arg_min(v, r, rowmin[k], k);
      block_arg_min(v, r, red_v, red_i);
      float m = INFINITY;
      int c = INT_MAX;
      for (int k = tid; k < Cn; k += nt) arg_min(m, c, Store<T>::load(Dl[(size_t)r * Cn + k]), k);
      block_arg_min(m, c, red_v, red_i);
      if (tid == 0) rowmin[r] = m;
      __syncthreads();
      if (m <= v) {
        i0 = r;
        j0 = c;
        h = m;
        break;
      }
    }
    const int i = min(i0, j0);
    const int j = max(i0, j0);
    const float ni = sz[i];
    const float nj = sz[j];

    // --- Lance-Williams row of the survivor i, rounded as stored ----------
    for (int k = tid; k < Cn; k += nt) {
      float nv = big;
      if (act[k] && k != i && k != j) {
        nv = stored<T>(ward_lw(Store<T>::load(Dl[(size_t)i * Cn + k]),
                               Store<T>::load(Dl[(size_t)j * Cn + k]), h, ni, nj, sz[k]));
      }
      newrow[k] = nv;
    }
    __syncthreads();

    // --- write row/column i, kill row/column j, keep the lower bounds -----
    float v = INFINITY;
    int a = INT_MAX;
    for (int k = tid; k < Cn; k += nt) {
      const float nv = newrow[k];
      const T nv_st = Store<T>::put(nv);
      Dl[(size_t)i * Cn + k] = nv_st;
      Dl[(size_t)k * Cn + i] = nv_st;
      Dl[(size_t)j * Cn + k] = big_st;
      Dl[(size_t)k * Cn + j] = big_st;
      if (act[k] && nv < rowmin[k]) rowmin[k] = nv;
      arg_min(v, a, nv, k);
    }
    block_arg_min(v, a, red_v, red_i);  // row i's exact minimum
    if (tid == 0) {
      rowmin[i] = v;
      rowmin[j] = INFINITY;
      act[j] = 0;
      sz[i] = ni + nj;
      const float hrec = fmaxf(h, fmaxf(lh[i], lh[j]));
      lh[i] = hrec;
      mi[base + t] = gi[i];
      mj[base + t] = gi[j];
      hh[base + t] = hrec;
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" int sharp_rnn_tail_launch(void* D, const void* alive, const void* sizes,
                                     const void* gidx, const void* lasth, void* mi,
                                     void* mj, void* hh, int L, int Cn, int store,
                                     void* stream) {
  if (L <= 0 || Cn < 2) return 0;
  const int threads = Cn < 1024 ? ((Cn + 31) / 32) * 32 : 1024;
  const size_t smem = sizeof(float) * (size_t)(6 * Cn + 66);
  const cudaStream_t s = (cudaStream_t)stream;
  if (store == 1) {
    rnn_tail_kernel<__nv_bfloat16><<<L, threads, smem, s>>>(
        (__nv_bfloat16*)D, (const float*)alive, (const float*)sizes, (const int32_t*)gidx,
        (const float*)lasth, (int32_t*)mi, (int32_t*)mj, (float*)hh, Cn);
  } else {
    rnn_tail_kernel<float><<<L, threads, smem, s>>>(
        (float*)D, (const float*)alive, (const float*)sizes, (const int32_t*)gidx,
        (const float*)lasth, (int32_t*)mi, (int32_t*)mj, (float*)hh, Cn);
  }
  return (int)cudaGetLastError();
}
