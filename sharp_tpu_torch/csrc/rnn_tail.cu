// Serial drain of the reciprocal-NN ladder's compacted subproblems, L lanes.
//
// Replaces the TPU kernel sharp_tpu/ops/linkage_pallas.py:_rnn_tail_kernel,
// entry `rnn_tail_pallas`. Each lane is a (Cn, Cn) matrix in float32 or
// bfloat16 storage, BIG on the diagonal and in dead slots, with its live
// flags, cluster sizes, global indices and running recorded heights. The
// lane's n_alive - 1 merges are taken in the strict serial order of the
// full-argmin loop: the flat first-index minimum (smallest value, then row,
// then column) of the stored values. Merge t records (gidx[i], gidx[j]) and
// hrec = max(h, lasth[i], lasth[j]), which becomes lasth[i]. The
// Lance-Williams row is computed in float32 from the stored values and
// written back rounded to the storage type (bf16: round to nearest even),
// as the plain version `rnn_tail` (sharp_tpu_torch/ops/linkage.py) does;
// output is identical to it for t < n_alive - 1. Entries after a lane's
// last merge are written as zeros.
//
// What bounds it on an H100: the merges of a lane form a chain of dependent
// steps, each reading and writing O(Cn) words, so a lane is latency-bound.
// The TPU kernel re-scans the whole (L, Cn, Cn) block every step because a
// TPU core has no cheap per-lane dynamic indexing; here every lane runs on
// its own SM with its own control flow.
//
// Design: one thread block per lane, drained by serial Ward's merge loop
// (ward_tile.cuh: the exact row cache with a runner-up, no revalidation),
// with the lane's sizes (0 for a dead slot), n_alive - 1 merges and the
// clamped record above; gidx and lasth sit in shared memory beside the
// cache.
//   * Cn <= 256: the tile tier. The lane's packed upper triangle is loaded
//     straight from D in its stored type (130.5 KB in f32, 65 KB in bf16),
//     and the lower triangle is compared with it, bit for bit. The plain
//     version reads rows, so the triangle holds only where the lane is
//     exactly symmetric; a lane that is not (D comes from a matrix product,
//     which does not promise it) copies its rows into the wrapper's working
//     copy and takes the global tier, in the same launch.
//   * Cn > 256: every lane copies its rows into the working copy (rows
//     padded to a multiple of 8 entries) and takes the global tier.
//   * routes[lane]: 0 the triangle in shared memory, 1 the rows in global
//     memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "ward_tile.cuh"

namespace {

using sharp::kTileMaxN;
using sharp::kWardMaxThreads;
using sharp::tile_bytes;
using sharp::tri_row;
using sharp::ward_merges;
using sharp::ward_state;
using sharp::ward_state_bytes;
using sharp::WardState;

__device__ __forceinline__ unsigned bits(float v) { return __float_as_uint(v); }
__device__ __forceinline__ unsigned bits(__nv_bfloat16 v) { return __bfloat16_as_ushort(v); }

// The tile tier runs at most kTileMaxN threads, which leaves each up to 255
// registers (at 1024 threads the merge loop spills).
template <typename T, bool kTile>
__global__ void __launch_bounds__(kTile ? kTileMaxN : kWardMaxThreads)
rnn_tail_kernel(const T* __restrict__ D,            // (L, Cn, Cn)
                T* __restrict__ W,                  // (L, Cn, ldw) working copy of the global tier
                const float* __restrict__ alive,    // (L, Cn) 1/0
                const float* __restrict__ sizes,    // (L, Cn)
                const int32_t* __restrict__ gidx,   // (L, Cn)
                const float* __restrict__ lasth,    // (L, Cn)
                int32_t* __restrict__ mi,           // (L, Cn)
                int32_t* __restrict__ mj,           // (L, Cn)
                float* __restrict__ hh,             // (L, Cn)
                int32_t* __restrict__ routes,       // (L,)
                int n, int ldw) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* tile = reinterpret_cast<T*>(smem);
  const size_t tb = kTile ? tile_bytes<T>(n) : 0;
  const WardState st = ward_state(smem + tb, n);
  float* lh = reinterpret_cast<float*>(smem + tb + ward_state_bytes(n));  // n
  int* gi = reinterpret_cast<int*>(lh + n);                                // n
  __shared__ int n_alive;

  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = nt >> 5;
  const size_t base = (size_t)blockIdx.x * n;
  const T* Dl = D + base * n;

  if (tid == 0) n_alive = 0;
  __syncthreads();
  int mine = 0;
  for (int k = tid; k < n; k += nt) {
    const bool live = alive[base + k] > 0.5f;
    st.sizes[k] = live ? sizes[base + k] : 0.0f;
    lh[k] = lasth[base + k];
    gi[k] = gidx[base + k];
    mine += live;
  }
  if (mine) atomicAdd(&n_alive, mine);
  bool sym = false;
  if constexpr (kTile) {
    // the upper triangle, row by row, then the lower triangle against it
    for (int a = warp; a < n - 1; a += nwarps) {
      const int off = tri_row(a, n);
      const T* src = Dl + (size_t)a * n;
      for (int b = a + 1 + lane; b < n; b += 32) tile[off + b] = src[b];
    }
    __syncthreads();
    bool differ = false;
    for (int b = warp + 1; b < n; b += nwarps) {
      const T* src = Dl + (size_t)b * n;
      for (int a = lane; a < b; a += 32) differ |= bits(src[a]) != bits(tile[tri_row(a, n) + b]);
    }
    sym = !__syncthreads_or(differ);
  } else {
    __syncthreads();
  }
  const int steps = max(n_alive - 1, 0);
  for (int t = steps + tid; t < n; t += nt) {
    mi[base + t] = 0;
    mj[base + t] = 0;
    hh[base + t] = 0.0f;
  }
  auto record = [&](int t, int i, int j, float h) {
    const float hrec = fmaxf(h, fmaxf(lh[i], lh[j]));
    lh[i] = hrec;
    mi[base + t] = gi[i];
    mj[base + t] = gi[j];
    hh[base + t] = hrec;
  };

  if constexpr (kTile) {
    if (sym) {
      if (tid == 0) routes[blockIdx.x] = 0;
      ward_merges<T, true>(tile, nullptr, n, 0, steps, st, record);
      return;
    }
  }
  if (tid == 0) routes[blockIdx.x] = 1;
  T* Wl = W + base * ldw;
  for (int r = warp; r < n; r += nwarps) {
    for (int c = lane; c < n; c += 32) Wl[(size_t)r * ldw + c] = Dl[(size_t)r * n + c];
  }
  __syncthreads();
  ward_merges<T, false>(nullptr, Wl, n, ldw, steps, st, record);
}

template <typename T, bool kTile>
int launch(const void* D, void* W, const void* alive, const void* sizes, const void* gidx,
           const void* lasth, void* mi, void* mj, void* hh, void* routes, int L, int n, int ldw,
           cudaStream_t stream) {
  const size_t smem = (kTile ? tile_bytes<T>(n) : 0) + ward_state_bytes(n) + 2 * sizeof(float) * (size_t)n;
  cudaError_t err = cudaFuncSetAttribute(rnn_tail_kernel<T, kTile>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  rnn_tail_kernel<T, kTile><<<L, sharp::ward_threads(n), smem, stream>>>(
      (const T*)D, (T*)W, (const float*)alive, (const float*)sizes, (const int32_t*)gidx,
      (const float*)lasth, (int32_t*)mi, (int32_t*)mj, (float*)hh, (int32_t*)routes, n, ldw);
  return (int)cudaGetLastError();
}

}  // namespace

// D (L, Cn, Cn) in the storage type (store: 0 float32, 1 bfloat16), read
// only; W (L, Cn, ldw) scratch in the same type, ldw a multiple of 8 and at
// least Cn; the state (L, Cn); outputs mi, mj, hh (L, Cn) and routes (L,).
extern "C" int sharp_rnn_tail_launch(const void* D, void* W, const void* alive, const void* sizes,
                                     const void* gidx, const void* lasth, void* mi, void* mj,
                                     void* hh, void* routes, int L, int Cn, int ldw, int store,
                                     void* stream) {
  if (L <= 0 || Cn < 2) return 0;
  if (W == nullptr || ldw < Cn || ldw % 8 != 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const bool tile = Cn <= kTileMaxN;
  if (store == 1) {
    return tile ? launch<__nv_bfloat16, true>(D, W, alive, sizes, gidx, lasth, mi, mj, hh, routes, L, Cn, ldw, s)
                : launch<__nv_bfloat16, false>(D, W, alive, sizes, gidx, lasth, mi, mj, hh, routes, L, Cn, ldw, s);
  }
  return tile ? launch<float, true>(D, W, alive, sizes, gidx, lasth, mi, mj, hh, routes, L, Cn, ldw, s)
              : launch<float, false>(D, W, alive, sizes, gidx, lasth, mi, mj, hh, routes, L, Cn, ldw, s);
}
