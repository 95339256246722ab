// Serial Ward.D agglomeration for K problems at once, float32 or bfloat16
// matrix storage.
//
// Replaces the TPU kernel sharp_tpu/ops/linkage_pallas.py:_kernel_deferred
// (:175-371, and its "full" variant _kernel), entry `ward_linkage_pallas`,
// in both of its storage types. Output is bit-identical to the plain
// full-argmin loop `ward_linkage(D, store_dtype=...)`
// (sharp_tpu_torch/ops/linkage.py): the same merges, recorded as (min, max),
// and the same heights. D is read as symmetric, from its upper triangle.
// With bf16 storage D is rounded to bf16 on entry, rows are read as stored
// values widened to float32, the Lance-Williams row is computed in float32
// and rounded to bf16 on store, and the argmin and the heights see stored
// values only, as in the TPU kernel.
//
// What bounds it on an H100: the n - 1 merges form a chain, each depending
// on the last, so one problem is latency-bound, not bound by bytes or
// operations. A merge is worth O(n) work; what it costs is its chain of
// reductions, barriers and dependent trips to memory.
//
// Design: one thread block per problem, K problems per launch, each drained
// by the exact row cache of ward_tile.cuh (no revalidation, two redux.sync
// per warp argmin, double-buffered row minima), all n points live, sizes 1.
//   * n <= 256 (kTileMaxN): the tile tier. The packed upper triangle is
//     loaded once from the float32 D, rounded to the storage type, and
//     never written back; two __syncthreads per merge.
//   * n > 256: the global tier, on a working copy the wrapper makes
//     (symmetric, rounded to the storage type, rows padded to a multiple of
//     8 entries); three __syncthreads per merge. The row cache's seven words
//     per row sit in shared memory up to n 8192 (225 KB); above, in a global
//     scratch of (K, 7, n) words the wrapper allocates, as the cut replay
//     keeps its state above its shared-memory limit (cutree.cu). The
//     per-warp partials stay in shared memory.
//   * The TPU kernel's deferred column ring and its one-hot flush are not
//     carried over: they work around the cost of a column write on the TPU.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "ward_tile.cuh"

namespace {

using sharp::kStateSmemMaxN;
using sharp::kTileMaxN;
using sharp::kWardMaxThreads;
using sharp::kWardPartBytes;
using sharp::Store;
using sharp::tile_bytes;
using sharp::tri_row;
using sharp::ward_merges;
using sharp::ward_rows_bytes;
using sharp::ward_state;
using sharp::ward_state_bytes;
using sharp::WardState;

// The tile tier runs at most kTileMaxN threads, which leaves each up to 255
// registers (at 1024 threads the merge loop spills).
template <typename T, bool kTile, bool kGlobalState>
__global__ void __launch_bounds__(kTile ? kTileMaxN : kWardMaxThreads)
ward_serial_kernel(const float* __restrict__ D,   // (K, n, n) float32, read by the tile tier
                   T* __restrict__ W,             // (K, n, ldw) working copy of the global tier
                   unsigned char* S,              // (K, 7, n) words of row state, n > kStateSmemMaxN
                   int32_t* __restrict__ merges,  // (K, n-1, 2)
                   float* __restrict__ heights,   // (K, n-1)
                   int n, int ldw) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* tile = reinterpret_cast<T*>(smem);
  const WardState st = kGlobalState ? ward_state(S + blockIdx.x * ward_rows_bytes(n), smem, n)
                                    : ward_state(smem + (kTile ? tile_bytes<T>(n) : 0), n);

  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = nt >> 5;
  const size_t prob = blockIdx.x;
  int32_t* mg = merges + prob * (n - 1) * 2;
  float* hh = heights + prob * (n - 1);

  if constexpr (kTile) {
    const float* Dp = D + prob * n * n;
    for (int a = warp; a < n - 1; a += nwarps) {
      const int off = tri_row(a, n);
      const float* src = Dp + (size_t)a * n;
      for (int b = a + 1 + lane; b < n; b += 32) tile[off + b] = Store<T>::put(src[b]);
    }
  }
  for (int k = tid; k < n; k += nt) st.sizes[k] = 1.0f;
  __syncthreads();
  ward_merges<T, kTile>(tile, kTile ? nullptr : W + prob * n * ldw, n, ldw, n - 1, st,
                        [&](int t, int i, int j, float h) {
                          mg[2 * t] = i;
                          mg[2 * t + 1] = j;
                          hh[t] = h;
                        });
}

template <typename T, bool kTile, bool kGlobalState = false>
int launch(const void* D, void* W, void* S, void* merges, void* heights, int K, int n, int ldw,
           cudaStream_t stream) {
  const size_t smem = kGlobalState ? kWardPartBytes : (kTile ? tile_bytes<T>(n) : 0) + ward_state_bytes(n);
  cudaError_t err = cudaFuncSetAttribute(ward_serial_kernel<T, kTile, kGlobalState>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  ward_serial_kernel<T, kTile, kGlobalState><<<K, sharp::ward_threads(n), smem, stream>>>(
      (const float*)D, (T*)W, (unsigned char*)S, (int32_t*)merges, (float*)heights, n, ldw);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_store(const void* D, void* W, void* S, void* merges, void* heights, int K, int n, int ldw,
                 cudaStream_t s) {
  if (n <= kTileMaxN) return launch<T, true>(D, W, S, merges, heights, K, n, ldw, s);
  if (n <= kStateSmemMaxN) return launch<T, false>(D, W, S, merges, heights, K, n, ldw, s);
  return launch<T, false, true>(D, W, S, merges, heights, K, n, ldw, s);
}

}  // namespace

// D (K, n, n) float32 for n <= 256; W (K, n, ldw) in the storage type for
// n > 256 (ldw a multiple of 8); S (K, 7, n) 4-byte words for n > 8192.
// store: 0 float32, 1 bfloat16.
extern "C" int sharp_ward_serial_launch(const void* D, void* W, void* S, void* merges, void* heights,
                                        int K, int n, int ldw, int store, void* stream) {
  if (K <= 0 || n < 2) return 0;
  const cudaStream_t s = (cudaStream_t)stream;
  const bool tile = n <= kTileMaxN;
  if (tile ? D == nullptr : (W == nullptr || ldw < n || ldw % 8 != 0)) return (int)cudaErrorInvalidValue;
  if (n > kStateSmemMaxN && S == nullptr) return (int)cudaErrorInvalidValue;
  if (store == 1) return launch_store<__nv_bfloat16>(D, W, S, merges, heights, K, n, ldw, s);
  return launch_store<float>(D, W, S, merges, heights, K, n, ldw, s);
}

#ifdef WARD_PROFILE
extern "C" int sharp_ward_profile(void* out, int reset) {
  cudaError_t e = cudaMemcpyFromSymbol(out, sharp::g_prof, sizeof(sharp::g_prof));
  if (e == cudaSuccess && reset) {
    unsigned long long z[8] = {0, 0, 0, 0, 0, 0, 0, 0};
    e = cudaMemcpyToSymbol(sharp::g_prof, z, sizeof(z));
  }
  return (int)e;
}
#endif
