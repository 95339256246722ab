// Serial Ward.D agglomeration for K problems at once, exact float32.
//
// Replaces the TPU kernel sharp_tpu/ops/linkage_pallas.py:_kernel_deferred
// (and its "full" variant :_kernel), entry `ward_linkage_pallas`.
// Output is bit-identical to the plain full-argmin loop `ward_linkage`
// (sharp_tpu_torch/ops/linkage.py): same merge order, same heights.
//
// What bounds it on an H100: the n-1 merges are serial and each depends on
// the last, so one problem is a chain of n-1 small steps: latency, not
// bandwidth or arithmetic. One step reads two rows and writes two rows and
// two columns of D (O(n) words); the global argmin over the (n, n) matrix
// is what a naive step would pay, O(n^2).
//
// Design:
//   * One thread block per problem (the first version fills K of the 132
//     SMs). D stays in global memory, a working copy the wrapper makes:
//     4 MB at n = 1024 cannot sit in 227 KB of shared memory, but the K
//     problems of the small path (15 x 1 MB at n = 512) sit in the 50 MB L2.
//   * Shared memory holds the per-row minimum cache and its argmin, the
//     cluster sizes, the live flags and the fresh Lance-Williams row.
//   * The row-min cache is a lower bound on each row's true minimum, with
//     lazy revalidation (the scheme of `ward_linkage_fast`,
//     sharp_tpu/ops/linkage.py:183-278): pop the smallest cached row,
//     recompute it exactly, repeat until the popped value is exact. That
//     gives the flat first-index argmin of the full matrix: smallest value,
//     then smallest row, then smallest column.
//   * Every reduction breaks ties to the smallest index; the merge is
//     recorded as (min, max).
//   * The Lance-Williams formula
//       ((ni + nk) * dik + (nj + nk) * djk - nk * h) / (ni + nj + nk)
//     is written with __fadd_rn / __fmul_rn / __fsub_rn / __fdiv_rn in that
//     association order, so no multiply-add is fused and the division is
//     IEEE, as in torch's separate elementwise ops.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <limits.h>

#include "ward_common.cuh"

namespace {

using sharp::arg_min;
using sharp::block_arg_min;
using sharp::kBig;
using sharp::ward_lw;
using sharp::warp_arg_min;

__global__ void ward_serial_kernel(float* __restrict__ D,          // (K, n, n), updated in place
                                   int32_t* __restrict__ merges,   // (K, n-1, 2)
                                   float* __restrict__ heights,    // (K, n-1)
                                   int n) {
  extern __shared__ float smem[];
  float* rowmin = smem;                       // n
  int* rowarg = (int*)(rowmin + n);           // n
  float* sizes = (float*)(rowarg + n);        // n
  int* active = (int*)(sizes + n);            // n
  float* newrow = (float*)(active + n);       // n
  float* red_v = newrow + n;                  // 33
  int* red_i = (int*)(red_v + 33);            // 33

  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = nt >> 5;
  float* Db = D + (size_t)blockIdx.x * n * n;
  int32_t* mg = merges + (size_t)blockIdx.x * (n - 1) * 2;
  float* hh = heights + (size_t)blockIdx.x * (n - 1);

  for (int k = tid; k < n; k += nt) {
    Db[(size_t)k * n + k] = kBig;
    sizes[k] = 1.0f;
    active[k] = 1;
  }
  __syncthreads();

  // exact initial row minima, one warp per row (coalesced row reads)
  for (int r = warp; r < n; r += nwarps) {
    float v = INFINITY;
    int a = INT_MAX;
    for (int c = lane; c < n; c += 32) arg_min(v, a, Db[(size_t)r * n + c], c);
    warp_arg_min(v, a);
    if (lane == 0) {
      rowmin[r] = v;
      rowarg[r] = a;
    }
  }
  __syncthreads();

  for (int t = 0; t < n - 1; ++t) {
    // --- pop the smallest cached row and revalidate until exact ---------
    int i0, j0;
    float h;
    while (true) {
      float v = INFINITY;
      int r = INT_MAX;
      for (int k = tid; k < n; k += nt) arg_min(v, r, rowmin[k], k);
      block_arg_min(v, r, red_v, red_i);
      float m = INFINITY;
      int c = INT_MAX;
      for (int k = tid; k < n; k += nt) arg_min(m, c, Db[(size_t)r * n + k], k);
      block_arg_min(m, c, red_v, red_i);
      if (tid == 0) {
        rowmin[r] = m;
        rowarg[r] = c;
      }
      __syncthreads();
      if (m <= v) {  // the cached bound was the true minimum
        i0 = r;
        j0 = c;
        h = m;
        break;
      }
    }
    const int i = min(i0, j0);
    const int j = max(i0, j0);
    const float ni = sizes[i];
    const float nj = sizes[j];

    // --- Lance-Williams row for the survivor i --------------------------
    for (int k = tid; k < n; k += nt) {
      float nv = kBig;
      if (active[k] && k != i && k != j) {
        nv = ward_lw(Db[(size_t)i * n + k], Db[(size_t)j * n + k], h, ni, nj,
                     sizes[k]);
      }
      newrow[k] = nv;
    }
    __syncthreads();

    // --- write row/column i, kill row/column j, keep the lower bounds ---
    float v = INFINITY;
    int a = INT_MAX;
    for (int k = tid; k < n; k += nt) {
      const float nv = newrow[k];
      Db[(size_t)i * n + k] = nv;
      Db[(size_t)k * n + i] = nv;
      Db[(size_t)j * n + k] = kBig;
      Db[(size_t)k * n + j] = kBig;
      if (nv < rowmin[k]) {
        rowmin[k] = nv;
        rowarg[k] = i;
      }
      arg_min(v, a, nv, k);
    }
    block_arg_min(v, a, red_v, red_i);  // row i's exact minimum
    if (tid == 0) {
      rowmin[i] = v;
      rowarg[i] = a;
      rowmin[j] = kBig;
      active[j] = 0;
      sizes[i] = ni + nj;
      mg[2 * t] = i;
      mg[2 * t + 1] = j;
      hh[t] = h;
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" int sharp_ward_serial_smem_bytes(int n) {
  return (int)(sizeof(float) * (size_t)(5 * n + 66));
}

extern "C" int sharp_ward_serial_launch(void* D, void* merges, void* heights,
                                        int K, int n, void* stream) {
  if (K <= 0 || n < 2) return 0;
  const int threads = n < 1024 ? ((n + 31) / 32) * 32 : 1024;
  const size_t smem = (size_t)sharp_ward_serial_smem_bytes(n);
  ward_serial_kernel<<<K, threads, smem, (cudaStream_t)stream>>>(
      (float*)D, (int32_t*)merges, (float*)heights, n);
  return (int)cudaGetLastError();
}
