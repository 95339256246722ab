// All-cuts merge replay for G problems at once.
//
// Replaces the TPU kernel sharp_tpu/ops/linkage_pallas.py:_cutree_kernel,
// entry `cutree_multi_pallas`. For each problem g the labels start as
// labels[k] = k and step t relabels j_t to i_t (labels[labels == j_t] =
// i_t); the labels after step t go to candidate row c = n_real[g] - t - 1 -
// minN whenever 0 <= c < ncand. Rows no step reaches stay 0. Output is
// identical to the plain replay `cutree_snapshots`
// (sharp_tpu_torch/ops/linkage.py). Dense relabelling and the validity
// mask run in torch, as in the JAX wrapper.
//
// What bounds it on an H100: the output, ncand * n int32 per problem
// (26.9 MB at G = 80, n = 2048, ncand = 39: 8 us at 3.35 TB/s). The snapshots
// come only from steps t0..t1,
//   t0 = max(0, n_real - minN - ncand),  t1 = min(n_real - 1 - minN, n - 2),
// so replaying all n - 1 steps in order, as the TPU kernel does, is a
// chain of n - 1 dependent steps that produces nothing for most of them.
//
// Design: one thread block per problem, in parallel phases instead of the
// chain.
//   (a) Deaths: a thread per step s <= t1 writes death[j_s] = s and
//       into[j_s] = i_s (every index starts at death = never).
//   (b) Viability: the sequences that ward_linkage, serial Ward and the
//       ladder emit merge a live pair (i_s != j_s, neither died before s)
//       and merge each j once. Then the label of cell x before step t is the
//       first index on its chain x -> into[x] -> ... that dies at t or later
//       (deaths rise along a chain). An atomicCAS on death[j] finds a j that
//       dies twice; a second pass checks death[i_s] > s and death[j_s] == s;
//       __syncthreads_or combines the checks.
//   (c) Labels before step t0: parent[x] = death[x] < t0 ? into[x] : x, then
//       pointer jumping in place until no pointer moves (a barrier per
//       round, at most about log2 n rounds however long the chains are).
//   (d) Snapshots: every thread owns chunks of 4 cells (16-byte stores when
//       n % 4 == 0, else single cells), keeps them in registers, replays
//       steps t0..t1 (at most ncand of them) with the merges read straight
//       from global memory (one address per step for the whole block), and
//       writes its chunk of each row; no barrier.
//   (e) A sequence that fails (b) takes the serial route in the same
//       kernel: (d) from step 0 with labels[k] = k. It computes the same
//       function by its exact route; routes[g] records 1 (0: the parallel
//       route).
// death and parent (2n int32) live in shared memory up to the opt-in limit
// (n <= 29,056 of 227 KB); above it in a global scratch (G, 2, n) that the
// wrapper allocates. The serial route needs neither.
//
// G = 1 (the wMetaC and sMetaC problems, n <= 1024): one block on one SM,
// three barrier-separated phases and a few jump rounds, a few microseconds
// on the card; it is launch-bound: chip_smoke.py times it beside the same
// kernel on a two-cell problem, and a call through the wrapper costs the
// host about ten times what the kernel costs the card (PERF.md).

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kNever = INT_MAX;  // death of an index no step up to t1 merges away
constexpr int kMinThreads = 64;
constexpr int kMaxThreads = 1024;

template <int V>
__device__ __forceinline__ void store_chunk(int32_t* p, const int (&l)[V]) {
  if constexpr (V == 4) {
    *reinterpret_cast<int4*>(p) = make_int4(l[0], l[1], l[2], l[3]);
  } else {
    p[0] = l[0];
  }
}

// V cells per chunk: 4 needs n % 4 == 0 (rows start 16-byte aligned), else 1.
template <int V>
__global__ void __launch_bounds__(kMaxThreads)
cutree_kernel(const int2* __restrict__ merges,    // (G, n-1) pairs (i, j)
              const int32_t* __restrict__ n_real,  // (G,)
              int32_t* __restrict__ snaps,         // (G, ncand, n)
              int32_t* __restrict__ routes,        // (G,)
              int32_t* __restrict__ scratch,       // (G, 2, n), or null: shared memory
              int n, int minN, int ncand) {
  extern __shared__ int32_t smem[];
  const int g = blockIdx.x;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  int32_t* death = scratch ? scratch + (size_t)g * 2 * n : smem;
  int32_t* parent = death + n;  // into[x] after (a), parent[x] after (c)
  const int2* mg = merges + (size_t)g * (n - 1);
  int32_t* out = snaps + (size_t)g * ncand * n;
  const int nr = n_real[g];
  const int t0 = max(0, nr - minN - ncand);
  const int t1 = min(nr - 1 - minN, n - 2);
  // steps t0..t1 write rows c_lo..c_hi; every other row is 0
  const int c_lo = nr - 1 - minN - t1;
  const int c_hi = nr - 1 - minN - t0;

  bool serial = false;
  if (t0 <= t1) {
    // --- (a) deaths, (b) viability ------------------------------------------
    for (int x = tid; x < n; x += nt) death[x] = kNever;
    __syncthreads();
    bool bad = false;
    for (int s = tid; s <= t1; s += nt) {
      const int2 m = mg[s];
      if (m.x < 0 || m.x >= n || m.y < 0 || m.y >= n || m.x == m.y) {
        bad = true;
        continue;
      }
      bad |= atomicCAS(&death[m.y], kNever, s) != kNever;
      parent[m.y] = m.x;
    }
    __syncthreads();
    for (int s = tid; s <= t1 && !bad; s += nt) {
      const int2 m = mg[s];
      bad = !(death[m.x] > s && death[m.y] == s);  // indices checked in (a)
    }
    serial = __syncthreads_or(bad);

    // --- (c) labels before step t0 ------------------------------------------
    if (!serial) {
      for (int x = tid; x < n; x += nt) {
        if (death[x] >= t0) parent[x] = x;
      }
      __syncthreads();
      bool moved;
      do {
        moved = false;
        for (int x = tid; x < n; x += nt) {
          const int p = parent[x];
          const int q = parent[p];
          if (q != p) {
            parent[x] = q;
            moved = true;
          }
        }
      } while (__syncthreads_or(moved));
    }
  }

  // --- (d) snapshots; (e) the serial route from step 0 ----------------------
  const int start = serial ? 0 : t0;
  const int32_t zero[V] = {};
  for (int q = tid; q < n / V; q += nt) {
    const int k0 = q * V;
    for (int c = 0; c < ncand; ++c) {
      if (c < c_lo || c > c_hi) store_chunk<V>(out + (size_t)c * n + k0, zero);
    }
    int l[V];
#pragma unroll
    for (int e = 0; e < V; ++e) l[e] = serial || t0 > t1 ? k0 + e : parent[k0 + e];
#pragma unroll 4
    for (int s = start; s <= t1; ++s) {
      const int2 m = mg[s];
#pragma unroll
      for (int e = 0; e < V; ++e) l[e] = l[e] == m.y ? m.x : l[e];
      if (s >= t0) store_chunk<V>(out + (size_t)(nr - 1 - minN - s) * n + k0, l);
    }
  }
  if (tid == 0) routes[g] = serial ? 1 : 0;
}

template <int V>
int launch(const void* merges, const void* n_real, void* snaps, void* routes, void* scratch,
           int G, int n, int minN, int ncand, cudaStream_t stream) {
  const int rounded = ((n + 31) / 32) * 32;
  const int threads = rounded < kMinThreads ? kMinThreads : (rounded > kMaxThreads ? kMaxThreads : rounded);
  const size_t smem = scratch ? 0 : sizeof(int32_t) * 2 * (size_t)n;
  cudaError_t err = cudaFuncSetAttribute(cutree_kernel<V>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  cutree_kernel<V><<<G, threads, smem, stream>>>((const int2*)merges, (const int32_t*)n_real,
                                                 (int32_t*)snaps, (int32_t*)routes,
                                                 (int32_t*)scratch, n, minN, ncand);
  return (int)cudaGetLastError();
}

}  // namespace

// merges (G, n-1, 2) int32, n_real (G,) int32 -> snaps (G, ncand, n) int32
// and routes (G,) int32. scratch: (G, 2, n) int32, or null to keep the
// replay's state in shared memory (n <= 29,056).
extern "C" int sharp_cutree_launch(const void* merges, const void* n_real, void* snaps,
                                   void* routes, void* scratch, int G, int n, int minN,
                                   int ncand, void* stream) {
  if (G <= 0) return 0;
  if (n < 2 || ncand < 1) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  return n % 4 == 0 ? launch<4>(merges, n_real, snaps, routes, scratch, G, n, minN, ncand, s)
                    : launch<1>(merges, n_real, snaps, routes, scratch, G, n, minN, ncand, s);
}
