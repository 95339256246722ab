// The candidate sweep of the selection: the nested cuts' node replay, the
// per-cell silhouette and CH terms, and each cut's median and sums.
//
// Replaces no TPU kernel: the JAX package's sweep
// (sharp_tpu/ops/silhouette.py, `sweep_scores_nested`) is a `lax.scan` over
// the candidates and jnp code that XLA fuses. The port ran it as a Python
// loop of ~35 eager operations a candidate and a chunked scoring over
// (lanes, ncand, n, V) temporaries, ~1,800 launches a selection; these three
// kernels replace the loop and the scoring (sharp_tpu_torch/ops/silhouette.py,
// `sweep_scores_nested`; its plain version is `sweep_scores_nested_plain`).
// The preamble (the finest cut's one-hot and the three products) and the
// cut-independent node quantities stay in torch between the launches:
//
//   sweep_nodes   one block a lane: replays the ncand nested merges in order
//                 c = ncand-1..0, writes each new node's distance sums, count
//                 and centroid sum as sums[coli] + sums[colj] (the plain
//                 version's operands, in its order), each candidate's own
//                 node per cell (L, ncand, n) in the narrowest integer type
//                 that holds V, and its live nodes (alive and non-empty) as
//                 a bit mask of W = ceil(V / 32) words.
//   sweep_score   a thread a cell: for each candidate, a (own node's sums
//                 over its size - 1), b (the least mean distance to another
//                 live node), the silhouette width with the singleton and
//                 k == 1 conventions, and the cell's 1 - corr(own centroid)
//                 term; both (L, ncand, n) float32.
//   sweep_median  one block a (lane, candidate): the two middle order
//                 statistics of the widths over the real cells by an exact
//                 radix select on the float bits (R's median, the plain
//                 version's sort and gather), W and B summed in a fixed
//                 order, and the CH index.
//
// The float arithmetic is the plain version's expression for expression
// (built with --fmad=false, IEEE division), so the medians are bit-equal to
// it; only the CH sums run in another (fixed) order.
//
// What bounds it on an H100: the node tables read once by sweep_score (the
// (L, n, V) sums and the own column of FC), the (L, ncand, n) widths and
// terms written once and read once by sweep_median: at the atlas's fold
// group (80, 2048, ncand 39, V 87) 57 MB + 2 x 25.6 MB written and read,
// about 0.05 ms at 3.35 TB/s. The replay is a chain of ncand dependent steps
// a lane, a few microseconds each.
//
// Design:
//   - sweep_nodes keeps the live bits in shared memory; row r of the sums,
//     count slot and centroid column q stay with one thread for the whole
//     replay, so only the own table, which every step reads at the merged
//     cells, needs a barrier a step. At the end the live words are masked
//     with count > 0.5 (the plain version's nodes_ok).
//   - sweep_score stages its cells' rows of sums / max(count, 1) (the
//     plain version's mean_node) in shared memory, at an odd row stride
//     (no bank conflicts): 128 cells a block, 64 or 32 where V is larger
//     (the atlas's sMetaC fuses: V 506, 64 cells); where 32 rows of V do
//     not fit, it reads the sums from global memory and divides as it
//     goes. b walks the set bits of the live words, which are the same for
//     every thread of the block, so a cut's k live nodes cost k steps, not
//     V.
//   - sweep_median selects on the 32-bit order-preserving key of each
//     width (pad cells +inf, as the plain version's torch.where): four
//     passes of 8 bits, a shared histogram per pass. No size cap: every
//     pass walks the n widths of its row in global memory.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kNodesThreads = 512;
constexpr int kScoreThreads = 128;
constexpr int kMedianThreads = 256;
constexpr int kSmemMax = 232448;  // the opt-in limit of a block's shared memory
constexpr int kMaxGridY = 65535;

// ---- sweep_nodes ------------------------------------------------------------

template <typename OwnT>
__global__ void __launch_bounds__(kNodesThreads)
sweep_nodes(const int32_t* __restrict__ merges,  // (L, n-1, 2)
            const int32_t* __restrict__ labels,  // (L, ncand, n) dense cut labels
            const int32_t* __restrict__ n_real,  // (L,)
            const int32_t* __restrict__ c_fine,  // (L,) the finest cut scored
            float* __restrict__ sums,            // (L, n, V) in place: columns nc_pad..V-1
            float* __restrict__ counts,          // (L, V) in place
            float* __restrict__ centsum,         // (L, V, p) in place
            OwnT* __restrict__ own,              // (L, ncand, n) out
            uint32_t* __restrict__ live,         // (L, ncand, W) out
            int n, int p, int V, int W, int nc_pad, int minN, int ncand) {
  extern __shared__ uint32_t alive[];            // W words
  const int l = blockIdx.x;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int m = n - 1;
  const int cf = c_fine[l];
  const int nr = n_real[l];
  float* S = sums + (size_t)l * n * V;
  float* C = counts + (size_t)l * V;
  float* CS = centsum + (size_t)l * V * p;
  OwnT* O = own + (size_t)l * ncand * n;
  uint32_t* A = live + (size_t)l * ncand * W;
  const int32_t* fine = labels + ((size_t)l * ncand + cf) * n;
  const int32_t* mg = merges + (size_t)l * m * 2;

  for (int w = tid; w < W; w += nt) {
    uint32_t bits = 0;
    for (int b = 0; b < 32 && w * 32 + b < V; ++b) bits |= (C[w * 32 + b] > 0.5f ? 1u : 0u) << b;
    alive[w] = bits;
  }
  __syncthreads();

  for (int c = ncand - 1; c >= 0; --c) {
    OwnT* Oc = O + (size_t)c * n;
    if (c < cf) {
      // c < cf <= ncand - 1: row c + 1 holds the own nodes before this step
      const OwnT* prev = Oc + n;
      const int t = min(max(nr - (minN + c) - 1, 0), m - 1);
      // a merge's cells clamped into the lane: a malformed sequence (a
      // precomputed_link from outside) cannot read past it
      const int coli = prev[min(max(mg[2 * t], 0), n - 1)];
      const int colj = prev[min(max(mg[2 * t + 1], 0), n - 1)];
      const int nw = nc_pad + c;
      for (int r = tid; r < n; r += nt) {
        float* row = S + (size_t)r * V;
        row[nw] = row[coli] + row[colj];
      }
      if (tid == 0) C[nw] = C[coli] + C[colj];
      for (int q = tid; q < p; q += nt) CS[(size_t)nw * p + q] = CS[(size_t)coli * p + q] + CS[(size_t)colj * p + q];
      for (int x = tid; x < n; x += nt) {
        const int o = prev[x];
        Oc[x] = (OwnT)(o == coli || o == colj ? nw : o);
      }
      for (int w = tid; w < W; w += nt) {
        uint32_t bits = alive[w];
        if (coli >> 5 == w) bits &= ~(1u << (coli & 31));
        if (colj >> 5 == w) bits &= ~(1u << (colj & 31));
        if (nw >> 5 == w) bits |= 1u << (nw & 31);
        alive[w] = bits;
      }
    } else {
      for (int x = tid; x < n; x += nt) Oc[x] = (OwnT)fine[x];
    }
    for (int w = tid; w < W; w += nt) A[(size_t)c * W + w] = alive[w];
    __syncthreads();
  }

  // the live nodes: alive and non-empty once every count is final
  for (int w = tid; w < W; w += nt) {
    uint32_t ok = 0;
    for (int b = 0; b < 32 && w * 32 + b < V; ++b) ok |= (C[w * 32 + b] > 0.5f ? 1u : 0u) << b;
    for (int c = 0; c < ncand; ++c) A[(size_t)c * W + w] &= ok;
  }
}

// ---- sweep_score ------------------------------------------------------------

template <typename OwnT>
__global__ void __launch_bounds__(kScoreThreads)
sweep_score(const float* __restrict__ sums,       // (L, n, V)
            const float* __restrict__ counts,     // (L, V)
            const float* __restrict__ fc,         // (L, n, V) corr(cell, node centroid)
            const OwnT* __restrict__ own,         // (L, ncand, n)
            const uint32_t* __restrict__ live,    // (L, ncand, W)
            const uint8_t* __restrict__ real,     // (L, n) bool
            float* __restrict__ width,            // (L, ncand, n) out
            float* __restrict__ wterm,            // (L, ncand, n) out
            int n, int V, int W, int ncand, int stride) {  // stride 0: no staged rows
  extern __shared__ float tile[];                 // (blockDim.x, stride) mean distances
  const int l = blockIdx.y;
  const int i0 = blockIdx.x * blockDim.x;
  const int tid = threadIdx.x;
  const int i = i0 + tid;
  const float* S = sums + (size_t)l * n * V;
  const float* C = counts + (size_t)l * V;
  if (stride) {
    const int rows = min((int)blockDim.x, n - i0);
    for (int e = tid; e < rows * V; e += blockDim.x) {
      const int r = e / V;
      const int v = e - r * V;
      tile[r * stride + v] = S[(size_t)(i0 + r) * V + v] / fmaxf(C[v], 1.0f);
    }
    __syncthreads();
  }
  if (i >= n) return;
  const float* srow = S + (size_t)i * V;
  const float* mrow = tile + tid * stride;
  const float* frow = fc + ((size_t)l * n + i) * V;
  const bool is_real = real[(size_t)l * n + i] != 0;
  const float rm = is_real ? 1.0f : 0.0f;
  for (int c = 0; c < ncand; ++c) {
    const size_t at = ((size_t)l * ncand + c) * n + i;
    const int oc = (int)own[at];
    const float own_sum = srow[oc] * rm;
    const float own_count = C[oc] * rm;
    const float a = own_sum / fmaxf(own_count - 1.0f, 1.0f);
    float b = INFINITY;
    const uint32_t* lw = live + ((size_t)l * ncand + c) * W;
    for (int w = 0; w < W; ++w) {
      uint32_t bits = lw[w];
      if (oc >> 5 == w) bits &= ~(1u << (oc & 31));
      while (bits) {
        const int v = w * 32 + __ffs(bits) - 1;
        bits &= bits - 1;
        const float mean = stride ? mrow[v] : srow[v] / fmaxf(C[v], 1.0f);
        b = fminf(b, mean);
      }
    }
    float s = 0.0f;  // singleton, and k == 1 (no other live node)
    if (!(own_count <= 1.5f) && isfinite(b)) s = (b - a) / fmaxf(fmaxf(a, b), 1e-12f);
    width[at] = s;
    wterm[at] = is_real ? 1.0f - frow[oc] : 0.0f;
  }
}

// ---- sweep_median -----------------------------------------------------------

// order-preserving key of a float (no NaN reaches it)
__device__ __forceinline__ uint32_t key_of(float x) {
  const uint32_t u = __float_as_uint(x);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float float_of(uint32_t k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

// the k-th smallest (0-based) key of the row, pads +inf
__device__ uint32_t select_kth(const float* __restrict__ x, const uint8_t* __restrict__ real, int n, int k,
                               uint32_t* hist, int* found) {
  const int tid = threadIdx.x;
  const uint32_t pad = key_of(INFINITY);
  uint32_t prefix = 0, mask = 0;
  for (int shift = 24; shift >= 0; shift -= 8) {
    for (int b = tid; b < 256; b += blockDim.x) hist[b] = 0;
    __syncthreads();
    for (int i = tid; i < n; i += blockDim.x) {
      const uint32_t key = real[i] ? key_of(x[i]) : pad;
      if ((key & mask) == prefix) atomicAdd(&hist[(key >> shift) & 255u], 1u);
    }
    __syncthreads();
    if (tid == 0) {
      int below = 0, b = 0;
      while (b < 255 && below + (int)hist[b] <= k) below += hist[b++];
      found[0] = b;
      found[1] = below;
    }
    __syncthreads();
    prefix |= (uint32_t)found[0] << shift;
    mask |= 255u << shift;
    k -= found[1];
    __syncthreads();
  }
  return prefix;
}

// a block-wide sum in a fixed order: each thread's strided terms in turn,
// then a tree over the threads (blockDim.x a power of two)
__device__ float block_sum(float part, float* red) {
  const int tid = threadIdx.x;
  red[tid] = part;
  __syncthreads();
  for (int off = blockDim.x / 2; off > 0; off >>= 1) {
    if (tid < off) red[tid] += red[tid + off];
    __syncthreads();
  }
  const float total = red[0];
  __syncthreads();
  return total;
}

__global__ void __launch_bounds__(kMedianThreads)
sweep_median(const float* __restrict__ width,     // (L, ncand, n)
             const float* __restrict__ wterm,     // (L, ncand, n)
             const uint8_t* __restrict__ real,    // (L, n) bool
             const int32_t* __restrict__ n_real,  // (L,)
             const uint32_t* __restrict__ live,   // (L, ncand, W)
             const float* __restrict__ counts,    // (L, V)
             const float* __restrict__ corr_cg,   // (L, V)
             float* __restrict__ msil,            // (L, ncand) out
             float* __restrict__ ch,              // (L, ncand) out
             int n, int V, int W, int ncand, int minN) {
  __shared__ uint32_t hist[256];
  __shared__ int found[2];
  __shared__ float red[kMedianThreads];
  const int c = blockIdx.x;
  const int l = blockIdx.y;
  const int tid = threadIdx.x;
  const size_t row = (size_t)l * ncand + c;
  const float* x = width + row * n;
  const uint8_t* rm = real + (size_t)l * n;
  const int nv = n_real[l];
  // R's median: the mean of order statistics (nv - 1) // 2 and nv // 2
  const int k_lo = min(max(nv >= 1 ? (nv - 1) / 2 : 0, 0), n - 1);
  const int k_hi = min(max(nv / 2, 0), n - 1);
  const float lo = float_of(select_kth(x, rm, n, k_lo, hist, found));
  const float hi = k_hi == k_lo ? lo : float_of(select_kth(x, rm, n, k_hi, hist, found));

  const float* wt = wterm + row * n;
  float part = 0.0f;
  for (int i = tid; i < n; i += blockDim.x) part += wt[i];
  const float Wsum = block_sum(part, red);
  const uint32_t* lw = live + row * W;
  const float* C = counts + (size_t)l * V;
  const float* G = corr_cg + (size_t)l * V;
  part = 0.0f;
  for (int v = tid; v < V; v += blockDim.x) {
    if ((lw[v >> 5] >> (v & 31)) & 1u) part += C[v] * (1.0f - G[v]);
  }
  const float Bsum = block_sum(part, red);
  if (tid == 0) {
    msil[row] = 0.5f * (lo + hi);
    const float ks = (float)(minN + c);
    const float nrf = (float)nv;
    const float chc = (Bsum / fmaxf(ks - 1.0f, 1.0f)) / fmaxf(Wsum / fmaxf(nrf - ks, 1.0f), 1e-12f);
    ch[row] = (ks > 1.0f && nrf > ks) ? chc : 0.0f;
  }
}

template <typename OwnT>
int launch(const void* merges, const void* labels, const void* n_real, const void* c_fine, void* sums,
           void* counts, void* centsum, const void* fc, const void* real, const void* corr_cg, void* own,
           void* live, void* width, void* wterm, void* msil, void* ch, int L, int n, int p, int V,
           int nc_pad, int minN, int ncand, int stage, cudaStream_t stream) {
  const int W = (V + 31) / 32;
  cudaError_t err;
  if (stage == 0) {
    const int need = (n > p ? n : p);
    const int rounded = ((need + 31) / 32) * 32;
    const int threads = rounded < 64 ? 64 : (rounded > kNodesThreads ? kNodesThreads : rounded);
    const size_t smem = sizeof(uint32_t) * W;
    if (smem > 48 * 1024) {
      err = cudaFuncSetAttribute(sweep_nodes<OwnT>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err != cudaSuccess) return (int)err;
    }
    sweep_nodes<OwnT><<<L, threads, smem, stream>>>(
        (const int32_t*)merges, (const int32_t*)labels, (const int32_t*)n_real, (const int32_t*)c_fine,
        (float*)sums, (float*)counts, (float*)centsum, (OwnT*)own, (uint32_t*)live, n, p, V, W, nc_pad, minN,
        ncand);
  } else if (stage == 1) {
    // the most cells a block (128, 64 or 32) whose rows of V fit in shared
    // memory; none fit above V ~1,800: the rows are read from global memory
    int stride = V | 1;
    int threads = kScoreThreads;
    while (threads > 32 && sizeof(float) * (size_t)threads * stride > (size_t)kSmemMax) threads /= 2;
    size_t smem = sizeof(float) * (size_t)threads * stride;
    if (smem > (size_t)kSmemMax) {
      stride = 0;
      smem = 0;
      threads = kScoreThreads;
    }
    if (smem > 48 * 1024) {
      err = cudaFuncSetAttribute(sweep_score<OwnT>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err != cudaSuccess) return (int)err;
    }
    const dim3 grid((n + threads - 1) / threads, L);
    sweep_score<OwnT><<<grid, threads, smem, stream>>>(
        (const float*)sums, (const float*)counts, (const float*)fc, (const OwnT*)own, (const uint32_t*)live,
        (const uint8_t*)real, (float*)width, (float*)wterm, n, V, W, ncand, stride);
  } else {
    const dim3 grid(ncand, L);
    sweep_median<<<grid, kMedianThreads, 0, stream>>>(
        (const float*)width, (const float*)wterm, (const uint8_t*)real, (const int32_t*)n_real,
        (const uint32_t*)live, (const float*)counts, (const float*)corr_cg, (float*)msil, (float*)ch, n, V, W,
        ncand, minN);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// One stage of the sweep of L lanes at n_pad n, ncand candidates and V =
// nc_pad + ncand nodes (0 sweep_nodes, 1 sweep_score, 2 sweep_median), on
// `stream`. own_bytes (1, 2 or 4) is the own table's integer width. Pointers
// a stage does not read may be null. Shapes and dtypes as in the kernels
// above; real is (L, n) bool, n_real and c_fine (L,) int32.
extern "C" int sharp_sweep_launch(const void* merges, const void* labels, const void* n_real,
                                  const void* c_fine, void* sums, void* counts, void* centsum,
                                  const void* fc, const void* real, const void* corr_cg, void* own,
                                  void* live, void* width, void* wterm, void* msil, void* ch, int L,
                                  int n, int p, int V, int nc_pad, int minN, int ncand, int own_bytes,
                                  int stage, void* stream) {
  if (L <= 0) return 0;
  if (n < 2 || ncand < 1 || V != nc_pad + ncand || L > kMaxGridY || stage < 0 || stage > 2)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
#define SWEEP_ARGS merges, labels, n_real, c_fine, sums, counts, centsum, fc, real, corr_cg, own, live, width, \
                   wterm, msil, ch, L, n, p, V, nc_pad, minN, ncand, stage, s
  switch (own_bytes) {
    case 1: return launch<uint8_t>(SWEEP_ARGS);
    case 2: return launch<uint16_t>(SWEEP_ARGS);
    case 4: return launch<int32_t>(SWEEP_ARGS);
    default: return (int)cudaErrorInvalidValue;
  }
#undef SWEEP_ARGS
}
