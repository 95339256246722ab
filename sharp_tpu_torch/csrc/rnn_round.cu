// One round of the reciprocal-NN ladder on L lanes, its work sized by the
// round's real pairs and live lanes: three launches on the caller's stream.
//
// Replaces the TPU kernel sharp_tpu/ops/linkage_pallas.py:_round_scatter_kernel
// (entry `rnn_round_scatter`, :854) and the XLA round around it
// (sharp_tpu/ops/linkage.py:612-767). Output is identical to the plain round
// `rnn_round` (sharp_tpu_torch/ops/linkage.py): `RnnLadder.round` on the
// lanes `RnnLadder.active(nxt)` flags, then the row cache `W.min(dim=2)`.
//
// State per lane, updated in place: W (m, m) in float32 or bfloat16
// storage; alive (m) bool; sizes, lasth (m) float32; gidx (m) int64; the row
// cache rowmin (m) float32 and rowarg (m) int64 (each row's minimum over the
// stored values, compared in float32, and the first index that holds it);
// merges (n, 2) int32 and heights (n) float32; cnt and rounds int64.
//
//   1. rnn_pairs_select, one block a lane. active = cnt < n - 1, alive count
//      > nxt, rounds < n. The first P leads in index order (c alive, rowmin[c]
//      < BIG / 2, rowarg[rowarg[c]] == c, c < rowarg[c]) fill the pair slots
//      s: a, b = rowarg[a], h = rowmin[a], na, nb. Column codes: -2 dying
//      (b), s the survivor of slot s (a), -1 untouched. Bookkeeping: merges
//      and heights at cnt + s, hrec = max(h, lasth[a], lasth[b]) into
//      lasth[a], (gidx[0], gidx[0], BIG) into the discard slot n - 1 when
//      fewer than P slots are filled, alive[b] = 0, cnt += pairs, rounds +=
//      active.
//   2. rnn_pairs_rows, a few blocks a lane, one pair at a time: the pair's
//      fresh row F[s, c], the Lance-Williams update of rows a and b read as
//      rows (W is not symmetric bit for bit) against the old sizes, rounded
//      to the storage type; then its pair-pair entries E[s, t], the step of
//      merge t applied to that stored row (the serial association).
//   3. rnn_round_scatter, row strips: a survivor row takes F[s] with, in
//      pair columns, V[s, t] (E of the earlier merge of the two: smaller h,
//      then smaller a), and BIG in its own, dying and dead columns; a dying
//      row becomes BIG; any other live row takes F[t, r] in survivor columns
//      and BIG in dying columns, and nothing else of it is written; a dead
//      row is all BIG and stays so. The row cache: survivor rows from the
//      row they write; dying rows (BIG, 0); other live rows from the cached
//      (min, arg) and the touched columns, read again in full only when the
//      cached arg's column grew. In a lane whose pair columns (two a pair),
//      written one entry (one 32-byte sector) at a time, would cost a row's
//      bytes or more, the other live rows are read whole instead, their pair columns
//      replaced, only the 16-byte pieces that hold one written back, and
//      their minimum taken in the same pass. sizes[a] += nb.
// A lane with no pair (frozen, done, or not active) reads and writes nothing
// in launches 2 and 3; a launch whose lanes all have no pair returns at once.
//
// Exactness: the arithmetic is the plain round's float32 operations in its
// order, each rounded on its own (__fadd_rn, __fmul_rn, __fsub_rn,
// __fdiv_rn; ward_common.cuh), bfloat16 stores round to nearest even, and
// every comparison is in float32. The incremental row minimum is exact: the
// cached (v0, i0) is the least (value, index) of the old row, so it is the
// least of the untouched columns whenever i0 is one of them, and the least of
// all columns lies among the touched ones whenever column i0's new value is
// at most v0.
//
// What bounds it on an H100: bytes. A round needs rows a and b of each pair
// read once, the changed entries written once (2 m entries a pair for its
// rows, and each other live row's 2 entries a pair), and the rows whose
// cached minimum grew read again; the rest of W is not touched. The earlier
// whole-W kernel read and wrote all of W every round, frozen lanes included.
// With 128 pairs at m 2048 the pair columns touch most 32-byte sectors of
// every row, so such a round writes close to all of W either way.

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
using sharp::ward_lw;
using sharp::warp_arg_min;

constexpr int kSelThreads = 1024;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRowBlocks = 8;    // blocks a lane in rnn_pairs_rows
constexpr int kStripBlocks = 16; // most blocks a lane in rnn_round_scatter

// Per-lane pair slots, written by rnn_pairs_select (L, P each).
struct Pairs {
  int32_t* npairs;  // (L)
  int32_t* a;
  int32_t* b;
  float* h;
  float* na;
  float* nb;
};

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

template <int VEC>
__device__ __forceinline__ void load_codes(const int32_t* p, int (&cc)[VEC]) {
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

// Block-wide sum of one int per thread (kSelThreads threads); every thread
// gets the total. `red` holds kSelThreads / 32 ints of shared memory.
__device__ __forceinline__ int block_sum(int x, int* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  x = __reduce_add_sync(0xffffffffu, x);
  __syncthreads();  // red may still be read by the previous call
  if (lane == 0) red[warp] = x;
  __syncthreads();
  int t = lane < (kSelThreads >> 5) ? red[lane] : 0;
  return __reduce_add_sync(0xffffffffu, t);
}

__global__ void __launch_bounds__(kSelThreads)
    rnn_pairs_select(uint8_t* __restrict__ alive,          // (L, m)
                     const float* __restrict__ sizes,      // (L, m)
                     const int64_t* __restrict__ gidx,     // (L, m)
                     float* __restrict__ lasth,            // (L, m)
                     const float* __restrict__ rowmin,     // (L, m)
                     const int64_t* __restrict__ rowarg,   // (L, m)
                     int32_t* __restrict__ merges,         // (L, n, 2)
                     float* __restrict__ heights,          // (L, n)
                     int64_t* __restrict__ cnt,            // (L)
                     int64_t* __restrict__ rounds,         // (L)
                     Pairs pr, int32_t* __restrict__ code, // (L, m)
                     int m, int n, int nxt, int P) {
  __shared__ int red[kSelThreads / 32];
  const int l = blockIdx.x;
  const size_t lm = (size_t)l * m;
  const size_t lp = (size_t)l * P;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;

  int na = 0;
  for (int c = tid; c < m; c += kSelThreads) na += alive[lm + c] != 0;
  const int n_alive = block_sum(na, red);
  const int64_t cnt0 = cnt[l];
  const bool active = cnt0 < n - 1 && n_alive > nxt && rounds[l] < n;

  // the leads in index order, the first P of them into the slots
  int found = 0;
  if (active) {
    for (int base = 0; base < m && found < P; base += kSelThreads) {
      const int c = base + tid;
      bool lead = false;
      int64_t j = 0;
      if (c < m && alive[lm + c] && rowmin[lm + c] < 0.5f * kBig) {
        j = rowarg[lm + c];
        lead = c < j && rowarg[lm + j] == c;
      }
      const unsigned ball = __ballot_sync(0xffffffffu, lead);
      __syncthreads();  // red is read by the previous chunk
      if (lane == 0) red[warp] = __popc(ball);
      __syncthreads();
      int before = 0, total = 0;
      for (int w = 0; w < (kSelThreads >> 5); ++w) {
        const int k = red[w];
        before += w < warp ? k : 0;
        total += k;
      }
      const int rank = found + before + __popc(ball & ((1u << lane) - 1u));
      if (lead && rank < P) {
        pr.a[lp + rank] = c;
        pr.b[lp + rank] = (int32_t)j;
        pr.h[lp + rank] = rowmin[lm + c];
        pr.na[lp + rank] = sizes[lm + c];
        pr.nb[lp + rank] = sizes[lm + j];
      }
      found += total;
    }
  }
  const int np = min(found, P);
  __syncthreads();  // the slots are written

  // merges and heights at cnt + s, hrec into lasth[a] (pairs are disjoint,
  // so no other slot reads lasth[a] or lasth[b]); P may exceed the block
  for (int s = tid; s < np; s += kSelThreads) {
    const int32_t ia = pr.a[lp + s], ib = pr.b[lp + s];
    const float h = pr.h[lp + s];
    const float la = lasth[lm + ia], lb = lasth[lm + ib];
    const float lab = la < lb ? lb : la;
    const float hrec = h < lab ? lab : h;
    const size_t pos = (size_t)l * n + (size_t)(cnt0 + s);
    merges[2 * pos] = (int32_t)gidx[lm + ia];
    merges[2 * pos + 1] = (int32_t)gidx[lm + ib];
    heights[pos] = hrec;
    lasth[lm + ia] = hrec;
  }
  if (tid == 0 && np < P) {
    // the empty slots' writes of the plain round: (gidx[0], gidx[0], BIG)
    const size_t pos = (size_t)l * n + (n - 1);
    const int32_t g0 = (int32_t)gidx[lm];
    merges[2 * pos] = g0;
    merges[2 * pos + 1] = g0;
    heights[pos] = kBig;
  }
  if (tid == 0) {
    pr.npairs[l] = np;
    cnt[l] = cnt0 + np;
    rounds[l] += active ? 1 : 0;
  }
  if (np == 0) return;
  for (int c = tid; c < m; c += kSelThreads) code[lm + c] = -1;
  __syncthreads();
  for (int s = tid; s < np; s += kSelThreads) {
    const int32_t ib = pr.b[lp + s];
    alive[lm + ib] = 0;
    code[lm + pr.a[lp + s]] = s;
    code[lm + ib] = -2;
  }
}

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
    rnn_pairs_rows(const T* __restrict__ W,          // (L, m, m)
                   const float* __restrict__ sizes,  // (L, m), before the round
                   Pairs pr,
                   T* __restrict__ F,                // (L, P, m)
                   float* __restrict__ E,            // (L, P, P)
                   int m, int P) {
  const int l = blockIdx.y;
  const int np = pr.npairs[l];
  const size_t lm = (size_t)l * m;
  const size_t lp = (size_t)l * P;
  const int nvec = m / VEC;
  for (int s = blockIdx.x; s < np; s += gridDim.x) {
    const int a = pr.a[lp + s], b = pr.b[lp + s];
    const float h = pr.h[lp + s], na = pr.na[lp + s], nb = pr.nb[lp + s];
    const T* Wa = W + (lm + a) * m;
    const T* Wb = W + (lm + b) * m;
    T* Fs = F + (lp + s) * m;
    for (int q = threadIdx.x; q < nvec; q += kThreads) {
      const int c0 = q * VEC;
      T xa[VEC], xb[VEC], out[VEC];
      load_vec<T, VEC>(Wa + c0, xa);
      load_vec<T, VEC>(Wb + c0, xb);
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const float v = ward_lw(Store<T>::load(xa[e]), Store<T>::load(xb[e]), h, na, nb,
                                sizes[lm + c0 + e]);
        out[e] = Store<T>::put(v);
      }
      store_vec<T, VEC>(Fs + c0, out);
    }
    __syncthreads();  // the stored row is visible to the block
    const float ne = __fadd_rn(na, nb);
    for (int t = threadIdx.x; t < np; t += kThreads) {
      const float ra = Store<T>::load(Fs[pr.a[lp + t]]);
      const float rb = Store<T>::load(Fs[pr.b[lp + t]]);
      const float nat = pr.na[lp + t], nbt = pr.nb[lp + t];
      const float num = __fsub_rn(__fadd_rn(__fmul_rn(__fadd_rn(nat, ne), ra),
                                            __fmul_rn(__fadd_rn(nbt, ne), rb)),
                                  __fmul_rn(ne, pr.h[lp + t]));
      const float den = fmaxf(__fadd_rn(__fadd_rn(nat, nbt), ne), 1e-9f);
      E[(lp + s) * P + t] = __fdiv_rn(num, den);
    }
    __syncthreads();
  }
}

// V[s, t] of the plain round: E of the earlier of merges s and t
__device__ __forceinline__ float pair_entry(const float* El, const float* hl, const int32_t* al,
                                            int s, int t, int P) {
  const float hs = hl[s], ht = hl[t];
  const bool earlier = (hs < ht) | ((hs == ht) & (al[s] < al[t]));
  return earlier ? El[(size_t)s * P + t] : El[(size_t)t * P + s];
}

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
    rnn_round_scatter(T* __restrict__ W,                    // (L, m, m), in place
                      const uint8_t* __restrict__ alive,    // (L, m), after select
                      float* __restrict__ sizes,            // (L, m)
                      Pairs pr,
                      const T* __restrict__ F,              // (L, P, m)
                      const float* __restrict__ E,          // (L, P, P)
                      const int32_t* __restrict__ code,     // (L, m)
                      float* __restrict__ rowmin,           // (L, m)
                      int64_t* __restrict__ rowarg,         // (L, m)
                      int m, int P, int strip) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int l = blockIdx.y;
  const int np = pr.npairs[l];
  if (np == 0) return;
  int32_t* sa = reinterpret_cast<int32_t*>(smem);         // P: the survivors
  int32_t* sb = sa + P;                                    // P: the dying
  T* fcol = reinterpret_cast<T*>(sb + P);                 // P * strip: F[t, r0 + j]

  const size_t lm = (size_t)l * m;
  const size_t lp = (size_t)l * P;
  const T big = Store<T>::put(kBig);
  const float bigf = Store<T>::load(big);
  // a lane whose pairs' columns would cost, written one entry at a time,
  // a row's bytes or more takes its other live rows whole (see below)
  const bool whole = 2 * np * 64 >= m * (int)sizeof(T);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int nvec = m / VEC;
  const T* Fl = F + lp * m;
  const float* El = E + lp * P;
  const float* hl = pr.h + lp;
  const int32_t* al = pr.a + lp;

  for (int t = threadIdx.x; t < np; t += kThreads) {
    sa[t] = pr.a[lp + t];
    sb[t] = pr.b[lp + t];
  }
  for (int r0 = blockIdx.x * strip; r0 < m; r0 += gridDim.x * strip) {
    const int nr = min(strip, m - r0);
    __syncthreads();  // the previous strip's columns are no longer read
    for (int k = threadIdx.x; k < np * strip; k += kThreads) {
      const int t = k / strip;
      const int j = k - t * strip;
      if (j < nr) fcol[k] = Fl[(size_t)t * m + r0 + j];
    }
    __syncthreads();

    for (int j = warp; j < nr; j += kWarps) {
      const int r = r0 + j;
      const int cr = code[lm + r];
      T* Wr = W + (lm + r) * m;
      float v = INFINITY;
      int arg = INT_MAX;
      if (cr == -2) {
        // merged away: the row is BIG
        T x[VEC];
#pragma unroll
        for (int e = 0; e < VEC; ++e) x[e] = big;
        for (int q = lane; q < nvec; q += 32) store_vec<T, VEC>(Wr + q * VEC, x);
        v = bigf;
        arg = 0;
      } else if (cr >= 0) {
        // survivor of slot cr: its fresh row, pair columns from V, BIG in
        // its own column and in dying and dead ones
        const T* Fs = Fl + (size_t)cr * m;
        for (int q = lane; q < nvec; q += 32) {
          const int c0 = q * VEC;
          T x[VEC];
          int cc[VEC];
          load_vec<T, VEC>(Fs + c0, x);
          load_codes<VEC>(code + lm + c0, cc);
#pragma unroll
          for (int e = 0; e < VEC; ++e) {
            const int c = c0 + e;
            if (cc[e] >= 0) x[e] = Store<T>::put(pair_entry(El, hl, al, cr, cc[e], P));
            if (c == r || !alive[lm + c]) x[e] = big;
            arg_min(v, arg, Store<T>::load(x[e]), c);
          }
          store_vec<T, VEC>(Wr + c0, x);
        }
        warp_arg_min(v, arg);
      } else if (!alive[lm + r]) {
        continue;  // dead: all BIG, its cache (BIG, 0) stands
      } else if (whole) {
        // untouched live row of a lane with many pairs: read whole, its
        // pair columns replaced (F[t, r] for survivors, BIG for the dying),
        // only the 16-byte pieces that hold one written back, and its
        // minimum from the same pass
        for (int q = lane; q < nvec; q += 32) {
          const int c0 = q * VEC;
          T x[VEC];
          int cc[VEC];
          load_vec<T, VEC>(Wr + c0, x);
          load_codes<VEC>(code + lm + c0, cc);
          bool changed = false;
#pragma unroll
          for (int e = 0; e < VEC; ++e) {
            if (cc[e] != -1) {
              x[e] = cc[e] >= 0 ? fcol[cc[e] * strip + j] : big;
              changed = true;
            }
            arg_min(v, arg, Store<T>::load(x[e]), c0 + e);
          }
          if (changed) store_vec<T, VEC>(Wr + c0, x);
        }
        warp_arg_min(v, arg);
      } else {
        // untouched live row: survivor columns take F[t, r], dying ones BIG
        for (int k = lane; k < 2 * np; k += 32) {
          const bool surv = k < np;
          const int c = surv ? sa[k] : sb[k - np];
          const T x = surv ? fcol[k * strip + j] : big;
          Wr[c] = x;
          arg_min(v, arg, Store<T>::load(x), c);
        }
        warp_arg_min(v, arg);
        const float v0 = rowmin[lm + r];
        const int i0 = (int)rowarg[lm + r];
        const int ci = code[lm + i0];
        const float now = ci == -2 ? bigf : (ci >= 0 ? Store<T>::load(fcol[ci * strip + j]) : v0);
        if (now > v0) {
          // the cached minimum's column grew: read the row again
          __syncwarp();
          v = INFINITY;
          arg = INT_MAX;
          for (int q = lane; q < nvec; q += 32) {
            const int c0 = q * VEC;
            T x[VEC];
            load_vec<T, VEC>(Wr + c0, x);
#pragma unroll
            for (int e = 0; e < VEC; ++e) arg_min(v, arg, Store<T>::load(x[e]), c0 + e);
          }
          warp_arg_min(v, arg);
        } else {
          arg_min(v, arg, v0, i0);
        }
      }
      if (lane == 0) {
        rowmin[lm + r] = v;
        rowarg[lm + r] = arg;
      }
    }
  }
  if (blockIdx.x == 0) {
    for (int t = threadIdx.x; t < np; t += kThreads) {
      sizes[lm + sa[t]] = __fadd_rn(sizes[lm + sa[t]], pr.nb[lp + t]);
    }
  }
}

// rows of W a block of rnn_round_scatter takes at a time: the strip's
// columns of every pair's fresh row sit in shared memory
int strip_rows(int P, size_t es) {
  for (int s = 64; s > 8; s /= 2) {
    if ((size_t)P * s * es + 8 * (size_t)P <= 96 * 1024) return s;
  }
  return 8;
}

template <typename T, int VEC>
int launch(void* W, void* alive, void* sizes, const void* gidx, void* lasth, void* rowmin,
           void* rowarg, void* merges, void* heights, void* cnt, void* rounds, const Pairs& pr,
           void* code, void* F, void* E, int L, int m, int n, int nxt, int P, cudaStream_t s) {
  rnn_pairs_select<<<L, kSelThreads, 0, s>>>(
      (uint8_t*)alive, (const float*)sizes, (const int64_t*)gidx, (float*)lasth,
      (const float*)rowmin, (const int64_t*)rowarg, (int32_t*)merges, (float*)heights,
      (int64_t*)cnt, (int64_t*)rounds, pr, (int32_t*)code, m, n, nxt, P);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const dim3 rgrid(min(P, kRowBlocks), L);
  rnn_pairs_rows<T, VEC><<<rgrid, kThreads, 0, s>>>((const T*)W, (const float*)sizes, pr, (T*)F,
                                                    (float*)E, m, P);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int strip = strip_rows(P, sizeof(T));
  const size_t smem = 2 * sizeof(int32_t) * (size_t)P + sizeof(T) * (size_t)P * strip;
  auto kernel = rnn_round_scatter<T, VEC>;
  if (smem > 48 * 1024) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 sgrid(min((m + strip - 1) / strip, kStripBlocks), L);
  kernel<<<sgrid, kThreads, smem, s>>>((T*)W, (const uint8_t*)alive, (float*)sizes, pr,
                                       (const T*)F, (const float*)E, (const int32_t*)code,
                                       (float*)rowmin, (int64_t*)rowarg, m, P, strip);
  return (int)cudaGetLastError();
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

}  // namespace

// ints: npairs (L), a, b (L, P); floats: h, na, nb (L, P); code (L, m) int32;
// F (L, P, m) in W's storage; E (L, P, P) float32.
extern "C" int sharp_rnn_round_launch(void* W, void* alive, void* sizes, const void* gidx,
                                      void* lasth, void* rowmin, void* rowarg, void* merges,
                                      void* heights, void* cnt, void* rounds, void* ints,
                                      void* floats, void* code, void* F, void* E, int L, int m,
                                      int n, int nxt, int P, int store, void* stream) {
  if (L <= 0 || m <= 0 || P <= 0) return 0;
  const cudaStream_t s = (cudaStream_t)stream;
  int32_t* iv = (int32_t*)ints;
  float* fv = (float*)floats;
  const size_t LP = (size_t)L * P;
  const Pairs pr{iv, iv + L, iv + L + LP, fv, fv + LP, fv + 2 * LP};
  const bool vec_ok = aligned16(W) && aligned16(F);
  if (store == 1) {
    if (vec_ok && m % 8 == 0) {
      return launch<__nv_bfloat16, 8>(W, alive, sizes, gidx, lasth, rowmin, rowarg, merges,
                                      heights, cnt, rounds, pr, code, F, E, L, m, n, nxt, P, s);
    }
    return launch<__nv_bfloat16, 1>(W, alive, sizes, gidx, lasth, rowmin, rowarg, merges, heights,
                                    cnt, rounds, pr, code, F, E, L, m, n, nxt, P, s);
  }
  if (vec_ok && m % 4 == 0) {
    return launch<float, 4>(W, alive, sizes, gidx, lasth, rowmin, rowarg, merges, heights, cnt,
                            rounds, pr, code, F, E, L, m, n, nxt, P, s);
  }
  return launch<float, 1>(W, alive, sizes, gidx, lasth, rowmin, rowarg, merges, heights, cnt,
                          rounds, pr, code, F, E, L, m, n, nxt, P, s);
}
