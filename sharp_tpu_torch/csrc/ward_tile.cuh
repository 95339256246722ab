// The merge loop of serial Ward.D with an exact row cache, shared by
// serial Ward (ward_serial.cu) and the ladder's tail (rnn_tail.cu): one
// thread block drains one problem in the strict serial order of the plain
// full-argmin loop, the flat first-index minimum (smallest value, then row,
// then column) of the stored values.
//
// The scheme:
//   * An exact row cache, with no revalidation. For every live row k,
//     (rowmin[k], rowarg[k]) is the minimum of the stored row and the first
//     index holding it (dead and self entries read as BIG, as the plain loop
//     holds them), so the pop, one first-index argmin over rowmin, is the
//     flat first-index argmin of the whole matrix, ties included. Beside it
//     sits a runner-up: the least (value, index) entry of the row outside
//     rowarg[k], or "unknown".
//   * After merge (i, j), row k's entries change only at column i (the
//     fresh value nv) and column j (dead). Where the merge touched neither
//     its minimum nor its runner-up, the fresh entry can only pass one of
//     them. Otherwise the new minimum and runner-up are the two least of
//     the entries still known (nv, and the old minimum or runner-up where
//     they stand), kept only where they cannot be beaten by the rest of the
//     row: every other entry lies above the old runner-up (or the old
//     minimum, if the runner-up is unknown) in (value, index) order, and
//     the first kProbe columns after it are read for ties of its value (rows
//     of equal distances, such as the padded points', find their next
//     minimum there). A row whose minimum is still undetermined is rescanned
//     (one warp per row, all such rows at once); an undetermined runner-up
//     becomes unknown. Row i's cache is the argmin of its fresh row, its
//     runner-up unknown; row j dies.
//   * Row minima are double-buffered: merge t reads one buffer and writes
//     the other, so no thread sees a half-updated cache.
//   * A first-index argmin over a warp is two redux.sync instructions on an
//     order-preserving key of the value (ward_common.cuh), not a chain of
//     shuffles; the argmin updates are selects, not branches.
//   * The tile tier (n <= kTileMaxN): the matrix lives in shared memory as
//     its packed upper triangle (130,560 B in f32 at n = 256, half that in
//     bf16), one entry per pair, so a merge writes one value per pair and no
//     column. Every warp folds the whole cache for the pop itself, so a
//     merge takes two __syncthreads: after the fresh row, and after the
//     rescans.
//   * The global tier: the matrix stays in global memory (L2), row-major,
//     rows padded to a multiple of 8 entries. A merge reads rows i and j and
//     writes row i and column i, a thread per column. A rescan issues its
//     16-byte loads of the row in batches before it folds them. The pop
//     folds per-warp partials after a third barrier. This tier reads rows
//     only, so it also holds for a matrix that is not symmetric.
//   * The Lance-Williams formula
//       ((ni + nk) * dik + (nj + nk) * djk - nk * h) / (ni + nj + nk)
//     is spelled with __fadd_rn / __fmul_rn / __fsub_rn / __fdiv_rn in that
//     association order (ward_common.cuh), so no multiply-add is fused and
//     the division is IEEE, as in torch's separate elementwise ops.
//
// The caller fills the matrix (the tile or the global rows) and the sizes
// (0 for a row that is dead from the start), synchronises, and calls
// ward_merges with the number of merges and a record(t, i, j, h) that one
// thread calls for merge t (i < j, h its stored height).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "ward_common.cuh"

namespace sharp {

constexpr int kTileMaxN = 256;
constexpr int kWardMinThreads = 64;
constexpr int kWardMaxThreads = 1024;
// columns read for ties after a row's old runner-up (or minimum)
constexpr int kProbe = 4;
// 16-byte chunks a lane has in flight in a rescan of the global tier
constexpr int kBatch = 4;

// Built with -DWARD_PROFILE (scripts/profile_ward_serial.py), thread 0 of
// block 0 adds the clock cycles of each phase of every merge, and the
// rescans, into g_prof: pop, pick, fresh row, row i, rescans, count.
#ifdef WARD_PROFILE
__device__ unsigned long long g_prof[8];
#define PROF_MARK(slot)                      \
  if (tid == 0 && blockIdx.x == 0) {         \
    const unsigned long long t_ = clock64(); \
    g_prof[slot] += t_ - t0_;                \
    t0_ = t_;                                \
  }
#else
#define PROF_MARK(slot)
#endif

__host__ __device__ __forceinline__ size_t align16(size_t b) { return (b + 15) & ~size_t(15); }

// a thread per column, kWardMinThreads to kWardMaxThreads
inline int ward_threads(int n) {
  const int rounded = ((n + 31) / 32) * 32;
  return rounded < kWardMinThreads ? kWardMinThreads : (rounded > kWardMaxThreads ? kWardMaxThreads : rounded);
}

// shared memory of the packed upper triangle of an n x n matrix in T
template <typename T>
__host__ __device__ __forceinline__ size_t tile_bytes(int n) {
  return align16(sizeof(T) * (size_t)n * (n - 1) / 2);
}

// Offset such that the pair (a, b), a < b, sits at tri_row(a, n) + b of
// the packed upper triangle (row a holds columns a + 1 .. n - 1).
__device__ __forceinline__ int tri_row(int a, int n) { return a * (2 * n - a - 1) / 2 - a - 1; }

// A 16-byte chunk of stored entries as floats.
__device__ __forceinline__ void unpack(const uint4& u, float (&x)[4]) {
  x[0] = __uint_as_float(u.x);
  x[1] = __uint_as_float(u.y);
  x[2] = __uint_as_float(u.z);
  x[3] = __uint_as_float(u.w);
}

__device__ __forceinline__ void unpack(const uint4& u, float (&x)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float2 f = __bfloat1622float2(h[e]);
    x[2 * e] = f.x;
    x[2 * e + 1] = f.y;
  }
}

// The row cache and its scratch: the minima in two buffers; argmins,
// runner-up values and runner-up indices in one; sizes; the rescan list (the
// seven words per row, in shared memory up to n kStateSmemMaxN, above it in
// a global scratch); the per-warp partials of the pop and of row i (always
// in shared memory).
struct WardState {
  float* cmin;    // 2n: row minima, two buffers
  int* carg;      // n: first index of the minimum
  float* smin;    // n: runner-up value
  int* sarg;      // n: runner-up index, -1 unknown
  float* sizes;   // n; 0 once a row is dead
  int* todo;      // n: rows to rescan
  float* part_v;  // 32 per-warp partials of the pop
  int* part_i;
  float* row_v;   // 32 per-warp partials of row i
  int* row_i;
};

// the seven words per row, and the per-warp partials
__host__ __device__ __forceinline__ size_t ward_rows_bytes(int n) { return 7 * sizeof(float) * (size_t)n; }
constexpr size_t kWardPartBytes = 4 * 32 * 4;
// the most rows whose words fit beside the partials in the 227 KB of shared
// memory a block may opt in to (225 KB at 8192)
constexpr int kStateSmemMaxN = 8192;

__host__ __device__ __forceinline__ size_t ward_state_bytes(int n) {
  return ward_rows_bytes(n) + kWardPartBytes;
}

// rows: the seven words per row (shared or global memory); part: the
// partials (shared memory)
__device__ __forceinline__ WardState ward_state(unsigned char* rows, unsigned char* part, int n) {
  WardState s;
  s.cmin = reinterpret_cast<float*>(rows);
  s.carg = reinterpret_cast<int*>(s.cmin + 2 * n);
  s.smin = reinterpret_cast<float*>(s.carg + n);
  s.sarg = reinterpret_cast<int*>(s.smin + n);
  s.sizes = reinterpret_cast<float*>(s.sarg + n);
  s.todo = reinterpret_cast<int*>(s.sizes + n);
  s.part_v = reinterpret_cast<float*>(part);
  s.part_i = reinterpret_cast<int*>(s.part_v + 32);
  s.row_v = reinterpret_cast<float*>(s.part_i + 32);
  s.row_i = reinterpret_cast<int*>(s.row_v + 32);
  return s;
}

// all of the state in shared memory at p
__device__ __forceinline__ WardState ward_state(unsigned char* p, int n) {
  return ward_state(p, p + ward_rows_bytes(n), n);
}

// `steps` merges of one problem of n points (the tile tier: `tile` holds
// the packed upper triangle, n <= kTileMaxN; the global tier: `Wb` the rows,
// ldw apart, a multiple of 8 entries). Every thread of the block calls it.
template <typename T, bool kTile, typename Record>
__device__ __forceinline__ void ward_merges(T* tile, T* Wb, int n, int ldw, int steps,
                                            const WardState& st, Record record) {
  constexpr int E = 16 / sizeof(T);  // entries per 16-byte chunk
  __shared__ int ntodo[2];  // merge t counts its rescans in ntodo[t & 1]
  float* cmin = st.cmin;
  int* carg = st.carg;
  float* smin = st.smin;
  int* sarg = st.sarg;
  float* sizes = st.sizes;
  int* todo = st.todo;

  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = nt >> 5;
  const float big = stored<T>(kBig);
  const int nch = (n + E - 1) / E;  // 16-byte chunks of a row of the global tier

  // stored entry (r, c), r != c, as float32
  auto at = [&](int r, int c) -> float {
    if constexpr (kTile) {
      return Store<T>::load(tile[tri_row(min(r, c), n) + max(r, c)]);
    } else {
      return Store<T>::load(Wb[(size_t)r * ldw + c]);
    }
  };
  // the first-index top-2 of row r, in every lane; column r, column j and
  // dead columns read as BIG. sizes[i] and sizes[j] are not read (the
  // merge's bookkeeping may be writing them): column i is live.
  auto scan_row = [&](int r, int i, int j, float& v0, int& a0, float& v1, int& a1) {
    v0 = v1 = INFINITY;
    a0 = a1 = INT_MAX;
    auto live = [&](int c) {
      const float sc = sizes[c == i || c == j ? r : c];
      return (c != r) & (c != j) & ((c == i) | (sc > 0.0f));
    };
    if constexpr (kTile) {
      // every load in bounds (c clamped, (r, r) read as a neighbour and
      // discarded), so none waits on a branch
      float x[kTileMaxN / 32];
#pragma unroll
      for (int s = 0; s < kTileMaxN / 32; ++s) {
        const int c = min(lane + 32 * s, n - 1);
        x[s] = Store<T>::load(tile[max(tri_row(min(r, c), n) + max(r, c), 0)]);
      }
#pragma unroll
      for (int s = 0; s < kTileMaxN / 32; ++s) {
        const int c = lane + 32 * s;
        top2_add(v0, a0, v1, a1, c < n ? (live(min(c, n - 1)) ? x[s] : big) : INFINITY, c);
      }
    } else {
      const uint4* row = reinterpret_cast<const uint4*>(Wb + (size_t)r * ldw);
      for (int q0 = 0; q0 < nch; q0 += 32 * kBatch) {
        uint4 buf[kBatch];
#pragma unroll
        for (int b = 0; b < kBatch; ++b) {
          const int q = q0 + 32 * b + lane;
          if (q < nch) buf[b] = row[q];
        }
#pragma unroll
        for (int b = 0; b < kBatch; ++b) {
          const int q = q0 + 32 * b + lane;
          if (q < nch) {
            float x[E];
            unpack(buf[b], x);
#pragma unroll
            for (int e = 0; e < E; ++e) {
              const int c = q * E + e;
              top2_add(v0, a0, v1, a1, c < n ? (live(min(c, n - 1)) ? x[e] : big) : INFINITY, c);
            }
          }
        }
      }
    }
    warp_top2_redux(v0, a0, v1, a1);
  };

  if (tid < 2) ntodo[tid] = 0;
  for (int r = warp; r < n; r += nwarps) {
    float v0 = INFINITY, v1 = INFINITY;
    int a0 = INT_MAX, a1 = INT_MAX;
    if (sizes[r] > 0.0f) scan_row(r, -1, -1, v0, a0, v1, a1);
    if (lane == 0) {
      cmin[r] = v0;
      carg[r] = a0;
      smin[r] = v1;
      sarg[r] = a1;
    }
  }
  __syncthreads();
#ifdef WARD_PROFILE
  unsigned long long t0_ = clock64();
#endif

  for (int t = 0; t < steps; ++t) {
    // this merge reads the row minima from one buffer and writes the other
    const float* rmin = cmin + (t & 1) * n;
    float* wmin = cmin + ((t + 1) & 1) * n;

    // --- pop: the first-index argmin of the cache ------------------------
    float h = INFINITY;
    int i0 = INT_MAX;
    if constexpr (kTile) {
      float x[kTileMaxN / 32];
#pragma unroll
      for (int s = 0; s < kTileMaxN / 32; ++s) x[s] = lane + 32 * s < n ? rmin[lane + 32 * s] : INFINITY;
#pragma unroll
      for (int s = 0; s < kTileMaxN / 32; ++s) arg_min(h, i0, x[s], lane + 32 * s);
      warp_arg_min(h, i0);
    } else {
      for (int k = tid; k < n; k += nt) arg_min(h, i0, rmin[k], k);
      warp_arg_min(h, i0);
      if (lane == 0) {
        st.part_v[warp] = h;
        st.part_i[warp] = i0;
      }
      __syncthreads();
      h = lane < nwarps ? st.part_v[lane] : INFINITY;
      i0 = lane < nwarps ? st.part_i[lane] : INT_MAX;
      warp_arg_min(h, i0);
    }
    PROF_MARK(0)
    // carg[i0] is not written before the next barrier: the fresh row below
    // writes the cache of rows other than i and j only
    const int j0 = carg[i0];
    const int i = min(i0, j0);
    const int j = max(i0, j0);
    const float ni = sizes[i];
    const float nj = sizes[j];
    PROF_MARK(1)

    // --- the survivor's fresh row, folded into every row's cache ----------
    // Column k of the fresh row from dik and djk: stores row k's cache (or
    // queues its rescan) and returns nv, with its stored form in nv_st.
    auto fresh = [&](int k, float dik, float djk, T& nv_st) -> float {
      const float nk = sizes[k];
      if (k == i || k == j || !(nk > 0.0f)) {
        if (k != i) wmin[k] = INFINITY;  // dead: j now, or earlier
        nv_st = Store<T>::put(big);
        return big;
      }
      const float m1 = rmin[k];
      const int a1 = carg[k];
      const float m2 = smin[k];
      const int a2 = sarg[k];
      const bool has2 = a2 >= 0;
      // every entry of row k but the known ones lies above (mb, ab) in
      // (value, index) order
      const float mb = has2 ? m2 : m1;
      const int ab = has2 ? a2 : a1;
      // the merge touched the row's minimum or runner-up: read the columns
      // just after ab, where ties of mb would stand (rows of equal
      // distances, such as the padded points', find them there)
      const bool touched = a1 == i || a1 == j || a2 == i || a2 == j;
      float probe[kProbe];
      if (touched) {
#pragma unroll
        for (int s = 0; s < kProbe; ++s) {
          const int c = ab + 1 + s;
          probe[s] = c < n && c != k ? at(k, c) : INFINITY;
        }
      }
      nv_st = Store<T>::put(ward_lw(dik, djk, h, ni, nj, nk));
      const float nv = Store<T>::load(nv_st);
      if (!touched) {
        // the minimum and runner-up stay in place; the fresh entry may pass
        // either
        if (lex_le(nv, i, m1, a1)) {
          wmin[k] = nv;
          carg[k] = i;
          smin[k] = m1;
          sarg[k] = a1;
        } else {
          wmin[k] = m1;
          if (has2 && lex_le(nv, i, m2, a2)) {
            smin[k] = nv;
            sarg[k] = i;
          }
        }
        return nv;
      }
      // the two least known entries: the fresh one, and the old minimum and
      // runner-up where the merge left them in place
      float v0 = INFINITY, v1 = INFINITY;
      int c0 = INT_MAX, c1 = INT_MAX;
      top2_add(v0, c0, v1, c1, nv, i);
      if (a1 != i && a1 != j) top2_add(v0, c0, v1, c1, m1, a1);
      if (has2 && a2 != i && a2 != j) top2_add(v0, c0, v1, c1, m2, a2);
      int stop = ab;
      bool d0 = lex_le(v0, c0, mb, stop);
      bool d1 = lex_le(v1, c1, mb, stop);
      if (!d0 || (!d1 && has2)) {
        // the first (up to two) columns after ab that still hold mb are the
        // least unknown entries; the window's other columns hold more
        int hits = 0;
        stop = min(ab + kProbe, n - 1);
#pragma unroll
        for (int s = 0; s < kProbe; ++s) {
          const int c = ab + 1 + s;
          if (hits < 2 && probe[s] == mb && c != i && c != j && c != a1 && sizes[c] > 0.0f) {
            top2_add(v0, c0, v1, c1, mb, c);
            if (++hits == 2) stop = c;
          }
        }
        d0 = lex_le(v0, c0, mb, stop);
        d1 = lex_le(v1, c1, mb, stop);
      }
      if (d0) {
        wmin[k] = v0;
        carg[k] = c0;
        smin[k] = v1;
        sarg[k] = d1 ? c1 : -1;
      } else {
        todo[atomicAdd(&ntodo[t & 1], 1)] = k;
      }
      return nv;
    };

    float v0 = INFINITY;
    int a0 = INT_MAX;
    if constexpr (kTile) {
      for (int k = tid; k < n; k += nt) {
        if (k == i) {
          arg_min(v0, a0, big, k);
          continue;
        }
        const bool cand = k != j && sizes[k] > 0.0f;
        T nv_st;
        const float nv = fresh(k, cand ? at(i, k) : big, cand ? at(j, k) : big, nv_st);
        if (cand) tile[tri_row(min(i, k), n) + max(i, k)] = nv_st;
        arg_min(v0, a0, nv, k);
      }
    } else {
      T* rowi = Wb + (size_t)i * ldw;
      const T* rowj = Wb + (size_t)j * ldw;
      for (int k = tid; k < n; k += nt) {
        T nv_st;
        const float nv = fresh(k, Store<T>::load(rowi[k]), Store<T>::load(rowj[k]), nv_st);
        if (k != i && k != j && sizes[k] > 0.0f) {
          rowi[k] = nv_st;
          Wb[(size_t)k * ldw + i] = nv_st;
        }
        arg_min(v0, a0, nv, k);
      }
    }
    warp_arg_min(v0, a0);
    if (lane == 0) {
      st.row_v[warp] = v0;
      st.row_i[warp] = a0;
    }
    __syncthreads();
    PROF_MARK(2)

    // --- row i's cache, the bookkeeping, and the rescans -------------------
    if (warp == 0) {
      float u0 = lane < nwarps ? st.row_v[lane] : INFINITY;
      int b0 = lane < nwarps ? st.row_i[lane] : INT_MAX;
      warp_arg_min(u0, b0);
      if (lane == 0) {
        // row i's minimum; its runner-up is left unknown
        wmin[i] = u0;
        carg[i] = b0;
        sarg[i] = -1;
        sizes[i] = ni + nj;
        sizes[j] = 0.0f;
        ntodo[(t + 1) & 1] = 0;  // last read in merge t - 1, next written in t + 1
        record(t, i, j, h);
      }
    }
    const int nto = ntodo[t & 1];
#ifdef WARD_PROFILE
    if (tid == 0 && blockIdx.x == 0) g_prof[5] += nto;
#endif
    PROF_MARK(3)
    for (int q = warp; q < nto; q += nwarps) {
      const int r = todo[q];
      float u0, u1;
      int b0, b1;
      scan_row(r, i, j, u0, b0, u1, b1);
      if (lane == 0) {
        wmin[r] = u0;
        carg[r] = b0;
        smin[r] = u1;
        sarg[r] = b1;
      }
    }
    __syncthreads();
    PROF_MARK(4)
  }
}

}  // namespace sharp
