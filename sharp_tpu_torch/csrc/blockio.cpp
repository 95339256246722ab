// SBLK — sparse cell-block codec for the out-of-core streaming path.
//
// sharp_tpu_torch's copy of the JAX package's codec
// (sharp_tpu/native/blockio.cpp): the same file layout, functions and
// error codes. The reference streams RDS block files and pays R's
// single-threaded deserialize + densify on every block
// (R/SHARP_unlimited3.R:103-131). This codec mmaps a compact CSR container
// and densifies rows into the caller's buffer with a thread pool, off the
// GIL (driven via ctypes, sharp_tpu_torch/io/native.py). It is host code:
// g++ builds it, not nvcc.
//
// File layout (little-endian):
//   8  bytes  magic "SBLK1\0\0\0"
//   u32       dtype code: 0 = f32 values, 1 = u16 values (rounded counts)
//   u32       reserved
//   u64 x 3   n_rows, n_cols, nnz
//   i64 x (n_rows + 1)  indptr
//   i32 x nnz           column indices
//   val x nnz           values (f32 or u16)
//
// Build: g++ -O3 -shared -fPIC -pthread -std=c++17 blockio.cpp -o blockio.so
// (io/native.get_lib does this at first use).

#include <cstdint>
#include <cstring>
#include <cstdio>
#include <thread>
#include <vector>
#include <atomic>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

constexpr char kMagic[8] = {'S', 'B', 'L', 'K', '1', 0, 0, 0};

struct Header {
  char magic[8];
  uint32_t dtype;
  uint32_t reserved;
  uint64_t n_rows;
  uint64_t n_cols;
  uint64_t nnz;
};

struct Mapped {
  void* base = nullptr;
  size_t len = 0;
  int fd = -1;

  ~Mapped() {
    if (base && base != MAP_FAILED) munmap(base, len);
    if (fd >= 0) close(fd);
  }
};

int map_file(const char* path, Mapped* m) {
  m->fd = open(path, O_RDONLY);
  if (m->fd < 0) return 1;
  struct stat st;
  if (fstat(m->fd, &st) != 0) return 2;
  m->len = static_cast<size_t>(st.st_size);
  if (m->len < sizeof(Header)) return 3;
  m->base = mmap(nullptr, m->len, PROT_READ, MAP_PRIVATE, m->fd, 0);
  if (m->base == MAP_FAILED) return 4;
  return 0;
}

const Header* header_of(const Mapped& m) {
  const Header* h = reinterpret_cast<const Header*>(m.base);
  if (memcmp(h->magic, kMagic, 8) != 0) return nullptr;
  return h;
}

}  // namespace

extern "C" {

// Header query. Returns 0 on success.
int sblk_read_header(const char* path, uint64_t* n_rows, uint64_t* n_cols,
                     uint64_t* nnz, uint32_t* dtype) {
  Mapped m;
  if (int rc = map_file(path, &m)) return rc;
  const Header* h = header_of(m);
  if (!h) return 5;
  *n_rows = h->n_rows;
  *n_cols = h->n_cols;
  *nnz = h->nnz;
  *dtype = h->dtype;
  return 0;
}

// Densify the whole block into out[n_rows * n_cols] (row-major f32,
// caller-allocated, will be zero-filled here). Returns 0 on success.
int sblk_densify(const char* path, float* out, int n_threads) {
  Mapped m;
  if (int rc = map_file(path, &m)) return rc;
  const Header* h = header_of(m);
  if (!h) return 5;
  const uint64_t n = h->n_rows, g = h->n_cols, nnz = h->nnz;

  const char* p = reinterpret_cast<const char*>(m.base) + sizeof(Header);
  const int64_t* indptr = reinterpret_cast<const int64_t*>(p);
  p += sizeof(int64_t) * (n + 1);
  const int32_t* indices = reinterpret_cast<const int32_t*>(p);
  p += sizeof(int32_t) * nnz;
  const void* values = p;

  size_t expect = sizeof(Header) + sizeof(int64_t) * (n + 1) +
                  sizeof(int32_t) * nnz +
                  (h->dtype == 0 ? 4 : 2) * nnz;
  if (m.len < expect) return 6;
  if (static_cast<uint64_t>(indptr[n]) != nnz) return 7;

  if (n_threads <= 0)
    n_threads = static_cast<int>(std::thread::hardware_concurrency());
  if (n_threads < 1) n_threads = 1;
  const uint64_t rows_per = (n + n_threads - 1) / n_threads;

  std::atomic<int> err{0};
  std::vector<std::thread> workers;
  for (int ti = 0; ti < n_threads; ++ti) {
    workers.emplace_back([&, ti]() {
      const uint64_t r0 = ti * rows_per;
      const uint64_t r1 = std::min(n, r0 + rows_per);
      for (uint64_t r = r0; r < r1; ++r) {
        float* row = out + r * g;
        memset(row, 0, sizeof(float) * g);
        const int64_t a = indptr[r], b = indptr[r + 1];
        if (a < 0 || b < a || static_cast<uint64_t>(b) > nnz) {
          err.store(8);
          return;
        }
        if (h->dtype == 0) {
          const float* v = reinterpret_cast<const float*>(values);
          for (int64_t k = a; k < b; ++k) {
            const uint32_t c = static_cast<uint32_t>(indices[k]);
            if (c >= g) { err.store(9); return; }
            row[c] = v[k];
          }
        } else {
          const uint16_t* v = reinterpret_cast<const uint16_t*>(values);
          for (int64_t k = a; k < b; ++k) {
            const uint32_t c = static_cast<uint32_t>(indices[k]);
            if (c >= g) { err.store(9); return; }
            row[c] = static_cast<float>(v[k]);
          }
        }
      }
    });
  }
  for (auto& w : workers) w.join();
  return err.load();
}

// Densify a row range [row0, row1) into out[(row1-row0) * n_cols].
int sblk_densify_rows(const char* path, uint64_t row0, uint64_t row1,
                      float* out, int n_threads) {
  Mapped m;
  if (int rc = map_file(path, &m)) return rc;
  const Header* h = header_of(m);
  if (!h) return 5;
  if (row1 > h->n_rows || row0 > row1) return 10;
  const uint64_t g = h->n_cols, nnz = h->nnz;

  const char* p = reinterpret_cast<const char*>(m.base) + sizeof(Header);
  const int64_t* indptr = reinterpret_cast<const int64_t*>(p);
  p += sizeof(int64_t) * (h->n_rows + 1);
  const int32_t* indices = reinterpret_cast<const int32_t*>(p);
  p += sizeof(int32_t) * nnz;
  const void* values = p;

  const uint64_t n = row1 - row0;
  if (n_threads <= 0)
    n_threads = static_cast<int>(std::thread::hardware_concurrency());
  if (n_threads < 1) n_threads = 1;
  const uint64_t rows_per = (n + n_threads - 1) / n_threads;

  std::atomic<int> err{0};
  std::vector<std::thread> workers;
  for (int ti = 0; ti < n_threads; ++ti) {
    workers.emplace_back([&, ti]() {
      const uint64_t r0 = ti * rows_per;
      const uint64_t r1n = std::min(n, r0 + rows_per);
      for (uint64_t r = r0; r < r1n; ++r) {
        float* row = out + r * g;
        memset(row, 0, sizeof(float) * g);
        const int64_t a = indptr[row0 + r], b = indptr[row0 + r + 1];
        if (a < 0 || b < a || static_cast<uint64_t>(b) > nnz) {
          err.store(8);
          return;
        }
        if (h->dtype == 0) {
          const float* v = reinterpret_cast<const float*>(values);
          for (int64_t k = a; k < b; ++k) row[indices[k]] = v[k];
        } else {
          const uint16_t* v = reinterpret_cast<const uint16_t*>(values);
          for (int64_t k = a; k < b; ++k)
            row[indices[k]] = static_cast<float>(v[k]);
        }
      }
    });
  }
  for (auto& w : workers) w.join();
  return err.load();
}

}  // extern "C"
