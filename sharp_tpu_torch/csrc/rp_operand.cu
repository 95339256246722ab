// The RP product's operand: log2(1 + x) of the float32 cells, rounded to
// bfloat16 or float16, in one pass.
//
// Replaces no TPU kernel: the JAX package leaves this pass to XLA, which
// fuses the log, the rounding and the product's operand load
// (sharp_tpu/ops/rp.py, `jnp.dot(..., preferred_element_type=float32)`).
// Without it the port made the operand in four passes over the group
// (the add, the log2, the rounding, a float32 copy for a SIMT product) and
// held three multi-GB intermediates; with it the product runs on the
// tensor cores (`torch.mm(..., out_dtype=torch.float32)`, ops/rp.py).
//
// out[r, c] = round_rn(log2f(1.0f + x[r, c]))  (or round_rn(x[r, c]) without
// the log) for c < cols, and exact zeros for cols <= c < cols_pad: the
// wrapper pads the gene axis to a multiple of 8 so that every row of the
// operand starts on 16 bytes, and pads R's rows with zeros to match. The
// float arithmetic is torch's `torch.log2(1.0 + x).to(dtype)` (the add
// rounded, then log2f, then round-to-nearest-even), so the operand is
// identical to the plain version `log2p1(X).to(dtype)`.
//
// What bounds it on an H100: bytes, 4 read and 2 written per element:
// (32,768 x 27,998) float32 in, (32,768 x 28,000) bf16 out, 5.5 GB a fold
// group, 1.64 ms at 3.35 TB/s.
//
// Design: each thread makes 8 consecutive outputs of one row and writes
// them as one 16-byte store, so a warp writes 512 contiguous bytes. Its 8
// inputs come as four float2 loads when every row starts on 8 bytes (cols
// even, as 27,998 is), else as single floats; the ragged last octet of a
// row loads element by element. The grid's x axis covers a row's octets,
// its y axis walks the rows. At the atlas's shape it reads 1.78 ms on an
// H100, 92% of its bound.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxGridY = 65535;

template <int VEC>
__device__ __forceinline__ void load8(const float* __restrict__ p, float v[8]) {
  if constexpr (VEC == 2) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 a = __ldg(reinterpret_cast<const float2*>(p) + i);
      v[2 * i] = a.x;
      v[2 * i + 1] = a.y;
    }
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i) v[i] = __ldg(p + i);
  }
}

__device__ __forceinline__ uint16_t round_to(float v, __nv_bfloat16*) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}

__device__ __forceinline__ uint16_t round_to(float v, __half*) {
  return __half_as_ushort(__float2half_rn(v));
}

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
rp_operand_kernel(const float* __restrict__ x, uint4* __restrict__ out, int64_t rows, int cols,
                  int octets, bool log_transform) {
  const int o = blockIdx.x * kThreads + threadIdx.x;
  if (o >= octets) return;
  const int c0 = o * 8;
  for (int64_t r = blockIdx.y; r < rows; r += gridDim.y) {
    const float* row = x + r * (int64_t)cols;
    float v[8];
    if (c0 + 8 <= cols) {
      load8<VEC>(row + c0, v);
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i) v[i] = c0 + i < cols ? __ldg(row + c0 + i) : 0.0f;
    }
    uint16_t h[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      // pads stay exact zeros: log2(1 + 0) is 0 too, but say so outright
      const float y = log_transform && c0 + i < cols ? log2f(1.0f + v[i]) : v[i];
      h[i] = round_to(y, static_cast<T*>(nullptr));
    }
    uint4 w;
    w.x = (uint32_t)h[0] | ((uint32_t)h[1] << 16);
    w.y = (uint32_t)h[2] | ((uint32_t)h[3] << 16);
    w.z = (uint32_t)h[4] | ((uint32_t)h[5] << 16);
    w.w = (uint32_t)h[6] | ((uint32_t)h[7] << 16);
    out[r * (int64_t)octets + o] = w;
  }
}

template <typename T>
int launch(const float* x, uint4* out, int64_t rows, int cols, int octets, bool log_transform,
           cudaStream_t s) {
  const dim3 grid((octets + kThreads - 1) / kThreads, (unsigned)(rows < kMaxGridY ? rows : kMaxGridY));
  if (cols % 2 == 0 && (uintptr_t)x % 8 == 0) {
    rp_operand_kernel<T, 2><<<grid, kThreads, 0, s>>>(x, out, rows, cols, octets, log_transform);
  } else {
    rp_operand_kernel<T, 1><<<grid, kThreads, 0, s>>>(x, out, rows, cols, octets, log_transform);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// x: (rows, cols) float32, contiguous; out: (rows, cols_pad) of 16-bit
// values, contiguous, cols_pad a multiple of 8 with cols <= cols_pad <
// cols + 8 and out on 16 bytes; kind 0 bfloat16, 1 float16.
extern "C" int sharp_rp_operand_launch(const void* x, void* out, long long rows, int cols,
                                       int cols_pad, int log_transform, int kind, void* stream) {
  if (rows <= 0) return 0;
  if (cols < 1 || cols_pad % 8 != 0 || cols_pad < cols || cols_pad >= cols + 8 ||
      (uintptr_t)out % 16 != 0 || (kind != 0 && kind != 1))
    return (int)cudaErrorInvalidValue;
  const float* xp = static_cast<const float*>(x);
  uint4* op = static_cast<uint4*>(out);
  const int octets = cols_pad / 8;
  const cudaStream_t s = (cudaStream_t)stream;
  return kind == 0 ? launch<__nv_bfloat16>(xp, op, rows, cols, octets, log_transform != 0, s)
                   : launch<__half>(xp, op, rows, cols, octets, log_transform != 0, s);
}
