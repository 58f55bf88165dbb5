// Per-row symmetric quantization of the q8 wire format, one pass per row.
//
// Replaces the TPU kernel quantize_rows of src/repro/kernels/wire.py.  On
// the (R, C) view of a payload leaf, for each row r:
//
//     s[r] = max_c |x[r, c]| / levels + 1e-30
//     q[r, c] = (int8) clamp(rint(x[r, c] / s[r]), -levels, levels)
//
// Bound on an H100: bytes.  Each element is read as f32 and written as one
// int8 (5 B), plus one f32 scale per row; the arithmetic is a handful of
// operations per element, far below the card's flop/byte balance point.
// Design: one warp per row (the payload rows of the ResNet consensus are
// 10 to 512 wide), eight rows per 256-thread block.  The warp reduces the
// row's abs-max in registers with shuffles (max is exact, so its order
// does not matter), then reads the row a second time, now from L1/L2, to
// quantize it.  The scale uses IEEE division and round-to-nearest add,
// and the quotient IEEE division plus rintf (round half to even), which
// makes the result bit-equal to the plain PyTorch version
// (``x / s`` with a tensor divisor, ``torch.round``).  Non-finite values
// follow the reference: a NaN anywhere in a row makes its abs-max and
// scale NaN (fmaxf would drop it), and a quotient that is NaN (from a NaN
// scale, or inf / inf) stores 0, as XLA's float-to-int8 convert does.
//
// Plain C interface (loaded with ctypes); launches on the caller's stream
// and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRowsPerBlock = 8;

// max that propagates NaN, as torch.amax and jnp.max do
__device__ __forceinline__ float nan_max(float m, float a) {
  return (a > m || a != a) ? a : m;
}

__global__ void quantize_rows_kernel(const float* __restrict__ x,
                                     int8_t* __restrict__ q,
                                     float* __restrict__ s, int64_t R,
                                     int64_t C, float levels) {
  const int lane = threadIdx.x & 31;
  const int64_t row = (int64_t)blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5);
  if (row >= R) return;
  const float* xr = x + row * C;
  float m = 0.f;
  for (int64_t c = lane; c < C; c += 32) m = nan_max(m, fabsf(__ldg(xr + c)));
  for (int off = 16; off > 0; off >>= 1)
    m = nan_max(m, __shfl_xor_sync(0xffffffffu, m, off));
  const float sc = __fadd_rn(__fdiv_rn(m, levels), 1e-30f);
  int8_t* qr = q + row * C;
  for (int64_t c = lane; c < C; c += 32) {
    const float v = rintf(__fdiv_rn(__ldg(xr + c), sc));
    qr[c] = v != v ? (int8_t)0
                   : (int8_t)(int)fminf(fmaxf(v, -levels), levels);
  }
  if (lane == 0) s[row] = sc;
}

}  // namespace

extern "C" {

int quantize_rows_f32(const float* x, int8_t* q, float* s, int64_t R,
                      int64_t C, int levels, void* stream) {
  if (R <= 0 || C <= 0) return (int)cudaSuccess;
  const int64_t blocks = (R + kRowsPerBlock - 1) / kRowsPerBlock;
  quantize_rows_kernel<<<(unsigned)blocks, 32 * kRowsPerBlock, 0,
                         (cudaStream_t)stream>>>(x, q, s, R, C,
                                                 (float)levels);
  return (int)cudaGetLastError();
}

}  // extern "C"
