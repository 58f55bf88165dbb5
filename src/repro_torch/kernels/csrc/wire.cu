// The wire-format kernels: per-row symmetric quantization (q8), and the
// packed 4-bit format (q4) with its fused gather and unpack/dequantize.
//
// quantize_rows replaces the TPU kernel of src/repro/kernels/wire.py.  On
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
// The three q4 kernels below are described where they are defined.  Every
// entry point has a plain C interface (loaded with ctypes), launches on
// the caller's stream and returns cudaGetLastError().

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

// ---------------------------------------------------------------------------
// q4: two's-complement nibbles in [-7, 7], two columns per byte (the even
// column in the low nibble), one f32 scale max|row| / 7 + 1e-30 per row.
//
// Bound on an H100: bytes, like quantize_rows (a few operations per
// element; 4 B read and half a byte written per element).  Design: one
// warp per row, eight rows per 256-thread block.  Pass one reduces the
// row's abs-max with shuffles (NaN-propagating); pass two has each lane
// quantize the two neighbouring columns of one output byte and store the
// byte, so every byte is written whole by one thread and no nibble needs
// a read-modify-write.  The second read of the row comes from L1/L2.  The
// payload rows of the ResNet-18 consensus are 10 to 256 wide.  Scale and
// quotient use IEEE division and rintf (round half to even), as the plain
// PyTorch version and the reference do; a NaN quotient packs 0, as
// XLA's float-to-int32 convert followed by & 0xF gives.
// ---------------------------------------------------------------------------

__device__ __forceinline__ float q4_scale(float m) {
  return __fadd_rn(__fdiv_rn(m, 7.f), 1e-30f);
}

__device__ __forceinline__ unsigned q4_nibble(float v, float sc) {
  const float r = rintf(__fdiv_rn(v, sc));
  return r != r ? 0u : (unsigned)((int)fminf(fmaxf(r, -7.f), 7.f) & 0xF);
}

// Replaces quantize_pack_q4 of src/repro/kernels/wire.py: x (R, C) f32 ->
// p (R, ceil(C/2)) uint8, s (R, 1) f32.  An odd C gets a zero high nibble
// in its last byte.
__global__ void quantize_pack_q4_kernel(const float* __restrict__ x,
                                        uint8_t* __restrict__ p,
                                        float* __restrict__ s, int64_t R,
                                        int64_t C) {
  const int lane = threadIdx.x & 31;
  const int64_t row = (int64_t)blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5);
  if (row >= R) return;
  const float* xr = x + row * C;
  float m = 0.f;
  for (int64_t c = lane; c < C; c += 32) m = nan_max(m, fabsf(__ldg(xr + c)));
  for (int off = 16; off > 0; off >>= 1)
    m = nan_max(m, __shfl_xor_sync(0xffffffffu, m, off));
  const float sc = q4_scale(m);
  const int64_t Cp = (C + 1) >> 1;
  uint8_t* pr = p + row * Cp;
  for (int64_t j = lane; j < Cp; j += 32) {
    const int64_t c = 2 * j;
    const unsigned lo = q4_nibble(__ldg(xr + c), sc);
    const unsigned hi = c + 1 < C ? q4_nibble(__ldg(xr + c + 1), sc) : 0u;
    pr[j] = (uint8_t)(lo | (hi << 4));
  }
  if (lane == 0) s[row] = sc;
}

// Replaces gather_quantize_q4 of src/repro/kernels/wire.py: the q4 encode
// of x[:, idx] (x (R, C) f32, idx (B,) int64 in [0, C)) -> p (R,
// ceil(B/2)), s (R, 1), without materializing the gathered rows.  Each
// thread reads the indices of its own columns (cached by __ldg; every row
// of the block reads the same ones).
__global__ void gather_quantize_q4_kernel(const float* __restrict__ x,
                                          const int64_t* __restrict__ idx,
                                          uint8_t* __restrict__ p,
                                          float* __restrict__ s, int64_t R,
                                          int64_t C, int64_t B) {
  const int lane = threadIdx.x & 31;
  const int64_t row = (int64_t)blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5);
  if (row >= R) return;
  const float* xr = x + row * C;
  float m = 0.f;
  for (int64_t b = lane; b < B; b += 32)
    m = nan_max(m, fabsf(__ldg(xr + __ldg(idx + b))));
  for (int off = 16; off > 0; off >>= 1)
    m = nan_max(m, __shfl_xor_sync(0xffffffffu, m, off));
  const float sc = q4_scale(m);
  const int64_t Bp = (B + 1) >> 1;
  uint8_t* pr = p + row * Bp;
  for (int64_t j = lane; j < Bp; j += 32) {
    const int64_t b = 2 * j;
    const unsigned lo = q4_nibble(__ldg(xr + __ldg(idx + b)), sc);
    const unsigned hi =
        b + 1 < B ? q4_nibble(__ldg(xr + __ldg(idx + b + 1)), sc) : 0u;
    pr[j] = (uint8_t)(lo | (hi << 4));
  }
  if (lane == 0) s[row] = sc;
}

// Replaces unpack_gather_dequantize_q4 of src/repro/kernels/wire.py: p (R,
// Cp) uint8, s (R, 1), idx (Cout,) int64 into the unpacked channel space
// [0, 2*Cp) -> out (R, Cout) f32 = sign-extended nibble idx[j] of the row
// times its scale.  Output column j reads byte idx[j] >> 1, nibble
// idx[j] & 1.  With idx = arange(n) it is the plain decode (the pad nibble
// is never read); with the inverse index of a compact encode into p padded
// by one zero byte column, every dropped column reads a zero nibble of the
// pad byte, which is the zero-fill expansion without a scatter.  Bytes
// bound (half a byte read and 4 B written per element); one warp per row,
// the scale loaded once per row.
__global__ void unpack_gather_dequantize_q4_kernel(
    const uint8_t* __restrict__ p, const float* __restrict__ s,
    const int64_t* __restrict__ idx, float* __restrict__ out, int64_t R,
    int64_t Cp, int64_t Cout) {
  const int lane = threadIdx.x & 31;
  const int64_t row = (int64_t)blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5);
  if (row >= R) return;
  const uint8_t* pr = p + row * Cp;
  const float sc = __ldg(s + row);
  float* orow = out + row * Cout;
  for (int64_t j = lane; j < Cout; j += 32) {
    const int64_t i = __ldg(idx + j);
    const int n = (__ldg(pr + (i >> 1)) >> ((i & 1) << 2)) & 0xF;
    orow[j] = __fmul_rn((float)((n ^ 8) - 8), sc);
  }
}

unsigned row_blocks(int64_t R) {
  return (unsigned)((R + kRowsPerBlock - 1) / kRowsPerBlock);
}

}  // namespace

extern "C" {

int quantize_rows_f32(const float* x, int8_t* q, float* s, int64_t R,
                      int64_t C, int levels, void* stream) {
  if (R <= 0 || C <= 0) return (int)cudaSuccess;
  quantize_rows_kernel<<<row_blocks(R), 32 * kRowsPerBlock, 0,
                         (cudaStream_t)stream>>>(x, q, s, R, C,
                                                 (float)levels);
  return (int)cudaGetLastError();
}

int quantize_pack_q4_f32(const float* x, uint8_t* p, float* s, int64_t R,
                         int64_t C, void* stream) {
  if (R <= 0 || C <= 0) return (int)cudaSuccess;
  quantize_pack_q4_kernel<<<row_blocks(R), 32 * kRowsPerBlock, 0,
                            (cudaStream_t)stream>>>(x, p, s, R, C);
  return (int)cudaGetLastError();
}

int gather_quantize_q4_f32(const float* x, const int64_t* idx, uint8_t* p,
                           float* s, int64_t R, int64_t C, int64_t B,
                           void* stream) {
  if (R <= 0 || B <= 0) return (int)cudaSuccess;
  gather_quantize_q4_kernel<<<row_blocks(R), 32 * kRowsPerBlock, 0,
                              (cudaStream_t)stream>>>(x, idx, p, s, R, C, B);
  return (int)cudaGetLastError();
}

int unpack_gather_dequantize_q4_f32(const uint8_t* p, const float* s,
                                    const int64_t* idx, float* out,
                                    int64_t R, int64_t Cp, int64_t Cout,
                                    void* stream) {
  if (R <= 0 || Cout <= 0) return (int)cudaSuccess;
  unpack_gather_dequantize_q4_kernel<<<row_blocks(R), 32 * kRowsPerBlock, 0,
                                       (cudaStream_t)stream>>>(
      p, s, idx, out, R, Cp, Cout);
  return (int)cudaGetLastError();
}

}  // extern "C"
