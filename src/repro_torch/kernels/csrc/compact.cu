// Kept-group gather (paper §4.4.1 packing, §4.4.3 zero-fill recovery).
//
// Replaces gather_groups of src/repro/kernels/compact.py, whose TPU kernel
// computes out[r, j] = x[r, idx[j]] on an (R, C) view.  This kernel takes
// the same gather on a (R, C, Q) view, with an index table (S, B):
//
//     out[r, j, q] = x[r, idx[s(r), j], q],   s(r) = (r / P) % S
//
// Q = 1 and S = 1 is the TPU kernel's (R, C) gather.  Q > 1 gathers along
// an axis that is not the minor one (a conv weight's input channels) in
// place, where the TPU path first moves the axis to the end; S > 1 gives
// each slice of a stacked leaf its own kept set (P rows per slice).  With
// an inverse index into a buffer padded by one zero channel it is the
// zero-fill expansion, so no scatter is needed.  A gather is an exact copy,
// so the result equals the plain PyTorch version bit for bit for any dtype;
// the kernel moves elements of 1, 2 or 4 bytes as unsigned integers.
//
// Bound on an H100: bytes.  Each output element is one read and one write
// (plus the index, cached), no arithmetic.  Design: one flat grid-stride
// loop over the output elements, so every shape fills the card the same
// way (the consensus's compactions range from 64-row GroupNorm leaves to
// 73,728-row conv leaves); neighbouring threads write neighbouring output
// elements, and read neighbouring inputs wherever Q > 1 or the kept set
// is dense.  Index arithmetic is 32-bit when every offset fits.
//
// Plain C interface (loaded with ctypes); the entry launches on the
// caller's stream and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <typename T, typename I>
__global__ void gather_kernel(const T* __restrict__ x,
                              const int32_t* __restrict__ idx,
                              T* __restrict__ out, I n, I C, I B, I Q, I S,
                              I P) {
  const I step = (I)gridDim.x * blockDim.x;
  for (I o = (I)blockIdx.x * blockDim.x + threadIdx.x; o < n; o += step) {
    I rj = o, q = 0;
    if (Q != 1) {
      rj = o / Q;
      q = o - rj * Q;
    }
    const I r = rj / B;
    const I j = rj - r * B;
    const I s = S == 1 ? 0 : (r / P) % S;
    const I c = (I)__ldg(idx + s * B + j);
    out[o] = __ldg(x + (r * C + c) * Q + q);
  }
}

template <typename T>
int launch(const void* x, const int32_t* idx, void* out, int64_t R,
           int64_t C, int64_t B, int64_t Q, int64_t S, int64_t P,
           cudaStream_t stream) {
  const int64_t n = R * B * Q;
  const int threads = 256;
  // enough blocks to cover every element once, capped so the grid-stride
  // loop keeps each of the 132 SMs at full occupancy
  int64_t blocks = (n + threads - 1) / threads;
  if (blocks > 132 * 8) blocks = 132 * 8;
  const int64_t most = R * C * Q > n ? R * C * Q : n;
  if (most + (int64_t)blocks * threads < ((int64_t)1 << 32)) {
    gather_kernel<T, uint32_t><<<(unsigned)blocks, threads, 0, stream>>>(
        (const T*)x, idx, (T*)out, (uint32_t)n, (uint32_t)C, (uint32_t)B,
        (uint32_t)Q, (uint32_t)S, (uint32_t)P);
  } else {
    gather_kernel<T, int64_t><<<(unsigned)blocks, threads, 0, stream>>>(
        (const T*)x, idx, (T*)out, n, C, B, Q, S, P);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x (R, C, Q) and out (R, B, Q) contiguous, elements of ``elem_bytes``
// bytes (1, 2 or 4); idx (S, B) int32 in [0, C).  Returns
// cudaErrorInvalidValue for another element size.
int gather_groups(const void* x, const int32_t* idx, void* out, int64_t R,
                  int64_t C, int64_t B, int64_t Q, int64_t S, int64_t P,
                  int elem_bytes, void* stream) {
  if (R <= 0 || B <= 0 || Q <= 0) return (int)cudaSuccess;
  const cudaStream_t st = (cudaStream_t)stream;
  switch (elem_bytes) {
    case 1: return launch<uint8_t>(x, idx, out, R, C, B, Q, S, P, st);
    case 2: return launch<uint16_t>(x, idx, out, R, C, B, Q, S, P, st);
    case 4: return launch<uint32_t>(x, idx, out, R, C, B, Q, S, P, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
