// Squared group norms (mask scores, paper §2.1).
//
// Replaces group_norms_sq of src/repro/kernels/group_norms.py: x (G, C, K)
// -> out (G, C) f32, the sum of squares over the fan-in axis K.  The TPU
// kernel walks K sequentially into the output tile; here one output is
// reduced by a fixed set of threads in a fixed order (no atomics), so the
// same input gives the same bits on every run.
//
// The scores are taken on weights moved into (G, C, K) order by a view
// (torch.movedim), so K is often not the minor axis: scoring a conv
// weight's output channels reads HWIO with C minor, scoring its input
// channels gives a K of two dims (kernel taps, then output channels).  The
// kernel reads the view's own element strides, with K as up to two dims
// (K1, K2), instead of a contiguous copy.  Two layouts:
//
//   * C minor (stride 1): a block of 8 channels x 32 K-slices; thread (s,
//     c) sums the K positions s, s + 32, ... of channel c, so each warp
//     reads whole 32-byte runs of neighbouring channels; the 32 partial
//     sums are added in slice order through shared memory.  Narrow tiles
//     and many slices give even the widest conv leaf (4 x 512 outputs of
//     4,608 terms) 256 blocks of short loops.
//   * otherwise: one warp per output; lane l sums the positions l, l + 32,
//     ... (K minor reads are coalesced), then a fixed shuffle tree.
//
// Bound on an H100: bytes.  Each input element is read once (4 B, or 2 B
// for bf16) for one multiply-add; the output is G*C floats.  Inputs are
// f32 or bf16, accumulated in f32 with fused multiply-adds.
//
// Plain C interface (loaded with ctypes); the entry launches on the
// caller's stream and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 8;                   // channels of a C-minor block
constexpr int kSlices = kThreads / kTile;  // K-slices of a C-minor block

__device__ __forceinline__ float load(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

// Sum of squares of the positions first, first + step, ... of the
// flattened (K1, K2) fan-in at element strides (sk1, sk2) from xc, in
// that order.  A single fan-in dim (K1 == 1) is a plain strided loop; two
// dims walk a running offset that wraps from one K2 row to the next.
template <typename T>
__device__ __forceinline__ float sum_sq(const T* __restrict__ xc, int64_t K1,
                                        int64_t K2, int64_t sk1, int64_t sk2,
                                        int64_t first, int64_t step) {
  float acc = 0.f;
  if (K1 == 1) {
    for (int64_t k = first; k < K2; k += step) {
      const float v = load(xc + k * sk2);
      acc = __fmaf_rn(v, v, acc);
    }
    return acc;
  }
  const int64_t K = K1 * K2;
  int64_t k2 = first % K2;
  int64_t off = (first / K2) * sk1 + k2 * sk2;
  for (int64_t k = first; k < K; k += step) {
    const float v = load(xc + off);
    acc = __fmaf_rn(v, v, acc);
    k2 += step;
    off += step * sk2;
    while (k2 >= K2) {
      k2 -= K2;
      off += sk1 - K2 * sk2;
    }
  }
  return acc;
}

// C minor: a block takes kTile neighbouring channels of one g, thread
// (s, c) sums the K-slice s of channel c, so a warp reads 4 runs of 8
// neighbouring channels (whole 32-byte sectors) per step; the kSlices
// partial sums of a channel are added in slice order.
template <typename T>
__global__ void norms_c_minor_kernel(const T* __restrict__ x,
                                     float* __restrict__ out, int64_t C,
                                     int64_t K1, int64_t K2, int64_t sg,
                                     int64_t sk1, int64_t sk2) {
  __shared__ float part[kSlices][kTile];
  const int64_t tiles = (C + kTile - 1) / kTile;
  const int64_t g = blockIdx.x / tiles;
  const int cl = threadIdx.x % kTile, s = threadIdx.x / kTile;
  const int64_t c = (blockIdx.x % tiles) * kTile + cl;
  part[s][cl] = c < C ? sum_sq(x + g * sg + c, K1, K2, sk1, sk2, s, kSlices)
                      : 0.f;
  __syncthreads();
  if (s == 0 && c < C) {
    float total = part[0][cl];
    for (int i = 1; i < kSlices; ++i) total = __fadd_rn(total, part[i][cl]);
    out[g * C + c] = total;
  }
}

// Any other layout: one warp per output; lane l sums the positions l,
// l + 32, ... (K-minor reads are coalesced), then a fixed shuffle tree.
template <typename T>
__global__ void norms_warp_kernel(const T* __restrict__ x,
                                  float* __restrict__ out, int64_t G,
                                  int64_t C, int64_t K1, int64_t K2,
                                  int64_t sg, int64_t sc, int64_t sk1,
                                  int64_t sk2) {
  const int lane = threadIdx.x & 31;
  const int64_t o = (int64_t)blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);
  if (o >= G * C) return;
  const int64_t g = o / C, c = o % C;
  float acc = sum_sq(x + g * sg + c * sc, K1, K2, sk1, sk2, lane, 32);
  for (int off = 16; off > 0; off >>= 1)
    acc = __fadd_rn(acc, __shfl_xor_sync(0xffffffffu, acc, off));
  if (lane == 0) out[o] = acc;
}

template <typename T>
int launch(const void* x, float* out, int64_t G, int64_t C, int64_t K1,
           int64_t K2, int64_t sg, int64_t sc, int64_t sk1, int64_t sk2,
           cudaStream_t stream) {
  const T* xt = (const T*)x;
  if (sc == 1 && C > 1) {
    const int64_t blocks = G * ((C + kTile - 1) / kTile);
    norms_c_minor_kernel<T><<<(unsigned)blocks, kThreads, 0, stream>>>(
        xt, out, C, K1, K2, sg, sk1, sk2);
  } else {
    const int64_t per = kThreads / 32;
    const int64_t blocks = (G * C + per - 1) / per;
    norms_warp_kernel<T><<<(unsigned)blocks, kThreads, 0, stream>>>(
        xt, out, G, C, K1, K2, sg, sc, sk1, sk2);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x: the (G, C, K1, K2) view at element strides (sg, sc, sk1, sk2) of an
// f32 (bf16 = 0) or bf16 (bf16 = 1) buffer; out: (G, C) f32 contiguous.
int group_norms_sq(const void* x, float* out, int64_t G, int64_t C,
                   int64_t K1, int64_t K2, int64_t sg, int64_t sc,
                   int64_t sk1, int64_t sk2, int bf16, void* stream) {
  if (G <= 0 || C <= 0) return (int)cudaSuccess;
  const cudaStream_t st = (cudaStream_t)stream;
  return bf16 ? launch<__nv_bfloat16>(x, out, G, C, K1, K2, sg, sc, sk1, sk2,
                                      st)
              : launch<float>(x, out, G, C, K1, K2, sg, sc, sk1, sk2, st);
}

}  // extern "C"
