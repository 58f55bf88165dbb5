// Squared group norms (mask scores, paper §2.1).
//
// Replaces group_norms_sq of src/repro/kernels/group_norms.py: x (G, C, K)
// -> out (G, C) f32, the sum of squares over the fan-in axis K.  The TPU
// kernel walks K sequentially into the output tile; here the fan-in of an
// output is cut into slices that run in parallel, and the partial sums are
// added in slice order (no float atomics), so the same input gives the
// same bits on every run.
//
// The scores are taken on weights moved into (G, C, K) order by a view
// (torch.movedim), so K is often not the minor axis and may be two dims:
// scoring a conv weight's output channels reads HWIO with C minor, a
// Mamba2 head's input weight is (G, 48, 1536, 64) with 64 contiguous
// values every 3072.  The kernels read the view's own element strides.
//
// Bound on an H100: bytes.  Each input element is read once (4 B, or 2 B
// for bf16) for one multiply-add; the output is G*C floats.  The largest
// views have few outputs (Mamba2: 384 of 98,304 terms each), so one warp
// an output, one 4-byte load in flight a lane, leaves most of the card
// idle.  The design keeps bytes in flight instead:
//
//   * The plan (kernels/group_norms.py: plan) is chosen on the host from
//     the view: layout, thread shape, slices of the fan-in, vector width.
//     A block of 256 threads reads one slice; the grid fills the 132 SMs.
//   * 16-byte loads (4 floats or 8 bf16) along the contiguous axis where
//     it and every other stride are aligned, scalar loads otherwise; each
//     thread issues four independent loads before it adds them.
//   * The fan-in is walked as rows (the strided dim) outer and columns
//     inner, each thread on a fixed arithmetic progression: no division
//     or wrap per element.
//   * K layout (the fan-in holds the contiguous axis, or no axis is
//     contiguous): a group of `group` threads (one or more warps) reduces
//     one output, 256 / group outputs a block.  Row walk: thread (tx, ty)
//     reads column tx of the rows ty, ty + ty_n, ... of its slice; column
//     walk (rows wider than the group): every row, columns tx, tx + tx_n,
//     ... of its slice of columns.
//   * C layout (channels contiguous): thread (tx, ty) reads the vector of
//     channels tx of the fan-in rows ty, ty + ty_n, ... of its slice; the
//     ty partials of a channel are added in ty order through shared
//     memory.
//   * Several slices: each block stores its partials; the last block of
//     an output block to finish (an integer counter of this library, reset
//     by that block for the next launch, so launches that slice must not
//     run at once on two streams) adds the partials of every slice in
//     slice order.  One slice: the block stores the result.
//
// Accumulation is in f32 with __fmaf_rn; within a thread the vector's
// lanes are separate sums, folded in a fixed order.
//
// Plain C interface (loaded with ctypes); the entry launches on the
// caller's stream and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kThreads = 256;
// output blocks a sliced launch may have (the plan slices only grids of
// fewer than 2112 blocks); their counters start at 0 with the library
constexpr int kCounters = 4096;
__device__ unsigned g_count[kCounters];

// The launch plan, as kernels/group_norms.py: plan lays it out.
struct Plan {
  int64_t layout;   // 0: K layout, 1: C layout
  int64_t vec;      // elements a load: 1, or 16 bytes' worth
  int64_t walk_rows;  // K layout: 1 row walk, 0 column walk
  int64_t G, C, sg, sc;
  int64_t rows, rs;   // the sliced (row) dim of the fan-in: count, stride
  int64_t cols, cs;   // K: columns in vectors, element stride; C: the
                      // inner fan-in dim, count and stride
  int64_t tx, ty;     // thread shape of an output group (K) or block (C)
  int64_t group;      // K: threads an output; C: channels a block
  int64_t slices, span;  // slices of the walked dim, its extent a slice
  int64_t blocks;     // grid.x: output blocks
};
constexpr int kPlanFields = 17;

__device__ __forceinline__ int64_t imin(int64_t a, int64_t b) {
  return a < b ? a : b;
}

template <typename T, int V>
struct Load;

template <>
struct Load<float, 1> {
  static __device__ __forceinline__ void run(const float* p, float (&f)[1]) {
    f[0] = __ldg(p);
  }
};
template <>
struct Load<float, 4> {
  static __device__ __forceinline__ void run(const float* p, float (&f)[4]) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(p));
    f[0] = v.x, f[1] = v.y, f[2] = v.z, f[3] = v.w;
  }
};
template <>
struct Load<__nv_bfloat16, 1> {
  static __device__ __forceinline__ void run(const __nv_bfloat16* p,
                                             float (&f)[1]) {
    f[0] = __bfloat162float(*p);
  }
};
template <>
struct Load<__nv_bfloat16, 8> {
  static __device__ __forceinline__ void run(const __nv_bfloat16* p,
                                             float (&f)[8]) {
    const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 t = __bfloat1622float2(h[i]);
      f[2 * i] = t.x, f[2 * i + 1] = t.y;
    }
  }
};

// acc[i] += sum of squares of lane i of the vectors at p + k * stride for
// k = first, first + step, ... < end, four loads issued before their adds.
template <typename T, int V>
__device__ __forceinline__ void walk(const T* __restrict__ p, int64_t k,
                                     int64_t end, int64_t step,
                                     int64_t stride, float (&acc)[V]) {
  for (; k + 3 * step < end; k += 4 * step) {
    float a[4][V];
#pragma unroll
    for (int u = 0; u < 4; ++u) Load<T, V>::run(p + (k + u * step) * stride,
                                                a[u]);
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int i = 0; i < V; ++i) acc[i] = __fmaf_rn(a[u][i], a[u][i], acc[i]);
  }
  for (; k < end; k += step) {
    float a[V];
    Load<T, V>::run(p + k * stride, a);
#pragma unroll
    for (int i = 0; i < V; ++i) acc[i] = __fmaf_rn(a[i], a[i], acc[i]);
  }
}

// Store output o's block total (held by the threads with `holder`).  With
// several slices the block stores its partial instead, and the last block
// of this output block to finish adds all the partials in slice order.
// Every thread of the block calls it.
__device__ __forceinline__ void finish(float total, bool holder, int64_t o,
                                       int64_t GC, int64_t slices,
                                       float* __restrict__ out,
                                       float* __restrict__ part) {
  __shared__ bool last;
  if (slices == 1) {
    if (holder) out[o] = total;
    return;
  }
  if (holder) part[blockIdx.y * GC + o] = total;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    last = atomicAdd(g_count + blockIdx.x, 1u) == (unsigned)(slices - 1);
  __syncthreads();
  if (!last) return;
  if (holder) {
    float sum = __ldcg(part + o);
#pragma unroll 4
    for (int64_t s = 1; s < slices; ++s)
      sum = __fadd_rn(sum, __ldcg(part + s * GC + o));
    out[o] = sum;
  }
  if (threadIdx.x == 0) g_count[blockIdx.x] = 0;   // for the next launch
}

// K layout: `group` threads an output, 256 / group outputs a block;
// blockIdx.y is the slice.
template <typename T, int V, bool ROWS>
__global__ void __launch_bounds__(kThreads)
    norms_k_kernel(const T* __restrict__ x, float* __restrict__ out,
                   float* __restrict__ part, Plan a) {
  __shared__ float warp_sum[kThreads / 32];
  const int t = threadIdx.x;
  const int lane = t % (int)a.group;
  const int tx = lane % (int)a.tx, ty = lane / (int)a.tx;
  const int64_t GC = a.G * a.C;
  const int64_t o = (int64_t)blockIdx.x * (kThreads / a.group) +
                    t / (int)a.group;
  float acc[V];
#pragma unroll
  for (int i = 0; i < V; ++i) acc[i] = 0.f;
  if (o < GC && ty < a.ty) {
    const T* xo = x + (o / a.C) * a.sg + (o % a.C) * a.sc;
    const int64_t lo = blockIdx.y * a.span;
    if (ROWS) {
      if (tx < a.cols)
        walk<T, V>(xo + tx * V * a.cs, lo + ty, imin(lo + a.span, a.rows),
                   a.ty, a.rs, acc);
    } else {
      const int64_t hi = imin(lo + a.span, a.cols);
      for (int64_t r = ty; r < a.rows; r += a.ty)
        walk<T, V>(xo + r * a.rs, lo + tx, hi, a.tx, V * a.cs, acc);
    }
  }
  float v = acc[0];
#pragma unroll
  for (int i = 1; i < V; ++i) v = __fadd_rn(v, acc[i]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, off));
  if ((t & 31) == 0) warp_sum[t >> 5] = v;
  __syncthreads();
  float total = 0.f;
  const bool holder = lane == 0 && o < GC;
  if (holder) {
    total = warp_sum[t >> 5];
    for (int w = 1; w < (int)a.group / 32; ++w)
      total = __fadd_rn(total, warp_sum[(t >> 5) + w]);
  }
  finish(total, holder, o, GC, a.slices, out, part);
}

// C layout: a block holds tx * V neighbouring channels of one g; thread
// (tx, ty) reads the channel vector tx at the fan-in rows ty, ty + ty_n,
// ... of slice blockIdx.y (and, for a second fan-in dim, all of it).
template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
    norms_c_kernel(const T* __restrict__ x, float* __restrict__ out,
                   float* __restrict__ part, Plan a) {
  __shared__ float tile_sum[kThreads * V];
  const int t = threadIdx.x;
  const int tx = t % (int)a.tx, ty = t / (int)a.tx;
  const int64_t tile_w = a.group;   // == tx_n * V
  const int64_t tiles = (a.C + tile_w - 1) / tile_w;
  const int64_t g = blockIdx.x / tiles, c0 = (blockIdx.x % tiles) * tile_w;
  const int64_t c = c0 + tx * V;
  float acc[V];
#pragma unroll
  for (int i = 0; i < V; ++i) acc[i] = 0.f;
  if (ty < a.ty && c < a.C) {
    const T* p = x + g * a.sg + c;
    const int64_t lo = blockIdx.y * a.span, hi = imin(lo + a.span, a.rows);
    if (a.cols == 1) {
      walk<T, V>(p, lo + ty, hi, a.ty, a.rs, acc);
    } else {
      for (int64_t r = lo + ty; r < hi; r += a.ty)
        walk<T, V>(p + r * a.rs, 0, a.cols, 1, a.cs, acc);
    }
  }
  if (ty < a.ty) {
#pragma unroll
    for (int i = 0; i < V; ++i) tile_sum[ty * tile_w + tx * V + i] = acc[i];
  }
  __syncthreads();
  float total = 0.f;
  const bool holder = t < tile_w && c0 + t < a.C;
  if (holder) {
    total = tile_sum[t];
    for (int y = 1; y < (int)a.ty; ++y)
      total = __fadd_rn(total, tile_sum[y * tile_w + t]);
  }
  finish(total, holder, g * a.C + c0 + t, a.G * a.C, a.slices, out, part);
}

template <typename T, int V>
void launch(const T* x, float* out, float* part, const Plan& a,
            cudaStream_t st) {
  const dim3 grid((unsigned)a.blocks, (unsigned)a.slices);
  if (a.layout == 1)
    norms_c_kernel<T, V><<<grid, kThreads, 0, st>>>(x, out, part, a);
  else if (a.walk_rows)
    norms_k_kernel<T, V, true><<<grid, kThreads, 0, st>>>(x, out, part, a);
  else
    norms_k_kernel<T, V, false><<<grid, kThreads, 0, st>>>(x, out, part, a);
}

}  // namespace

extern "C" {

// x: the view the plan describes, of an f32 (bf16 = 0) or bf16 (bf16 = 1)
// buffer; out: (G, C) f32 contiguous; part: slices * G * C f32 scratch
// (unused with one slice); plan: the kPlanFields int64 of
// kernels/group_norms.py: plan, in Plan's order.
int group_norms_sq(const void* x, float* out, float* part,
                   const int64_t* plan, int bf16, void* stream) {
  Plan a;
  static_assert(sizeof(Plan) == kPlanFields * sizeof(int64_t), "plan");
  memcpy(&a, plan, sizeof(Plan));
  if (a.G <= 0 || a.C <= 0) return (int)cudaSuccess;
  if (a.slices > 1 && a.blocks > kCounters)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  if (bf16) {
    const __nv_bfloat16* xb = (const __nv_bfloat16*)x;
    if (a.vec == 8) launch<__nv_bfloat16, 8>(xb, out, part, a, st);
    else launch<__nv_bfloat16, 1>(xb, out, part, a, st);
  } else {
    const float* xf = (const float*)x;
    if (a.vec == 4) launch<float, 4>(xf, out, part, a, st);
    else launch<float, 1>(xf, out, part, a, st);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
