// The wire-format kernels: per-row symmetric quantization (q8) with its
// fused gather+quantize and gather+dequantize, and the packed 4-bit format
// (q4) with its fused gather and unpack/dequantize.
//
// quantize_rows replaces the TPU kernel of src/repro/kernels/wire.py.  On
// the (R, C) view of a payload leaf, for each row r:
//
//     s[r] = max_c |x[r, c]| / levels + 1e-30
//     q[r, c] = (int8) clamp(rint(x[r, c] / s[r]), -levels, levels)
//
// Bound on an H100: bytes.  Each element is read as f32 and written as one
// int8 (5 B; 3 B from bf16 rows, which the TPU kernel takes too), plus one
// f32 scale per row; the arithmetic is a handful of
// operations per element, far below the card's flop/byte balance point.
// The payload rows run from 10 wide (ResNet) to 1536 (Mamba2's embedding,
// head and output projection, 213,450 rows a round), so the design adapts
// to C, as the wrapper's plan (kernels/wire.py: quantize_plan) chooses:
//
//   * L lanes a row (1 to 256, a power of two; 256 / L rows a block), so
//     a narrow row leaves no lane idle and a wide one spreads over several
//     warps;
//   * 16-byte loads and 4-byte stores of four int8 where C % 4 == 0 and
//     the base is 16-byte aligned (then every row is), scalar ones
//     otherwise;
//   * the row kept in registers between the abs-max and the quantize pass
//     (up to 6 vectors a lane: 6144 floats a row), so each element is
//     read from HBM once, with every load of a lane in flight at once; a
//     small view (latency-bound) takes one vector a lane, a large one
//     (bytes-bound) up to 6, which keeps enough warps resident to overlap
//     one row's loads with another's division; wider rows stream: one
//     warp a row, the second read from L1/L2.
//
// The abs-max is reduced with shuffles within the row's lanes (max is
// exact, so its order does not matter).  The scale uses IEEE division and
// round-to-nearest add, and the quotient IEEE division plus rintf (round
// half to even), which makes the result bit-equal to the plain PyTorch
// version (``x / s`` with a tensor divisor, ``torch.round``).  Non-finite
// values follow the reference: a NaN anywhere in a row makes its abs-max
// and scale NaN (fmaxf would drop it), and a quotient that is NaN (from a
// NaN scale, or inf / inf) stores 0, as XLA's float-to-int8 convert does.
//
// The row engines read a row through a loader (Dense: the quantizers;
// Kept: the fused gather encodes, which run the same engines over their
// kept columns).  The other kernels are described where they are defined.
// Every entry point has a plain C interface (loaded with ctypes), launches
// on the caller's stream and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRowsPerBlock = 8;
// the widest row whose kept columns a block stages in shared memory: 6
// vectors of four a lane at 256 lanes (kernels/wire.py: _lanes), 24 KB
constexpr int64_t kStagedCols = 256 * 6 * 4;

unsigned row_blocks(int64_t R) {
  return (unsigned)((R + kRowsPerBlock - 1) / kRowsPerBlock);
}

// lanes a power of two up to 256; nv 1, 2, 3, 4 or 6 vectors a lane, or 0
// (the row streams, one warp a row)
bool plan_ok(int lanes, int nv) {
  if (lanes < 1 || lanes > 256 || (lanes & (lanes - 1))) return false;
  return nv == 0 ? lanes == 32 : (nv >= 1 && nv <= 4) || nv == 6;
}

// max that propagates NaN, as torch.amax and jnp.max do
__device__ __forceinline__ float nan_max(float m, float a) {
  return (a > m || a != a) ? a : m;
}

// one q8 value: rint(v / sc) clamped to [-levels, levels]; a NaN quotient
// stores 0, as XLA's float-to-int8 convert does
__device__ __forceinline__ int8_t q8_value(float v, float sc, float levels) {
  const float r = rintf(__fdiv_rn(v, sc));
  return r != r ? (int8_t)0 : (int8_t)(int)fminf(fmaxf(r, -levels), levels);
}

// ---------------------------------------------------------------------------
// Row loaders: vector j of an n-wide output row, V consecutive output
// columns (V 4: four floats; V 2: a pair, its second column 0 past the
// row's end; V 1: one float).
// ---------------------------------------------------------------------------

// A bf16 value (its 16-bit word) as f32: exact.
__device__ __forceinline__ float bf_f32(uint32_t h) {
  return __uint_as_float(h << 16);
}

__device__ __forceinline__ float as_f32(float x) { return x; }
__device__ __forceinline__ float as_f32(uint16_t h) { return bf_f32(h); }

// Output column c reads column c of the source row (the quantizers), whose
// elements are f32 (T float) or bf16 words (T uint16_t, read as f32, as
// the TPU kernel's astype reads them; a vector of four is one 8-byte
// load).
template <class T>
struct DenseT {
  const T* x;
  int64_t ld;   // elements a source row
  __device__ __forceinline__ const T* row(int64_t r) const {
    return x + r * ld;
  }
  template <int V, int W>
  __device__ __forceinline__ void load(const T* xr, int64_t j, int64_t n,
                                       float (&v)[W]) const {
    if constexpr (V == 4 && sizeof(T) == 4) {
      const float4 t = __ldg(reinterpret_cast<const float4*>(xr + 4 * j));
      v[0] = t.x, v[1] = t.y, v[2] = t.z, v[3] = t.w;
    } else if constexpr (V == 4) {
      const uint2 t = __ldg(reinterpret_cast<const uint2*>(xr + 4 * j));
      v[0] = bf_f32(t.x & 0xffffu), v[1] = bf_f32(t.x >> 16);
      v[2] = bf_f32(t.y & 0xffffu), v[3] = bf_f32(t.y >> 16);
    } else if constexpr (V == 2) {
      v[0] = as_f32(__ldg(xr + 2 * j));
      v[1] = 2 * j + 1 < n ? as_f32(__ldg(xr + 2 * j + 1)) : 0.f;
    } else {
      v[0] = as_f32(__ldg(xr + j));
    }
  }
};
using Dense = DenseT<float>;

// Output column c reads column cols[c] of the source row (the fused gather
// encodes).  Staged (S): cols lie in shared memory as int32 and a vector
// reads its four with one 16-byte load; else they lie in device memory as
// the caller typed them (I) and are read one by one.  Four columns that
// are one run from a multiple of 4 take one 16-byte load of x where
// ``runs`` allows it (the host plan: C % 4 == 0 and x 16-byte aligned,
// so every row is); other columns take one load each.
// The source columns c[0..V) of output vector j, columns V j .. V j + V -
// 1 of ``cols``: staged in shared memory as int32 (S; V 4 reads its four
// with one 16-byte load) or in device memory as the caller typed them (I).
template <int V, class I, bool S>
__device__ __forceinline__ void kept_cols(const I* cols, int64_t j,
                                          int64_t (&c)[V]) {
  if constexpr (S && V == 4) {
    const int4 t = *reinterpret_cast<const int4*>(cols + 4 * j);
    c[0] = t.x, c[1] = t.y, c[2] = t.z, c[3] = t.w;
  } else {
#pragma unroll
    for (int k = 0; k < V; ++k) {
      if constexpr (S) c[k] = cols[V * j + k];
      else c[k] = __ldg(cols + V * j + k);
    }
  }
}

// four columns that are one run from a multiple of 4
__device__ __forceinline__ bool aligned_run(const int64_t (&c)[4]) {
  return (c[0] & 3) == 0 && c[1] == c[0] + 1 && c[2] == c[0] + 2 &&
         c[3] == c[0] + 3;
}

template <class I, bool S>
struct Kept {
  static_assert(!S || sizeof(I) == 4, "staged columns are int32");
  const float* x;
  int64_t ld;   // floats a source row
  const I* cols;
  int runs;
  __device__ __forceinline__ const float* row(int64_t r) const {
    return x + r * ld;
  }
  __device__ __forceinline__ int64_t col(int64_t k) const {
    if constexpr (S) return cols[k];
    else return __ldg(cols + k);
  }
  template <int V, int W>
  __device__ __forceinline__ void load(const float* xr, int64_t j, int64_t n,
                                       float (&v)[W]) const {
    if constexpr (V == 4) {
      int64_t c[4];
      kept_cols<4, I, S>(cols, j, c);
      if (runs && aligned_run(c)) {
        const float4 t = __ldg(reinterpret_cast<const float4*>(xr + c[0]));
        v[0] = t.x, v[1] = t.y, v[2] = t.z, v[3] = t.w;
      } else {
#pragma unroll
        for (int k = 0; k < 4; ++k) v[k] = __ldg(xr + c[k]);
      }
    } else if constexpr (V == 2) {
      v[0] = __ldg(xr + col(2 * j));
      v[1] = 2 * j + 1 < n ? __ldg(xr + col(2 * j + 1)) : 0.f;
    } else {
      v[0] = __ldg(xr + col(j));
    }
  }
};

// The kept columns of a fused gather encode (n of them), staged once a
// block in shared memory as int32: every row of the block reads the same
// ones.  Every thread of the block reaches the barrier.
template <class I>
__device__ __forceinline__ const int32_t* stage_cols(const I* __restrict__ idx,
                                                     int64_t n) {
  extern __shared__ __align__(16) int32_t kept_cols[];
  for (int64_t k = threadIdx.x; k < n; k += blockDim.x)
    kept_cols[k] = (int32_t)__ldg(idx + k);
  __syncthreads();
  return kept_cols;
}

// ---------------------------------------------------------------------------
// q8
// ---------------------------------------------------------------------------

template <int V>
__device__ __forceinline__ void store_q8(int8_t* p, const float (&v)[V],
                                         float sc, float levels) {
  if constexpr (V == 4) {
    *reinterpret_cast<char4*>(p) =
        make_char4(q8_value(v[0], sc, levels), q8_value(v[1], sc, levels),
                   q8_value(v[2], sc, levels), q8_value(v[3], sc, levels));
  } else {
#pragma unroll
    for (int k = 0; k < V; ++k) p[k] = q8_value(v[k], sc, levels);
  }
}

// Rows held in registers: L lanes a row (a power of two up to 256: 256 / L
// rows a block), lane l of a row holding its vectors l, l + L, ... (NV of
// them at most, V floats each; n output columns a row), loaded at once,
// reduced (shuffles within a warp, then shared memory across the row's
// warps), quantized, stored.
template <int NV, int V, class Ld>
__device__ __forceinline__ void q8_rows(const Ld& ld, int8_t* __restrict__ q,
                                        float* __restrict__ s, int64_t R,
                                        int64_t n, int L, float levels,
                                        float* warp_max) {
  const int sub = threadIdx.x & (L - 1);
  const int64_t row = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) / L;
  const bool active = row < R;
  const int64_t nvec = n / V;
  // no load is conditional, so all of a lane's loads are issued before
  // the first is used: past the row's end a lane reads its last vector
  // again, and a row past R reads row R - 1 (neither is counted or stored)
  const auto* xr = ld.row(active ? row : R - 1);
  float v[NV][V];
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int64_t j = sub + (int64_t)i * L;
    ld.template load<V>(xr, j < nvec ? j : nvec - 1, n, v[i]);
  }
  float m = 0.f;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const bool in = sub + (int64_t)i * L < nvec;
#pragma unroll
    for (int k = 0; k < V; ++k) m = nan_max(m, in ? fabsf(v[i][k]) : 0.f);
  }
  for (int off = (L < 32 ? L : 32) >> 1; off > 0; off >>= 1)
    m = nan_max(m, __shfl_xor_sync(0xffffffffu, m, off));
  if (L > 32) {   // uniform: every thread reaches the barrier
    if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = m;
    __syncthreads();
    const int w0 = (threadIdx.x & ~(L - 1)) >> 5;   // the row's first warp
    m = warp_max[w0];
    for (int w = 1; w < L / 32; ++w) m = nan_max(m, warp_max[w0 + w]);
  }
  if (!active) return;
  const float sc = __fadd_rn(__fdiv_rn(m, levels), 1e-30f);
  int8_t* qr = q + row * n;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int64_t j = sub + (int64_t)i * L;
    if (j < nvec) store_q8<V>(qr + j * V, v[i], sc, levels);
  }
  if (sub == 0) s[row] = sc;
}

// Rows wider than the registers hold: one warp a row, eight rows a block;
// the abs-max pass keeps four loads of a lane in flight, the quantize pass
// reads the row again (from L1/L2).
template <int V, class Ld>
__device__ __forceinline__ void q8_stream(const Ld& ld, int8_t* __restrict__ q,
                                          float* __restrict__ s, int64_t R,
                                          int64_t n, float levels) {
  const int lane = threadIdx.x & 31;
  const int64_t row = (int64_t)blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5);
  if (row >= R) return;
  const int64_t nvec = n / V;
  const auto* xr = ld.row(row);
  float m = 0.f;
  int64_t j = lane;
  for (; j + 96 < nvec; j += 128) {
    float v[4][V];
#pragma unroll
    for (int u = 0; u < 4; ++u) ld.template load<V>(xr, j + 32 * u, n, v[u]);
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int k = 0; k < V; ++k) m = nan_max(m, fabsf(v[u][k]));
  }
  for (; j < nvec; j += 32) {
    float v[V];
    ld.template load<V>(xr, j, n, v);
#pragma unroll
    for (int k = 0; k < V; ++k) m = nan_max(m, fabsf(v[k]));
  }
  for (int off = 16; off > 0; off >>= 1)
    m = nan_max(m, __shfl_xor_sync(0xffffffffu, m, off));
  const float sc = __fadd_rn(__fdiv_rn(m, levels), 1e-30f);
  int8_t* qr = q + row * n;
  for (j = lane; j < nvec; j += 32) {
    float v[V];
    ld.template load<V>(xr, j, n, v);
    store_q8<V>(qr + j * V, v, sc, levels);
  }
  if (lane == 0) s[row] = sc;
}

template <int NV, int V, class T>
__global__ void __launch_bounds__(256)
    quantize_rows_kernel(const T* __restrict__ x, int8_t* __restrict__ q,
                         float* __restrict__ s, int64_t R, int64_t C, int L,
                         float levels) {
  __shared__ float warp_max[8];
  q8_rows<NV, V>(DenseT<T>{x, C}, q, s, R, C, L, levels, warp_max);
}

template <int V, class T>
__global__ void __launch_bounds__(256)
    quantize_rows_kernel_stream(const T* __restrict__ x,
                                int8_t* __restrict__ q,
                                float* __restrict__ s, int64_t R, int64_t C,
                                float levels) {
  q8_stream<V>(DenseT<T>{x, C}, q, s, R, C, levels);
}

// Replaces gather_quantize of src/repro/kernels/wire.py: the q8 encode of
// x[:, idx] (x (R, C) f32, idx (B,) int32 in [0, C)) -> q (R, B) int8, s
// (R, 1) f32, the compact+q8 encode in one pass without materializing the
// gathered rows.  Bytes bound: each kept element read once (4 B) and
// written once (1 B).  It runs quantize_rows's engines over the B kept
// columns, with their plan (kernels/wire.py: gather_quantize_plan): the
// row's kept elements held in registers between the abs-max and the
// quantize, every load of a lane issued before the first use, char4
// stores where B % 4 == 0.  The rules keep whole groups of channels
// (ResNet: 8, 32 contiguous bytes of a row), so a vector of four kept
// columns is mostly one aligned run: one 16-byte load.  The columns are
// staged once a block in shared memory; rows too wide for the registers
// stream and read their columns from device memory.  The arithmetic is
// quantize_rows's, so the result equals the plain version (gather, then
// quantize) bit for bit.
template <int NV, int V>
__global__ void __launch_bounds__(256)
    gather_quantize_kernel(const float* __restrict__ x,
                           const int32_t* __restrict__ idx,
                           int8_t* __restrict__ q, float* __restrict__ s,
                           int64_t R, int64_t C, int64_t B, int L, int runs,
                           float levels) {
  __shared__ float warp_max[8];
  const int32_t* cols = stage_cols(idx, B);
  q8_rows<NV, V>(Kept<int32_t, true>{x, C, cols, runs}, q, s, R, B, L,
                 levels, warp_max);
}

template <int V>
__global__ void __launch_bounds__(256)
    gather_quantize_kernel_stream(const float* __restrict__ x,
                                  const int32_t* __restrict__ idx,
                                  int8_t* __restrict__ q,
                                  float* __restrict__ s, int64_t R, int64_t C,
                                  int64_t B, int runs, float levels) {
  q8_stream<V>(Kept<int32_t, false>{x, C, idx, runs}, q, s, R, B, levels);
}

// One launch of quantize_rows (idx null: n = C) or of gather_quantize (n =
// B kept columns of C), with the plan the host chose.
template <int V>
int launch_q8(const float* x, const int32_t* idx, int8_t* q, float* s,
              int64_t R, int64_t C, int64_t n, float levels, int lanes,
              int nv, int runs, cudaStream_t st) {
  if (!plan_ok(lanes, nv) || (idx && nv && n > kStagedCols))
    return (int)cudaErrorInvalidValue;
  const unsigned blocks = (unsigned)((R * lanes + 255) / 256);
  const size_t smem = idx ? (size_t)n * sizeof(int32_t) : 0;
  switch (nv) {
#define QROWS(N)                                                          \
  case N:                                                                 \
    if (idx)                                                              \
      gather_quantize_kernel<N, V><<<blocks, 256, smem, st>>>(            \
          x, idx, q, s, R, C, n, lanes, runs, levels);                    \
    else                                                                  \
      quantize_rows_kernel<N, V, float><<<blocks, 256, 0, st>>>(          \
          x, q, s, R, C, lanes, levels);                                  \
    break;
    QROWS(1) QROWS(2) QROWS(3) QROWS(4) QROWS(6)
#undef QROWS
    default:
      if (idx)
        gather_quantize_kernel_stream<V><<<row_blocks(R), 256, 0, st>>>(
            x, idx, q, s, R, C, n, runs, levels);
      else
        quantize_rows_kernel_stream<V, float><<<row_blocks(R), 256, 0, st>>>(
            x, q, s, R, C, levels);
      break;
  }
  return (int)cudaGetLastError();
}

// One launch of quantize_rows on bf16 rows (the same plan; vec 4 reads
// four bf16 with one 8-byte load).
template <int V>
int launch_q8_bf16(const uint16_t* x, int8_t* q, float* s, int64_t R,
                   int64_t C, float levels, int lanes, int nv,
                   cudaStream_t st) {
  if (!plan_ok(lanes, nv)) return (int)cudaErrorInvalidValue;
  const unsigned blocks = (unsigned)((R * lanes + 255) / 256);
  switch (nv) {
#define QROWS(N)                                                          \
  case N:                                                                 \
    quantize_rows_kernel<N, V, uint16_t><<<blocks, 256, 0, st>>>(         \
        x, q, s, R, C, lanes, levels);                                    \
    break;
    QROWS(1) QROWS(2) QROWS(3) QROWS(4) QROWS(6)
#undef QROWS
    default:
      quantize_rows_kernel_stream<V, uint16_t>
          <<<row_blocks(R), 256, 0, st>>>(x, q, s, R, C, levels);
      break;
  }
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// q4: two's-complement nibbles in [-7, 7], two columns per byte (the even
// column in the low nibble), one f32 scale max|row| / 7 + 1e-30 per row.
//
// Bound on an H100: bytes, like quantize_rows (a few operations per
// element; 4 B read and half a byte written per element).  Every output
// byte is written whole by one thread, so no nibble needs a
// read-modify-write.  Scale and quotient use IEEE division and rintf
// (round half to even), as the plain PyTorch version and the reference
// do; a NaN quotient packs 0, as XLA's float-to-int32 convert followed by
// & 0xF gives.
// ---------------------------------------------------------------------------

__device__ __forceinline__ float q4_scale(float m) {
  return __fadd_rn(__fdiv_rn(m, 7.f), 1e-30f);
}

__device__ __forceinline__ unsigned q4_nibble(float v, float sc) {
  const float r = rintf(__fdiv_rn(v, sc));
  return r != r ? 0u : (unsigned)((int)fminf(fmaxf(r, -7.f), 7.f) & 0xF);
}

// Replaces quantize_pack_q4 of src/repro/kernels/wire.py, for many leaves
// in one launch: leaf i's x (R, C) f32 -> p (R, ceil(C/2)) uint8, s (R, 1)
// f32; an odd C gets a zero high nibble in its last byte.
//
// A consensus round encodes every payload leaf of the q4 ring (ResNet-18:
// 62, with rows 10 to 256 wide), each far too small to fill the card, so
// one launch takes a table of up to kQ4Cap leaves by value (a
// __grid_constant__ parameter: no host-to-device copy).  Each leaf starts
// at a block number of the table; a block finds its leaf by binary search
// and runs that leaf's plan (kernels/wire.py: q4_plan), which is
// quantize_rows's: L lanes a row (256 / L rows a block), each lane holding
// NV vectors of the row in registers between the abs-max and the
// quantize, every load issued before the first use; rows too wide for the
// registers stream, one warp a row, the second read from L1/L2.  Vectors
// are four floats (16-byte loads, where C % 4 == 0 and the bases allow;
// two bytes stored) or a pair (two loads, one byte stored), so every
// output byte is written whole by one thread.  The arithmetic is the
// per-leaf kernel's (q4_scale, q4_nibble, nan_max), so the result equals
// the plain version bit for bit.

constexpr int kQ4Cap = 64;    // leaves a launch (kernels/wire.py Q4_CAPACITY)
constexpr int kQ4Fields = 9;  // int64 fields of one leaf from the wrapper

struct Q4Leaf {
  const float* x;
  uint8_t* p;
  float* s;
  uint32_t R, C, lanes, nv, vec;   // nv 0: stream (lanes 32)
  uint32_t first;                  // the leaf's first block
};

struct Q4Table {
  Q4Leaf leaf[kQ4Cap];
  int n;
};

template <int V>
__device__ __forceinline__ float vec_max(float m, const float (&v)[4]) {
#pragma unroll
  for (int k = 0; k < V; ++k) m = nan_max(m, fabsf(v[k]));
  return m;
}

// the packed bytes of vector j: two (V 4) or one, the pad nibble 0
template <int V>
__device__ __forceinline__ void store_vec(uint8_t* pr, int64_t j, int64_t C,
                                          const float (&v)[4], float sc) {
  if constexpr (V == 4) {
    *reinterpret_cast<uint16_t*>(pr + 2 * j) = (uint16_t)(
        q4_nibble(v[0], sc) | (q4_nibble(v[1], sc) << 4) |
        (q4_nibble(v[2], sc) << 8) | (q4_nibble(v[3], sc) << 12));
  } else {
    const unsigned hi = 2 * j + 1 < C ? q4_nibble(v[1], sc) : 0u;
    pr[j] = (uint8_t)(q4_nibble(v[0], sc) | (hi << 4));
  }
}

// Rows held in registers, as q8_rows holds them (f.C output columns a row,
// read through the loader): lane l of a row takes its vectors l, l + L,
// ... (NV at most); past the row's end a lane reads its last vector
// again, and a row past R reads row R - 1 (neither is counted or stored),
// so no load is conditional.
template <int NV, int V, class Ld>
__device__ __forceinline__ void q4_rows(const Q4Leaf& f, const Ld& ld,
                                        uint32_t blk, float* warp_max) {
  const int L = (int)f.lanes;
  const int sub = threadIdx.x & (L - 1);
  const int64_t R = f.R, C = f.C;
  const int64_t row = ((int64_t)blk * blockDim.x + threadIdx.x) / L;
  const bool active = row < R;
  const int64_t nvec = (C + V - 1) / V;
  const float* xr = ld.row(active ? row : R - 1);
  float v[NV][4];
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int64_t j = sub + (int64_t)i * L;
    ld.template load<V>(xr, j < nvec ? j : nvec - 1, C, v[i]);
  }
  float m = 0.f;
#pragma unroll
  for (int i = 0; i < NV; ++i)
    if (sub + (int64_t)i * L < nvec) m = vec_max<V>(m, v[i]);
  for (int off = (L < 32 ? L : 32) >> 1; off > 0; off >>= 1)
    m = nan_max(m, __shfl_xor_sync(0xffffffffu, m, off));
  if (L > 32) {   // uniform: every thread of the block reaches the barrier
    if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = m;
    __syncthreads();
    const int w0 = (threadIdx.x & ~(L - 1)) >> 5;   // the row's first warp
    m = warp_max[w0];
    for (int w = 1; w < L / 32; ++w) m = nan_max(m, warp_max[w0 + w]);
  }
  if (!active) return;
  const float sc = q4_scale(m);
  uint8_t* pr = f.p + row * ((C + 1) >> 1);
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int64_t j = sub + (int64_t)i * L;
    if (j < nvec) store_vec<V>(pr, j, C, v[i], sc);
  }
  if (sub == 0) f.s[row] = sc;
}

// Rows wider than the registers hold: one warp a row, eight rows a block.
template <int V, class Ld>
__device__ __forceinline__ void q4_stream(const Q4Leaf& f, const Ld& ld,
                                          uint32_t blk) {
  const int lane = threadIdx.x & 31;
  const int64_t row = (int64_t)blk * kRowsPerBlock + (threadIdx.x >> 5);
  if (row >= f.R) return;
  const int64_t C = f.C, nvec = (C + V - 1) / V;
  const float* xr = ld.row(row);
  float m = 0.f;
  for (int64_t j = lane; j < nvec; j += 32) {
    float v[4];
    ld.template load<V>(xr, j, C, v);
    m = vec_max<V>(m, v);
  }
  for (int off = 16; off > 0; off >>= 1)
    m = nan_max(m, __shfl_xor_sync(0xffffffffu, m, off));
  const float sc = q4_scale(m);
  uint8_t* pr = f.p + row * ((C + 1) >> 1);
  for (int64_t j = lane; j < nvec; j += 32) {
    float v[4];
    ld.template load<V>(xr, j, C, v);
    store_vec<V>(pr, j, C, v, sc);
  }
  if (lane == 0) f.s[row] = sc;
}

template <int V, class Ld>
__device__ __forceinline__ void q4_leaf(const Q4Leaf& f, const Ld& ld,
                                        uint32_t blk, float* warp_max) {
  switch (f.nv) {
    case 1: q4_rows<1, V>(f, ld, blk, warp_max); break;
    case 2: q4_rows<2, V>(f, ld, blk, warp_max); break;
    case 3: q4_rows<3, V>(f, ld, blk, warp_max); break;
    case 4: q4_rows<4, V>(f, ld, blk, warp_max); break;
    case 6: q4_rows<6, V>(f, ld, blk, warp_max); break;
    default: q4_stream<V>(f, ld, blk); break;
  }
}

__global__ void __launch_bounds__(256)
    quantize_pack_q4_table_kernel(const __grid_constant__ Q4Table t) {
  __shared__ float warp_max[8];
  const uint32_t b = blockIdx.x;
  int lo = 0, hi = t.n - 1;   // the last leaf whose first block is <= b
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (t.leaf[mid].first <= b) lo = mid;
    else hi = mid - 1;
  }
  const Q4Leaf& f = t.leaf[lo];
  const Dense ld{f.x, f.C};
  if (f.vec == 4) q4_leaf<4>(f, ld, b - f.first, warp_max);
  else q4_leaf<2>(f, ld, b - f.first, warp_max);
}

// Replaces gather_quantize_q4 of src/repro/kernels/wire.py: the q4 encode
// of x[:, idx] (x (R, C) f32, idx (B,) int64 in [0, C)) -> p (R,
// ceil(B/2)), s (R, 1), without materializing the gathered rows.  Bytes
// bound, like gather_quantize, which it mirrors: one leaf f of B output
// columns (f.C) run by quantize_pack_q4's engines with their plan
// (kernels/wire.py: gather_quantize_q4_plan), each vector of four kept
// columns that is one aligned run read with one 16-byte load, two packed
// bytes stored a vector where B % 4 == 0 (else pairs, one byte each).
// The columns are staged once a block in shared memory; rows too wide for
// the registers stream and read their columns from device memory.
__global__ void __launch_bounds__(256)
    gather_quantize_q4_kernel(const __grid_constant__ Q4Leaf f,
                              const int64_t* __restrict__ idx, int64_t C,
                              int runs) {
  __shared__ float warp_max[8];
  if (f.nv == 0) {
    const Kept<int64_t, false> ld{f.x, C, idx, runs};
    if (f.vec == 4) q4_stream<4>(f, ld, blockIdx.x);
    else q4_stream<2>(f, ld, blockIdx.x);
    return;
  }
  const Kept<int32_t, true> ld{f.x, C, stage_cols(idx, f.C), runs};
  if (f.vec == 4) q4_leaf<4>(f, ld, blockIdx.x, warp_max);
  else q4_leaf<2>(f, ld, blockIdx.x, warp_max);
}

// ---------------------------------------------------------------------------
// The decodes.  gather_dequantize replaces gather_dequantize of
// src/repro/kernels/wire.py: q (R, Cq) int8, s (R, 1) f32, idx (Cout,)
// int32 -> out (R, Cout) f32 = q[r, idx[j]] * s[r].
// unpack_gather_dequantize_q4 replaces unpack_gather_dequantize_q4 there:
// p (R, Cp) uint8, idx (Cout,) int64 into the unpacked columns [0, 2 Cp)
// -> out (R, Cout) f32 = the sign-extended nibble idx[j] of row r (byte
// idx[j] >> 1, the low nibble for an even column) times s[r].
//
// Both take one more index value than the TPU kernels: Cq (q8) or 2 Cp
// (q4) reads nothing and writes 0 * s[r] (NaN on a row whose scale is NaN
// or inf, as the reference's zero pad column gives).  So the zero-fill
// expansion of a compact payload is a decode by the inverse index of the
// compaction, without a padded copy of the payload.  A null idx is the
// identity, the plain decode: column j reads column j, and no index is
// read.
//
// Bound on an H100: bytes.  The f32 output is over 80% of them (4 B
// written an element, against 1 B (q8) or half a byte (q4) read).  The
// codec API decodes one leaf a launch, and most of ResNet's leaves are so
// small that the launch and its chain of dependent loads set the time, so
// the design shortens that chain and keeps the stores streaming:
//   * the quantizers' row plan over the Cout output columns
//     (kernels/wire.py: gather_dequantize_plan and its q4 twin): L lanes
//     a row (256 / L rows a block) and up to 6 vectors a lane, so a narrow
//     row leaves no lane idle and a wide one spreads over several warps;
//     rows past 6 vectors a lane at 256 lanes stream, one warp a row;
//   * the index staged once a block in shared memory as int32 (every row
//     of the block shares it); where a row's payload is no wider than its
//     output (an expansion reads all of it) and its width and base allow
//     4-byte loads, the block's payload rows, which lie contiguous in
//     memory, are staged beside it with 16- or 4-byte loads issued
//     together with the index's and the rows' scales, so no load waits on
//     another: one round trip to device memory, one barrier (other rows,
//     such as the TPU kernel's zero-padded ones, are read in place);
//   * four columns that are one run from a multiple of 4 read their
//     payload with one load, 4 bytes of q or 2 of p, as the device decides
//     from the index (the host plan says only whether the rows' width and
//     base allow it: ``runs``).  The rules keep whole groups (ResNet: 8
//     channels), so every kept vector of an expansion is such a run, and
//     a dropped one reads nothing;
//   * vectors of four output columns stored with one float4 where Cout %
//     4 == 0 and out is 16-byte aligned, else single columns; streaming
//     stores (st.global.cs: the output is not read again here), all of a
//     lane's loads, its row's scale first, issued before its first store.
// The arithmetic is the plain version's: (float)q * s rounded once
// (__fmul_rn), the nibble sign-extended as (n ^ 8) - 8, so the result is
// bit-equal to it.
// ---------------------------------------------------------------------------

// A load of read-only data: from device memory through the read-only
// path, or (S) from shared memory.
template <bool S, class T>
__device__ __forceinline__ T load_ro(const T* p) {
  if constexpr (S) return *p;
  else return __ldg(p);
}

// A decode's payload: a row's column c as a code (q8: its byte; q4: its
// nibble), four codes from a multiple of 4 in one load, and a code's
// value.  A vector's codes are packed in one 32-bit word, kBits each.  S:
// the rows were staged in shared memory.
struct Q8Codes {
  using T = int8_t;
  static constexpr int kBits = 8;
  const T* p;
  int64_t ld;     // bytes a row: Cq
  int64_t zero;   // the index that writes 0 * s: Cq
  template <bool S>
  __device__ __forceinline__ uint32_t one(const T* pr, int64_t c) const {
    return (uint8_t)load_ro<S>(pr + c);
  }
  template <bool S>
  __device__ __forceinline__ uint32_t four(const T* pr, int64_t c) const {
    return load_ro<S>(reinterpret_cast<const unsigned int*>(pr + c));
  }
  __device__ __forceinline__ static float value(uint32_t w, int k) {
    return (float)(int8_t)(uint8_t)(w >> (8 * k));
  }
};

struct Q4Codes {
  using T = uint8_t;
  static constexpr int kBits = 4;
  const T* p;
  int64_t ld;     // bytes a row: Cp
  int64_t zero;   // 2 Cp
  template <bool S>
  __device__ __forceinline__ uint32_t one(const T* pr, int64_t c) const {
    return ((uint32_t)load_ro<S>(pr + (c >> 1)) >> ((c & 1) << 2)) & 0xFu;
  }
  template <bool S>
  __device__ __forceinline__ uint32_t four(const T* pr, int64_t c) const {
    return load_ro<S>(reinterpret_cast<const unsigned short*>(pr + (c >> 1)));
  }
  __device__ __forceinline__ static float value(uint32_t w, int k) {
    const int n = (int)((w >> (4 * k)) & 0xFu);
    return (float)((n ^ 8) - 8);
  }
};

// A decode's source columns: Ident (column c reads column c) or Index
// (column cols[c], staged in shared memory or read from device memory).
struct Ident {
  template <int V>
  __device__ __forceinline__ void get(int64_t j, int64_t (&c)[V]) const {
#pragma unroll
    for (int k = 0; k < V; ++k) c[k] = V * j + k;
  }
};

template <class I, bool S>
struct Index {
  const I* cols;
  template <int V>
  __device__ __forceinline__ void get(int64_t j, int64_t (&c)[V]) const {
    kept_cols<V, I, S>(cols, j, c);
  }
};

// The codes of output vector j of a row (columns V j .. V j + V - 1) from
// payload row pr (S: in shared memory): one load where they are one run
// from a multiple of 4 and ``runs`` allows it, else one load a column; a
// column at the zero index (or past it) packs 0 and reads nothing.
template <int V, bool S, class P, class Src>
__device__ __forceinline__ uint32_t dec_codes(const P& pay,
                                              const typename P::T* pr,
                                              const Src& src, int64_t j,
                                              int runs) {
  int64_t c[V];
  src.template get<V>(j, c);
  if constexpr (V == 4) {
    if (runs && aligned_run(c) && (uint64_t)c[3] < (uint64_t)pay.zero)
      return pay.template four<S>(pr, c[0]);
  }
  uint32_t w = 0;
#pragma unroll
  for (int k = 0; k < V; ++k)
    if ((uint64_t)c[k] < (uint64_t)pay.zero)
      w |= pay.template one<S>(pr, c[k]) << (P::kBits * k);
  return w;
}

template <int V, class P>
__device__ __forceinline__ void dec_store(float* orow, int64_t j, uint32_t w,
                                          float sc) {
  if constexpr (V == 4) {
    __stcs(reinterpret_cast<float4*>(orow + 4 * j),
           make_float4(__fmul_rn(P::value(w, 0), sc),
                       __fmul_rn(P::value(w, 1), sc),
                       __fmul_rn(P::value(w, 2), sc),
                       __fmul_rn(P::value(w, 3), sc)));
  } else {
    __stcs(orow + j, __fmul_rn(P::value(w, 0), sc));
  }
}

// Row ``row`` of n output columns, scale sc, on the row plan (lane
// ``sub`` of L taking the row's vectors sub, sub + L, ...: NV at most)
// from payload row pr (S: in shared memory); every load before the first
// store.
template <int NV, int V, bool S, class P, class Src>
__device__ __forceinline__ void dec_row(const P& pay, const typename P::T* pr,
                                        const Src& src, float sc,
                                        float* __restrict__ out, int64_t row,
                                        int64_t n, int sub, int L, int runs) {
  const int64_t nvec = n / V;
  uint32_t w[NV];
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int64_t j = sub + (int64_t)i * L;
    w[i] = j < nvec ? dec_codes<V, S>(pay, pr, src, j, runs) : 0u;
  }
  float* orow = out + row * n;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int64_t j = sub + (int64_t)i * L;
    if (j < nvec) dec_store<V, P>(orow, j, w[i], sc);
  }
}

// Copy ``count`` units of W from src to dst (shared memory), and the
// index's first n entries as int32 to cols, each thread's loads of both
// issued before its stores.  Every thread of the block reaches the
// barrier.
template <class W, class I>
__device__ __forceinline__ void stage(const W* __restrict__ src, W* dst,
                                      int64_t count,
                                      const I* __restrict__ idx,
                                      int32_t* cols, int64_t n) {
  const int64_t m = count > n ? count : n;
  for (int64_t k = threadIdx.x; k < m; k += blockDim.x) {
    W a{};
    I b{};
    if (k < count) a = __ldg(src + k);
    if (k < n) b = __ldg(idx + k);
    if (k < count) dst[k] = a;
    if (k < n) cols[k] = (int32_t)b;
  }
  __syncthreads();
}

// One block's rows on the row plan, each row's scale loaded first.  idx
// null: the identity, nothing staged.  Else the index is staged, and with
// it (unit 16 or 4: the width of the copy the rows' width and base allow;
// 0: none) the block's payload rows, which are then read from shared
// memory.
template <int NV, int V, class P, class I>
__global__ void __launch_bounds__(256)
    decode_kernel(const P pay, const float* __restrict__ s,
                  const I* __restrict__ idx, float* __restrict__ out,
                  int64_t R, int64_t n, int L, int runs, int unit) {
  const int sub = threadIdx.x & (L - 1);
  const int64_t per = blockDim.x / L;   // rows a block
  const int64_t r0 = (int64_t)blockIdx.x * per;
  const int64_t row = r0 + threadIdx.x / L;
  const float sc = __ldg(s + (row < R ? row : R - 1));
  if (idx == nullptr) {   // uniform: the identity stages nothing
    if (row < R)
      dec_row<NV, V, false>(pay, pay.p + row * pay.ld, Ident{}, sc, out, row,
                            n, sub, L, runs);
    return;
  }
  extern __shared__ __align__(16) int32_t dec_smem[];
  // the index first (n int32, padded to 16 bytes), then the payload rows
  int32_t* cols = dec_smem;
  auto* rows = reinterpret_cast<typename P::T*>(dec_smem + ((n + 3) & ~3));
  const int64_t nrows = R - r0 < per ? R - r0 : per;
  const int64_t bytes = nrows * pay.ld * (int64_t)sizeof(typename P::T);
  const auto* src = pay.p + r0 * pay.ld;
  if (unit == 16)
    stage(reinterpret_cast<const uint4*>(src), reinterpret_cast<uint4*>(rows),
          bytes / 16, idx, cols, n);
  else   // unit 4, or 0: the index alone
    stage(reinterpret_cast<const uint32_t*>(src),
          reinterpret_cast<uint32_t*>(rows), unit ? bytes / 4 : 0, idx, cols,
          n);
  if (row >= R) return;
  const Index<int32_t, true> at{cols};
  if (unit)
    dec_row<NV, V, true>(pay, rows + (row - r0) * pay.ld, at, sc, out, row, n,
                         sub, L, runs);
  else
    dec_row<NV, V, false>(pay, pay.p + row * pay.ld, at, sc, out, row, n, sub,
                          L, runs);
}

// Rows wider than the plan holds: one warp a row, eight rows a block, four
// vectors of a lane in flight at a time; the index read from device
// memory.
template <int V, class P, class Src>
__device__ __forceinline__ void dec_stream(const P& pay, const Src& src,
                                           const float* __restrict__ s,
                                           float* __restrict__ out, int64_t R,
                                           int64_t n, int runs) {
  const int lane = threadIdx.x & 31;
  const int64_t row = (int64_t)blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5);
  if (row >= R) return;
  const int64_t nvec = n / V;
  const typename P::T* pr = pay.p + row * pay.ld;
  const float sc = __ldg(s + row);
  float* orow = out + row * n;
  int64_t j = lane;
  for (; j + 96 < nvec; j += 128) {
    uint32_t w[4];
#pragma unroll
    for (int u = 0; u < 4; ++u)
      w[u] = dec_codes<V, false>(pay, pr, src, j + 32 * u, runs);
#pragma unroll
    for (int u = 0; u < 4; ++u) dec_store<V, P>(orow, j + 32 * u, w[u], sc);
  }
  for (; j < nvec; j += 32)
    dec_store<V, P>(orow, j, dec_codes<V, false>(pay, pr, src, j, runs), sc);
}

template <int V, class P, class I>
__global__ void __launch_bounds__(256)
    decode_kernel_stream(const P pay, const float* __restrict__ s,
                         const I* __restrict__ idx, float* __restrict__ out,
                         int64_t R, int64_t n, int runs) {
  if (idx == nullptr)
    dec_stream<V>(pay, Ident{}, s, out, R, n, runs);
  else
    dec_stream<V>(pay, Index<I, false>{idx}, s, out, R, n, runs);
}

// One launch of a decode over n output columns, with the plan the host
// chose (nv 0 streams); an identity wider than the payload, or payload
// rows too wide to stage, are refused.
template <class P, class I>
int launch_decode(const P& pay, const float* s, const I* idx, float* out,
                  int64_t R, int64_t n, int lanes, int nv, int vec, int runs,
                  int unit, cudaStream_t st) {
  if (R <= 0 || n <= 0) return (int)cudaSuccess;
  const int64_t row_bytes = pay.ld * (int64_t)sizeof(typename P::T);
  if (!plan_ok(lanes, nv) || (vec != 4 && vec != 1) || (vec == 4 && n % 4) ||
      (idx && nv && n > kStagedCols) || (!idx && n > pay.zero) ||
      (unit != 0 && unit != 4 && unit != 16) ||
      (unit && (!idx || !nv || row_bytes % unit || row_bytes > n)))
    return (int)cudaErrorInvalidValue;
  const int64_t grid = nv == 0 ? (R + 7) / 8 : (R * lanes + 255) / 256;
  if (grid >= ((int64_t)1 << 31)) return (int)cudaErrorInvalidValue;
  const unsigned blocks = (unsigned)grid;
  if (vec != 4) runs = 0;
  if (nv == 0) {
    if (vec == 4)
      decode_kernel_stream<4><<<blocks, 256, 0, st>>>(pay, s, idx, out, R, n,
                                                     runs);
    else
      decode_kernel_stream<1><<<blocks, 256, 0, st>>>(pay, s, idx, out, R, n,
                                                     runs);
    return (int)cudaGetLastError();
  }
  // the index (int32, padded to 16 bytes: at most 24 KB) and, staged, the
  // block's 256 / L payload rows of at most n bytes each (the plan covers
  // a row with L lanes of at most 6 vectors of 4: at most 6 KB)
  const size_t smem =
      idx ? (size_t)((n + 3) & ~3) * sizeof(int32_t) +
                (unit ? (size_t)(256 / lanes) * row_bytes : 0)
          : 0;
  switch (nv) {
#define DECODE(N)                                                          \
  case N:                                                                  \
    if (vec == 4)                                                          \
      decode_kernel<N, 4><<<blocks, 256, smem, st>>>(pay, s, idx, out, R, \
                                                     n, lanes, runs, unit); \
    else                                                                   \
      decode_kernel<N, 1><<<blocks, 256, smem, st>>>(pay, s, idx, out, R, \
                                                     n, lanes, runs, unit); \
    break;
    DECODE(1) DECODE(2) DECODE(3) DECODE(4) DECODE(6)
#undef DECODE
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// lanes (1..256, a power of two), nv (vectors a lane holds in registers:
// 1, 2, 3, 4 or 6; 0 streams, with lanes 32) and vec (4: 16-byte loads,
// which need C % 4 == 0 and a 16-byte aligned x; else 1) as
// kernels/wire.py: quantize_plan chooses them.
int quantize_rows_f32(const float* x, int8_t* q, float* s, int64_t R,
                      int64_t C, int levels, int lanes, int nv, int vec,
                      void* stream) {
  if (R <= 0 || C <= 0) return (int)cudaSuccess;
  const cudaStream_t st = (cudaStream_t)stream;
  return vec == 4 ? launch_q8<4>(x, nullptr, q, s, R, C, C, (float)levels,
                                 lanes, nv, 0, st)
                  : launch_q8<1>(x, nullptr, q, s, R, C, C, (float)levels,
                                 lanes, nv, 0, st);
}

// quantize_rows_f32 on bf16 rows (x the rows' 16-bit words); vec 4 reads
// four with one 8-byte load, which needs C % 4 == 0 and an 8-byte aligned
// x (kernels/wire.py: quantize_plan with 2-byte elements).
int quantize_rows_bf16(const uint16_t* x, int8_t* q, float* s, int64_t R,
                       int64_t C, int levels, int lanes, int nv, int vec,
                       void* stream) {
  if (R <= 0 || C <= 0) return (int)cudaSuccess;
  const cudaStream_t st = (cudaStream_t)stream;
  return vec == 4 ? launch_q8_bf16<4>(x, q, s, R, C, (float)levels, lanes,
                                      nv, st)
                  : launch_q8_bf16<1>(x, q, s, R, C, (float)levels, lanes,
                                      nv, st);
}

// lanes and nv as for quantize_rows_f32, over the B output columns; vec 4
// (vectors of four output columns, which needs B % 4 == 0) or 1; runs 1
// lets a vector whose kept columns are one run from a multiple of 4 take
// one 16-byte load (vec 4, C % 4 == 0 and a 16-byte aligned x), as
// kernels/wire.py: gather_quantize_plan chooses them.
int gather_quantize_f32(const float* x, const int32_t* idx, int8_t* q,
                        float* s, int64_t R, int64_t C, int64_t B, int levels,
                        int lanes, int nv, int vec, int runs, void* stream) {
  if (R <= 0 || B <= 0) return (int)cudaSuccess;
  if (idx == nullptr || (vec == 4 && B % 4)) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  return vec == 4 ? launch_q8<4>(x, idx, q, s, R, C, B, (float)levels,
                                 lanes, nv, runs, st)
                  : launch_q8<1>(x, idx, q, s, R, C, B, (float)levels,
                                 lanes, nv, 0, st);
}

// ``n`` leaves (1..kQ4Cap) of kQ4Fields int64 each, as kernels/wire.py:
// quantize_pack_q4_table lays them out: x, p, s addresses, R, C, lanes,
// nv, vec (kernels/wire.py: q4_plan), first block; ``blocks`` blocks in
// all.  Returns cudaErrorInvalidValue for another n.
int quantize_pack_q4_table(const int64_t* fields, int n, int64_t blocks,
                           void* stream) {
  if (n < 1 || n > kQ4Cap || blocks < 1 || blocks >= ((int64_t)1 << 31))
    return (int)cudaErrorInvalidValue;
  Q4Table t = {};
  t.n = n;
  for (int i = 0; i < n; ++i) {
    const int64_t* g = fields + (int64_t)i * kQ4Fields;
    Q4Leaf& f = t.leaf[i];
    f.x = reinterpret_cast<const float*>(g[0]);
    f.p = reinterpret_cast<uint8_t*>(g[1]);
    f.s = reinterpret_cast<float*>(g[2]);
    f.R = (uint32_t)g[3], f.C = (uint32_t)g[4], f.lanes = (uint32_t)g[5];
    f.nv = (uint32_t)g[6], f.vec = (uint32_t)g[7], f.first = (uint32_t)g[8];
  }
  quantize_pack_q4_table_kernel<<<(unsigned)blocks, 256, 0,
                                  (cudaStream_t)stream>>>(t);
  return (int)cudaGetLastError();
}

// lanes, nv as for quantize_rows_f32, over the B output columns; vec 4
// (vectors of four output columns, two packed bytes; B % 4 == 0) or 2
// (pairs); runs as for gather_quantize_f32 (kernels/wire.py:
// gather_quantize_q4_plan).
int gather_quantize_q4_f32(const float* x, const int64_t* idx, uint8_t* p,
                           float* s, int64_t R, int64_t C, int64_t B,
                           int lanes, int nv, int vec, int runs,
                           void* stream) {
  if (R <= 0 || B <= 0) return (int)cudaSuccess;
  if (idx == nullptr || !plan_ok(lanes, nv) || (vec != 4 && vec != 2) ||
      (vec == 4 && B % 4) || (nv && B > kStagedCols) ||
      R >= ((int64_t)1 << 32) || B >= ((int64_t)1 << 32))
    return (int)cudaErrorInvalidValue;
  const Q4Leaf f = {x, p, s, (uint32_t)R, (uint32_t)B, (uint32_t)lanes,
                    (uint32_t)nv, (uint32_t)vec, 0u};
  const int64_t blocks = nv == 0 ? (R + 7) / 8 : (R * lanes + 255) / 256;
  const size_t smem = nv ? (size_t)B * sizeof(int32_t) : 0;
  gather_quantize_q4_kernel<<<(unsigned)blocks, 256, smem,
                              (cudaStream_t)stream>>>(f, idx, C,
                                                      vec == 4 ? runs : 0);
  return (int)cudaGetLastError();
}

// The decodes (see decode_kernel): lanes and nv as for quantize_rows_f32,
// over the Cout output columns; vec 4 (float4 stores: Cout % 4 == 0 and
// out 16-byte aligned) or 1; runs 1 lets four columns that are one run
// from a multiple of 4 take one load of the payload rows as the kernel
// reads them: 4 bytes of q (Cq % 4 == 0 and, unstaged, q 4-byte aligned)
// or 2 bytes of p (Cp % 2 == 0, p 2-byte aligned); unit 16 or 4 stages a
// block's payload rows (no wider than Cout bytes) with loads of that
// width, 0 reads them in place; as kernels/wire.py: gather_dequantize_plan
// and unpack_gather_dequantize_q4_plan choose them.  idx in [0, Cq] (q8)
// or [0, 2 Cp] (q4), the last value writing 0 * s; a null idx is the
// identity over the first Cout columns (unit 0).
int gather_dequantize_f32(const int8_t* q, const float* s, const int32_t* idx,
                          float* out, int64_t R, int64_t Cq, int64_t Cout,
                          int lanes, int nv, int vec, int runs, int unit,
                          void* stream) {
  return launch_decode(Q8Codes{q, Cq, Cq}, s, idx, out, R, Cout, lanes, nv,
                       vec, runs, unit, (cudaStream_t)stream);
}

int unpack_gather_dequantize_q4_f32(const uint8_t* p, const float* s,
                                    const int64_t* idx, float* out,
                                    int64_t R, int64_t Cp, int64_t Cout,
                                    int lanes, int nv, int vec, int runs,
                                    int unit, void* stream) {
  return launch_decode(Q4Codes{p, Cp, 2 * Cp}, s, idx, out, R, Cout, lanes,
                       nv, vec, runs, unit, (cudaStream_t)stream);
}

}  // extern "C"
