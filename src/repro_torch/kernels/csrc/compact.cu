// Kept-group gather (paper §4.4.1 packing, §4.4.3 zero-fill recovery).
//
// Replaces gather_groups of src/repro/kernels/compact.py, whose TPU kernel
// computes out[r, j] = x[r, idx[j]] on an (R, C) view.  This kernel takes
// the same gather on a (R, C, Q) view, in whole groups of g channels, with
// an index table (S, B / g) of kept groups:
//
//     out[r, j*g + k, q] = x[r, idx[s(r), j]*g + k, q],  s(r) = (r / P) % S
//
// for k < g.  g = 1, Q = 1 and S = 1 is the TPU kernel's (R, C) gather.
// Q > 1 gathers along an axis that is not the minor one (a conv weight's
// input channels) in place, where the TPU path first moves the axis to the
// end; S > 1 gives each slice of a stacked leaf its own kept set (P rows
// per slice).  An index equal to C / g (one past the last group) writes
// zeros and reads nothing, so the inverse index of a compaction applied to
// the compact buffer itself is the zero-fill expansion: no padded copy and
// no scatter.  A gather is an exact copy, so the result equals the plain
// PyTorch version bit for bit for any dtype.
//
// Bound on an H100: bytes.  Each output element is one write, and one read
// unless it is a zero; there is no arithmetic.  Design:
//
//   * runs: a kept group is g·Q contiguous elements in the input and in
//     the output (g consecutive channels of Q elements each), so the
//     kernel reads one index per run and moves the run in units of 16, 8,
//     4, 2 or 1 bytes, the widest that divides the run's bytes and both
//     base addresses (the wrapper's plan, kernels/compact.py: plan).
//     ResNet's rules keep whole GroupNorm groups of 8 channels: f32 runs
//     of 32·Q bytes, so every unit is 16 bytes;
//   * a flat walk of the output: each leaf's output is R·(B/g)·L units (L
//     units a run) in memory order; a block takes 1024 consecutive units,
//     thread t units t, t + 256, t + 512, t + 768, so the writes of a warp
//     are one contiguous 512-byte stretch and the reads of a run coalesce;
//     each thread issues its four loads before its first store.  The unit
//     -> (row, run, slice) decomposition divides by multiplication with
//     constants the wrapper computes (fastdiv), never by a division;
//   * one launch for many leaves: the leaves of a rule differ in shape,
//     axis and slices, so the launch takes a table of up to kCap leaves by
//     value as a __grid_constant__ parameter (no host-to-device copy);
//     each leaf starts at a block number of the table (a prefix of its
//     tile counts), and a block finds its leaf by binary search.
//
// Plain C interface (loaded with ctypes); the entry launches on the
// caller's stream and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kCap = 32;       // leaves a launch (kernels/compact.py CAPACITY)
constexpr int kThreads = 256;  // threads a block
constexpr int kUnits = 4;      // units a thread (a tile is 1024 units)
constexpr int kFields = 20;    // int64 fields of one leaf from the wrapper

// n / d for n < 2^31 as (umulhi(n, m) + n) >> s; kernels/compact.py:
// fastdiv computes (m, s) and checks the identity
struct FastDiv {
  uint32_t m, s;
};

__device__ __forceinline__ uint32_t fdiv(uint32_t n, FastDiv d) {
  return (__umulhi(n, d.m) + n) >> d.s;
}

struct Leaf {
  const char* x;         // (R, Cg, L) units
  char* out;             // (R, Bg, L) units
  const int32_t* idx;    // (S, Bg) kept groups in [0, Cg]; Cg: zeros
  uint32_t R, Cg, Bg, L, S, P;
  uint32_t unit;         // bytes a unit: 16, 8, 4, 2 or 1
  uint32_t units;        // R * Bg * L, under 2^31
  uint32_t first;        // the leaf's first block
  FastDiv dL, dB, dP, dS;
};

struct Table {
  Leaf leaf[kCap];
  int n;
};

template <typename U>
__device__ __forceinline__ void copy_tile(const Leaf& f, uint32_t tile) {
  const U* __restrict__ x = reinterpret_cast<const U*>(f.x);
  U* __restrict__ out = reinterpret_cast<U*>(f.out);
  const uint32_t base = tile * (kThreads * kUnits) + threadIdx.x;
  int64_t src[kUnits];   // input unit, -1 for a zero, -2 past the end
#pragma unroll
  for (int i = 0; i < kUnits; ++i) {
    const uint32_t u = base + i * kThreads;
    src[i] = -2;
    if (u < f.units) {
      const uint32_t q = fdiv(u, f.dL), l = u - q * f.L;
      const uint32_t r = fdiv(q, f.dB), j = q - r * f.Bg;
      uint32_t s = 0;
      if (f.S != 1) {
        const uint32_t rp = fdiv(r, f.dP);
        s = rp - fdiv(rp, f.dS) * f.S;
      }
      const uint32_t c = (uint32_t)__ldg(f.idx + s * f.Bg + j);
      src[i] = c < f.Cg ? ((int64_t)r * f.Cg + c) * f.L + l : -1;
    }
  }
  U v[kUnits];
#pragma unroll
  for (int i = 0; i < kUnits; ++i) v[i] = src[i] >= 0 ? __ldg(x + src[i]) : U{};
#pragma unroll
  for (int i = 0; i < kUnits; ++i)
    if (src[i] != -2) out[base + i * kThreads] = v[i];
}

__global__ void __launch_bounds__(kThreads)
    gather_table_kernel(const __grid_constant__ Table t) {
  const uint32_t b = blockIdx.x;
  int lo = 0, hi = t.n - 1;   // the last leaf whose first block is <= b
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (t.leaf[mid].first <= b) lo = mid;
    else hi = mid - 1;
  }
  const Leaf& f = t.leaf[lo];
  const uint32_t tile = b - f.first;
  switch (f.unit) {
    case 16: copy_tile<uint4>(f, tile); break;
    case 8: copy_tile<uint2>(f, tile); break;
    case 4: copy_tile<uint32_t>(f, tile); break;
    case 2: copy_tile<uint16_t>(f, tile); break;
    default: copy_tile<uint8_t>(f, tile); break;
  }
}

}  // namespace

extern "C" {

// ``n`` leaves (1..kCap) of kFields int64 each, as kernels/compact.py:
// _fields lays them out: x, out, idx addresses, R, Cg, Bg, L, S, P, unit,
// units, first block, then (m, s) of the divisions by L, Bg, P and S;
// ``blocks`` blocks in all.  Returns cudaErrorInvalidValue for another n.
int gather_table(const int64_t* fields, int n, int64_t blocks, void* stream) {
  if (n < 1 || n > kCap || blocks < 1 || blocks >= ((int64_t)1 << 31))
    return (int)cudaErrorInvalidValue;
  Table t = {};
  t.n = n;
  for (int i = 0; i < n; ++i) {
    const int64_t* g = fields + (int64_t)i * kFields;
    Leaf& f = t.leaf[i];
    f.x = reinterpret_cast<const char*>(g[0]);
    f.out = reinterpret_cast<char*>(g[1]);
    f.idx = reinterpret_cast<const int32_t*>(g[2]);
    f.R = (uint32_t)g[3], f.Cg = (uint32_t)g[4], f.Bg = (uint32_t)g[5];
    f.L = (uint32_t)g[6], f.S = (uint32_t)g[7], f.P = (uint32_t)g[8];
    f.unit = (uint32_t)g[9], f.units = (uint32_t)g[10];
    f.first = (uint32_t)g[11];
    f.dL = {(uint32_t)g[12], (uint32_t)g[13]};
    f.dB = {(uint32_t)g[14], (uint32_t)g[15]};
    f.dP = {(uint32_t)g[16], (uint32_t)g[17]};
    f.dS = {(uint32_t)g[18], (uint32_t)g[19]};
  }
  gather_table_kernel<<<(unsigned)blocks, kThreads, 0,
                        (cudaStream_t)stream>>>(t);
  return (int)cudaGetLastError();
}

}  // extern "C"
