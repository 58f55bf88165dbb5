// Mamba2 SSD chunked scan (state-space duality, arXiv:2405.21060).
//
// Replaces ssd_chunk_scan of src/repro/kernels/ssd_scan.py.  Inputs x
// (Bt, T, H, P), dt (Bt, T, H) f32, A (Bt, H) f32 (one row per batch row:
// under vmap over ADMM workers each worker has its own A), B and C
// (Bt, T, N); outputs y (Bt, T, H, P) in x's dtype and the final state
// h (Bt, H, N, P) f32.  x, B, C and y are f32 or bf16; every product and
// sum is f32.  With chunks of Q steps (c the chunk, q and s steps inside
// it, cum the inclusive sum of dt*A within the chunk):
//
//   S_c[n,p]  = sum_s B[s,n] exp(cum[Q-1] - cum[s]) dt[s] x[s,p]
//   h_c       = h_{c-1} exp(cum[Q-1]) + S_c                 (h_{-1} = 0)
//   y[q,p]    = sum_{s<=q} (C[q].B[s]) exp(cum[q] - cum[s]) dt[s] x[s,p]
//             + exp(cum[q]) sum_n C[q,n] h_{c-1}[n,p]
//
// The TPU kernel walks the chunks of one (batch row, head block) in order
// on one core with h carried in VMEM.  A Hopper block cannot carry state
// to the next, and Bt x H/bh blocks (96 at the training shape) would leave
// most of the 132 SMs idle, so the scan is split at its one sequential
// dependence, the state recurrence over chunks:
//
//   1. chunk_cumsum    cum and the chunk's decay exp(cum[Q-1]), one
//                      thread per (b, c, h), in step order;
//   2. transpose       B and C of every chunk to (N, Q) rows, padded to a
//                      multiple of 4 steps, so every product below reads
//                      its operands as k-major rows;
//   3. chunk_cb        (C.B^T)^T per chunk, shared by all heads (as the TPU
//                      kernel's head block shares it), tiles on or below
//                      the diagonal only;
//   4. chunk_state     S_c of every (b, c) as ONE product over the chunk's
//                      steps: B^T (N x Q) times the rows of x scaled by
//                      exp(cum[Q-1] - cum[s]) dt[s] (Q x H*P), so B is
//                      staged once for two heads;
//   5. state_pass      the recurrence over chunks, one thread per 4 state
//                      elements, in chunk order, 4 chunks' loads in
//                      flight; it leaves in place of S_c the state entering
//                      chunk c, and writes h;
//   6. chunk_inter     exp(cum[q]) C[q].h_{c-1} of every (b, c) as one
//                      product (C staged once for two heads), into y;
//   7. chunk_intra     the causal intra-chunk product, its weights
//                      (C.B^T)[q,s] exp(cum[q] - cum[s]) dt[s] formed in
//                      shared memory from the staged C.B^T tile for the
//                      block's two heads, added to y.
//
// Bound on an H100: operations.  At the training shape (Bt 4, T 4096,
// H 48, P 64, N 128, Q 256) the causal products are ~39 GFLOP of f32 on
// ~0.43 GB.  Products 3, 4, 6 and 7 share one loop: blocks of 4 warps, 8 x
// 8 outputs a thread, 64 x 128 output tiles (rows of the product x two
// head slots of 64 columns), operands read from k-major shared tiles with
// 128-bit loads, and a ring of 16-step stages filled by cp.async (four
// stages, three for 7), so that the next stages are in flight while one is
// multiplied.  64-row tiles keep little of 7's causal tiles above the
// diagonal, where a warp whose rows all precede a stage skips it.  The
// operands that need arithmetic before the product (x scaled per step,
// the causal weights) are turned into it in shared memory one stage
// ahead, after the barrier that publishes the stage: one barrier a stage.
//
// Bit-equality with the plain version (ref.ssd_chunk_scan_ref, whose f32
// products cuBLAS sums in step order with fused multiply-adds from 0):
// every output is summed by one thread with fmaf, over k in ascending
// order, from 0, with no split of k; every elementwise factor is formed by
// the plain version's expression in its order, with the _rn intrinsics so
// that nvcc contracts nothing; expf is the libm expf (no fast math).  A
// term the kernel skips (s > q, whole stages above a warp's rows) is a
// term whose weight the plain version makes exactly 0: adding 0 * x
// changes no sum.  Above the diagonal the decay exp(cum[q] - cum[s]) has
// a positive exponent and may overflow; it is never computed, where the
// TPU kernel multiplies exp(...) by a 0/1 mask (inf * 0 is NaN once a
// chunk's sum of dt*|A| passes ~88).  No atomics: a run gives the same
// bits every time.
//
// bf16 operands are widened to f32 copies in the workspace first (exact,
// as the plain version's .to(float32)), and y is rounded to bf16 once, at
// the end.  Rows are moved 16 bytes at a time where P and N are multiples
// of 4 and x, B and y are 16-byte aligned, else 4 bytes at a time.
//
// Plain C interface (loaded with ctypes): ssd_chunk_scan_workspace gives
// the f32 scratch the entry needs; the entry launches the kernels on the
// caller's stream and returns the first cudaError_t.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 128;  // 4 warps of 32 x 64 outputs, 8 x 8 a thread
constexpr int kBlocks = 4;     // blocks an SM holds (128 registers a thread)
constexpr int kSlot = 64;      // columns of a head slot (p within a head)
constexpr int kBK = 16;        // reduction steps per stage
// Every product takes tiles of 64 rows x 128 columns (kPH = 2 head
// slots) through a ring of 4 stages (3 for chunk_intra, whose weights
// take shared memory too).  Small blocks: a barrier stalls 4 warps, and
// the SM runs 4 blocks.
constexpr int kBM = 64, kBN = 128, kStages = 4, kIStages = 3;
constexpr int kPH = kBN / kSlot;

// --- cp.async: copies into shared memory that complete in the background;
// a copy with ok == false writes zeros and reads nothing.
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp16(float* dst, const float* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp4(float* dst, const float* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// --- one thread's share of an operand's stages.  A stage is kBK rows of
// COLS columns, k-major; the thread copies the 4 columns c..c+3 (c = tid %
// (COLS / 4) * 4) of rows kk + R i, kk = tid / (COLS / 4), R = 4 kThreads /
// COLS.
// Element (k, c + j) of the operand is at p + k * ld + j, where p is the
// element (kk, c) of stage 0 and row k exists for k < K; ncol of the 4
// columns exist.  What does not exist is staged as 0.
template <int COLS>
struct Feed {
  static constexpr int kPer = COLS / 4;          // threads per row
  static constexpr int kRows = kThreads / kPer;  // rows per pass
  static_assert(kBK % kRows == 0, "whole passes per stage");
  const float* base;   // any element of the operand: the address of an
                       // empty copy
  const float* p;
  int64_t ld;
  int kk, K, ncol;
  static __device__ int col() { return threadIdx.x % kPer * 4; }
};
__device__ __forceinline__ int clamp4(int64_t n) {
  return n < 0 ? 0 : n > 4 ? 4 : (int)n;
}
// Rows of base[k * ld + m], m < M: the tile's column c is m = c.
template <int COLS>
__device__ __forceinline__ Feed<COLS> row_feed(const float* base, int64_t ld,
                                               int K, int64_t M) {
  const int kk = threadIdx.x / Feed<COLS>::kPer, c = Feed<COLS>::col();
  return {base, base + kk * ld + c, ld, kk, K, clamp4(M - c)};
}
// Rows of (h, p) at base[k * ld + h * P + p]: the tile's column c is head
// h0 + c / kSlot, p = p0 + c % kSlot.
template <int COLS>
__device__ __forceinline__ Feed<COLS> head_feed(const float* base, int64_t ld,
                                                int K, int64_t H, int64_t P,
                                                int h0, int p0) {
  const int kk = threadIdx.x / Feed<COLS>::kPer, c = Feed<COLS>::col();
  const int64_t h = h0 + c / kSlot, p = p0 + c % kSlot;
  return {base, base + kk * ld + h * P + p, ld, kk, K,
          h < H ? clamp4(P - p) : 0};
}

// Stage k0 / kBK of an operand into dst: one 16-byte copy per row (VEC:
// the operand's rows hold whole chunks of 4), else four 4-byte copies.
template <bool VEC, int COLS>
__device__ __forceinline__ void load_tile(float* dst, const Feed<COLS>& f,
                                          int k0) {
  constexpr int R = Feed<COLS>::kRows;
  float* d = dst + f.kk * COLS + Feed<COLS>::col();
#pragma unroll
  for (int i = 0; i < kBK / R; ++i) {
    const bool row = k0 + f.kk + R * i < f.K;
    const float* s = f.p + (int64_t)(k0 + R * i) * f.ld;
    if (VEC) {
      const bool ok = row && f.ncol > 0;
      cp16(d + R * i * COLS, ok ? s : f.base, ok);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool ok = row && j < f.ncol;
        cp4(d + R * i * COLS + j, ok ? s + j : f.base, ok);
      }
    }
  }
}

// side[(a * kPH + hl) * kBK + k] = src_a[(k0 + k) * H + h0 + hl] for the
// tables a = 0 (cum), 1 (dt) of the tile's heads (0 outside), copied by
// the first 2 kPH kBK threads: the per-step, per-head factors of a stage.
constexpr int kSide = 2 * kPH * kBK;   // floats of a stage's side tables
__device__ __forceinline__ void load_side(float* side, const float* cum,
                                          const float* dt, int64_t H, int h0,
                                          int k0, int K) {
  static_assert(kSide <= kThreads, "one copy per thread");
  const int t = threadIdx.x;
  if (t >= kSide) return;
  const int hl = t / kBK % kPH, k = t % kBK;
  const float* src = t < kPH * kBK ? cum : dt;
  const bool ok = k0 + k < K && h0 + hl < H;
  cp4(side + t, ok ? src + (int64_t)(k0 + k) * H + h0 + hl : src, ok);
}

// cq[hl * kBM + r] = cum[q0 + r, h0 + hl] of the chunk (0 outside), for
// the tile's heads, published by the product loop's first barrier.
__device__ __forceinline__ void load_cq(float* cq, const float* cum,
                                        int64_t H, int h0, int q0,
                                        int64_t Q) {
  for (int v = threadIdx.x; v < kPH * kBM; v += kThreads) {
    const int hl = v / kBM, r = v % kBM;
    cq[v] = q0 + r < Q && h0 + hl < H ? cum[(q0 + r) * H + h0 + hl] : 0.f;
  }
}

// The thread's place in a tile: warp (wm, wn) of 2 x 2 holds rows
// wm * 32.. and head slot wn; the thread holds rows r0 + {0..3, 16..19}
// and columns c0 + {0..3, 32..35}.
struct Place {
  int wm, wn, r0, c0;
};
static_assert(kBM == 64 && kBN == 2 * kSlot && kThreads == 128,
              "4 warps of 32 x 64 outputs");
__device__ __forceinline__ Place place() {
  const int w = threadIdx.x / 32, l = threadIdx.x % 32;
  return {w % 2, w / 2, w % 2 * 32 + l / 8 * 4, w / 2 * kSlot + l % 8 * 4};
}
__device__ __forceinline__ int row_of(const Place& t, int i) {
  return t.r0 + (i < 4 ? i : i + 12);
}
__device__ __forceinline__ int col_of(const Place& t, int jh) {
  return t.c0 + 32 * jh;   // the first of 4 columns
}

// acc += A^T B over one stage: A [kBK][kBM], B [kBK][kBN] in shared
// memory; each output's chain of fmaf runs over k in ascending order.
__device__ __forceinline__ void fma_stage(const float* __restrict__ As,
                                          const float* __restrict__ Bs,
                                          const Place& t,
                                          float (&acc)[8][8]) {
#pragma unroll
  for (int k = 0; k < kBK; ++k) {
    const float4 a0 = *reinterpret_cast<const float4*>(As + k * kBM + t.r0);
    const float4 a1 =
        *reinterpret_cast<const float4*>(As + k * kBM + t.r0 + 16);
    const float4 b0 = *reinterpret_cast<const float4*>(Bs + k * kBN + t.c0);
    const float4 b1 =
        *reinterpret_cast<const float4*>(Bs + k * kBN + t.c0 + 32);
    const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

// The product loop of chunk_cb, chunk_state, chunk_inter and chunk_intra
// over nk stages through a ring of Op::kS stages.  `op` supplies load(i,
// buf) (issues stage i's copies into ring slot buf), prepare(i, buf)
// (turns landed stage i into operands; it runs one stage ahead, after the
// barrier that publishes the stage) and compute(i, buf, acc).  Stages
// i + 1 .. i + kS - 1 are in flight while stage i is multiplied; one
// barrier per stage.
template <class Op>
__device__ __forceinline__ void mainloop(Op& op, int nk, float (&acc)[8][8]) {
  constexpr int S = Op::kS;
  static_assert(S >= 3, "a stage lands while one is prepared");
#pragma unroll
  for (int s = 0; s < S - 1; ++s) {
    if (s < nk) op.load(s, s);
    cp_commit();
  }
  cp_wait<S - 2>();              // stage 0 landed
  __syncthreads();
  if (nk > 0) op.prepare(0, 0);
  for (int i = 0; i < nk; ++i) {
    cp_wait<S - 3>();            // stage i + 1 landed (this thread's copies)
    __syncthreads();             // ... everyone's; stage i prepared; slot of
                                 // stage i - 1 free
    const int nx = i + S - 1;
    if (nx < nk) op.load(nx, nx % S);
    cp_commit();
    if (i + 1 < nk) op.prepare(i + 1, (i + 1) % S);
    op.compute(i, i % S, acc);
  }
}

constexpr int kTileA = kBK * kBM;  // floats of an A stage
constexpr int kTileB = kBK * kBN;  // ... of a B stage
constexpr int kRingA = kStages * kTileA;

// An output tile through plain stages: A and B rings in shared memory.
template <bool VB>
struct Plain {
  static constexpr int kS = kStages;
  Feed<kBM> a;
  Feed<kBN> b;
  float* sa;
  float* sb;
  Place t;
  __device__ void load(int i, int buf) {
    load_tile<true>(sa + buf * kTileA, a, i * kBK);
    load_tile<VB>(sb + buf * kTileB, b, i * kBK);
  }
  __device__ void prepare(int, int) {}
  __device__ void compute(int, int buf, float (&acc)[8][8]) {
    fma_stage(sa + buf * kTileA, sb + buf * kTileB, t, acc);
  }
};

// The tile of a flat block index: the head tile (nht of them: nhg groups of
// kPH heads x tiles of kSlot p) fastest, then the chunk bc, then the row
// tile.
struct TileIdx {
  int64_t bc;
  int h0, p0, rt;
};
__device__ __forceinline__ TileIdx tile_idx(int64_t nbc, int nhg, int nht) {
  const int64_t b = blockIdx.x;
  const int hd = (int)(b % nht);
  const int64_t r = b / nht;
  return {r % nbc, hd % nhg * kPH, hd / nhg * kSlot, (int)(r / nbc)};
}

// ---------------------------------------------------------------------------

// 1. cum[b, t, h]: the sum of dt * A over the steps of t's chunk up to t;
// dch[bc, h] = exp(cum at the chunk's end), the chunk's decay.
__global__ void chunk_cumsum(const float* __restrict__ dt,
                             const float* __restrict__ A,
                             float* __restrict__ cum, float* __restrict__ dch,
                             int64_t Bt, int64_t nc, int64_t H, int64_t Q) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= Bt * nc * H) return;
  const int64_t h = i % H, bc = i / H, b = bc / nc;
  const float a = A[b * H + h];
  const float* d = dt + bc * Q * H + h;   // (b, c * Q, h) of (Bt, T, H)
  float* o = cum + bc * Q * H + h;
  float acc = 0.f;
  for (int64_t q0 = 0; q0 < Q; q0 += 16) {   // 16 loads in flight
    float v[16];
#pragma unroll
    for (int u = 0; u < 16; ++u) v[u] = q0 + u < Q ? d[(q0 + u) * H] : 0.f;
#pragma unroll
    for (int u = 0; u < 16; ++u) {
      if (q0 + u >= Q) break;
      acc = __fadd_rn(acc, __fmul_rn(v[u], a));
      o[(q0 + u) * H] = acc;
    }
  }
  dch[i] = expf(acc);
}

// 2. BT[bc, n, s] = B[bc, s, n] and CT likewise, s < Qp (0 for s >= Q).
__global__ void transpose_chunks(const float* __restrict__ Bm,
                                 const float* __restrict__ Cm,
                                 float* __restrict__ BT,
                                 float* __restrict__ CT, int64_t nbc,
                                 int64_t Q, int64_t Qp, int64_t N) {
  __shared__ float tile[32][33];
  const int64_t ns = (Qp + 31) / 32, nn = (N + 31) / 32;
  const int64_t b = blockIdx.x;
  const int64_t s0 = b % ns * 32, n0 = b / ns % nn * 32, z = b / (ns * nn);
  const bool isc = z >= nbc;
  const int64_t bc = isc ? z - nbc : z;
  const float* src = (isc ? Cm : Bm) + bc * Q * N;
  float* dst = (isc ? CT : BT) + bc * N * Qp;
  const int tx = threadIdx.x % 32, ty = threadIdx.x / 32;
  for (int r = ty; r < 32; r += kThreads / 32) {
    const int64_t s = s0 + r, n = n0 + tx;
    tile[r][tx] = s < Q && n < N ? src[s * N + n] : 0.f;
  }
  __syncthreads();
  for (int r = ty; r < 32; r += kThreads / 32) {
    const int64_t n = n0 + r, s = s0 + tx;
    if (n < N && s < Qp) dst[n * Qp + s] = tile[tx][r];
  }
}

// 3. cbT[bc, s, q] = sum_n C[q, n] B[s, n] for the tiles of kBM s x kBN q
// that hold some s <= q.
__global__ void __launch_bounds__(kThreads, kBlocks)
chunk_cb(const float* __restrict__ BT, const float* __restrict__ CT,
         float* __restrict__ cbT, int64_t ns, int64_t nq, int64_t Q,
         int64_t Qp, int64_t N) {
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  const int64_t b = blockIdx.x;
  const int st = (int)(b % ns), qt = (int)(b / ns % nq);
  const int64_t bc = b / (ns * nq);
  const int s0 = st * kBM, q0 = qt * kBN;
  if (s0 > q0 + kBN - 1) return;
  const float* bt = BT + bc * N * Qp;
  const float* ct = CT + bc * N * Qp;
  Plain<true> op{row_feed<kBM>(bt + s0, Qp, (int)N, Q - s0),
                 row_feed<kBN>(ct + q0, Qp, (int)N, Q - q0), sm, sm + kRingA,
                 place()};
  float acc[8][8] = {};
  mainloop(op, (int)((N + kBK - 1) / kBK), acc);
  const Place& t = op.t;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int64_t s = s0 + row_of(t, i);
#pragma unroll
    for (int jh = 0; jh < 2; ++jh) {
      const int64_t q = q0 + col_of(t, jh);
      if (s < Q && q < Q)   // rows of cbT hold whole chunks of 4
        *reinterpret_cast<float4*>(cbT + (bc * Q + s) * Qp + q) =
            make_float4(acc[i][4 * jh], acc[i][4 * jh + 1],
                        acc[i][4 * jh + 2], acc[i][4 * jh + 3]);
    }
  }
}

__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// Stores the thread's 8 x 8 outputs of a head-slot tile whose row r starts
// at out + r * row_ld (out and src are at the tile's first row):
// out(r, h, p) = f(i, j, src(r, h, p)), src read only if READ.
template <bool VEC, bool READ, typename T, class F>
__device__ __forceinline__ void store_heads(T* out, const float* src,
                                            int64_t row_ld, int rows, int H,
                                            int P, int h0, int p0,
                                            const Place& t, F f) {
  const int h = h0 + t.wn;
  if (h >= H) return;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = row_of(t, i);
    if (r >= rows) continue;
#pragma unroll
    for (int jh = 0; jh < 2; ++jh) {
      const int p = p0 + col_of(t, jh) % kSlot;
      const int64_t o = r * row_ld + (int64_t)h * P + p;
      if (VEC && sizeof(T) == 4) {   // whole chunks of 4 (P % 4 == 0)
        if (p >= P) continue;
        float4 v = READ ? *reinterpret_cast<const float4*>(src + o)
                        : make_float4(0.f, 0.f, 0.f, 0.f);
        v.x = f(i, 4 * jh, v.x);
        v.y = f(i, 4 * jh + 1, v.y);
        v.z = f(i, 4 * jh + 2, v.z);
        v.w = f(i, 4 * jh + 3, v.w);
        *reinterpret_cast<float4*>(out + o) = v;
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (p + j < P) put(out + o + j, f(i, 4 * jh + j,
                                            READ ? src[o + j] : 0.f));
      }
    }
  }
}

// 4. states[bc, n, h, p] = S_c: one (kBM n) x (two heads of 64 p) tile of
// the chunk's product B^T (x * ws), summed over the steps s in order, with
// ws[s] = exp(cum[Q-1] - cum[s]) * dt[s] formed per stage.
template <bool VEC>
struct StateOp {
  static constexpr int kS = kStages;
  Feed<kBM> a;   // B rows s: n
  Feed<kBN> b;   // x rows s: (h, p), scaled by ws in prepare
  const float* cum;   // (rows of the chunk) x H
  const float* dt;
  int64_t H;
  int h0;
  float* sa;
  float* sb;
  float* side;   // [kStages][cum, dt][kPH][kBK]
  const float* cend;  // cum[Q-1] of the kPH heads
  Place t;
  __device__ void load(int i, int buf) {
    load_tile<VEC>(sa + buf * kTileA, a, i * kBK);
    load_tile<VEC>(sb + buf * kTileB, b, i * kBK);
    load_side(side + buf * kSide, cum, dt, H, h0, i * kBK, b.K);
  }
  __device__ void prepare(int, int buf) {   // x * ws, in place
    constexpr int R = Feed<kBN>::kRows;
    const float* sd = side + buf * kSide;
    const int c = Feed<kBN>::col(), hl = c / kSlot;
#pragma unroll
    for (int i = 0; i < kBK / R; ++i) {
      const int k = b.kk + R * i;
      float4* v = reinterpret_cast<float4*>(sb + buf * kTileB + k * kBN + c);
      const float w = __fmul_rn(expf(__fsub_rn(cend[hl], sd[hl * kBK + k])),
                                sd[(kPH + hl) * kBK + k]);
      float4 x = *v;
      x.x = __fmul_rn(x.x, w);
      x.y = __fmul_rn(x.y, w);
      x.z = __fmul_rn(x.z, w);
      x.w = __fmul_rn(x.w, w);
      *v = x;
    }
  }
  __device__ void compute(int, int buf, float (&acc)[8][8]) {
    fma_stage(sa + buf * kTileA, sb + buf * kTileB, t, acc);
  }
};

template <bool VEC>
__global__ void __launch_bounds__(kThreads, kBlocks)
chunk_state(const float* __restrict__ x, const float* __restrict__ Bm,
            const float* __restrict__ dt, const float* __restrict__ cum,
            float* __restrict__ states, int64_t nbc, int nhg, int nht,
            int64_t H, int64_t P, int64_t N, int64_t Q) {
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  __shared__ float side[kStages * kSide];
  __shared__ float cend[kPH];
  const TileIdx ti = tile_idx(nbc, nhg, nht);
  const int n0 = ti.rt * kBM;
  const int64_t t0 = ti.bc * Q;   // the chunk's first row of (Bt * T)
  if (threadIdx.x < kPH)
    cend[threadIdx.x] = ti.h0 + (int)threadIdx.x < H
                            ? cum[(t0 + Q - 1) * H + ti.h0 + threadIdx.x]
                            : 0.f;
  StateOp<VEC> op{row_feed<kBM>(Bm + t0 * N + n0, N, (int)Q, N - n0),
                  head_feed<kBN>(x + t0 * H * P, H * P, (int)Q, H, P, ti.h0,
                                 ti.p0),
                  cum + t0 * H, dt + t0 * H, H, ti.h0, sm, sm + kRingA, side,
                  cend, place()};
  float acc[8][8] = {};
  mainloop(op, (int)((Q + kBK - 1) / kBK), acc);
  float* out = states + (ti.bc * N + n0) * H * P;
  store_heads<VEC, false>(out, out, H * P, (int)(N - n0), (int)H, (int)P,
                          ti.h0, ti.p0, op.t,
                          [&](int i, int j, float) { return acc[i][j]; });
}

// 5. The recurrence over chunks for V consecutive state elements of one
// (b, n, h): in place of S_c it stores the state entering chunk c; h gets
// the last.  The loads of 4 chunks are in flight at once.
template <int V>
__global__ void state_pass(float* __restrict__ states,
                           const float* __restrict__ dch,
                           float* __restrict__ hout, int64_t Bt, int64_t nc,
                           int64_t H, int64_t P, int64_t N) {
  const int64_t NHP = N * H * P;
  const int64_t i = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) * V;
  if (i >= Bt * NHP) return;
  const int64_t e = i % NHP, b = i / NHP;
  const int64_t p = e % P, h = e / P % H, n = e / (H * P);
  float* sp = states + b * nc * NHP + e;
  const float* dp = dch + b * nc * H + h;
  using Vt = typename std::conditional<V == 4, float4, float>::type;
  Vt cur{};
  for (int64_t c0 = 0; c0 < nc; c0 += 4) {
    Vt s[4];
    float d[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      if (c0 + u >= nc) break;
      d[u] = dp[(c0 + u) * H];
      s[u] = *reinterpret_cast<const Vt*>(sp + (c0 + u) * NHP);
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      if (c0 + u >= nc) break;
      *reinterpret_cast<Vt*>(sp + (c0 + u) * NHP) = cur;
      float* c = reinterpret_cast<float*>(&cur);
      const float* x = reinterpret_cast<const float*>(&s[u]);
#pragma unroll
      for (int v = 0; v < V; ++v)
        c[v] = __fadd_rn(__fmul_rn(c[v], d[u]), x[v]);
    }
  }
  *reinterpret_cast<Vt*>(hout + ((b * H + h) * N + n) * P + p) = cur;
}

// 6. yf[(b, c*Q + q), h, p] = exp(cum[q]) * sum_n C[q, n] h_{c-1}[n, h, p]
// for a (kBM q) x (two heads of 64 p) tile; 0 in the first chunk, whose
// entering state is 0.
template <bool VEC>
__global__ void __launch_bounds__(kThreads, kBlocks)
chunk_inter(const float* __restrict__ CT, const float* __restrict__ hin,
            const float* __restrict__ cum, float* __restrict__ yf,
            int64_t nbc, int64_t nc, int nhg, int nht, int64_t H, int64_t P,
            int64_t N, int64_t Q, int64_t Qp) {
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  __shared__ float cq[kPH * kBM];
  const TileIdx ti = tile_idx(nbc, nhg, nht);
  const int q0 = ti.rt * kBM;
  const int64_t t0 = ti.bc * Q;
  load_cq(cq, cum + t0 * H, H, ti.h0, q0, Q);
  Plain<VEC> op{row_feed<kBM>(CT + ti.bc * N * Qp + q0, Qp, (int)N, Q - q0),
                head_feed<kBN>(hin + ti.bc * N * H * P, H * P, (int)N, H, P,
                               ti.h0, ti.p0),
                sm, sm + kRingA, place()};
  float acc[8][8] = {};
  mainloop(op, ti.bc % nc ? (int)((N + kBK - 1) / kBK) : 0, acc);
  const Place& t = op.t;
  float eq[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) eq[i] = expf(cq[t.wn * kBM + row_of(t, i)]);
  float* out = yf + (t0 + q0) * H * P;
  store_heads<VEC, false>(
      out, out, H * P, (int)(Q - q0), (int)H, (int)P, ti.h0, ti.p0, t,
      [&](int i, int j, float) { return __fmul_rn(acc[i][j], eq[i]); });
}

// 7. y = (the causal intra-chunk product) + yf for a (64 q) x (two heads
// of 64 p) tile; the weights of each head are formed in shared memory from
// the tile's C.B^T stage, staged once for the two heads.

template <bool VEC>
struct IntraOp {
  static constexpr int kS = kIStages;
  Feed<kBM> a;   // cbT rows s: q
  Feed<kBN> b;   // x rows s: (h, p)
  const float* cum;   // (rows of the chunk) x H
  const float* dt;
  int64_t H;
  int h0, q0, Q;
  float* sa;     // cbT ring
  float* sb;     // x ring
  float* ws;     // weights [2 (stage parity)][head slot][kTileA]
  float* side;   // [kIStages][cum, dt][kPH][kBK]
  float4 cq;     // cum[q] of the 4 rows q0 + m.. of the thread's head slot
  Place t;
  __device__ void load(int i, int buf) {
    load_tile<true>(sa + buf * kTileA, a, i * kBK);
    load_tile<VEC>(sb + buf * kTileB, b, i * kBK);
    load_side(side + buf * kSide, cum, dt, H, h0,
                       i * kBK, b.K);
  }
  // The thread's (head slot hl, steps k..k+3, rows m..m+3) of the weights
  // w[hl][k][m] = (cb[s, q] * exp(cum[q] - cum[s])) * dt[s] for s <= q,
  // else 0 (never exp'd), with s = i*kBK + k, q = q0 + m.
  static __device__ int wslot() { return threadIdx.x / (kThreads / kPH); }
  static __device__ int wstep() {
    return threadIdx.x % (kThreads / kPH) / (kBM / 4) * 4;
  }
  static __device__ int wrow() { return threadIdx.x % (kBM / 4) * 4; }
  __device__ void prepare(int i, int buf) {
    const int hl = wslot(), k0 = wstep(), m = wrow();
    const float* sd = side + buf * kSide;
    const float4 cs4 = *reinterpret_cast<const float4*>(sd + hl * kBK + k0);
    const float4 d4 =
        *reinterpret_cast<const float4*>(sd + (kPH + hl) * kBK + k0);
    const float cs[4] = {cs4.x, cs4.y, cs4.z, cs4.w};
    const float d[4] = {d4.x, d4.y, d4.z, d4.w};
    const float cqv[4] = {cq.x, cq.y, cq.z, cq.w};
    float* w = ws + (i % 2) * kPH * kTileA + hl * kTileA;
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int k = k0 + u, s = i * kBK + k;
      const float4 c4 = *reinterpret_cast<const float4*>(
          sa + buf * kTileA + k * kBM + m);
      const float c[4] = {c4.x, c4.y, c4.z, c4.w};
      float o[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        o[j] = s <= q0 + m + j && s < Q
                   ? __fmul_rn(__fmul_rn(c[j], expf(__fsub_rn(cqv[j], cs[u]))),
                               d[u])
                   : 0.f;
      *reinterpret_cast<float4*>(w + k * kBM + m) =
          make_float4(o[0], o[1], o[2], o[3]);
    }
  }
  __device__ void compute(int i, int buf, float (&acc)[8][8]) {
    if (i * kBK > q0 + t.wm * 32 + 31) return;   // all s > q of the warp
    fma_stage(ws + (i % 2) * kPH * kTileA + t.wn * kTileA,
                        sb + buf * kTileB, t, acc);
  }
};
static_assert(kPH * (kBK / 4) * (kBM / 4) == kThreads,
              "one thread per 4 x 4 weights of a stage");

template <bool VEC, typename T>
__global__ void __launch_bounds__(kThreads, kBlocks)
chunk_intra(const float* __restrict__ x, const float* __restrict__ dt,
            const float* __restrict__ cum, const float* __restrict__ cbT,
            const float* yf, T* y, int64_t nbc, int nhg, int nht, int64_t H,
            int64_t P, int64_t Q, int64_t Qp) {
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  __shared__ __align__(16) float side[kIStages * kSide];
  const TileIdx ti = tile_idx(nbc, nhg, nht);
  const int nq = (int)((Q + kBM - 1) / kBM);
  const int q0 = (nq - 1 - ti.rt) * kBM;   // the longest tiles first
  const int64_t t0 = ti.bc * Q;
  const int h = ti.h0 + IntraOp<VEC>::wslot(), m = IntraOp<VEC>::wrow();
  float cq[4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
    cq[j] = q0 + m + j < Q && h < H ? cum[(t0 + q0 + m + j) * H + h] : 0.f;
  const int s_end = (int)(q0 + kBM < Q ? q0 + kBM : Q);   // causal
  IntraOp<VEC> op{row_feed<kBM>(cbT + t0 * Qp + q0, Qp, s_end, Q - q0),
                  head_feed<kBN>(x + t0 * H * P, H * P, s_end, H, P, ti.h0,
                                 ti.p0),
                  cum + t0 * H, dt + t0 * H, H, ti.h0, q0, (int)Q,
                  sm, sm + kIStages * kTileA,
                  sm + kIStages * (kTileA + kTileB), side,
                  make_float4(cq[0], cq[1], cq[2], cq[3]), place()};
  float acc[8][8] = {};
  mainloop(op, (s_end + kBK - 1) / kBK, acc);
  store_heads<VEC, true>(y + (t0 + q0) * H * P, yf + (t0 + q0) * H * P,
                         H * P, (int)(Q - q0), (int)H, (int)P, ti.h0, ti.p0,
                         op.t, [&](int i, int j, float u) {
                           return __fadd_rn(acc[i][j], u);
                         });
}

__global__ void widen(const __nv_bfloat16* __restrict__ src,
                      float* __restrict__ dst, int64_t n) {
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * blockDim.x)
    dst[i] = __bfloat162float(src[i]);
}

// ---------------------------------------------------------------------------

int64_t cdiv(int64_t a, int64_t b) { return (a + b - 1) / b; }
int64_t pad4(int64_t n) { return cdiv(n, 4) * 4; }

// The workspace: f32 segments of 16-byte multiples.  Returns its length in
// floats; fills the pointers when base is not null.
struct Work {
  float *cum, *dch, *bt, *ct, *cbt, *states, *yf, *xf, *bf, *cf;
};
int64_t layout(float* base, int64_t Bt, int64_t T, int64_t H, int64_t P,
               int64_t N, int64_t Q, bool bf16, Work* w) {
  const int64_t nc = T / Q, Qp = pad4(Q);
  int64_t off = 0;
  auto take = [&](float** p, int64_t n) {
    if (base) *p = base + off;
    off += pad4(n);
  };
  Work tmp{};
  Work* o = w ? w : &tmp;
  take(&o->cum, Bt * T * H);
  take(&o->dch, Bt * nc * H);
  take(&o->bt, Bt * nc * N * Qp);
  take(&o->ct, Bt * nc * N * Qp);
  take(&o->cbt, Bt * nc * Q * Qp);
  take(&o->states, Bt * nc * N * H * P);
  if (bf16) {
    take(&o->yf, Bt * T * H * P);
    take(&o->xf, Bt * T * H * P);
    take(&o->bf, Bt * T * N);
    take(&o->cf, Bt * T * N);
  }
  return off;
}

bool aligned16(const void* p) { return (uintptr_t)p % 16 == 0; }

template <class K>
cudaError_t allow_smem(K kernel, int bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

// A launch (CHECK) or a runtime call (TRY) whose error ends the entry.
#define CHECK(...)                                 \
  do {                                             \
    __VA_ARGS__;                                   \
    const cudaError_t e_ = cudaGetLastError();     \
    if (e_ != cudaSuccess) return (int)e_;         \
  } while (0)
#define TRY(...)                                   \
  do {                                             \
    const cudaError_t e_ = (__VA_ARGS__);          \
    if (e_ != cudaSuccess) return (int)e_;         \
  } while (0)

template <bool VEC, typename T>
int run(const float* x, const float* dt, const float* A, const float* Bm,
        const float* Cm, T* y, float* hout, const Work& w, int64_t Bt,
        int64_t T_, int64_t H, int64_t P, int64_t N, int64_t Q,
        cudaStream_t stream) {
  const int64_t nc = T_ / Q, nbc = Bt * nc, Qp = pad4(Q);
  const int64_t nq = cdiv(Q, kBM), nqn = cdiv(Q, kBN), nhg = cdiv(H, kPH);
  const int64_t nht = nhg * cdiv(P, kSlot);
  const int plain_smem = kStages * (kTileA + kTileB) * (int)sizeof(float);
  const int intra_smem =
      (kIStages * (kTileA + kTileB) + 2 * kPH * kTileA) *
      (int)sizeof(float);
  const int64_t ntr = cdiv(Qp, 32) * cdiv(N, 32) * 2 * nbc;
  if (nht > INT32_MAX || nbc * nq * nqn > INT32_MAX || ntr > INT32_MAX ||
      nbc * nht * cdiv(N, kBM) > INT32_MAX || nbc * nht * nq > INT32_MAX)
    return (int)cudaErrorInvalidConfiguration;
  float* yf = sizeof(T) == 4 ? reinterpret_cast<float*>(y) : w.yf;

  CHECK(chunk_cumsum<<<(unsigned)cdiv(nbc * H, kThreads), kThreads, 0,
                       stream>>>(dt, A, w.cum, w.dch, Bt, nc, H, Q));
  CHECK(transpose_chunks<<<(unsigned)ntr, kThreads, 0, stream>>>(
      Bm, Cm, w.bt, w.ct, nbc, Q, Qp, N));
  TRY(allow_smem(chunk_cb, plain_smem));
  CHECK(chunk_cb<<<(unsigned)(nbc * nq * nqn), kThreads, plain_smem,
                   stream>>>(w.bt, w.ct, w.cbt, nq, nqn, Q, Qp, N));
  TRY(allow_smem(chunk_state<VEC>, plain_smem));
  CHECK(chunk_state<VEC><<<(unsigned)(nbc * nht * cdiv(N, kBM)), kThreads,
                           plain_smem, stream>>>(
      x, Bm, dt, w.cum, w.states, nbc, (int)nhg, (int)nht, H, P, N, Q));
  constexpr int V = VEC ? 4 : 1;   // elements per thread (P % 4 == 0)
  CHECK(state_pass<V><<<(unsigned)cdiv(Bt * N * H * P / V, kThreads),
                        kThreads, 0, stream>>>(w.states, w.dch, hout, Bt, nc,
                                               H, P, N));
  TRY(allow_smem(chunk_inter<VEC>, plain_smem));
  CHECK(chunk_inter<VEC><<<(unsigned)(nbc * nht * nq), kThreads, plain_smem,
                           stream>>>(w.ct, w.states, w.cum, yf, nbc, nc,
                                     (int)nhg, (int)nht, H, P, N, Q, Qp));
  TRY(allow_smem(chunk_intra<VEC, T>, intra_smem));
  CHECK(chunk_intra<VEC, T><<<(unsigned)(nbc * nht * nq), kThreads,
                              intra_smem, stream>>>(
      x, dt, w.cum, w.cbt, yf, y, nbc, (int)nhg, (int)nht, H, P, Q, Qp));
  return 0;
}

}  // namespace

extern "C" {

// Floats of f32 workspace ssd_chunk_scan needs for these dimensions.
int64_t ssd_chunk_scan_workspace(int64_t Bt, int64_t T, int64_t H,
                                 int64_t P, int64_t N, int64_t Q, int bf16) {
  return layout(nullptr, Bt, T, H, P, N, Q, bf16 != 0, nullptr);
}

// x (Bt, T, H, P), B and C (Bt, T, N), y (Bt, T, H, P): f32 (bf16 = 0) or
// bf16 (bf16 = 1); dt (Bt, T, H), A (Bt, H), h (Bt, H, N, P) f32; all
// contiguous.  work: ssd_chunk_scan_workspace(...) floats, 16-byte
// aligned.  Q divides T.
int ssd_chunk_scan(const void* x, const float* dt, const float* A,
                   const void* Bm, const void* Cm, void* y, float* h,
                   float* work, int64_t Bt, int64_t T, int64_t H, int64_t P,
                   int64_t N, int64_t Q, int bf16, void* stream) {
  if (Bt <= 0 || T <= 0 || H <= 0 || P <= 0 || N <= 0 || Q <= 0 || T % Q ||
      !aligned16(work))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  Work w;
  layout(work, Bt, T, H, P, N, Q, bf16 != 0, &w);
  const float *xf = static_cast<const float*>(x),
              *bf = static_cast<const float*>(Bm),
              *cf = static_cast<const float*>(Cm);
  if (bf16) {   // widen the operands once; every product reads f32
    const int64_t nx = Bt * T * H * P, nb = Bt * T * N;
    const unsigned g = 132 * 8;
    CHECK(widen<<<g, kThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), w.xf, nx));
    CHECK(widen<<<g, kThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(Bm), w.bf, nb));
    CHECK(widen<<<g, kThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(Cm), w.cf, nb));
    xf = w.xf, bf = w.bf, cf = w.cf;
  }
  const bool vec = P % 4 == 0 && N % 4 == 0 && aligned16(xf) &&
                   aligned16(bf) && (bf16 || aligned16(y));
  if (bf16) {
    auto* yb = static_cast<__nv_bfloat16*>(y);
    return vec ? run<true>(xf, dt, A, bf, cf, yb, h, w, Bt, T, H, P, N, Q, st)
               : run<false>(xf, dt, A, bf, cf, yb, h, w, Bt, T, H, P, N, Q,
                            st);
  }
  auto* yf = static_cast<float*>(y);
  return vec ? run<true>(xf, dt, A, bf, cf, yf, h, w, Bt, T, H, P, N, Q, st)
             : run<false>(xf, dt, A, bf, cf, yf, h, w, Bt, T, H, P, N, Q, st);
}

}  // extern "C"
