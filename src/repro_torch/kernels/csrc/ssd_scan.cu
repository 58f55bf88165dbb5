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
// on one core with h carried in VMEM.  On Hopper a block cannot carry
// state to the next, and Bt x H/bh blocks (96 at the training shape) would
// leave most of the 132 SMs idle, so the scan is split at its one
// sequential dependence, the state recurrence over chunks:
//
//   1. chunk_cumsum  cum, one thread per (b, c, h), in step order;
//   2. chunk_cb      C.B^T per chunk (shared by all heads, as the TPU
//                    kernel's head block shares it), tiles on or below the
//                    diagonal only;
//   3. chunk_state   S_c for every (b, c, h) at once (a 128 x 64 x Q
//                    product per block);
//   4. state_pass    the recurrence over chunks, one thread per state
//                    element, in chunk order; it leaves in place of S_c
//                    the state entering chunk c, and writes h;
//   5. chunk_scan    y for every (b, c, h, 64-step tile) at once: the
//                    causal intra-chunk product and the term of the
//                    entering state.
//
// Above the diagonal (s > q) the decay exp(cum[q] - cum[s]) has a positive
// exponent and may overflow; it is never computed: those terms are
// skipped, where the TPU kernel multiplies exp(...) by a 0/1 mask (inf * 0
// is NaN once a chunk's sum of dt*|A| passes ~88).
//
// Bound on an H100: operations.  At the training shape (Bt 4, T 4096,
// H 48, P 64, N 128, Q 256) the causal products are ~39 GFLOP of f32 on
// ~0.43 GB.  The products (steps 2, 3, 5) are register-tiled f32 loops
// on the CUDA cores: 64-row tiles staged in shared memory 32 reduction
// steps at a time, 16 or 32 outputs per thread.  No wgmma/TMA yet.  Every
// output is summed by one thread in a fixed order (no atomics), so a run
// gives the same bits every time.
//
// Plain C interface (loaded with ctypes); the entry launches the five
// kernels on the caller's stream and returns the first cudaError_t.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // 16 x 16 threads per tile block
constexpr int kTile = 64;      // rows and columns of an output tile
constexpr int kStep = 32;      // reduction steps staged per pass
constexpr int kRows = 128;     // state rows (n) of a chunk_state block

__device__ __forceinline__ float ld(const float* p) { return __ldg(p); }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void st(float* p, float v) { *p = v; }
__device__ __forceinline__ void st(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// 1. cum[b, t, h]: the sum of dt * A over the steps of t's chunk up to t.
__global__ void chunk_cumsum(const float* __restrict__ dt,
                             const float* __restrict__ A,
                             float* __restrict__ cum, int64_t Bt, int64_t nc,
                             int64_t H, int64_t Q) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= Bt * nc * H) return;
  const int64_t h = i % H, bc = i / H, b = bc / nc;
  const float a = A[b * H + h];
  const int64_t base = bc * Q * H + h;   // (b, c * Q, h) of (Bt, T, H)
  float acc = 0.f;
  for (int64_t q = 0; q < Q; ++q) {
    acc = __fadd_rn(acc, __fmul_rn(dt[base + q * H], a));
    cum[base + q * H] = acc;
  }
}

// 2. cb[bc, q, s] = sum_n C[q, n] B[s, n] within chunk bc, for the 64 x 64
// tiles that hold some s <= q.
template <typename T>
__global__ void __launch_bounds__(kThreads)
chunk_cb(const T* __restrict__ Bm, const T* __restrict__ Cm,
         float* __restrict__ cb, int64_t Q, int64_t N) {
  const int64_t bc = blockIdx.x;
  const int q0 = blockIdx.y * kTile, s0 = blockIdx.z * kTile;
  if (s0 > q0 + kTile - 1) return;
  __shared__ float Cs[kStep][kTile + 1], Bs[kStep][kTile + 1];
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const T* Cc = Cm + bc * Q * N;
  const T* Bc = Bm + bc * Q * N;
  float acc[4][4] = {};
  for (int64_t n0 = 0; n0 < N; n0 += kStep) {
    for (int e = threadIdx.x; e < kTile * kStep; e += kThreads) {
      const int r = e / kStep, k = e % kStep;
      const int64_t n = n0 + k;
      Cs[k][r] = (q0 + r < Q && n < N) ? ld(Cc + (q0 + r) * N + n) : 0.f;
      Bs[k][r] = (s0 + r < Q && n < N) ? ld(Bc + (s0 + r) * N + n) : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int k = 0; k < kStep; ++k) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[i] = Cs[k][ty + 16 * i];
        b[i] = Bs[k][tx + 16 * i];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int64_t q = q0 + ty + 16 * i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int64_t s = s0 + tx + 16 * j;
      if (q < Q && s < Q) cb[(bc * Q + q) * Q + s] = acc[i][j];
    }
  }
}

// 3. states[bc, h, n, p] = S_c: a (128 n) x (64 p) tile of one (b, c, h),
// summed over the chunk's steps s in order.
template <typename T>
__global__ void __launch_bounds__(kThreads)
chunk_state(const T* __restrict__ x, const float* __restrict__ dt,
            const T* __restrict__ Bm, const float* __restrict__ cum,
            float* __restrict__ states, int64_t H, int64_t P, int64_t N,
            int64_t Q) {
  const int64_t bch = blockIdx.x, h = bch % H, bc = bch / H;
  const int n0 = blockIdx.y * kRows, p0 = blockIdx.z * kTile;
  __shared__ float Bs[kStep][kRows], Xs[kStep][kTile], ws[kStep];
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int64_t t0 = bc * Q;  // first step of the chunk, as (b, t) rows
  const float cum_end = cum[(t0 + Q - 1) * H + h];
  float acc[8][4] = {};
  for (int64_t s0 = 0; s0 < Q; s0 += kStep) {
    if (threadIdx.x < kStep) {
      const int64_t s = s0 + threadIdx.x;
      const int64_t ts = (t0 + s) * H + h;
      ws[threadIdx.x] = s < Q ? __fmul_rn(expf(cum_end - cum[ts]), dt[ts])
                              : 0.f;
    }
    __syncthreads();
    for (int e = threadIdx.x; e < kStep * kRows; e += kThreads) {
      const int k = e / kRows, r = e % kRows;
      const int64_t s = s0 + k, n = n0 + r;
      Bs[k][r] = (s < Q && n < N) ? ld(Bm + (t0 + s) * N + n) : 0.f;
    }
    for (int e = threadIdx.x; e < kStep * kTile; e += kThreads) {
      const int k = e / kTile, c = e % kTile;
      const int64_t s = s0 + k, p = p0 + c;
      Xs[k][c] = (s < Q && p < P)
                     ? __fmul_rn(ld(x + ((t0 + s) * H + h) * P + p), ws[k])
                     : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int k = 0; k < kStep; ++k) {
      float a[8], b[4];
#pragma unroll
      for (int i = 0; i < 8; ++i) a[i] = Bs[k][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Xs[k][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
  float* out = states + (bc * H + h) * N * P;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int64_t n = n0 + ty + 16 * i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int64_t p = p0 + tx + 16 * j;
      if (n < N && p < P) out[n * P + p] = acc[i][j];
    }
  }
}

// 4. The recurrence over chunks for one state element (b, h, n, p): in
// place of S_c it stores the state entering chunk c; h gets the last.
__global__ void state_pass(float* __restrict__ states,
                           const float* __restrict__ cum,
                           float* __restrict__ hout, int64_t Bt, int64_t nc,
                           int64_t H, int64_t Q, int64_t NP) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= Bt * H * NP) return;
  const int64_t e = i % NP, bh = i / NP, h = bh % H, b = bh / H;
  float cur = 0.f;
  for (int64_t c = 0; c < nc; ++c) {
    const int64_t bc = b * nc + c;
    float* sp = states + (bc * H + h) * NP + e;
    const float s = *sp;
    *sp = cur;
    const float d = expf(cum[(bc * Q + Q - 1) * H + h]);
    cur = __fadd_rn(__fmul_rn(cur, d), s);
  }
  hout[bh * NP + e] = cur;
}

// 5. y for a (64 q) x (64 p) tile of one (b, c, h): the causal intra-chunk
// product over s <= q, plus exp(cum[q]) times C[q] . h_{c-1}.
template <typename T>
__global__ void __launch_bounds__(kThreads)
chunk_scan(const T* __restrict__ x, const float* __restrict__ dt,
           const T* __restrict__ Cm, const float* __restrict__ cum,
           const float* __restrict__ cb, const float* __restrict__ hin,
           T* __restrict__ y, int64_t H, int64_t P, int64_t N, int64_t Q) {
  const int64_t bch = blockIdx.x, h = bch % H, bc = bch / H;
  const int q0 = blockIdx.y * kTile, p0 = blockIdx.z * kTile;
  __shared__ float As[kStep][kTile + 1], Xs[kStep][kTile];
  __shared__ float cq[kTile], cs[kStep], dts[kStep];
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int64_t t0 = bc * Q;
  if (threadIdx.x < kTile) {
    const int64_t q = q0 + threadIdx.x;
    cq[threadIdx.x] = q < Q ? cum[(t0 + q) * H + h] : 0.f;
  }
  float acc[4][4] = {}, inter[4][4] = {};
  const int64_t s_end = q0 + kTile < Q ? q0 + kTile : Q;
  for (int64_t s0 = 0; s0 < s_end; s0 += kStep) {
    if (threadIdx.x < kStep) {
      const int64_t s = s0 + threadIdx.x, ts = (t0 + s) * H + h;
      cs[threadIdx.x] = s < Q ? cum[ts] : 0.f;
      dts[threadIdx.x] = s < Q ? dt[ts] : 0.f;
    }
    __syncthreads();
    for (int e = threadIdx.x; e < kTile * kStep; e += kThreads) {
      const int r = e / kStep, k = e % kStep;
      const int64_t q = q0 + r, s = s0 + k;
      float w = 0.f;
      if (s <= q && q < Q)   // causal: the decay's exponent is <= 0 here
        w = __fmul_rn(__fmul_rn(cb[(bc * Q + q) * Q + s],
                                expf(cq[r] - cs[k])),
                      dts[k]);
      As[k][r] = w;
    }
    for (int e = threadIdx.x; e < kStep * kTile; e += kThreads) {
      const int k = e / kTile, c = e % kTile;
      const int64_t s = s0 + k, p = p0 + c;
      Xs[k][c] = (s < Q && p < P) ? ld(x + ((t0 + s) * H + h) * P + p)
                                  : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int k = 0; k < kStep; ++k) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[i] = As[k][ty + 16 * i];
        b[i] = Xs[k][tx + 16 * i];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
  const float* hc = hin + (bc * H + h) * N * P;
  for (int64_t n0 = 0; n0 < N; n0 += kStep) {
    for (int e = threadIdx.x; e < kTile * kStep; e += kThreads) {
      const int r = e / kStep, k = e % kStep;
      const int64_t q = q0 + r, n = n0 + k;
      As[k][r] = (q < Q && n < N) ? ld(Cm + (t0 + q) * N + n) : 0.f;
    }
    for (int e = threadIdx.x; e < kStep * kTile; e += kThreads) {
      const int k = e / kTile, c = e % kTile;
      const int64_t n = n0 + k, p = p0 + c;
      Xs[k][c] = (n < N && p < P) ? hc[n * P + p] : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int k = 0; k < kStep; ++k) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[i] = As[k][ty + 16 * i];
        b[i] = Xs[k][tx + 16 * i];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          inter[i][j] = fmaf(a[i], b[j], inter[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    const int64_t q = q0 + r;
    if (q >= Q) continue;
    const float eq = expf(cq[r]);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int64_t p = p0 + tx + 16 * j;
      if (p < P)
        st(y + ((t0 + q) * H + h) * P + p,
           __fadd_rn(acc[i][j], __fmul_rn(inter[i][j], eq)));
    }
  }
}

int64_t cdiv(int64_t a, int64_t b) { return (a + b - 1) / b; }

template <typename T>
int launch(const void* xv, const float* dt, const float* A, const void* Bv,
           const void* Cv, void* yv, float* hout, float* cum, float* cb,
           float* states, int64_t Bt, int64_t T_, int64_t H, int64_t P,
           int64_t N, int64_t Q, cudaStream_t stream) {
  const T* x = static_cast<const T*>(xv);
  const T* Bm = static_cast<const T*>(Bv);
  const T* Cm = static_cast<const T*>(Cv);
  T* y = static_cast<T*>(yv);
  const int64_t nc = T_ / Q;
  cudaError_t err;
  chunk_cumsum<<<(unsigned)cdiv(Bt * nc * H, kThreads), kThreads, 0,
                 stream>>>(dt, A, cum, Bt, nc, H, Q);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const dim3 g_cb((unsigned)(Bt * nc), (unsigned)cdiv(Q, kTile),
                  (unsigned)cdiv(Q, kTile));
  chunk_cb<T><<<g_cb, kThreads, 0, stream>>>(Bm, Cm, cb, Q, N);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const dim3 g_st((unsigned)(Bt * nc * H), (unsigned)cdiv(N, kRows),
                  (unsigned)cdiv(P, kTile));
  chunk_state<T><<<g_st, kThreads, 0, stream>>>(x, dt, Bm, cum, states, H, P,
                                                 N, Q);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  state_pass<<<(unsigned)cdiv(Bt * H * N * P, kThreads), kThreads, 0,
               stream>>>(states, cum, hout, Bt, nc, H, Q, N * P);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const dim3 g_sc((unsigned)(Bt * nc * H), (unsigned)cdiv(Q, kTile),
                  (unsigned)cdiv(P, kTile));
  chunk_scan<T><<<g_sc, kThreads, 0, stream>>>(x, dt, Cm, cum, cb, states, y,
                                                H, P, N, Q);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x (Bt, T, H, P), B and C (Bt, T, N), y (Bt, T, H, P): f32 (bf16 = 0) or
// bf16 (bf16 = 1); dt (Bt, T, H), A (Bt, H), h (Bt, H, N, P) f32; all
// contiguous.  Scratch (f32, contiguous): cum (Bt, T, H), cb (Bt, T/Q, Q,
// Q), states (Bt, T/Q, H, N, P).  Q divides T.
int ssd_chunk_scan(const void* x, const float* dt, const float* A,
                   const void* Bm, const void* Cm, void* y, float* h,
                   float* cum, float* cb, float* states, int64_t Bt,
                   int64_t T, int64_t H, int64_t P, int64_t N, int64_t Q,
                   int bf16, void* stream) {
  if (Bt <= 0 || T <= 0 || H <= 0 || P <= 0 || N <= 0 || Q <= 0 || T % Q)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  return bf16 ? launch<__nv_bfloat16>(x, dt, A, Bm, Cm, y, h, cum, cb, states,
                                      Bt, T, H, P, N, Q, st)
              : launch<float>(x, dt, A, Bm, Cm, y, h, cum, cb, states, Bt, T,
                              H, P, N, Q, st);
}

}  // extern "C"
