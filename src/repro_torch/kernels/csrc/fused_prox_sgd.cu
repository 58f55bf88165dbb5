// Fused proximal-SGD update (paper Eq. 8 + momentum), one streaming pass.
//
// Replaces the TPU kernels fused_prox_sgd (scalar rho/eta baked in) and
// fused_prox_sgd_dyn (per-row rho column, traced eta) of
// src/repro/kernels/fused_prox_sgd.py.  On the (R, C) view of a leaf:
//
//     g_tot = g + rho[r] * (theta - z + u)
//     m'    = mu * m + g_tot
//     theta'= theta - eta * m'
//
// Bound on an H100: bytes.  Five f32 reads and two f32 writes per element
// (28 B) against ~8 flops, three orders of magnitude below the card's
// flop/byte balance point, so the least time is 28 B * n / 3.35 TB/s.
// Design: a grid-stride loop over the flat element index, with 16-byte
// float4 loads and stores when the row width allows it (C % 4 == 0, so a
// vector never straddles two rows and their rho values); rho comes from a
// per-row column or, as for every ResNet leaf, one value per leaf (stride
// 0), read once per thread like eta.  Every operation is an explicit
// round-to-nearest intrinsic in the reference's order, so nvcc cannot
// contract a multiply-add into an FMA and the result is the same, bit for
// bit, as PyTorch's plain elementwise version.
//
// The bf16 entries (the TPU kernels are dtype-generic: their outputs take
// theta's dtype) read and write bf16 (14 B an element) and follow JAX's
// bf16 arithmetic, which the plain PyTorch version reproduces: each
// operation computes in f32 from bf16 operands and rounds its result to
// bf16 (round to nearest even) before the next one uses it, and rho, eta
// and the momentum are bf16 values.  Every rounding is explicit, so no
// multiply-add contracts across one.  Design: the f32 kernels' grid-stride
// loop with 16-byte loads of eight bf16 where C % 8 == 0.
//
// Plain C interface (loaded with ctypes); each entry launches on the
// caller's stream and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float prox_one(float th, float g, float z, float u,
                                          float m, float rho, float eta,
                                          float mu, float* m_out) {
  float gtot = __fadd_rn(g, __fmul_rn(rho, __fadd_rn(__fsub_rn(th, z), u)));
  float mn = __fadd_rn(__fmul_rn(mu, m), gtot);
  *m_out = mn;
  return __fsub_rn(th, __fmul_rn(eta, mn));
}

// rho: per-row column (rho_stride 1) or one value (rho_stride 0), or null
// for the scalar-rho entry; eta: one device value, or null for the scalar.
// A single rho is read once per thread: the row index (a 64-bit division)
// is only computed for a true per-row column.
__global__ void prox_sgd_scalar_kernel(
    const float* __restrict__ th, const float* __restrict__ g,
    const float* __restrict__ z, const float* __restrict__ u,
    const float* __restrict__ m, const float* __restrict__ rho,
    int64_t rho_stride, float rho_s, const float* __restrict__ eta,
    float eta_s, float mu, float* __restrict__ th_out,
    float* __restrict__ m_out, int64_t n, int64_t C) {
  const float e = eta ? __ldg(eta) : eta_s;
  const float r0 = rho ? __ldg(rho) : rho_s;
  const bool per_row = rho && rho_stride;
  const int64_t step = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += step) {
    const float r = per_row ? __ldg(rho + i / C) : r0;
    float mn;
    th_out[i] = prox_one(__ldg(th + i), __ldg(g + i), __ldg(z + i),
                         __ldg(u + i), __ldg(m + i), r, e, mu, &mn);
    m_out[i] = mn;
  }
}

__global__ void prox_sgd_vec4_kernel(
    const float4* __restrict__ th, const float4* __restrict__ g,
    const float4* __restrict__ z, const float4* __restrict__ u,
    const float4* __restrict__ m, const float* __restrict__ rho,
    int64_t rho_stride, float rho_s, const float* __restrict__ eta,
    float eta_s, float mu, float4* __restrict__ th_out,
    float4* __restrict__ m_out, int64_t n4, int64_t C4) {
  const float e = eta ? __ldg(eta) : eta_s;
  const float r0 = rho ? __ldg(rho) : rho_s;
  const bool per_row = rho && rho_stride;
  const int64_t step = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n4;
       i += step) {
    const float r = per_row ? __ldg(rho + i / C4) : r0;
    const float4 a = __ldg(th + i), b = __ldg(g + i), c = __ldg(z + i),
                 d = __ldg(u + i), f = __ldg(m + i);
    float4 to, mo;
    to.x = prox_one(a.x, b.x, c.x, d.x, f.x, r, e, mu, &mo.x);
    to.y = prox_one(a.y, b.y, c.y, d.y, f.y, r, e, mu, &mo.y);
    to.z = prox_one(a.z, b.z, c.z, d.z, f.z, r, e, mu, &mo.z);
    to.w = prox_one(a.w, b.w, c.w, d.w, f.w, r, e, mu, &mo.w);
    th_out[i] = to;
    m_out[i] = mo;
  }
}


// ---------------------------------------------------------------------------
// bf16: a value is its 16-bit word; bf16 -> f32 is exact, f32 -> bf16 is
// the hardware's round to nearest even (one cvt.rn.bf16.f32).
// ---------------------------------------------------------------------------

__device__ __forceinline__ float bf_f32(uint32_t h) {
  return __uint_as_float(h << 16);
}

__device__ __forceinline__ uint32_t f32_bf(float x) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(x));
}

// one bf16 operation's result: the f32 result rounded to bf16
__device__ __forceinline__ float rb(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ uint32_t prox_one_bf16(uint32_t th, uint32_t g,
                                                  uint32_t z, uint32_t u,
                                                  uint32_t m, float rho,
                                                  float eta, float mu,
                                                  uint32_t* m_out) {
  const float t = bf_f32(th);
  const float d = rb(__fadd_rn(rb(__fsub_rn(t, bf_f32(z))), bf_f32(u)));
  const float gtot = rb(__fadd_rn(bf_f32(g), rb(__fmul_rn(rho, d))));
  const float mn = rb(__fadd_rn(rb(__fmul_rn(mu, bf_f32(m))), gtot));
  *m_out = f32_bf(mn);
  return f32_bf(__fsub_rn(t, rb(__fmul_rn(eta, mn))));
}

// rho and eta as in the f32 kernels, their values bf16 words; mu a bf16
// value passed as f32.
__global__ void prox_sgd_bf16_scalar_kernel(
    const uint16_t* __restrict__ th, const uint16_t* __restrict__ g,
    const uint16_t* __restrict__ z, const uint16_t* __restrict__ u,
    const uint16_t* __restrict__ m, const uint16_t* __restrict__ rho,
    int64_t rho_stride, float rho_s, const uint16_t* __restrict__ eta,
    float eta_s, float mu, uint16_t* __restrict__ th_out,
    uint16_t* __restrict__ m_out, int64_t n, int64_t C) {
  const float e = eta ? bf_f32(__ldg(eta)) : eta_s;
  const float r0 = rho ? bf_f32(__ldg(rho)) : rho_s;
  const bool per_row = rho && rho_stride;
  const int64_t step = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += step) {
    const float r = per_row ? bf_f32(__ldg(rho + i / C)) : r0;
    uint32_t mn;
    th_out[i] = (uint16_t)prox_one_bf16(__ldg(th + i), __ldg(g + i),
                                        __ldg(z + i), __ldg(u + i),
                                        __ldg(m + i), r, e, mu, &mn);
    m_out[i] = (uint16_t)mn;
  }
}

// eight bf16 a 16-byte vector; C % 8 == 0, so a vector lies in one row
__global__ void prox_sgd_bf16_vec8_kernel(
    const uint4* __restrict__ th, const uint4* __restrict__ g,
    const uint4* __restrict__ z, const uint4* __restrict__ u,
    const uint4* __restrict__ m, const uint16_t* __restrict__ rho,
    int64_t rho_stride, float rho_s, const uint16_t* __restrict__ eta,
    float eta_s, float mu, uint4* __restrict__ th_out,
    uint4* __restrict__ m_out, int64_t n8, int64_t C8) {
  const float e = eta ? bf_f32(__ldg(eta)) : eta_s;
  const float r0 = rho ? bf_f32(__ldg(rho)) : rho_s;
  const bool per_row = rho && rho_stride;
  const int64_t step = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n8;
       i += step) {
    const float r = per_row ? bf_f32(__ldg(rho + i / C8)) : r0;
    const uint4 a = __ldg(th + i), b = __ldg(g + i), c = __ldg(z + i),
                d = __ldg(u + i), f = __ldg(m + i);
    const uint32_t A[4] = {a.x, a.y, a.z, a.w}, B[4] = {b.x, b.y, b.z, b.w},
                   Cz[4] = {c.x, c.y, c.z, c.w}, D[4] = {d.x, d.y, d.z, d.w},
                   F[4] = {f.x, f.y, f.z, f.w};
    uint32_t T[4], M[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      uint32_t mlo, mhi;
      const uint32_t tlo = prox_one_bf16(A[k] & 0xffffu, B[k] & 0xffffu,
                                         Cz[k] & 0xffffu, D[k] & 0xffffu,
                                         F[k] & 0xffffu, r, e, mu, &mlo);
      const uint32_t thi = prox_one_bf16(A[k] >> 16, B[k] >> 16, Cz[k] >> 16,
                                         D[k] >> 16, F[k] >> 16, r, e, mu,
                                         &mhi);
      T[k] = tlo | (thi << 16);
      M[k] = mlo | (mhi << 16);
    }
    th_out[i] = make_uint4(T[0], T[1], T[2], T[3]);
    m_out[i] = make_uint4(M[0], M[1], M[2], M[3]);
  }
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15u) == 0; }

int launch(const float* th, const float* g, const float* z, const float* u,
           const float* m, const float* rho, int64_t rho_stride, float rho_s,
           const float* eta, float eta_s, float mu, float* th_out,
           float* m_out, int64_t n, int64_t C, cudaStream_t stream) {
  if (n <= 0) return (int)cudaSuccess;
  const int threads = 256;
  // enough blocks to cover every element once, capped so the grid-stride
  // loop keeps each SM at full occupancy (132 SMs x 8 blocks of 256)
  const int64_t max_blocks = 132 * 8;
  const bool vec = (C % 4 == 0) && aligned16(th) && aligned16(g) &&
                   aligned16(z) && aligned16(u) && aligned16(m) &&
                   aligned16(th_out) && aligned16(m_out);
  if (vec) {
    const int64_t n4 = n / 4;
    int64_t blocks = (n4 + threads - 1) / threads;
    if (blocks > max_blocks) blocks = max_blocks;
    prox_sgd_vec4_kernel<<<(unsigned)blocks, threads, 0, stream>>>(
        (const float4*)th, (const float4*)g, (const float4*)z,
        (const float4*)u, (const float4*)m, rho, rho_stride, rho_s, eta,
        eta_s, mu, (float4*)th_out, (float4*)m_out, n4, C / 4);
  } else {
    int64_t blocks = (n + threads - 1) / threads;
    if (blocks > max_blocks) blocks = max_blocks;
    prox_sgd_scalar_kernel<<<(unsigned)blocks, threads, 0, stream>>>(
        th, g, z, u, m, rho, rho_stride, rho_s, eta, eta_s, mu, th_out,
        m_out, n, C);
  }
  return (int)cudaGetLastError();
}

int launch_bf16(const uint16_t* th, const uint16_t* g, const uint16_t* z,
                const uint16_t* u, const uint16_t* m, const uint16_t* rho,
                int64_t rho_stride, float rho_s, const uint16_t* eta,
                float eta_s, float mu, uint16_t* th_out, uint16_t* m_out,
                int64_t n, int64_t C, cudaStream_t stream) {
  if (n <= 0) return (int)cudaSuccess;
  const int threads = 256;
  const int64_t max_blocks = 132 * 8;
  const bool vec = (C % 8 == 0) && aligned16(th) && aligned16(g) &&
                   aligned16(z) && aligned16(u) && aligned16(m) &&
                   aligned16(th_out) && aligned16(m_out);
  if (vec) {
    const int64_t n8 = n / 8;
    int64_t blocks = (n8 + threads - 1) / threads;
    if (blocks > max_blocks) blocks = max_blocks;
    prox_sgd_bf16_vec8_kernel<<<(unsigned)blocks, threads, 0, stream>>>(
        (const uint4*)th, (const uint4*)g, (const uint4*)z, (const uint4*)u,
        (const uint4*)m, rho, rho_stride, rho_s, eta, eta_s, mu,
        (uint4*)th_out, (uint4*)m_out, n8, C / 8);
  } else {
    int64_t blocks = (n + threads - 1) / threads;
    if (blocks > max_blocks) blocks = max_blocks;
    prox_sgd_bf16_scalar_kernel<<<(unsigned)blocks, threads, 0, stream>>>(
        th, g, z, u, m, rho, rho_stride, rho_s, eta, eta_s, mu, th_out,
        m_out, n, C);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// fused_prox_sgd_dyn: rho a per-row device column (stride 0 or 1), eta a
// device scalar — both change every round without a rebuild.
int prox_sgd_dyn_f32(const float* th, const float* g, const float* z,
                     const float* u, const float* m, const float* rho,
                     int64_t rho_stride, const float* eta, float mu,
                     float* th_out, float* m_out, int64_t n, int64_t C,
                     void* stream) {
  return launch(th, g, z, u, m, rho, rho_stride, 0.f, eta, 0.f, mu, th_out,
                m_out, n, C, (cudaStream_t)stream);
}

// fused_prox_sgd: rho and eta passed by value.
int prox_sgd_f32(const float* th, const float* g, const float* z,
                 const float* u, const float* m, float rho, float eta,
                 float mu, float* th_out, float* m_out, int64_t n, int64_t C,
                 void* stream) {
  return launch(th, g, z, u, m, nullptr, 0, rho, nullptr, eta, mu, th_out,
                m_out, n, C, (cudaStream_t)stream);
}

// The bf16 entries: operands, rho and eta bf16 words; mu, and the scalar
// entry's rho and eta, bf16 values passed as f32.
int prox_sgd_dyn_bf16(const uint16_t* th, const uint16_t* g,
                      const uint16_t* z, const uint16_t* u, const uint16_t* m,
                      const uint16_t* rho, int64_t rho_stride,
                      const uint16_t* eta, float mu, uint16_t* th_out,
                      uint16_t* m_out, int64_t n, int64_t C, void* stream) {
  return launch_bf16(th, g, z, u, m, rho, rho_stride, 0.f, eta, 0.f, mu,
                     th_out, m_out, n, C, (cudaStream_t)stream);
}

int prox_sgd_bf16(const uint16_t* th, const uint16_t* g, const uint16_t* z,
                  const uint16_t* u, const uint16_t* m, float rho, float eta,
                  float mu, uint16_t* th_out, uint16_t* m_out, int64_t n,
                  int64_t C, void* stream) {
  return launch_bf16(th, g, z, u, m, nullptr, 0, rho, nullptr, eta, mu,
                     th_out, m_out, n, C, (cudaStream_t)stream);
}

}  // extern "C"
