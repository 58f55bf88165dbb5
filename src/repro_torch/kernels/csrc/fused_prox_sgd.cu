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
// Plain C interface (loaded with ctypes); each entry launches on the
// caller's stream and returns cudaGetLastError().

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

}  // extern "C"
