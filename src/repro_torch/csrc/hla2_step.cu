// One HLA2 decode token for every (slot*head) row, state updated in place,
// for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/decode_step.py, hla2_step_pallas (body
// _hla2_step_kernel), whose state operands alias its outputs.
//
// Bound on this card: bytes.  Each row reads and rewrites its fp32 state,
// 2 * (3 d dv-sized matrices + 2 d-vectors) ~ 395 KB at d = dv = 128, for
// about 4 FLOP per state element read: far below the ridge, so the floor
// is the 3.35 TB/s device-memory rate.
//
// Design: one CTA of 128 threads per row; thread j owns column j of S, C
// and G, so a warp's loads and stores are consecutive floats.  Each state
// element is read once and written once.  Pass 1 updates S and reduces
// u = q^T S1 over rows into shared memory; after one barrier, pass 2
// updates C (reducing k^T C0, u^T C0 and q^T C0 from the old values: the
// cross summaries read the previous C) and then G.  Loads go in groups of
// eight per thread to keep several requests in flight.  The scalar dot
// products of q, k, u, m and h are recomputed by every thread from shared
// memory, which costs less than a block reduction at d = 128.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int THREADS = 128;
constexpr int U = 8;  // loads in flight per thread

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
    hla2_step_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const float* __restrict__ gamma,
                     T* __restrict__ o, float* __restrict__ S,
                     float* __restrict__ C, float* __restrict__ m,
                     float* __restrict__ G, float* __restrict__ h, int d,
                     int dv, int normalize, float eps, float lam) {
  extern __shared__ float sm[];
  float* qs = sm;      // d
  float* ks = qs + d;  // d
  float* ms = ks + d;  // d   old m
  float* hs = ms + d;  // d   old h
  float* us = hs + d;  // d   u = q^T S1
  float* vs = us + d;  // dv

  const size_t row = blockIdx.x;
  q += row * d;
  k += row * d;
  v += row * dv;
  o += row * dv;
  S += row * d * d;
  C += row * d * dv;
  m += row * d;
  G += row * d * dv;
  h += row * d;
  const int tid = threadIdx.x;
  const float g = gamma ? gamma[row] : 1.f;

  for (int i = tid; i < d; i += THREADS) {
    qs[i] = to_f(q[i]);
    ks[i] = to_f(k[i]);
    ms[i] = m[i];
    hs[i] = h[i];
  }
  for (int e = tid; e < dv; e += THREADS) vs[e] = to_f(v[e]);
  __syncthreads();

  float km = 0.f, qk = 0.f, qq = 0.f, qm = 0.f, qh = 0.f;
  for (int i = 0; i < d; ++i) {
    km = fmaf(ks[i], ms[i], km);
    qk = fmaf(qs[i], ks[i], qk);
    qq = fmaf(qs[i], qs[i], qq);
    qm = fmaf(qs[i], ms[i], qm);
    qh = fmaf(qs[i], hs[i], qh);
  }
  // m1 = g m0 + q;  h1 = g^2 h0 + g k (k . m0)
  for (int i = tid; i < d; i += THREADS) {
    m[i] = g * ms[i] + qs[i];
    h[i] = g * g * hs[i] + g * ks[i] * km;
  }

  // pass 1: S1 = g S0 + k k^T, u = q^T S1
  for (int b = tid; b < d; b += THREADS) {
    const float kb = ks[b];
    float acc = 0.f;
    for (int a0 = 0; a0 < d; a0 += U) {
      float s[U];
#pragma unroll
      for (int j = 0; j < U; ++j)
        s[j] = a0 + j < d ? S[(size_t)(a0 + j) * d + b] : 0.f;
#pragma unroll
      for (int j = 0; j < U; ++j) {
        const int a = a0 + j;
        if (a < d) {
          const float s1 = fmaf(ks[a], kb, g * s[j]);
          S[(size_t)a * d + b] = s1;
          acc = fmaf(qs[a], s1, acc);
        }
      }
    }
    us[b] = acc;
  }
  __syncthreads();

  float uq = 0.f, um = 0.f;
  for (int i = 0; i < d; ++i) {
    uq = fmaf(us[i], qs[i], uq);
    um = fmaf(us[i], ms[i], um);
  }
  float den = 1.f;
  if (normalize) {
    // u.m1 - q.h1 + lam q.m1 with m1, h1 expanded from the old m, h
    den = (g * um + uq) - (g * g * qh + g * qk * km) + lam * (g * qm + qq) +
          eps;
  }

  // pass 2: C1 = g C0 + q v^T, G1 = g^2 G0 + g k (k^T C0), then
  // num = u^T C1 - q^T G1 + lam q^T C1
  for (int e = tid; e < dv; e += THREADS) {
    const float ve = vs[e];
    float kc = 0.f, uc = 0.f, qc = 0.f;
    for (int a0 = 0; a0 < d; a0 += U) {
      float c[U];
#pragma unroll
      for (int j = 0; j < U; ++j)
        c[j] = a0 + j < d ? C[(size_t)(a0 + j) * dv + e] : 0.f;
#pragma unroll
      for (int j = 0; j < U; ++j) {
        const int a = a0 + j;
        if (a < d) {
          kc = fmaf(ks[a], c[j], kc);
          uc = fmaf(us[a], c[j], uc);
          qc = fmaf(qs[a], c[j], qc);
          C[(size_t)a * dv + e] = fmaf(qs[a], ve, g * c[j]);
        }
      }
    }
    float qg = 0.f;
    for (int a0 = 0; a0 < d; a0 += U) {
      float gv[U];
#pragma unroll
      for (int j = 0; j < U; ++j)
        gv[j] = a0 + j < d ? G[(size_t)(a0 + j) * dv + e] : 0.f;
#pragma unroll
      for (int j = 0; j < U; ++j) {
        const int a = a0 + j;
        if (a < d) {
          const float g1 = fmaf(g * ks[a], kc, g * g * gv[j]);
          G[(size_t)a * dv + e] = g1;
          qg = fmaf(qs[a], g1, qg);
        }
      }
    }
    const float uc1 = g * uc + ve * uq;  // u^T C1
    const float qc1 = g * qc + ve * qq;  // q^T C1
    const float num = uc1 - qg + lam * qc1;
    store(o + e, normalize ? num / den : num);
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const float* gamma, void* o, float* S, float* C, float* m,
                   float* G, float* h, int BH, int d, int dv, int normalize,
                   float eps, float lam, cudaStream_t stream) {
  const size_t smem = (size_t)(5 * d + dv) * sizeof(float);
  hla2_step_kernel<T><<<BH, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), gamma, static_cast<T*>(o), S, C, m, G, h, d,
      dv, normalize, eps, lam);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// q, k: (BH, d); v, o: (BH, dv) in bf16 (is_bf16) or fp32; gamma: (BH,)
// fp32 or null; S (BH, d, d), C, G (BH, d, dv), m, h (BH, d): fp32 state,
// updated in place.  Returns the CUDA error of the launch (0 = launched).
int hla2_step(const void* q, const void* k, const void* v, const float* gamma,
              void* o, float* S, float* C, float* m, float* G, float* h,
              int BH, int d, int dv, int is_bf16, int normalize, float eps,
              float lam, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = is_bf16 ? launch<__nv_bfloat16>(q, k, v, gamma, o, S, C, m, G, h, BH,
                                        d, dv, normalize, eps, lam, s)
                : launch<float>(q, k, v, gamma, o, S, C, m, G, h, BH, d, dv,
                                normalize, eps, lam, s);
  return (int)err;
}

}  // extern "C"
