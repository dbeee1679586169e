// One AHLA decode token for every (slot*head) row, state updated in place,
// for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/decode_step.py, ahla_step_pallas (body
// _ahla_step_kernel), whose state operands alias its outputs.
//
// Computes Algorithm 2 for one token, with the inclusive P (Theorem 6.1):
//   [P | m] <- g [P | m] + k [v | 1]^T,   [r | s] = q^T [P | m]
//   [E | n] <- g [E | n] + k [r | s]^T,   [o | den] = q^T [E | n]
//   R <- R + k q^T                         (undecayed; no output reads it)
// and o, or o / (den + eps) under normalisation.
//
// Bound on this card: bytes.  Each row reads and rewrites its fp32 state,
// 2 * (d d + 2 d dv + 2 d) floats ~ 395 KB at d = dv = 128, for about 2
// FLOP per state element: far below the ridge, so the floor is the 3.35
// TB/s device-memory rate.
//
// Design: one CTA of 512 threads per row, as 4 row groups of 128 column
// threads: thread (g, e) owns column e of P, E and R over the rows of its
// group, so a warp's loads and stores are consecutive floats, and each
// state element is read once and written once.  Column e of the E update
// needs only r[e], a sum over rows of column e of the new P: the four
// groups' partial sums meet in shared memory after one barrier; the output
// likewise after a second.  The scalars s and den are q . m and q . n of
// the new vectors, expanded from the old ones (copied to shared memory
// before any thread rewrites them) and recomputed by every thread.  Loads
// go in groups of eight per thread to keep several requests in flight.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int CT = 128;  // column threads
constexpr int NG = 4;    // row groups
constexpr int THREADS = CT * NG;
constexpr int U = 8;  // loads in flight per thread

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// Column e of the (d, cols) matrix X over this thread's rows (groups of U
// consecutive rows, NG*U apart): X[a][e] <- g X[a][e] + u[a] w; returns the
// partial sum of q[a] X_new[a][e].
__device__ __forceinline__ float update_column(float* X, int cols, int e,
                                               int group, int d, float g,
                                               const float* u, float w,
                                               const float* qs) {
  float acc = 0.f;
  for (int a0 = group * U; a0 < d; a0 += NG * U) {
    float x[U];
#pragma unroll
    for (int j = 0; j < U; ++j)
      x[j] = a0 + j < d ? X[(size_t)(a0 + j) * cols + e] : 0.f;
#pragma unroll
    for (int j = 0; j < U; ++j) {
      const int a = a0 + j;
      if (a < d) {
        const float x1 = fmaf(u[a], w, g * x[j]);
        X[(size_t)a * cols + e] = x1;
        acc = fmaf(qs[a], x1, acc);
      }
    }
  }
  return acc;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
    ahla_step_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const float* __restrict__ gamma,
                     T* __restrict__ o, float* __restrict__ R,
                     float* __restrict__ P, float* __restrict__ m,
                     float* __restrict__ E, float* __restrict__ nv, int d,
                     int dv, int normalize, float eps) {
  extern __shared__ float sm[];
  float* qs = sm;        // d
  float* ks = qs + d;    // d
  float* ms = ks + d;    // d          old m
  float* ns = ms + d;    // d          old n
  float* vs = ns + d;    // dv
  float* rb = vs + dv;   // dv         r = q^T P1
  float* red = rb + dv;  // NG x dv    partial column sums

  const size_t row = blockIdx.x;
  q += row * d;
  k += row * d;
  v += row * dv;
  o += row * dv;
  R += row * d * d;
  P += row * d * dv;
  m += row * d;
  E += row * d * dv;
  nv += row * d;
  const int tid = threadIdx.x;
  const int col = tid % CT, group = tid / CT;
  const float g = gamma ? gamma[row] : 1.f;

  for (int i = tid; i < d; i += THREADS) {
    qs[i] = to_f(q[i]);
    ks[i] = to_f(k[i]);
    ms[i] = m[i];
    ns[i] = nv[i];
  }
  for (int e = tid; e < dv; e += THREADS) vs[e] = to_f(v[e]);
  __syncthreads();

  float qk = 0.f, qm = 0.f, qn = 0.f;
  for (int i = 0; i < d; ++i) {
    qk = fmaf(qs[i], ks[i], qk);
    qm = fmaf(qs[i], ms[i], qm);
    qn = fmaf(qs[i], ns[i], qn);
  }
  const float s = g * qm + qk;  // q . m1, m1 = g m0 + k
  // m1 = g m0 + k;  n1 = g n0 + s k
  for (int i = tid; i < d; i += THREADS) {
    m[i] = g * ms[i] + ks[i];
    nv[i] = g * ns[i] + s * ks[i];
  }

  // pass 1: P1 = g P0 + k v^T (partial r = q^T P1) and R += k q^T
  for (int e = col; e < dv; e += CT)
    red[group * dv + e] = update_column(P, dv, e, group, d, g, ks, vs[e], qs);
  for (int c = col; c < d; c += CT)
    update_column(R, d, c, group, d, 1.f, ks, qs[c], qs);
  __syncthreads();
  for (int e = tid; e < dv; e += THREADS) {
    float r = 0.f;
    for (int j = 0; j < NG; ++j) r += red[j * dv + e];
    rb[e] = r;
  }
  __syncthreads();

  // pass 2: E1 = g E0 + k r^T (partial o = q^T E1)
  for (int e = col; e < dv; e += CT)
    red[group * dv + e] = update_column(E, dv, e, group, d, g, ks, rb[e], qs);
  __syncthreads();
  // den = q . n1 = g q . n0 + s q . k
  const float den = g * qn + s * qk + eps;
  for (int e = tid; e < dv; e += THREADS) {
    float x = 0.f;
    for (int j = 0; j < NG; ++j) x += red[j * dv + e];
    store(o + e, normalize ? x / den : x);
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const float* gamma, void* o, float* R, float* P, float* m,
                   float* E, float* n, int BH, int d, int dv, int normalize,
                   float eps, cudaStream_t stream) {
  const size_t smem = (size_t)(4 * d + (2 + NG) * dv) * sizeof(float);
  ahla_step_kernel<T><<<BH, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), gamma, static_cast<T*>(o), R, P, m, E, n, d,
      dv, normalize, eps);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// q, k: (BH, d); v, o: (BH, dv) in bf16 (is_bf16) or fp32; gamma: (BH,)
// fp32 or null; R (BH, d, d), P, E (BH, d, dv), m, n (BH, d): fp32 state,
// updated in place.  Returns the CUDA error of the launch (0 = launched).
int ahla_step(const void* q, const void* k, const void* v, const float* gamma,
              void* o, float* R, float* P, float* m, float* E, float* n,
              int BH, int d, int dv, int is_bf16, int normalize, float eps,
              int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = is_bf16 ? launch<__nv_bfloat16>(q, k, v, gamma, o, R, P, m, E, n, BH,
                                        d, dv, normalize, eps, s)
                : launch<float>(q, k, v, gamma, o, R, P, m, E, n, BH, d, dv,
                                normalize, eps, s);
  return (int)err;
}

}  // extern "C"
