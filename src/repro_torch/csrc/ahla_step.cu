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
// TB/s device-memory rate (64 rows: 25.3 MB, 7.6 us).
//
// Design: each row is one thread-block cluster of CLUSTER = 4 CTAs of 256
// threads (step_cluster.cuh).  CTA j owns a column slice of every matrix:
// R[:, C_j], P[:, E_j] and E[:, E_j].  Its share, 3 * 128 * 32 * 4 = 48 KB
// at d = dv = 128, is copied into shared memory by TMA, one 2D copy per
// matrix issued by thread 0: m, n and P first, then E and R once P has
// landed, so P arrives at the front of the queue, and its 16 KB per CTA
// (4.2 MB over 256 CTAs at 64 rows, 2 CTAs on each SM) are written back
// while E and R (32 KB per CTA) stream in.  Everything is column-local,
// from the old values:
//   r[e] = q.P1[:, e] = g q.P0[:, e] + (q.k) v[e]
//   o[e] = q.E1[:, e] = g q.E0[:, e] + (q.k) r[e]
// and P1 = g P0 + k v^T, E1 = g E0 + k r^T, R1 = R0 + k q^T go back to
// device memory with 16-byte stores as each matrix lands.  The scalars
// s = q.m1 = g q.m0 + q.k and den = q.n1 = g q.n0 + s q.k are warp sums
// that every warp computes for itself.
//
// So the cluster shares nothing but the vectors m and n, read by every CTA
// and rewritten in place: every CTA has its copy of the old ones in shared
// memory before it arrives at the cluster barrier, and only rank 0 writes
// m1 = g m0 + k and n1 = g n0 + s k after it.

#include <cuda_runtime.h>

#include "step_cluster.cuh"

namespace {

using namespace step_cluster;

template <typename T>
__global__ void __launch_bounds__(THREADS)
    ahla_step_kernel(const __grid_constant__ CUtensorMap tR,
                     const __grid_constant__ CUtensorMap tP,
                     const __grid_constant__ CUtensorMap tE,
                     const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const float* __restrict__ gamma,
                     T* __restrict__ o, float* __restrict__ R,
                     float* __restrict__ P, float* __restrict__ m,
                     float* __restrict__ E, float* __restrict__ nv, int d,
                     int dv, int normalize, float eps) {
  extern __shared__ __align__(128) float sm[];
  const int rank = (int)cg::this_cluster().block_rank();
  const Slice sc = slice_of(d, rank), se = slice_of(dv, rank);
  uint64_t* bars = reinterpret_cast<uint64_t*>(sm);  // m and n, P, E, R
  float* Ps = sm + 32;                   // d x se.cw  P0[:, E_j]
  float* Es = Ps + slice_floats(d, dv);  // d x se.cw  E0[:, E_j]
  float* Rs = Es + slice_floats(d, dv);  // d x sc.cw  R0[:, C_j]
  float* ms = Rs + slice_floats(d, d);   // d          old m
  float* ns = ms + d;                    // d          old n
  float* qs = ns + d;                    // d
  float* ks = qs + d;                    // d
  float* vs = ks + d;                    // se.cw      v[E_j]
  float* rs = vs + se.cw;                // se.cw      r[E_j]
  float* red = rs + se.cw;               // 2 x THREADS partial column sums

  const size_t row = blockIdx.x / CLUSTER;
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
  const float g = gamma ? gamma[row] : 1.f;

  // m, n and P first, each one TMA copy from thread 0: E waits on r, so P
  // must land first, alone
  if (tid == 0) {
    init_bars(bars, 4);
    expect_bytes(bars, 2 * d * sizeof(float));
    bulk_load(ms, m, d * sizeof(float), bars);
    bulk_load(ns, nv, d * sizeof(float), bars);
    expect_bytes(bars + 1, box_bytes(d, se));
    load_box(Ps, tP, se, row * d, bars + 1);
  }
  for (int i = tid; i < d; i += THREADS) {
    qs[i] = to_f(q[i]);
    ks[i] = to_f(k[i]);
  }
  for (int b = tid; b < se.w; b += THREADS) vs[b] = to_f(v[se.c0 + b]);
  __syncthreads();
  wait_bar(bars);
  cluster_arrive();  // this CTA has read the old m, n
  const float qk = warp_dot(qs, ks, d), qm = warp_dot(qs, ms, d),
              qn = warp_dot(qs, ns, d);
  const float s = g * qm + qk;  // q . m1, m1 = g m0 + k

  // P1 = g P0 + k v^T; r = q^T P1; E and R on their way meanwhile
  wait_bar(bars + 1);
  if (tid == 0) {
    expect_bytes(bars + 2, box_bytes(d, se));
    load_box(Es, tE, se, row * d, bars + 2);
    expect_bytes(bars + 3, box_bytes(d, sc));
    load_box(Rs, tR, sc, row * d, bars + 3);
  }
  col_partials(Ps, d, se, qs, red);
  update_slice(P, d, dv, se, Ps, g, 1.f, ks, vs);
  __syncthreads();
  for (int b = tid; b < se.w; b += THREADS)
    rs[b] = fmaf(qk, vs[b], g * col_total(red, se.w, b));

  // E1 = g E0 + k r^T; o = q^T E1, den = q . n1 = g q . n0 + s q . k
  wait_bar(bars + 2);
  __syncthreads();  // publishes r
  col_partials(Es, d, se, qs, red + THREADS);
  update_slice(E, d, dv, se, Es, g, 1.f, ks, rs);
  __syncthreads();
  const float den = g * qn + s * qk + eps;
  for (int b = tid; b < se.w; b += THREADS) {
    const float x = fmaf(qk, rs[b], g * col_total(red + THREADS, se.w, b));
    store(o + se.c0 + b, normalize ? x / den : x);
  }

  // R1 = R0 + k q^T
  wait_bar(bars + 3);
  update_slice(R, d, d, sc, Rs, 1.f, 1.f, ks, qs + sc.c0);

  // every CTA of the row has read the old m, n
  cluster_wait();
  if (rank == 0) {
    for (int i = tid; i < d; i += THREADS) {
      m[i] = g * ms[i] + ks[i];
      nv[i] = g * ns[i] + s * ks[i];
    }
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const float* gamma, void* o, float* R, float* P, float* m,
                   float* E, float* n, int BH, int d, int dv, int normalize,
                   float eps, cudaStream_t stream) {
  CUtensorMap tR, tP, tE;
  cudaError_t err = slice_map(&tR, R, BH * d, d, d);
  if (err == cudaSuccess) err = slice_map(&tP, P, BH * d, dv, d);
  if (err == cudaSuccess) err = slice_map(&tE, E, BH * d, dv, d);
  if (err != cudaSuccess) return err;
  const int ce = slice_width(dv);
  const size_t smem = (size_t)(32 + slice_floats(d, d) +
                               2 * slice_floats(d, dv) + 4 * d + 2 * ce +
                               2 * THREADS) *
                      sizeof(float);
  return launch_rows(ahla_step_kernel<T>, BH, d, dv, smem, stream, tR, tP, tE,
                     static_cast<const T*>(q), static_cast<const T*>(k),
                     static_cast<const T*>(v), gamma, static_cast<T*>(o), R,
                     P, m, E, n, d, dv, normalize, eps);
}

}  // namespace

extern "C" {

// q, k: (BH, d); v, o: (BH, dv) in bf16 (is_bf16) or fp32; gamma: (BH,)
// fp32 or null; R (BH, d, d), P, E (BH, d, dv), m, n (BH, d): fp32 state,
// updated in place; d, dv multiples of 4, d <= 256, dv <= 1024, every state
// tensor 16-byte aligned.  Returns the CUDA error of the launch (0 =
// launched).
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
