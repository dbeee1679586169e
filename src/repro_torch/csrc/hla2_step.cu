// One HLA2 decode token for every (slot*head) row, state updated in place,
// for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/decode_step.py, hla2_step_pallas (body
// _hla2_step_kernel), whose state operands alias its outputs.
//
// Bound on this card: bytes.  Each row reads and rewrites its fp32 state,
// 2 * (3 d dv-sized matrices + 2 d-vectors) ~ 395 KB at d = dv = 128, for
// 2-4 FLOP per state element: far below the ridge, so the floor is the
// 3.35 TB/s device-memory rate (64 rows: 25.3 MB, 7.6 us).
//
// Design: each row is one thread-block cluster of CLUSTER = 4 CTAs of 256
// threads (step_cluster.cuh).  CTA j owns a column slice of every matrix:
// S[:, B_j], C[:, E_j] and G[:, E_j] (ceil(cols / 4) columns rounded up to
// 4; the last slice narrower, some empty when cols is small).  Its share,
// 3 * 128 * 32 * 4 = 48 KB at d = dv = 128, is copied into shared memory by
// TMA, one 2D copy per matrix issued by thread 0: m, h and S first, then C
// and G once S has landed, so S arrives at the front of the queue, and its
// 16 KB per CTA (4.2 MB over 256 CTAs at 64 rows, 2 CTAs on each SM) are
// written back while C and G (32 KB per CTA) stream in.  Every sum runs on
// the old values, column by column:
//   u[b]       = q.S1[:, b]  = g q.S0[:, b] + (q.k) k[b]
//   kC[e]      = k.C0[:, e],  q.C1[:, e] = g q.C0[:, e] + (q.q) v[e]
//   q.G1[:, e] = g^2 q.G0[:, e] + g (q.k) kC[e]
//   u.C1[:, e] = g u.C0[:, e] + (u.q) v[e]
// and S1 = g S0 + k k^T, C1 = g C0 + q v^T, G1 = g^2 G0 + g k kC^T go back
// to device memory with 16-byte stores as each matrix lands.  Only u.C0
// needs all of u: each CTA leaves its slice of u in its shared memory, and
// after a cluster barrier gathers the whole of u from its peers (distributed
// shared memory); a second barrier keeps every CTA alive until its peers
// have read it.  So the cluster exchanges d floats and nothing else.
//
// The vectors m and h are read by every CTA and rewritten in place: every
// CTA has its copy of the old ones in shared memory before it arrives at
// the first cluster barrier, and only rank 0 writes m1 = g m0 + q and
// h1 = g^2 h0 + g k (k.m0) after it.  The scalar products of q, k, m, h and
// u are warp sums that every warp computes for itself.

#include <cuda_runtime.h>

#include "step_cluster.cuh"

namespace {

using namespace step_cluster;

template <typename T>
__global__ void __launch_bounds__(THREADS)
    hla2_step_kernel(const __grid_constant__ CUtensorMap tS,
                     const __grid_constant__ CUtensorMap tC,
                     const __grid_constant__ CUtensorMap tG,
                     const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const float* __restrict__ gamma,
                     T* __restrict__ o, float* __restrict__ S,
                     float* __restrict__ C, float* __restrict__ m,
                     float* __restrict__ G, float* __restrict__ h, int d,
                     int dv, int normalize, float eps, float lam) {
  extern __shared__ __align__(128) float sm[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const Slice sb = slice_of(d, rank), se = slice_of(dv, rank);
  uint64_t* bars = reinterpret_cast<uint64_t*>(sm);  // m and h, S, C, G
  float* Ss = sm + 32;                   // d x sb.cw  S0[:, B_j]
  float* Cs = Ss + slice_floats(d, d);   // d x se.cw  C0[:, E_j]
  float* Gs = Cs + slice_floats(d, dv);  // d x se.cw  G0[:, E_j]
  float* ms = Gs + slice_floats(d, dv);  // d          old m
  float* hs = ms + d;                    // d          old h
  float* qs = hs + d;                    // d
  float* ks = qs + d;                    // d
  float* uf = ks + d;                    // d          all of u, gathered
  float* us = uf + d;                    // sb.cw      this CTA's slice of u
  float* vs = us + sb.cw;                // se.cw      v[E_j]
  float* kc = vs + se.cw;                // se.cw      k.C0[:, E_j]
  float* red = kc + se.cw;               // 4 x THREADS partial column sums

  const size_t row = blockIdx.x / CLUSTER;
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

  // m, h and S first, each one TMA copy from thread 0: the exchange of u
  // waits on S, so S must land first, alone
  if (tid == 0) {
    init_bars(bars, 4);
    expect_bytes(bars, 2 * d * sizeof(float));
    bulk_load(ms, m, d * sizeof(float), bars);
    bulk_load(hs, h, d * sizeof(float), bars);
    expect_bytes(bars + 1, box_bytes(d, sb));
    load_box(Ss, tS, sb, row * d, bars + 1);
  }
  for (int i = tid; i < d; i += THREADS) {
    qs[i] = to_f(q[i]);
    ks[i] = to_f(k[i]);
  }
  for (int b = tid; b < se.w; b += THREADS) vs[b] = to_f(v[se.c0 + b]);
  __syncthreads();
  wait_bar(bars);
  const float km = warp_dot(ks, ms, d), qk = warp_dot(qs, ks, d),
              qq = warp_dot(qs, qs, d), qm = warp_dot(qs, ms, d),
              qh = warp_dot(qs, hs, d);

  // S1 = g S0 + k k^T; this CTA's slice of u = q^T S1; C and G on their
  // way meanwhile
  wait_bar(bars + 1);
  if (tid == 0) {
    expect_bytes(bars + 2, box_bytes(d, se));
    load_box(Cs, tC, se, row * d, bars + 2);
    expect_bytes(bars + 3, box_bytes(d, se));
    load_box(Gs, tG, se, row * d, bars + 3);
  }
  col_partials(Ss, d, sb, qs, red);
  update_slice(S, d, d, sb, Ss, g, 1.f, ks, ks + sb.c0);
  __syncthreads();
  for (int b = tid; b < sb.w; b += THREADS)
    us[b] = fmaf(qk, ks[sb.c0 + b], g * col_total(red, sb.w, b));
  cluster_arrive();  // u's slice ready for the peers; old m, h read

  // C1 = g C0 + q v^T; k.C0 and q.C0
  wait_bar(bars + 2);
  col_partials(Cs, d, se, ks, red + THREADS, qs, red + 2 * THREADS);
  update_slice(C, d, dv, se, Cs, g, 1.f, qs, vs);

  // every CTA has read the old m, h and left its slice of u
  cluster_wait();
  if (rank == 0) {
    for (int i = tid; i < d; i += THREADS) {
      m[i] = g * ms[i] + qs[i];
      h[i] = g * g * hs[i] + g * ks[i] * km;
    }
  }
  for (int i = tid; i < d; i += THREADS) {
    const int r = i / sb.cw;
    uf[i] = cluster.map_shared_rank(us, r)[i - r * sb.cw];
  }
  __syncthreads();
  cluster_arrive();  // done reading the peers' shared memory
  for (int b = tid; b < se.w; b += THREADS)
    kc[b] = col_total(red + THREADS, se.w, b);
  col_partials(Cs, d, se, uf, red);
  const float uq = warp_dot(uf, qs, d), um = warp_dot(uf, ms, d);
  float den = 1.f;
  if (normalize) {
    // u.m1 - q.h1 + lam q.m1 with m1, h1 expanded from the old m, h
    den = (g * um + uq) - (g * g * qh + g * qk * km) + lam * (g * qm + qq) +
          eps;
  }

  // G1 = g^2 G0 + g k kC^T; q.G0; the output
  wait_bar(bars + 3);
  __syncthreads();  // publishes kc
  col_partials(Gs, d, se, qs, red + 3 * THREADS);
  update_slice(G, d, dv, se, Gs, g * g, g, ks, kc);
  __syncthreads();
  for (int b = tid; b < se.w; b += THREADS) {
    const float ve = vs[b];
    const float uc1 = fmaf(ve, uq, g * col_total(red, se.w, b));  // u.C1
    const float qc1 =
        fmaf(ve, qq, g * col_total(red + 2 * THREADS, se.w, b));  // q.C1
    const float qg1 = g * g * col_total(red + 3 * THREADS, se.w, b) +
                      g * qk * kc[b];  // q.G1
    const float num = uc1 - qg1 + lam * qc1;
    store(o + se.c0 + b, normalize ? num / den : num);
  }
  cluster_wait();  // no CTA leaves while a peer may still read its u
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const float* gamma, void* o, float* S, float* C, float* m,
                   float* G, float* h, int BH, int d, int dv, int normalize,
                   float eps, float lam, cudaStream_t stream) {
  CUtensorMap tS, tC, tG;
  cudaError_t err = slice_map(&tS, S, BH * d, d, d);
  if (err == cudaSuccess) err = slice_map(&tC, C, BH * d, dv, d);
  if (err == cudaSuccess) err = slice_map(&tG, G, BH * d, dv, d);
  if (err != cudaSuccess) return err;
  const int cb = slice_width(d), ce = slice_width(dv);
  const size_t smem = (size_t)(32 + slice_floats(d, d) +
                               2 * slice_floats(d, dv) + 5 * d + cb + 2 * ce +
                               4 * THREADS) *
                      sizeof(float);
  return launch_rows(hla2_step_kernel<T>, BH, d, dv, smem, stream, tS, tC, tG,
                     static_cast<const T*>(q), static_cast<const T*>(k),
                     static_cast<const T*>(v), gamma, static_cast<T*>(o), S,
                     C, m, G, h, d, dv, normalize, eps, lam);
}

}  // namespace

extern "C" {

// q, k: (BH, d); v, o: (BH, dv) in bf16 (is_bf16) or fp32; gamma: (BH,)
// fp32 or null; S (BH, d, d), C, G (BH, d, dv), m, h (BH, d): fp32 state,
// updated in place; d, dv multiples of 4, d <= 256, dv <= 1024, every state
// tensor 16-byte aligned.  Returns the CUDA error of the launch (0 =
// launched).
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
