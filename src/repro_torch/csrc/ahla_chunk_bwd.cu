// Chunkwise AHLA backward for Hopper (sm_90a): training.
//
// Replaces: src/repro/kernels/ahla_chunk.py, ahla_chunk_bwd_pallas (body
// _ahla_chunk_bwd_kernel).
//
// Computes, per (batch*head) row, dq, dk, dv and dgamma of the chunkwise
// forward (ahla_chunk_fwd.cu) for an output cotangent do, walking the
// chunks in reverse from the carry [P | m], [E | n] each chunk started from
// (the forward's checkpoints).  The final carry's cotangent is zero: the
// forward discards it.  The math is the hand-derived adjoint of one chunk
// that src/repro_torch/kernels/chunk_math.py::ahla_chunk_math_bwd spells
// out (the reference gets it from jax.vjp).  With Vb = [V | 1], dOb the
// cotangent of the widened output [O | den], A = (Q K^T) . Lg, p[t] =
// g^(t+1), r[t] = g^(w-1-t), rho = g^w:
//   dR  = A^T dOb + r . (K dE1)            dA = dOb R^T + dR Vb^T
//   dQ  = (dA . Lg) K + p . (dOb E0^T + dR P0^T)
//   dK  = (dA . Lg)^T Q + r . (Vb dP1^T + R dE1^T)
//   dV  = A^T dR + r . (K dP1)
//   dP0 = rho dP1 + Q^T (p . dR),  dE0 = rho dE1 + Q^T (p . dOb)
//
// Bound on this card: operations.  A 64-token chunk at d = dv = 128 needs
// about 12.6 M FMAs per row (ten d x dv x w products, seven w x w x d or
// dv triangles) against 0.25 MB of q/k/v/do/dq/dk/dv and checkpoint
// traffic.  The floor prices each product at the card's fastest
// fp32-accurate rate for its operands (chip_smoke.ahla_chunk_bwd_fmas,
// _bound): 989 TFLOP/s for bf16 x bf16, 989/3 for an input times an fp32
// term, 495/3 for fp32 x fp32.
//
// Design: a row is split over CTAs of CW = 32 columns of [V | 1], grid
// (rows, ceil(dvx / 32)): 128 CTAs for the train step's 32 rows.  Every
// term above but dQ, dK and dgamma is column-local: each CTA recomputes
// its columns of R from the checkpoint, keeps its columns of the carry
// cotangents dP, dE in shared memory for the whole reverse walk, and
// writes its columns of dv itself.  dA, and with it dQ, dK and dgamma, is
// a sum over the column tiles, linear in each tile's share: each CTA
// writes its partial dQ, dK of every chunk to a per-tile fp32 buffer in
// device memory and its partial dgamma to a per-tile slot, and a second
// small kernel here sums the tiles in a fixed order (deterministic, no
// atomics).  Unnormalised, every cotangent of the den column stays zero
// through the walk, so dvx = dv and no CTA holds that column.  Under
// normalize, dvx = dv + 1 and the den cotangent -rowsum(do . O) / z^2
// needs every value column of O: a first kernel here recomputes [O | den]
// per (row, chunk) from the checkpoint and writes 1/z and that cotangent
// per token.
//
// Every product is a warp-level mma.sync (mma_tile.cuh): bf16 where both
// operands are raw bf16 inputs (Q K^T), else split TF32, 2 MMAs where one
// side is a raw input and 3 where both are fp32.  Every operand is a plain
// tile read: a decay that scales an output row (p in p . (Q P0), r in
// r . (K dE1)) is applied in the product's out(), one on the contraction
// index lives in an fp32 tile formed once per chunk (p . dR, p . dOb), A
// is stored once per chunk and read transposed for A^T, and a sum of two
// products is two calls whose second accumulates into the first's output
// (same N, same thread per element: no barrier between them).  Decay
// powers come from a table g^0..g^64; a derivative of g^k is formed only
// for k >= 1 (never g^-1).  A ragged tail is one shorter chunk with its
// own decay powers, as in the forward.
//
// Shared memory (180,516 bytes at d = 128 with bf16 inputs, 221,476 with
// fp32): the chunk's Q, K and the tile's V and do in their input type; Q
// K^T and A, then dA . Lg (w x w); the tile's dOb, R, dR, p . dR and one
// scratch (dV's first term, then p . dOb) (w x 32 fp32); the checkpointed
// [P | m], [E | n] columns and dP, dE (d x 32).  Each chunk's inputs and
// checkpoint are copied with cp.async at the top of the chunk and waited
// for at once.  Staging the next chunk while this one computes was built
// and timed on an H100, and was slower: a second stage of q, k, v, do
// (40,960 bytes with bf16 inputs; with fp32 it does not fit) and an early
// copy of the next checkpoint, before this chunk's last phase, took
// 2.59-2.69 ms at the train shape (32 rows x 2048, bf16) against 2.42-2.46
// ms without (PERF.md, section 6).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <type_traits>

#include "mma_tile.cuh"

namespace {

using mma_tile::cp_async_commit;
using mma_tile::cp_async_wait;
using mma_tile::group_sum;
using mma_tile::mma_mm;
using mma_tile::stage;
using mma_tile::Tile;

constexpr int W = 64;   // tokens per chunk: the forward's partition
constexpr int CW = 32;  // columns of [V | 1] per CTA
constexpr int THREADS = 256;
constexpr int GROUP = THREADS / W;  // threads per token in the row sums
static_assert(THREADS % W == 0 && 32 % GROUP == 0, "token groups in warps");

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

__host__ __device__ int n_tiles(int dv, int normalize) {
  return (dv + normalize + CW - 1) / CW;
}

// input-type elements of the raw inputs: Q, K (W x d), the tile's V, do
// (W x CW)
__host__ __device__ size_t input_elems(int d) {
  return 2 * (size_t)W * d + 2 * W * CW;
}

// Under normalize, per (row, chunk): the forward's widened output [O | den]
// for every column, recomputed from the checkpoint, then per token zd[2t] =
// 1 / z and zd[2t + 1] = -sum_e do[t, e] O[t, e] / z^2, z = den + eps.
template <typename T>
__global__ void __launch_bounds__(THREADS)
    ahla_bwd_den_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v,
                        const float* __restrict__ gamma,
                        const T* __restrict__ dout,
                        const float* __restrict__ Pc,
                        const float* __restrict__ Ec, float* __restrict__ zd,
                        int n, int d, int dv, float eps) {
  constexpr bool kIn = std::is_same<T, __nv_bfloat16>::value;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int vw = dv + 1, vp = (vw + 3) / 4 * 4;
  const Tile<T> Q(reinterpret_cast<T*>(smem_raw), d), K(Q.p + W * d, d);
  const Tile<float> A(reinterpret_cast<float*>(K.p + W * d), W);  // W x W
  const Tile<float> Vb(A.p + W * W, vp);  // W x vw  [V | 1], then [O | den]
  const Tile<float> Rs(Vb.p + W * vp, vp);  // W x vw  [R | s]
  float* gp = Rs.p + W * vp;                // W + 1   g^i

  const size_t row = blockIdx.x;
  const int c = blockIdx.y, nc = gridDim.y, c0 = c * W, L = min(W, n - c0);
  const float* P0 = Pc + (row * nc + c) * d * vw;
  const float* E0 = Ec + (row * nc + c) * d * vw;
  q += row * n * d;
  k += row * n * d;
  v += row * n * dv;
  dout += row * n * dv;
  zd += 2 * row * n;
  const int tid = threadIdx.x;
  const float logg = logf(gamma ? gamma[row] : 1.f);
  for (int i = tid; i <= W; i += THREADS) gp[i] = expf(i * logg);
  for (int i = tid; i < L * d; i += THREADS) {
    const int t = i / d, a = i - t * d;
    Q(t, a) = q[(size_t)(c0 + t) * d + a];
    K(t, a) = k[(size_t)(c0 + t) * d + a];
  }
  for (int i = tid; i < L * vw; i += THREADS) {
    const int t = i / vw, e = i - t * vw;
    Vb(t, e) = e < dv ? to_f(v[(size_t)(c0 + t) * dv + e]) : 1.f;
  }
  __syncthreads();
  mma_mm<2, kIn, kIn>(  // A = (Q K^T) . Lg
      L, L, d, [=](int t, int a) { return to_f(Q(t, a)); },
      [=](int a, int j) { return to_f(K(j, a)); },
      [=](int t, int j, float x) { A(t, j) = j <= t ? gp[t - j] * x : 0.f; });
  __syncthreads();
  mma_mm<4, kIn, false>(  // [R | s] = p . (Q [P0 | m0]) + A [V | 1]
      L, vw, d, [=](int t, int a) { return to_f(Q(t, a)); },
      [=](int a, int e) { return P0[a * vw + e]; },
      [=](int t, int e, float x) { Rs(t, e) = gp[t + 1] * x; });
  mma_mm<4, false, kIn>(
      L, vw, L, [=](int t, int j) { return A(t, j); },
      [=](int j, int e) { return Vb(j, e); },
      [=](int t, int e, float x) { Rs(t, e) += x; });
  __syncthreads();
  mma_mm<4, kIn, false>(  // [O | den] = p . (Q [E0 | n0]) + A [R | s]
      L, vw, d, [=](int t, int a) { return to_f(Q(t, a)); },
      [=](int a, int e) { return E0[a * vw + e]; },
      [=](int t, int e, float x) { Vb(t, e) = gp[t + 1] * x; });
  mma_mm<4, false, false>(
      L, vw, L, [=](int t, int j) { return A(t, j); },
      [=](int j, int e) { return Rs(j, e); },
      [=](int t, int e, float x) { Vb(t, e) += x; });
  __syncthreads();
  {
    const int t = tid / GROUP, part = tid % GROUP;
    float s = 0.f;
    if (t < L)
      for (int e = part; e < dv; e += GROUP)
        s = fmaf(to_f(dout[(size_t)(c0 + t) * dv + e]), Vb(t, e), s);
    s = group_sum<GROUP>(s);
    if (part == 0 && t < L) {
      const float z = Vb(t, dv) + eps;
      zd[2 * (c0 + t)] = 1.f / z;
      zd[2 * (c0 + t) + 1] = -s / (z * z);
    }
  }
}

// One block per SM (its shared memory leaves no room for a second); the
// 1 lets ptxas use the registers that allows.
template <typename T, bool NORM>
__global__ void __launch_bounds__(THREADS, 1)
    ahla_chunk_bwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v,
                          const float* __restrict__ gamma,
                          const T* __restrict__ dout, const float* Pc,
                          const float* Ec, const float* zd, float* dqp,
                          float* dkp, T* dvo, float* dgp, int n, int d,
                          int dv) {
  constexpr bool kIn = std::is_same<T, __nv_bfloat16>::value;
  constexpr bool kDo = kIn && !NORM;  // dOb is the raw bf16 do
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* tp = reinterpret_cast<T*>(smem_raw);
  const Tile<T> Q(tp, d), K(tp + W * d, d);  // W x d  the chunk's q, k
  const Tile<T> V(tp + 2 * W * d, CW);        // W x CW its columns of v,
  const Tile<T> Do(V.p + W * CW, CW);         // W x CW   and of do
  float* fs = reinterpret_cast<float*>(tp + input_elems(d));
  const Tile<float> QK(fs, W);              // W x W  raw q_t . k_j, j <= t
  const Tile<float> A(QK.p + W * W, W);     // W x W  A, then dA . Lg
  const Tile<float> Db(A.p + W * W, CW);    // W x CW dOb
  const Tile<float> R(Db.p + W * CW, CW);   // W x CW R
  const Tile<float> dR(R.p + W * CW, CW);   // W x CW dR
  const Tile<float> pdR(dR.p + W * CW, CW); // W x CW p . dR
  const Tile<float> X(pdR.p + W * CW, CW);  // W x CW dV's first term, p . dOb
  const Tile<float> P0(X.p + W * CW, CW);   // d x CW checkpointed [P | m]
  const Tile<float> E0(P0.p + d * CW, CW);  // d x CW checkpointed [E | n]
  const Tile<float> dP(E0.p + d * CW, CW);  // d x CW carry cotangents,
  const Tile<float> dE(dP.p + d * CW, CW);  // d x CW   whole walk
  float* gp = dE.p + d * CW;                // W + 1  g^i
  float* red = gp + (W + 1);                // THREADS / 32 partial dgamma

  const size_t row = blockIdx.x;
  const int tile = blockIdx.y, T_ = gridDim.y, e0 = tile * CW;
  const int ew = min(CW, dv + (NORM ? 1 : 0) - e0);  // columns of [V | 1]
  const int ev = max(0, min(CW, dv - e0));  // of them, columns of V
  const int nc = (n + W - 1) / W, vw = dv + 1;
  q += row * n * d;
  k += row * n * d;
  v += row * n * dv;
  dout += row * n * dv;
  dvo += row * n * dv;
  Pc += row * nc * d * vw;
  Ec += row * nc * d * vw;
  if (NORM) zd += 2 * row * n;
  dqp += (row * T_ + tile) * n * d;
  dkp += (row * T_ + tile) * n * d;
  const int tid = threadIdx.x;
  const float logg = logf(gamma ? gamma[row] : 1.f);

  for (int i = tid; i < d * CW; i += THREADS) {
    dP(i / CW, i % CW) = 0.f;
    dE(i / CW, i % CW) = 0.f;
  }
  for (int i = tid; i <= W; i += THREADS) gp[i] = expf(i * logg);
  if (NORM && ev < ew)  // the ones column of [V | 1]
    for (int t = tid; t < W; t += THREADS) store(&V(t, ev), 1.f);
  float dg = 0.f;  // this thread's share of this tile's dgamma

  for (int c = nc - 1; c >= 0; --c) {
    const int c0 = c * W, L = min(W, n - c0);
    const bool last = c == nc - 1;  // dP1 = dE1 = 0: skip their products
    const float rho = gp[L];
    auto q_ = [=](int t, int a) { return to_f(Q(t, a)); };
    auto k_ = [=](int t, int a) { return to_f(K(t, a)); };
    auto v_ = [=](int t, int e) { return to_f(V(t, e)); };
    auto pr = [=](int t) { return gp[L - 1 - t]; };  // r[t] = g^(L-1-t)
    float* dqc = dqp + (size_t)c0 * d;
    float* dkc = dkp + (size_t)c0 * d;
    // the chunk's rows of q, k, its columns of v, do and its checkpoint
    stage(Q, q + (size_t)c0 * d, L, d, d);
    stage(K, k + (size_t)c0 * d, L, d, d);
    stage(V, v + (size_t)c0 * dv + e0, L, ev, dv);
    stage(Do, dout + (size_t)c0 * dv + e0, L, ev, dv);
    stage(P0, Pc + (size_t)c * d * vw + e0, d, ew, vw);
    stage(E0, Ec + (size_t)c * d * vw + e0, d, ew, vw);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();

    // ---- Q K^T and A; d rho; dOb ----------------------------------------
    mma_mm<2, kIn, kIn>(
        L, L, d, q_, [=](int a, int j) { return k_(j, a); },
        [=](int t, int j, float x) {
          QK(t, j) = j <= t ? x : 0.f;
          A(t, j) = j <= t ? gp[t - j] * x : 0.f;
        });
    if (!last) {  // d rho: <dP1, P0> + <dE1, E0> over this tile's columns
      float drho = 0.f;
      for (int i = tid; i < d * ew; i += THREADS) {
        const int a = i / ew, e = i - a * ew;
        drho = fmaf(dP(a, e), P0(a, e), drho);
        drho = fmaf(dE(a, e), E0(a, e), drho);
      }
      dg += drho * L * gp[L - 1];
    }
    for (int i = tid; i < L * ew; i += THREADS) {
      const int t = i / ew, e = i - t * ew;
      if (!NORM)
        Db(t, e) = to_f(Do(t, e));
      else if (e < ev)
        Db(t, e) = to_f(Do(t, e)) * zd[2 * (c0 + t)];
      else  // the den column
        Db(t, e) = zd[2 * (c0 + t) + 1];
    }
    __syncthreads();

    // ---- dR, and d/dp[t] of p . (Q E0) ----------------------------------
    mma_mm<2, false, kDo>(  // dR = A^T dOb
        L, ew, L, [=](int t, int j) { return A(j, t); },
        [=](int j, int e) { return Db(j, e); },
        [=](int t, int e, float x) {
          dR(t, e) = x;
          if (last) pdR(t, e) = gp[t + 1] * x;
        });
    if (!last)
      mma_mm<2, kIn, false>(  // dR += r . (K dE1)
          L, ew, d, k_, [=](int a, int e) { return dE(a, e); },
          [=](int t, int e, float x) {
            const float y = dR(t, e) + pr(t) * x;
            dR(t, e) = y;
            pdR(t, e) = gp[t + 1] * y;
          });
    mma_mm<2, kIn, false>(  // dOb . (Q E0)
        L, ew, d, q_, [=](int a, int e) { return E0(a, e); },
        [&](int t, int e, float x) {
          dg += Db(t, e) * x * (t + 1) * gp[t];
        });
    __syncthreads();

    // ---- R, d/dp[t] of p . (Q P0), dV -----------------------------------
    mma_mm<2, kIn, false>(  // R = p . (Q P0), and dR . (Q P0)
        L, ew, d, q_, [=](int a, int e) { return P0(a, e); },
        [&](int t, int e, float x) {
          R(t, e) = gp[t + 1] * x;
          dg += dR(t, e) * x * (t + 1) * gp[t];
        });
    mma_mm<2, false, kIn>(  // R += A Vb
        L, ew, L, [=](int t, int j) { return A(t, j); }, v_,
        [=](int t, int e, float x) { R(t, e) += x; });
    mma_mm<2, false, false>(  // dV = A^T dR, this tile's value columns
        L, ev, L, [=](int t, int j) { return A(j, t); },
        [=](int j, int e) { return dR(j, e); },
        [=](int t, int e, float x) {
          if (last)
            store(dvo + (size_t)(c0 + t) * dv + e0 + e, x);
          else
            X(t, e) = x;
        });
    if (!last)
      mma_mm<2, kIn, false>(  // dV += r . (K dP1)
          L, ev, d, k_, [=](int a, int e) { return dP(a, e); },
          [=](int t, int e, float x) {
            store(dvo + (size_t)(c0 + t) * dv + e0 + e, X(t, e) + pr(t) * x);
          });
    __syncthreads();

    // ---- dA, the partial dK and dQ's carry terms -------------------------
    mma_mm<2, kDo, false>(  // dA = dOb R^T
        L, L, ew, [=](int t, int e) { return Db(t, e); },
        [=](int e, int j) { return R(j, e); },
        [=](int t, int j, float x) { A(t, j) = x; });
    mma_mm<2, false, kIn>(  // dA += dR Vb^T; A = dA . Lg, and its dLg
        L, L, ew, [=](int t, int e) { return dR(t, e); },
        [=](int e, int j) { return v_(j, e); },
        [&](int t, int j, float x) {
          const float y = A(t, j) + x;
          if (j < t) dg += y * QK(t, j) * (t - j) * gp[t - j - 1];
          A(t, j) = j <= t ? gp[t - j] * y : 0.f;
        });
    if (!last) {  // dK = r . (Vb dP1^T + R dE1^T), and d/dr[t] of it
      auto dr = [&](int t, int a, float x) {
        if (t < L - 1) dg += k_(t, a) * x * (L - 1 - t) * gp[L - 2 - t];
      };
      mma_mm<4, kIn, false>(
          L, d, ew, v_, [=](int e, int a) { return dP(a, e); },
          [&](int t, int a, float x) {
            dkc[t * d + a] = pr(t) * x;
            dr(t, a, x);
          });
      mma_mm<4, false, false>(
          L, d, ew, [=](int t, int e) { return R(t, e); },
          [=](int e, int a) { return dE(a, e); },
          [&](int t, int a, float x) {
            dkc[t * d + a] += pr(t) * x;
            dr(t, a, x);
          });
    }
    mma_mm<4, kDo, false>(  // dQ = p . (dOb E0^T + dR P0^T)
        L, d, ew, [=](int t, int e) { return Db(t, e); },
        [=](int e, int a) { return E0(a, e); },
        [=](int t, int a, float x) { dqc[t * d + a] = gp[t + 1] * x; });
    mma_mm<4, false, false>(
        L, d, ew, [=](int t, int e) { return dR(t, e); },
        [=](int e, int a) { return P0(a, e); },
        [=](int t, int a, float x) { dqc[t * d + a] += gp[t + 1] * x; });
    for (int i = tid; i < L * ew; i += THREADS) {  // p . dOb (dV is out)
      const int t = i / ew, e = i - t * ew;
      X(t, e) = gp[t + 1] * Db(t, e);
    }
    __syncthreads();

    // ---- dQ, dK of dA; the carry cotangents -----------------------------
    mma_mm<4, false, kIn>(  // dQ += (dA . Lg) K
        L, d, L, [=](int t, int j) { return A(t, j); }, k_,
        [=](int t, int a, float x) { dqc[t * d + a] += x; });
    mma_mm<4, false, kIn>(  // dK += (dA . Lg)^T Q
        L, d, L, [=](int t, int j) { return A(j, t); }, q_,
        [=](int t, int a, float x) {
          if (last)
            dkc[t * d + a] = x;
          else
            dkc[t * d + a] += x;
        });
    mma_mm<2, kIn, false>(  // dP0 = rho dP1 + Q^T (p . dR)
        d, ew, L, [=](int a, int t) { return q_(t, a); },
        [=](int t, int e) { return pdR(t, e); },
        [=](int a, int e, float x) { dP(a, e) = rho * dP(a, e) + x; });
    mma_mm<2, kIn, false>(  // dE0 = rho dE1 + Q^T (p . dOb)
        d, ew, L, [=](int a, int t) { return q_(t, a); },
        [=](int t, int e) { return X(t, e); },
        [=](int a, int e, float x) { dE(a, e) = rho * dE(a, e) + x; });
    __syncthreads();  // tiles are free for the next chunk
  }

  for (int off = 16; off > 0; off >>= 1)
    dg += __shfl_down_sync(0xffffffffu, dg, off);
  if ((tid & 31) == 0) red[tid >> 5] = dg;
  __syncthreads();
  if (tid == 0) {
    float s = 0.f;
    for (int i = 0; i < THREADS / 32; ++i) s += red[i];
    dgp[row * T_ + tile] = s;
  }
}

// dq, dk = the sum over the T_ column tiles of the partials, in tile
// order; dgamma likewise from the per-tile sums.
template <typename T>
__global__ void __launch_bounds__(THREADS)
    ahla_bwd_reduce_kernel(const float* __restrict__ dqp,
                           const float* __restrict__ dkp,
                           const float* __restrict__ dgp, T* dq, T* dk,
                           float* dgamma, int BH, int T_, size_t per_row) {
  const size_t total = BH * per_row;
  for (size_t i = (size_t)blockIdx.x * THREADS + threadIdx.x; i < total;
       i += (size_t)gridDim.x * THREADS) {
    const size_t row = i / per_row, rem = i - row * per_row;
    const size_t base = row * T_ * per_row + rem;
    float sq = 0.f, sk = 0.f;
    for (int t = 0; t < T_; ++t) {
      sq += dqp[base + t * per_row];
      sk += dkp[base + t * per_row];
    }
    store(dq + i, sq);
    store(dk + i, sk);
  }
  if (dgamma && blockIdx.x == 0)
    for (int r = threadIdx.x; r < BH; r += THREADS) {
      float s = 0.f;
      for (int t = 0; t < T_; ++t) s += dgp[r * T_ + t];
      dgamma[r] = s;
    }
}

// fp32 scratch floats: the per-tile partial dq and dk (BH, T, n, d) each,
// the per-tile dgamma (BH, T) and, under normalize, (1/z, d den) per token
size_t scratch_floats(int BH, int n, int d, int dv, int normalize) {
  const size_t T_ = n_tiles(dv, normalize);
  return 2 * (size_t)BH * T_ * n * d + BH * T_ +
         (normalize ? 2 * (size_t)BH * n : 0);
}

// Shared-memory bytes of the walk for head dim d and input type size
// tsize (180,516 at d = 128 with bf16 inputs, 221,476 with fp32); a size
// above the 227 KB limit makes cudaFuncSetAttribute fail the launch.
size_t smem_bytes(int d, size_t tsize) {
  const size_t floats = 2 * (size_t)W * W + 5 * (size_t)W * CW +
                        4 * (size_t)d * CW + (W + 1) + THREADS / 32;
  return input_elems(d) * tsize + floats * sizeof(float);
}

size_t den_smem_bytes(int d, int dv, size_t tsize) {
  const size_t vp = (dv + 1 + 3) / 4 * 4;
  const size_t floats = (size_t)W * W + 2 * W * vp + (W + 1);
  return 2 * (size_t)W * d * tsize + floats * sizeof(float);
}

template <typename T, bool NORM>
cudaError_t launch_walk(const T* q, const T* k, const T* v,
                        const float* gamma, const T* dout, const float* Pc,
                        const float* Ec, const float* zd, float* dqp,
                        float* dkp, T* dvo, float* dgp, int BH, int T_, int n,
                        int d, int dv, cudaStream_t stream) {
  auto kern = ahla_chunk_bwd_kernel<T, NORM>;
  const size_t smem = smem_bytes(d, sizeof(T));
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kern<<<dim3(BH, T_), THREADS, smem, stream>>>(
      q, k, v, gamma, dout, Pc, Ec, zd, dqp, dkp, dvo, dgp, n, d, dv);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const float* gamma, const void* dout, const float* Pc,
                   const float* Ec, void* dq, void* dk, void* dv_out,
                   float* dgamma, float* scratch, int BH, int n, int d,
                   int dv, int normalize, float eps, cudaStream_t stream) {
  const int T_ = n_tiles(dv, normalize), nc = (n + W - 1) / W;
  float* dqp = scratch;
  float* dkp = dqp + (size_t)BH * T_ * n * d;
  float* dgp = dkp + (size_t)BH * T_ * n * d;
  float* zd = normalize ? dgp + (size_t)BH * T_ : nullptr;
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* dt = static_cast<const T*>(dout);
  T* dvo = static_cast<T*>(dv_out);
  cudaError_t err;
  if (normalize) {
    auto den = ahla_bwd_den_kernel<T>;
    const size_t smem = den_smem_bytes(d, dv, sizeof(T));
    err = cudaFuncSetAttribute(
        den, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    den<<<dim3(BH, nc), THREADS, smem, stream>>>(qt, kt, vt, gamma, dt, Pc,
                                                 Ec, zd, n, d, dv, eps);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    err = launch_walk<T, true>(qt, kt, vt, gamma, dt, Pc, Ec, zd, dqp, dkp,
                               dvo, dgp, BH, T_, n, d, dv, stream);
  } else {
    err = launch_walk<T, false>(qt, kt, vt, gamma, dt, Pc, Ec, zd, dqp, dkp,
                                dvo, dgp, BH, T_, n, d, dv, stream);
  }
  if (err != cudaSuccess) return err;
  const size_t per_row = (size_t)n * d;
  const size_t blocks = (BH * per_row + THREADS - 1) / THREADS;
  ahla_bwd_reduce_kernel<T><<<(unsigned)(blocks < 1056 ? blocks : 1056),
                              THREADS, 0, stream>>>(
      dqp, dkp, dgp, static_cast<T*>(dq), static_cast<T*>(dk), dgamma, BH, T_,
      per_row);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// fp32 scratch floats that ahla_chunk_bwd needs.
long ahla_chunk_bwd_scratch_floats(int BH, int n, int d, int dv,
                                   int normalize) {
  return (long)scratch_floats(BH, n, d, dv, normalize);
}

// Dynamic shared-memory bytes the walk kernel asks for.
long ahla_chunk_bwd_smem_bytes(int d, int is_bf16) {
  return (long)smem_bytes(d, is_bf16 ? 2 : 4);
}

// q, k: (BH, n, d); v, dout: (BH, n, dv) in bf16 (is_bf16) or fp32; gamma:
// (BH,) fp32 or null; Pc, Ec: the forward's fp32 checkpoints (BH, ceil(n /
// 64), d, dv + 1); dq, dk, dv_out: outputs like q, k, v; dgamma: (BH,) fp32
// output or null; scratch: ahla_chunk_bwd_scratch_floats fp32.  Launches up
// to three kernels on the stream (under normalize the den pass, then the
// reverse walk, then the sum over column tiles).  Returns the first CUDA
// error (0 = launched).
int ahla_chunk_bwd(const void* q, const void* k, const void* v,
                   const float* gamma, const void* dout, const float* Pc,
                   const float* Ec, void* dq, void* dk, void* dv_out,
                   float* dgamma, float* scratch, int BH, int n, int d, int dv,
                   int is_bf16, int normalize, float eps, int device,
                   void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = is_bf16 ? launch<__nv_bfloat16>(q, k, v, gamma, dout, Pc, Ec, dq, dk,
                                        dv_out, dgamma, scratch, BH, n, d, dv,
                                        normalize, eps, s)
                : launch<float>(q, k, v, gamma, dout, Pc, Ec, dq, dk, dv_out,
                                dgamma, scratch, BH, n, d, dv, normalize, eps,
                                s);
  return (int)err;
}

}  // extern "C"
