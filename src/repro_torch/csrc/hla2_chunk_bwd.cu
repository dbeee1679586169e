// Chunkwise masked HLA2 backward for Hopper (sm_90a): training.
//
// Replaces: src/repro/kernels/hla2_chunk.py, hla2_chunk_bwd_pallas (body
// _hla2_chunk_bwd_kernel).
//
// Computes, per (batch*head) row, dq, dk, dv and dgamma of the chunkwise
// forward (hla2_chunk_fwd.cu) for an output cotangent do, walking the
// chunks in reverse from the carry each chunk started from (the forward's
// checkpoints).  The final carry's cotangent is zero: the forward discards
// it.  The math is the hand-derived adjoint of one chunk that
// src/repro_torch/kernels/chunk_math.py::hla2_chunk_math_bwd spells out;
// the reference gets the same function from jax.vjp.
//
// Bound on this card: operations.  A 64-token chunk at d = dv = 128 needs
// about 21 M FMAs per row against 0.3 MB of q/k/v/do/dq/dk/dv and
// checkpoint traffic.  The floor prices each product at the card's fastest
// fp32-accurate rate for its operands (chip_smoke.chunk_bwd_fmas, _bound):
// 989 TFLOP/s for bf16 x bf16, 989/3 for an input times an fp32 term (three
// bf16 parts of the fp32 side), 495/3 for fp32 x fp32 (split TF32).  This
// kernel runs the second kind as two TF32 MMAs (495/2, mma_tile.cuh).
//
// Design: the backward is linear in do, and a column tile's columns of V,
// C and G enter only through that tile's do.  So a row is split over CTAs
// of CW = 32 value columns, grid (rows, ceil(dv / CW)): 128 CTAs for the
// train step's 32 rows.  Each CTA runs the whole reverse walk on its column
// slice, with its own den column [V_tile | 1] under normalize, and carries
// a private partial dS (d x d), its columns of dC and dG and its partial
// dm, dh (the den column of [dC | dm], [dG | dh]).  It writes its columns
// of dv itself, and its partial dq, dk of every chunk to a per-tile fp32
// buffer, and its partial dgamma to a per-tile slot; a second small kernel
// in this file sums the tiles in a fixed order into dq, dk and dgamma
// (deterministic, no atomics).  The partial dS never leaves its tile: dS1
// -> dK runs on it, which is right by linearity.  Cost: the row-wide
// products (K Q^T, A Bm, Q S0, Q S0 Q^T, Q Q^T under lam) and the d x d
// ones with the partial dS (Kg dS1, K dS1^T, the dS update, the products
// with S0^T) are repeated by every tile: about 10 M FMAs per tile-CTA per
// chunk, 1.9x one CTA's whole row, spread over 4x the SMs.  A 4-CTA
// cluster that summed the per-chunk dS increment through distributed
// shared memory would avoid the repetition (later work).  CW = 64 does not
// fit: dC and dG would take 66 KB beside dS.
//
// Shared memory (219,428 bytes at d = 128 with fp32 inputs, 186,660 with
// bf16) holds for the whole walk the carry cotangents dS (d x d) and the
// tile's [dC | dm], [dG | dh] (d x 36), and per chunk Q, K in the input
// type, the tile's [V | 1] and do (then [dnum | dden]) (w x 36), K Q^T and
// M = g^(t+1) Q S0 Q^T + A Bm + lam Q Q^T (w x w).  The transient tiles
// (Q S0, Q S0 Q^T, the Y and T tiles below) live in a per-CTA fp32 scratch
// in device memory that stays in L2: at d = 128 they take 279,040 bytes,
// more than a block's whole 232,448.  Every product is a warp-level
// mma.sync; phases are separated by barriers, and each output element of a
// product belongs to one thread.  Decay powers come from a table
// g^0..g^64; a derivative of g^k is formed only for k >= 1 (never g^-1).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <type_traits>

#include "mma_tile.cuh"

namespace {

using mma_tile::group_sum;
using mma_tile::mma_mm;
using mma_tile::prefetch_l2;
using mma_tile::Tile;

constexpr int W = 64;          // tokens per chunk: the forward's partition
constexpr int CW = 32;         // value columns per CTA
constexpr int CWX = CW + 1;    // widened: [V_tile | 1] under normalize
constexpr int CWP = CW + 4;    // row width of the widened tiles in smem
constexpr int THREADS = 256;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

constexpr int GROUP = THREADS / W;  // threads per token in the row sums
static_assert(THREADS % W == 0 && 32 % GROUP == 0, "token groups in warps");

__host__ __device__ int n_tiles(int dv) { return (dv + CW - 1) / CW; }

// fp32 scratch floats per CTA (see the layout in the kernel)
__host__ __device__ size_t cta_floats(int d) {
  const int xw = d > CWX ? d : CWX;
  return (size_t)W * (d + W + 2 * xw + 3 * d + 2 * CWX) + 3 * W * W;
}

// One block per SM (its shared memory leaves no room for a second); the
// 1 lets ptxas use the registers that allows, where it otherwise capped
// this kernel at 64 or 128 and spilled.
template <typename T>
__global__ void __launch_bounds__(THREADS, 1)
    hla2_chunk_bwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v,
                          const float* __restrict__ gamma,
                          const T* __restrict__ dout, const float* Sc,
                          const float* Cc, const float* mc, const float* Gc,
                          const float* hc, float* dqp, float* dkp, T* dvo,
                          float* dgp, float* scratch, int n, int d, int dv,
                          int normalize, float eps, float lam) {
  constexpr bool kIn = std::is_same<T, __nv_bfloat16>::value;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* fs = reinterpret_cast<float*>(smem_raw);
  const Tile<float> dS(fs, d);               // d x d    partial dS
  const Tile<float> dC(dS.p + d * d, CWP);   // d x dvx  [dC | dm]
  const Tile<float> dG(dC.p + d * CWP, CWP); // d x dvx  [dG | dh]
  const Tile<float> Vs(dG.p + d * CWP, CWP); // W x dvx  V' = [V | 1]
  const Tile<float> Ds(Vs.p + W * CWP, CWP); // W x dvx  dO, then dnum'
  const Tile<float> KQ(Ds.p + W * CWP, W);   // W x W    KQ[i][j] = k_i . q_j
  const Tile<float> M(KQ.p + W * W, W);      // W x W    g^(t+1) X2 + AB
  float* gp = M.p + W * W;                   // W + 1    g^i
  float* red = gp + (W + 1);                 // THREADS / 32 partial dgamma
  T* tq = reinterpret_cast<T*>(red + THREADS / 32);
  const Tile<T> Qs(tq, d), Ks(tq + W * d, d);  // W x d each, input type

  const int T_ = gridDim.y, tile = blockIdx.y, e0 = tile * CW;
  const int cw = min(CW, dv - e0);
  const int dvx = cw + normalize;  // the tile's widened width [V | 1]
  const int xw = d > CWX ? d : CWX;
  const size_t row = blockIdx.x, slot = row * T_ + tile;
  const int nc = (n + W - 1) / W;
  q += row * n * d;
  k += row * n * d;
  v += row * n * dv;
  dout += row * n * dv;
  dvo += row * n * dv;
  Sc += row * nc * d * d;
  Cc += row * nc * d * dv;
  mc += row * nc * d;
  Gc += row * nc * d * dv;
  hc += row * nc * d;
  float* dQa = dqp + slot * n * d;  // this tile's partial dq, dk
  float* dKa = dkp + slot * n * d;
  float* Xs = scratch + slot * cta_floats(d);  // W x d    Q S0
  float* X2 = Xs + W * d;      // W x W    Q S0 Q^T
  float* Y1 = X2 + W * W;      // W x xw   num', then Kg dG1', then dQS0
  float* Y2 = Y1 + W * xw;     // W x xw   Z', then dnum' C0'^T
  float* Y3 = Y2 + W * xw;     // W x d    dnum' G0'^T
  float* YQ = Y3 + W * d;      // W x d    dQg = V' dC1'^T
  float* YK = YQ + W * d;      // W x d    dKg = K dS1^T + Z' dG1'^T
  float* YV = YK + W * d;      // W x CWX  dVg' = N^T (Kg dG1')
  float* dVa = YV + W * CWX;   // W x CWX  the chunk's dv'
  float* TA = dVa + W * CWX;   // W x W    dN, then dA
  float* TE = TA + W * W;      // W x W    E = dnum' V'^T
  float* TB = TE + W * W;      // W x W    dBm
  const int tid = threadIdx.x;
  const float logg = logf(gamma ? gamma[row] : 1.f);
  const bool has_lam = lam != 0.f;

  for (int i = tid; i < d * d; i += THREADS) dS(i / d, i % d) = 0.f;
  for (int i = tid; i < d * dvx; i += THREADS)
    dC(i / dvx, i % dvx) = dG(i / dvx, i % dvx) = 0.f;
  for (int i = tid; i <= W; i += THREADS) gp[i] = expf(i * logg);
  float dg = 0.f;  // this thread's share of dgamma
  __syncthreads();

  for (int c = nc - 1; c >= 0; --c) {
    const int c0 = c * W, L = min(W, n - c0);
    const float rho = gp[L];
    const float* S0 = Sc + (size_t)c * d * d;
    const float* C0 = Cc + (size_t)c * d * dv + e0;
    const float* m0 = mc + (size_t)c * d;
    const float* G0 = Gc + (size_t)c * d * dv + e0;
    const float* h0 = hc + (size_t)c * d;
    // the tile's widened checkpointed carry: C0' = [C0 | m0], G0' = [G0 | h0]
    auto C0w = [=](int a, int e) { return e < cw ? C0[a * dv + e] : m0[a]; };
    auto G0w = [=](int a, int e) { return e < cw ? G0[a * dv + e] : h0[a]; };
    auto pr = [=](int t) { return gp[L - 1 - t]; };  // g^(L-1-t)
    auto q_ = [=](int t, int a) { return to_f(Qs(t, a)); };
    auto k_ = [=](int t, int a) { return to_f(Ks(t, a)); };

    for (int i = tid; i < L * d; i += THREADS) {
      const int t = i / d, a = i - t * d;
      const size_t src = (size_t)(c0 + t) * d + a;
      Qs(t, a) = q[src];
      Ks(t, a) = k[src];
    }
    for (int i = tid; i < L * dvx; i += THREADS) {
      const int t = i / dvx, e = i - t * dvx;
      const size_t src = (size_t)(c0 + t) * dv + e0 + e;
      Vs(t, e) = e < cw ? to_f(v[src]) : 1.f;
      Ds(t, e) = e < cw ? to_f(dout[src]) : 0.f;
    }
    if (c > 0) {  // the previous chunk's rows, into L2 while this one runs
      prefetch_l2(q + (size_t)(c0 - W) * d, (size_t)W * d * sizeof(T));
      prefetch_l2(k + (size_t)(c0 - W) * d, (size_t)W * d * sizeof(T));
    }
    __syncthreads();

    // ---- recompute the forward's tiles --------------------------------
    mma_mm<2, kIn, kIn>(  // KQ = K Q^T
        L, L, d, k_, [=](int a, int j) { return q_(j, a); },
        [=](int i, int j, float x) { KQ(i, j) = x; });
    mma_mm<4, kIn, false>(  // Xs = Q S0
        L, d, d, q_, [=](int a, int b) { return S0[a * d + b]; },
        [=](int t, int b, float x) { Xs[t * d + b] = x; });
    __syncthreads();
    mma_mm<2, false, false>(  // M = A Bm
        L, L, L,
        [=](int t, int i) { return i <= t ? gp[t - i] * KQ(i, t) : 0.f; },
        [=](int i, int j) { return i <= j ? KQ(i, j) : 0.f; },
        [=](int t, int j, float x) { M(t, j) = x; });
    mma_mm<2, false, kIn>(  // X2 = Q S0 Q^T, M += g^(t+1) X2
        L, L, d, [=](int t, int a) { return Xs[t * d + a]; },
        [=](int a, int j) { return q_(j, a); },
        [=](int t, int j, float x) {
          X2[t * W + j] = x;
          M(t, j) += gp[t + 1] * x;
        });
    if (has_lam)  // M += lam Q Q^T
      mma_mm<2, kIn, kIn>(
          L, L, d, q_, [=](int a, int j) { return q_(j, a); },
          [=](int t, int j, float x) { M(t, j) += lam * x; });
    __syncthreads();
    // intra-chunk weights of num': (g^(t+1) X2 + AB + lam QQ) . Lg
    auto wgt = [=](int t, int j) {
      return j > t ? 0.f : gp[t - j] * M(t, j);
    };

    if (normalize) {
      // num' = g^(2t)(Q S0 C0' - Q G0') + wgt V' + lam g^t Q C0'; its last
      // column is the denominator
      const int kl = has_lam ? d : 0;
      mma_mm<2, false, false>(
          L, dvx, 2 * d + L + kl,
          [=](int t, int kk) {
            const float pt = gp[t + 1];
            if (kk < d) return pt * pt * Xs[t * d + kk];
            if (kk < 2 * d) return -pt * pt * q_(t, kk - d);
            if (kk < 2 * d + L) return wgt(t, kk - 2 * d);
            return lam * pt * q_(t, kk - 2 * d - L);
          },
          [=](int kk, int e) {
            if (kk < d) return C0w(kk, e);
            if (kk < 2 * d) return G0w(kk - d, e);
            if (kk < 2 * d + L) return Vs(kk - 2 * d, e);
            return C0w(kk - 2 * d - L, e);
          },
          [=](int t, int e, float x) { Y1[t * xw + e] = x; });
      __syncthreads();
      // dnum = dO / z, dden = -rowsum(dO . num) / z^2 over this tile's
      // columns, z = den + eps
      for (int t = tid; t < L; t += THREADS) {
        const float z = Y1[t * xw + cw] + eps;
        float s = 0.f;
        for (int e = 0; e < cw; ++e) s = fmaf(Ds(t, e), Y1[t * xw + e], s);
        for (int e = 0; e < cw; ++e) Ds(t, e) /= z;
        Ds(t, cw) = -s / (z * z);
      }
      __syncthreads();
    }

    // ---- carry part: reads the outgoing carry cotangents dS, dC', dG' ---
    mma_mm<2, false, false>(  // Y1 = Kg dG1'
        L, dvx, d, [=](int t, int a) { return pr(t) * k_(t, a); },
        [=](int a, int e) { return dG(a, e); },
        [=](int t, int e, float x) { Y1[t * xw + e] = x; });
    mma_mm<2, false, false>(  // Y2 = Z' = N (r . V') + rho K C0'
        L, dvx, L + d,
        [=](int t, int kk) {
          if (kk < L) return kk < t ? KQ(t, kk) * pr(kk) : 0.f;
          return rho * k_(t, kk - L);
        },
        [=](int kk, int e) { return kk < L ? Vs(kk, e) : C0w(kk - L, e); },
        [=](int t, int e, float x) { Y2[t * xw + e] = x; });
    mma_mm<4, kIn, false>(  // YQ = V' dC1'^T
        L, d, dvx, [=](int t, int e) { return Vs(t, e); },
        [=](int e, int a) { return dC(a, e); },
        [=](int t, int a, float x) { YQ[t * d + a] = x; });
    mma_mm<2, false, false>(  // dV' = (r . Q) dC1'
        L, dvx, d, [=](int t, int a) { return pr(t) * q_(t, a); },
        [=](int a, int e) { return dC(a, e); },
        [=](int t, int e, float x) { dVa[t * CWX + e] = x; });
    mma_mm<4, kIn, false>(  // dK = Kg dS1
        L, d, d, k_, [=](int a, int b) { return dS(a, b); },
        [=](int t, int b, float x) { dKa[(size_t)(c0 + t) * d + b] = pr(t) * x; });
    mma_mm<4, kIn, false>(  // YK = K dS1^T
        L, d, d, k_, [=](int a, int b) { return dS(b, a); },
        [=](int t, int b, float x) { YK[t * d + b] = x; });
    __syncthreads();
    mma_mm<4, false, false>(  // YK += Z' dG1'^T
        L, d, dvx, [=](int t, int e) { return Y2[t * xw + e]; },
        [=](int e, int a) { return dG(a, e); },
        [=](int t, int a, float x) { YK[t * d + a] += x; });
    mma_mm<4, false, false>(  // dK += rho (Kg dG1') C0'^T
        L, d, dvx, [=](int t, int e) { return rho * Y1[t * xw + e]; },
        [=](int e, int a) { return C0w(a, e); },
        [=](int t, int a, float x) { dKa[(size_t)(c0 + t) * d + a] += x; });
    mma_mm<2, false, false>(  // TA = dN = ((Kg dG1') (r . V')^T) . Ls
        L, L, dvx, [=](int t, int e) { return Y1[t * xw + e]; },
        [=](int e, int j) { return pr(j) * Vs(j, e); },
        [=](int t, int j, float x) { TA[t * W + j] = j < t ? x : 0.f; });
    mma_mm<2, false, false>(  // YV = dVg' = N^T (Kg dG1'), N[t][j] = KQ[t][j]
        L, dvx, L, [=](int j, int t) { return t > j ? KQ(t, j) : 0.f; },
        [=](int t, int e) { return Y1[t * xw + e]; },
        [=](int j, int e, float x) { YV[j * CWX + e] = x; });
    __syncthreads();
    mma_mm<4, false, kIn>(  // dK += dN Q + r . dKg
        L, d, L, [=](int t, int j) { return TA[t * W + j]; },
        [=](int j, int a) { return q_(j, a); },
        [=](int t, int a, float x) {
          dKa[(size_t)(c0 + t) * d + a] += x + pr(t) * YK[t * d + a];
        });
    mma_mm<4, false, kIn>(  // dQ = dN^T K + r . dQg
        L, d, L, [=](int j, int t) { return TA[t * W + j]; }, k_,
        [=](int j, int a, float x) {
          dQa[(size_t)(c0 + j) * d + a] = x + pr(j) * YQ[j * d + a];
        });
    {  // dr, and dV' += r . dVg': GROUP threads per token
      const int t = tid / GROUP, part = tid % GROUP;
      float dr = 0.f;
      if (t < L) {
        for (int e = part; e < dvx; e += GROUP) {
          dr = fmaf(YV[t * CWX + e], Vs(t, e), dr);
          dVa[t * CWX + e] += pr(t) * YV[t * CWX + e];
        }
#pragma unroll 4
        for (int a = part; a < d; a += GROUP) {
          dr = fmaf(YK[t * d + a], k_(t, a), dr);
          dr = fmaf(YQ[t * d + a], q_(t, a), dr);
        }
      }
      dr = group_sum<GROUP>(dr);
      if (part == 0 && t < L - 1) dg += dr * (L - 1 - t) * gp[L - 2 - t];
    }
    // the carry cotangents in place: dS0 = rho dS1, dC0' = rho (dC1' +
    // K^T Kg dG1'), dG0' = rho^2 dG1', and their share of d rho
    float drho = 0.f;
    mma_mm<2, kIn, false>(
        d, dvx, L, [=](int a, int t) { return k_(t, a); },
        [=](int t, int e) { return Y1[t * xw + e]; },
        [&](int a, int e, float x) {
          const float old = dC(a, e);
          drho += (old + x) * C0w(a, e);
          dC(a, e) = rho * (old + x);
        });
    for (int i = tid; i < d * d; i += THREADS) {
      const int a = i / d, b = i - a * d;
      drho = fmaf(dS(a, b), S0[i], drho);
      dS(a, b) *= rho;
    }
    for (int i = tid; i < d * dvx; i += THREADS) {
      const int a = i / dvx, e = i - a * dvx;
      drho += 2.f * rho * dG(a, e) * G0w(a, e);
      dG(a, e) *= rho * rho;
    }
    dg += drho * L * gp[L - 1];
    __syncthreads();

    // ---- output part --------------------------------------------------
    mma_mm<2, false, kIn>(  // TE = E = dnum' V'^T, and its terms of dLg
        L, L, dvx, [=](int t, int e) { return Ds(t, e); },
        [=](int e, int j) { return Vs(j, e); },
        [&](int t, int j, float x) {
          TE[t * W + j] = x;
          if (j < t) dg += x * M(t, j) * (t - j) * gp[t - j - 1];
        });
    mma_mm<4, false, false>(  // Y2 = dnum' C0'^T
        L, d, dvx, [=](int t, int e) { return Ds(t, e); },
        [=](int e, int a) { return C0w(a, e); },
        [=](int t, int a, float x) { Y2[t * xw + a] = x; });
    mma_mm<4, false, false>(  // Y3 = dnum' G0'^T
        L, d, dvx, [=](int t, int e) { return Ds(t, e); },
        [=](int e, int a) { return G0w(a, e); },
        [=](int t, int a, float x) { Y3[t * d + a] = x; });
    __syncthreads();
    mma_mm<2, false, false>(  // TA = dA = (E . Lg) Bm^T, and its term of dLg
        L, L, L,
        [=](int t, int j) { return j <= t ? gp[t - j] * TE[t * W + j] : 0.f; },
        [=](int j, int i) { return i <= j ? KQ(i, j) : 0.f; },
        [&](int t, int i, float x) {
          TA[t * W + i] = x;
          if (i < t) dg += x * KQ(i, t) * (t - i) * gp[t - i - 1];
        });
    mma_mm<2, false, false>(  // TB = dBm = (A^T (E . Lg)) . U
        L, L, L,
        [=](int i, int t) { return t >= i ? gp[t - i] * KQ(i, t) : 0.f; },
        [=](int t, int j) { return t >= j ? gp[t - j] * TE[t * W + j] : 0.f; },
        [=](int i, int j, float x) { TB[i * W + j] = i <= j ? x : 0.f; });
    mma_mm<4, false, kIn>(  // Y1 = dQS0 = (g^(t+1) E . Lg) Q
        L, d, L,
        [=](int t, int j) {
          return j <= t ? gp[t + 1] * gp[t - j] * TE[t * W + j] : 0.f;
        },
        [=](int j, int a) { return q_(j, a); },
        [=](int t, int a, float x) { Y1[t * xw + a] = x; });
    mma_mm<2, false, false>(  // dV' += wgt^T dnum'
        L, dvx, L, [=](int j, int t) { return wgt(t, j); },
        [=](int t, int e) { return Ds(t, e); },
        [=](int j, int e, float x) { dVa[j * CWX + e] += x; });
    {
      // dQ += g^(2t)(Y2 S0^T - Y3) + lam g^t Y2 + dX2^T (Q S0)
      //       + lam (E . Lg + (E . Lg)^T) Q
      const int kl = has_lam ? L : 0;
      mma_mm<4, false, false>(
          L, d, d + L + kl,
          [=](int t, int kk) {
            if (kk < d) return gp[t + 1] * gp[t + 1] * Y2[t * xw + kk];
            if (kk < d + L) {
              const int j = kk - d;
              return j >= t ? gp[j + 1] * gp[j - t] * TE[j * W + t] : 0.f;
            }
            const int j = kk - d - L;
            float x = j <= t ? gp[t - j] * TE[t * W + j] : 0.f;
            if (j >= t) x += gp[j - t] * TE[j * W + t];
            return lam * x;
          },
          [=](int kk, int a) {
            if (kk < d) return S0[a * d + kk];
            if (kk < d + L) return Xs[(kk - d) * d + a];
            return q_(kk - d - L, a);
          },
          [=](int t, int a, float x) {
            const float pt = gp[t + 1];
            dQa[(size_t)(c0 + t) * d + a] +=
                x - pt * pt * Y3[t * d + a] + lam * pt * Y2[t * xw + a];
          });
    }
    mma_mm<2, false, false>(  // dC0' += (g^(2t) Q S0 + lam g^t Q)^T dnum'
        d, dvx, L,
        [=](int a, int t) {
          const float pt = gp[t + 1];
          return pt * (pt * Xs[t * d + a] + lam * q_(t, a));
        },
        [=](int t, int e) { return Ds(t, e); },
        [=](int a, int e, float x) { dC(a, e) += x; });
    mma_mm<2, kIn, false>(  // dG0' -= Q^T (g^(2t) dnum')
        d, dvx, L, [=](int a, int t) { return q_(t, a); },
        [=](int t, int e) { return gp[t + 1] * gp[t + 1] * Ds(t, e); },
        [=](int a, int e, float x) { dG(a, e) -= x; });
    {  // dp, d/dg of g^(t+1): GROUP threads per token
      const int t = tid / GROUP, part = tid % GROUP;
      float s1 = 0.f, s3 = 0.f, s2 = 0.f;
      if (t < L) {
#pragma unroll 4
        for (int a = part; a < d; a += GROUP) {
          s1 = fmaf(Xs[t * d + a], Y2[t * xw + a], s1);
          s1 = fmaf(-q_(t, a), Y3[t * d + a], s1);
          s3 = fmaf(q_(t, a), Y2[t * xw + a], s3);
        }
        for (int j = part; j <= t; j += GROUP)
          s2 = fmaf(gp[t - j] * X2[t * W + j], TE[t * W + j], s2);
      }
      const float dpt = 2.f * gp[t + 1] * group_sum<GROUP>(s1) +
                        group_sum<GROUP>(s2) + lam * group_sum<GROUP>(s3);
      if (part == 0 && t < L) dg += dpt * (t + 1) * gp[t];
    }
    __syncthreads();
    mma_mm<4, false, false>(  // dQ += dQS0 S0^T + dBm^T K + (dA . Lg) K
        L, d, d + 2 * L,
        [=](int t, int kk) {
          if (kk < d) return Y1[t * xw + kk];
          if (kk < d + L) {
            const int i = kk - d;
            return i <= t ? TB[i * W + t] : 0.f;
          }
          const int i = kk - d - L;
          return i <= t ? gp[t - i] * TA[t * W + i] : 0.f;
        },
        [=](int kk, int a) {
          if (kk < d) return S0[a * d + kk];
          return k_((kk - d) % L, a);
        },
        [=](int t, int a, float x) { dQa[(size_t)(c0 + t) * d + a] += x; });
    mma_mm<4, false, kIn>(  // dK += dBm Q + (dA . Lg)^T Q
        L, d, 2 * L,
        [=](int i, int kk) {
          if (kk < L) return kk >= i ? TB[i * W + kk] : 0.f;
          const int t = kk - L;
          return t >= i ? gp[t - i] * TA[t * W + i] : 0.f;
        },
        [=](int kk, int a) { return q_(kk % L, a); },
        [=](int i, int a, float x) { dKa[(size_t)(c0 + i) * d + a] += x; });
    mma_mm<4, kIn, false>(  // dS0 += Q^T (g^(2t) Y2 + dQS0)
        d, d, L, [=](int a, int t) { return q_(t, a); },
        [=](int t, int b) {
          return gp[t + 1] * gp[t + 1] * Y2[t * xw + b] + Y1[t * xw + b];
        },
        [=](int a, int b, float x) { dS(a, b) += x; });
    __syncthreads();

    for (int i = tid; i < L * cw; i += THREADS) {
      const int t = i / cw, e = i - t * cw;
      store(dvo + (size_t)(c0 + t) * dv + e0 + e, dVa[t * CWX + e]);
    }
    __syncthreads();  // scratch and tiles are free for the next chunk
  }

  for (int off = 16; off > 0; off >>= 1)
    dg += __shfl_down_sync(0xffffffffu, dg, off);
  if ((tid & 31) == 0) red[tid >> 5] = dg;
  __syncthreads();
  if (tid == 0) {
    float s = 0.f;
    for (int i = 0; i < THREADS / 32; ++i) s += red[i];
    dgp[slot] = s;
  }
}

// dq, dk and dgamma: the sums of the column tiles' partials, in tile order
template <typename T>
__global__ void __launch_bounds__(THREADS)
    hla2_bwd_reduce_kernel(const float* __restrict__ dqp,
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

// fp32 scratch floats: the per-CTA transient tiles, the per-tile partial
// dq and dk (BH, T, n, d) each and the per-tile dgamma (BH, T)
size_t scratch_floats(int BH, int n, int d, int dv) {
  const size_t ctas = (size_t)BH * n_tiles(dv);
  return ctas * cta_floats(d) + 2 * ctas * n * d + ctas;
}

// Shared-memory bytes for head dim d and input type size tsize (219,428 at
// d = 128 with fp32 inputs, 186,660 with bf16); a size above the 227 KB
// limit makes cudaFuncSetAttribute fail the launch.
size_t smem_bytes(int d, size_t tsize) {
  const size_t floats = (size_t)d * d + 2 * (size_t)d * CWP + 2 * W * CWP +
                        2 * W * W + (W + 1) + THREADS / 32;
  return floats * sizeof(float) + 2 * (size_t)W * d * tsize;
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const float* gamma, const void* dout,
                   const float* const* ck, void* dq, void* dk, void* dv_out,
                   float* dgamma, float* scratch, int BH, int n, int d,
                   int dv, int normalize, float eps, float lam,
                   cudaStream_t stream) {
  const int T_ = n_tiles(dv);
  const size_t ctas = (size_t)BH * T_;
  float* dqp = scratch + ctas * cta_floats(d);
  float* dkp = dqp + ctas * n * d;
  float* dgp = dkp + ctas * n * d;
  auto kern = hla2_chunk_bwd_kernel<T>;
  const size_t smem = smem_bytes(d, sizeof(T));
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kern<<<dim3(BH, T_), THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), gamma, static_cast<const T*>(dout), ck[0],
      ck[1], ck[2], ck[3], ck[4], dqp, dkp, static_cast<T*>(dv_out), dgp,
      scratch, n, d, dv, normalize, eps, lam);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t per_row = (size_t)n * d;
  const size_t blocks = (BH * per_row + THREADS - 1) / THREADS;
  hla2_bwd_reduce_kernel<T><<<(unsigned)(blocks < 1056 ? blocks : 1056),
                              THREADS, 0, stream>>>(
      dqp, dkp, dgp, static_cast<T*>(dq), static_cast<T*>(dk), dgamma, BH, T_,
      per_row);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// fp32 scratch floats that hla2_chunk_bwd needs.
long hla2_chunk_bwd_scratch_floats(int BH, int n, int d, int dv) {
  return (long)scratch_floats(BH, n, d, dv);
}

// Dynamic shared-memory bytes the walk kernel asks for.
long hla2_chunk_bwd_smem_bytes(int d, int is_bf16) {
  return (long)smem_bytes(d, is_bf16 ? 2 : 4);
}

// q, k: (BH, n, d); v, dout: (BH, n, dv) in bf16 (is_bf16) or fp32; gamma:
// (BH,) fp32 or null; Sc, Cc, mc, Gc, hc: the forward's fp32 checkpoints
// (BH, ceil(n / 64), ...); dq, dk, dv_out: outputs like q, k, v; dgamma:
// (BH,) fp32 output or null; scratch: hla2_chunk_bwd_scratch_floats fp32.
// Launches two kernels on the stream (the reverse walk over column tiles,
// then the sum over the tiles).  Returns the first CUDA error (0 =
// launched).
int hla2_chunk_bwd(const void* q, const void* k, const void* v,
                   const float* gamma, const void* dout, const float* Sc,
                   const float* Cc, const float* mc, const float* Gc,
                   const float* hc, void* dq, void* dk, void* dv_out,
                   float* dgamma, float* scratch, int BH, int n, int d, int dv,
                   int is_bf16, int normalize, float eps, float lam,
                   int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* const ck[5] = {Sc, Cc, mc, Gc, hc};
  err = is_bf16
            ? launch<__nv_bfloat16>(q, k, v, gamma, dout, ck, dq, dk, dv_out,
                                    dgamma, scratch, BH, n, d, dv, normalize,
                                    eps, lam, s)
            : launch<float>(q, k, v, gamma, dout, ck, dq, dk, dv_out, dgamma,
                            scratch, BH, n, d, dv, normalize, eps, lam, s);
  return (int)err;
}

}  // extern "C"
