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
// Bound on this card: operations.  A 64-token chunk at d = dv = 128 does
// about 3.5x the forward's products (about 60 MFLOP per row) against
// 0.3 MB of q/k/v/do/dq/dk/dv and checkpoint traffic; every product here is
// an fp32 FMA loop on the CUDA cores, so the floor is the 67 TFLOP/s fp32
// rate (chip_smoke.py prices the function's products).
//
// Design: the TPU grid's reversed chunk axis becomes a loop inside one CTA
// per row, so there are no cross-block sums: dgamma is a per-thread sum
// reduced once at the end.  Shared memory (215 KB at d = dv = 128) holds
// the chunk's Q, K, V, dO (fp32, rows padded by one float against bank
// conflicts), Q S0 and three w x w tiles (K Q^T, (A Bm) and Q S0 Q^T).
// Everything else lives in a per-row fp32 scratch in device memory that
// stays in L2: the five carry cotangents, the chunk's dq/dk/dv
// accumulators and the transient tiles.  Normalisation is the
// unnormalised case with V widened by a ones column and C, G widened by
// m, h (their cotangents [dC | dm], [dG | dh] likewise), so one code path
// serves both.  Phases are separated by barriers: every read of the old
// carry cotangent finishes before it is rewritten in place, and each
// output element of a product belongs to one thread.  Decay powers come
// from a table g^0..g^64; a derivative of g^k is formed only for k >= 1
// (never g^-1).  Known weakness: one CTA per row (32 CTAs for hla-1b at
// batch 2) on 132 SMs, products on the CUDA cores, not the tensor cores.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int W = 64;  // tokens per chunk: the forward's partition
constexpr int THREADS = 256;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// out(r, c, sum_{kk < K} a(r, kk) * b(kk, c)) for every r < M, c < N.
// Each work item owns a TM x TN micro-tile with rows tr + i*RG and columns
// tc + j*CG, so the lanes of a warp read consecutive columns of b.
template <int TM, int TN, class FA, class FB, class FO>
__device__ __forceinline__ void tile_mm(int M, int N, int K, FA a, FB b,
                                        FO out) {
  const int RG = (M + TM - 1) / TM;
  const int CG = (N + TN - 1) / TN;
  for (int item = threadIdx.x; item < RG * CG; item += blockDim.x) {
    const int tr = item / CG, tc = item % CG;
    float acc[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
    for (int kk = 0; kk < K; ++kk) {
      float av[TM], bv[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const int r = tr + i * RG;
        av[i] = r < M ? a(r, kk) : 0.f;
      }
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int c = tc + j * CG;
        bv[j] = c < N ? b(kk, c) : 0.f;
      }
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int r = tr + i * RG, c = tc + j * CG;
        if (r < M && c < N) out(r, c, acc[i][j]);
      }
  }
}

// fp32 scratch floats per row (see the layout in the kernel)
__host__ __device__ size_t scratch_floats(int d, int dv, int normalize) {
  const int dvx = dv + normalize, xw = d > dvx ? d : dvx;
  return (size_t)d * d + 2 * (size_t)d * dvx +
         (size_t)W * (5 * d + 2 * dvx + 2 * xw) + 4 * (size_t)W * W;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
    hla2_chunk_bwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v,
                          const float* __restrict__ gamma,
                          const T* __restrict__ dout, const float* Sc,
                          const float* Cc, const float* mc, const float* Gc,
                          const float* hc, T* dq, T* dk, T* dvo,
                          float* dgamma, float* scratch, int n, int d, int dv,
                          int normalize, float eps, float lam) {
  extern __shared__ float smem[];
  const int dvx = dv + normalize;  // widened value width: [V | 1]
  const int xw = d > dvx ? d : dvx;
  const int dp = d + 1, vp = dvx + 1, wp = W + 1;
  float* Qs = smem;            // W x dp
  float* Ks = Qs + W * dp;     // W x dp
  float* Vs = Ks + W * dp;     // W x vp   V' = [V | 1]
  float* Ds = Vs + W * vp;     // W x vp   dO, then dnum' = [dnum | dden]
  float* Xs = Ds + W * vp;     // W x dp   Q S0
  float* KQ = Xs + W * dp;     // W x wp   KQ[i][j] = k_i . q_j
  float* AB = KQ + W * wp;     // W x wp   (A Bm)[t][j] for j <= t
  float* X2 = AB + W * wp;     // W x wp   (Q S0 Q^T)[t][j] for j <= t
  float* gp = X2 + W * wp;     // W + 1    g^i
  float* red = gp + (W + 1);   // THREADS / 32 partial dgamma sums

  const size_t row = blockIdx.x;
  const int nc = (n + W - 1) / W;
  q += row * n * d;
  k += row * n * d;
  v += row * n * dv;
  dout += row * n * dv;
  dq += row * n * d;
  dk += row * n * d;
  dvo += row * n * dv;
  Sc += row * nc * d * d;
  Cc += row * nc * d * dv;
  mc += row * nc * d;
  Gc += row * nc * d * dv;
  hc += row * nc * d;
  float* dS = scratch + row * scratch_floats(d, dv, normalize);  // d x d
  float* dC = dS + d * d;      // d x dvx  [dC | dm], carry cotangents
  float* dG = dC + d * dvx;    // d x dvx  [dG | dh]
  float* dQa = dG + d * dvx;   // W x d    the chunk's dq, dk, dv
  float* dKa = dQa + W * d;    // W x d
  float* dVa = dKa + W * d;    // W x dvx
  float* YQ = dVa + W * dvx;   // W x d    dQg = V' dC1'^T
  float* YK = YQ + W * d;      // W x d    dKg = K dS1^T + Z' dG1'^T
  float* YV = YK + W * d;      // W x dvx  dVg' = N^T (Kg dG1')
  float* Y1 = YV + W * dvx;    // W x xw   num', then Kg dG1', then dQS0
  float* Y2 = Y1 + W * xw;     // W x xw   Z', then dnum' C0'^T
  float* Y3 = Y2 + W * xw;     // W x d    dnum' G0'^T
  float* TA = Y3 + W * d;      // W x W    dN, then dA
  float* TE = TA + W * W;      // W x W    E = dnum' V'^T
  float* TB = TE + W * W;      // W x W    dBm
  float* QQ = TB + W * W;      // W x W    Q Q^T (lam only)
  const int tid = threadIdx.x;
  const float logg = logf(gamma ? gamma[row] : 1.f);
  const bool has_lam = lam != 0.f;

  for (int i = tid; i < d * d; i += THREADS) dS[i] = 0.f;
  for (int i = tid; i < d * dvx; i += THREADS) dC[i] = dG[i] = 0.f;
  for (int i = tid; i <= W; i += THREADS) gp[i] = expf(i * logg);
  float dg = 0.f;  // this thread's share of dgamma
  __syncthreads();

  for (int c = nc - 1; c >= 0; --c) {
    const int c0 = c * W, L = min(W, n - c0);
    const float rho = gp[L];
    const float* S0 = Sc + (size_t)c * d * d;
    const float* C0 = Cc + (size_t)c * d * dv;
    const float* m0 = mc + (size_t)c * d;
    const float* G0 = Gc + (size_t)c * d * dv;
    const float* h0 = hc + (size_t)c * d;
    // the widened checkpointed carry: C0' = [C0 | m0], G0' = [G0 | h0]
    auto C0w = [=](int a, int e) { return e < dv ? C0[a * dv + e] : m0[a]; };
    auto G0w = [=](int a, int e) { return e < dv ? G0[a * dv + e] : h0[a]; };
    auto pr = [=](int t) { return gp[L - 1 - t]; };  // g^(L-1-t)

    for (int i = tid; i < L * d; i += THREADS) {
      const int t = i / d, a = i - t * d;
      const size_t src = (size_t)(c0 + t) * d + a;
      Qs[t * dp + a] = to_f(q[src]);
      Ks[t * dp + a] = to_f(k[src]);
    }
    for (int i = tid; i < L * dvx; i += THREADS) {
      const int t = i / dvx, e = i - t * dvx;
      const size_t src = (size_t)(c0 + t) * dv + e;
      Vs[t * vp + e] = e < dv ? to_f(v[src]) : 1.f;
      Ds[t * vp + e] = e < dv ? to_f(dout[src]) : 0.f;
    }
    __syncthreads();

    // ---- recompute the forward's tiles --------------------------------
    tile_mm<4, 4>(
        L, L, d, [=](int i, int a) { return Ks[i * dp + a]; },
        [=](int a, int j) { return Qs[j * dp + a]; },
        [=](int i, int j, float x) { KQ[i * wp + j] = x; });
    tile_mm<4, 8>(
        L, d, d, [=](int t, int a) { return Qs[t * dp + a]; },
        [=](int a, int b) { return S0[a * d + b]; },
        [=](int t, int b, float x) { Xs[t * dp + b] = x; });
    if (has_lam)
      tile_mm<4, 4>(
          L, L, d, [=](int t, int a) { return Qs[t * dp + a]; },
          [=](int a, int j) { return Qs[j * dp + a]; },
          [=](int t, int j, float x) { QQ[t * W + j] = x; });
    __syncthreads();
    tile_mm<4, 4>(
        L, L, L,
        [=](int t, int i) { return i <= t ? gp[t - i] * KQ[i * wp + t] : 0.f; },
        [=](int i, int j) { return i <= j ? KQ[i * wp + j] : 0.f; },
        [=](int t, int j, float x) { AB[t * wp + j] = x; });
    tile_mm<4, 4>(
        L, L, d, [=](int t, int a) { return Xs[t * dp + a]; },
        [=](int a, int j) { return Qs[j * dp + a]; },
        [=](int t, int j, float x) { X2[t * wp + j] = x; });
    __syncthreads();
    // intra-chunk weights of num': (g^(t+1) X2 + AB + lam QQ) . Lg
    auto wgt = [=](int t, int j) {
      if (j > t) return 0.f;
      const float x = gp[t + 1] * X2[t * wp + j] + AB[t * wp + j];
      return gp[t - j] * (has_lam ? x + lam * QQ[t * W + j] : x);
    };

    if (normalize) {
      // num' = g^(2t)(Q S0 C0' - Q G0') + wgt V' + lam g^t Q C0'; its last
      // column is the denominator
      const int kl = has_lam ? d : 0;
      tile_mm<4, 8>(
          L, dvx, 2 * d + L + kl,
          [=](int t, int kk) {
            const float pt = gp[t + 1];
            if (kk < d) return pt * pt * Xs[t * dp + kk];
            if (kk < 2 * d) return -pt * pt * Qs[t * dp + kk - d];
            if (kk < 2 * d + L) return wgt(t, kk - 2 * d);
            return lam * pt * Qs[t * dp + kk - 2 * d - L];
          },
          [=](int kk, int e) {
            if (kk < d) return C0w(kk, e);
            if (kk < 2 * d) return G0w(kk - d, e);
            if (kk < 2 * d + L) return Vs[(kk - 2 * d) * vp + e];
            return C0w(kk - 2 * d - L, e);
          },
          [=](int t, int e, float x) { Y1[t * xw + e] = x; });
      __syncthreads();
      // dnum = dO / z, dden = -rowsum(dO . num) / z^2, z = den + eps
      for (int t = tid; t < L; t += THREADS) {
        const float z = Y1[t * xw + dv] + eps;
        float s = 0.f;
        for (int e = 0; e < dv; ++e) s = fmaf(Ds[t * vp + e], Y1[t * xw + e], s);
        for (int e = 0; e < dv; ++e) Ds[t * vp + e] /= z;
        Ds[t * vp + dv] = -s / (z * z);
      }
      __syncthreads();
    }

    // ---- carry part: reads the outgoing carry cotangents dS, dC', dG' ---
    tile_mm<4, 8>(  // Y1 = Kg dG1'
        L, dvx, d, [=](int t, int a) { return pr(t) * Ks[t * dp + a]; },
        [=](int a, int e) { return dG[a * dvx + e]; },
        [=](int t, int e, float x) { Y1[t * xw + e] = x; });
    tile_mm<4, 8>(  // Y2 = Z' = N (r . V') + rho K C0'
        L, dvx, L + d,
        [=](int t, int kk) {
          if (kk < L) return kk < t ? KQ[t * wp + kk] * pr(kk) : 0.f;
          return rho * Ks[t * dp + kk - L];
        },
        [=](int kk, int e) {
          return kk < L ? Vs[kk * vp + e] : C0w(kk - L, e);
        },
        [=](int t, int e, float x) { Y2[t * xw + e] = x; });
    tile_mm<4, 8>(  // YQ = V' dC1'^T
        L, d, dvx, [=](int t, int e) { return Vs[t * vp + e]; },
        [=](int e, int a) { return dC[a * dvx + e]; },
        [=](int t, int a, float x) { YQ[t * d + a] = x; });
    tile_mm<4, 8>(  // dV' = (r . Q) dC1'
        L, dvx, d, [=](int t, int a) { return pr(t) * Qs[t * dp + a]; },
        [=](int a, int e) { return dC[a * dvx + e]; },
        [=](int t, int e, float x) { dVa[t * dvx + e] = x; });
    tile_mm<4, 8>(  // dK = Kg dS1, YK = K dS1^T
        L, d, d, [=](int t, int a) { return Ks[t * dp + a]; },
        [=](int a, int b) { return dS[a * d + b]; },
        [=](int t, int b, float x) { dKa[t * d + b] = pr(t) * x; });
    tile_mm<4, 8>(
        L, d, d, [=](int t, int a) { return Ks[t * dp + a]; },
        [=](int a, int b) { return dS[b * d + a]; },
        [=](int t, int b, float x) { YK[t * d + b] = x; });
    __syncthreads();
    tile_mm<4, 8>(  // YK += Z' dG1'^T
        L, d, dvx, [=](int t, int e) { return Y2[t * xw + e]; },
        [=](int e, int a) { return dG[a * dvx + e]; },
        [=](int t, int a, float x) { YK[t * d + a] += x; });
    tile_mm<4, 8>(  // dK += rho (Kg dG1') C0'^T
        L, d, dvx, [=](int t, int e) { return rho * Y1[t * xw + e]; },
        [=](int e, int a) { return C0w(a, e); },
        [=](int t, int a, float x) { dKa[t * d + a] += x; });
    tile_mm<4, 4>(  // TA = dN = ((Kg dG1') (r . V')^T) . Ls
        L, L, dvx, [=](int t, int e) { return Y1[t * xw + e]; },
        [=](int e, int j) { return pr(j) * Vs[j * vp + e]; },
        [=](int t, int j, float x) { TA[t * W + j] = j < t ? x : 0.f; });
    tile_mm<4, 8>(  // YV = dVg' = N^T (Kg dG1'), N[t][j] = KQ[t][j], j < t
        L, dvx, L, [=](int j, int t) { return t > j ? KQ[t * wp + j] : 0.f; },
        [=](int t, int e) { return Y1[t * xw + e]; },
        [=](int j, int e, float x) { YV[j * dvx + e] = x; });
    __syncthreads();
    tile_mm<4, 8>(  // dK += dN Q + r . dKg
        L, d, L, [=](int t, int j) { return TA[t * W + j]; },
        [=](int j, int a) { return Qs[j * dp + a]; },
        [=](int t, int a, float x) {
          dKa[t * d + a] += x + pr(t) * YK[t * d + a];
        });
    tile_mm<4, 8>(  // dQ = dN^T K + r . dQg
        L, d, L, [=](int j, int t) { return TA[t * W + j]; },
        [=](int t, int a) { return Ks[t * dp + a]; },
        [=](int j, int a, float x) {
          dQa[j * d + a] = x + pr(j) * YQ[j * d + a];
        });
    for (int t = tid; t < L; t += THREADS) {  // dr, and dV' += r . dVg'
      float dr = 0.f;
      for (int e = 0; e < dvx; ++e) {
        dr = fmaf(YV[t * dvx + e], Vs[t * vp + e], dr);
        dVa[t * dvx + e] += pr(t) * YV[t * dvx + e];
      }
      for (int a = 0; a < d; ++a) {
        dr = fmaf(YK[t * d + a], Ks[t * dp + a], dr);
        dr = fmaf(YQ[t * d + a], Qs[t * dp + a], dr);
      }
      if (t < L - 1) dg += dr * (L - 1 - t) * gp[L - 2 - t];
    }
    // the carry cotangents in place: dS0 = rho dS1, dC0' = rho (dC1' +
    // K^T Kg dG1'), dG0' = rho^2 dG1', and their share of d rho
    float drho = 0.f;
    tile_mm<8, 8>(
        d, dvx, L, [=](int a, int t) { return Ks[t * dp + a]; },
        [=](int t, int e) { return Y1[t * xw + e]; },
        [&](int a, int e, float x) {
          const float old = dC[a * dvx + e];
          drho += (old + x) * C0w(a, e);
          dC[a * dvx + e] = rho * (old + x);
        });
    for (int i = tid; i < d * d; i += THREADS) {
      drho = fmaf(dS[i], S0[i], drho);
      dS[i] *= rho;
    }
    for (int i = tid; i < d * dvx; i += THREADS) {
      drho += 2.f * rho * dG[i] * G0w(i / dvx, i % dvx);
      dG[i] *= rho * rho;
    }
    dg += drho * L * gp[L - 1];
    __syncthreads();

    // ---- output part --------------------------------------------------
    tile_mm<4, 4>(  // TE = E = dnum' V'^T, and its terms of dLg
        L, L, dvx, [=](int t, int e) { return Ds[t * vp + e]; },
        [=](int e, int j) { return Vs[j * vp + e]; },
        [&](int t, int j, float x) {
          TE[t * W + j] = x;
          if (j < t) {
            float y = gp[t + 1] * X2[t * wp + j] + AB[t * wp + j];
            if (has_lam) y += lam * QQ[t * W + j];
            dg += x * y * (t - j) * gp[t - j - 1];
          }
        });
    tile_mm<4, 8>(  // Y2 = dnum' C0'^T
        L, d, dvx, [=](int t, int e) { return Ds[t * vp + e]; },
        [=](int e, int a) { return C0w(a, e); },
        [=](int t, int a, float x) { Y2[t * xw + a] = x; });
    tile_mm<4, 8>(  // Y3 = dnum' G0'^T
        L, d, dvx, [=](int t, int e) { return Ds[t * vp + e]; },
        [=](int e, int a) { return G0w(a, e); },
        [=](int t, int a, float x) { Y3[t * d + a] = x; });
    __syncthreads();
    tile_mm<4, 4>(  // TA = dA = (E . Lg) Bm^T, and its term of dLg
        L, L, L,
        [=](int t, int j) { return j <= t ? gp[t - j] * TE[t * W + j] : 0.f; },
        [=](int j, int i) { return i <= j ? KQ[i * wp + j] : 0.f; },
        [&](int t, int i, float x) {
          TA[t * W + i] = x;
          if (i < t) dg += x * KQ[i * wp + t] * (t - i) * gp[t - i - 1];
        });
    tile_mm<4, 4>(  // TB = dBm = (A^T (E . Lg)) . U
        L, L, L,
        [=](int i, int t) { return t >= i ? gp[t - i] * KQ[i * wp + t] : 0.f; },
        [=](int t, int j) { return t >= j ? gp[t - j] * TE[t * W + j] : 0.f; },
        [=](int i, int j, float x) { TB[i * W + j] = i <= j ? x : 0.f; });
    tile_mm<4, 8>(  // Y1 = dQS0 = (g^(t+1) E . Lg) Q
        L, d, L,
        [=](int t, int j) {
          return j <= t ? gp[t + 1] * gp[t - j] * TE[t * W + j] : 0.f;
        },
        [=](int j, int a) { return Qs[j * dp + a]; },
        [=](int t, int a, float x) { Y1[t * xw + a] = x; });
    tile_mm<4, 8>(  // dV' += wgt^T dnum'
        L, dvx, L, [=](int j, int t) { return wgt(t, j); },
        [=](int t, int e) { return Ds[t * vp + e]; },
        [=](int j, int e, float x) { dVa[j * dvx + e] += x; });
    {
      // dQ += g^(2t)(Y2 S0^T - Y3) + lam g^t Y2 + dX2^T (Q S0)
      //       + lam (E . Lg + (E . Lg)^T) Q
      const int kl = has_lam ? L : 0;
      tile_mm<4, 8>(
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
            if (kk < d + L) return Xs[(kk - d) * dp + a];
            return Qs[(kk - d - L) * dp + a];
          },
          [=](int t, int a, float x) {
            const float pt = gp[t + 1];
            dQa[t * d + a] +=
                x - pt * pt * Y3[t * d + a] + lam * pt * Y2[t * xw + a];
          });
    }
    tile_mm<8, 8>(  // dC0' += (g^(2t) Q S0 + lam g^t Q)^T dnum'
        d, dvx, L,
        [=](int a, int t) {
          const float pt = gp[t + 1];
          return pt * (pt * Xs[t * dp + a] + lam * Qs[t * dp + a]);
        },
        [=](int t, int e) { return Ds[t * vp + e]; },
        [=](int a, int e, float x) { dC[a * dvx + e] += x; });
    tile_mm<8, 8>(  // dG0' -= Q^T (g^(2t) dnum')
        d, dvx, L,
        [=](int a, int t) { return gp[t + 1] * gp[t + 1] * Qs[t * dp + a]; },
        [=](int t, int e) { return Ds[t * vp + e]; },
        [=](int a, int e, float x) { dG[a * dvx + e] -= x; });
    for (int t = tid; t < L; t += THREADS) {  // dp, d/dg of g^(t+1)
      float s1 = 0.f, s3 = 0.f, s2 = 0.f;
      for (int a = 0; a < d; ++a) {
        s1 = fmaf(Xs[t * dp + a], Y2[t * xw + a], s1);
        s1 = fmaf(-Qs[t * dp + a], Y3[t * d + a], s1);
        s3 = fmaf(Qs[t * dp + a], Y2[t * xw + a], s3);
      }
      for (int j = 0; j <= t; ++j)
        s2 = fmaf(gp[t - j] * X2[t * wp + j], TE[t * W + j], s2);
      const float dpt = 2.f * gp[t + 1] * s1 + s2 + lam * s3;
      dg += dpt * (t + 1) * gp[t];
    }
    __syncthreads();
    tile_mm<4, 8>(  // dQ += dQS0 S0^T + dBm^T K + (dA . Lg) K
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
          return Ks[((kk - d) % L) * dp + a];
        },
        [=](int t, int a, float x) { dQa[t * d + a] += x; });
    tile_mm<4, 8>(  // dK += dBm Q + (dA . Lg)^T Q
        L, d, 2 * L,
        [=](int i, int kk) {
          if (kk < L) return kk >= i ? TB[i * W + kk] : 0.f;
          const int t = kk - L;
          return t >= i ? gp[t - i] * TA[t * W + i] : 0.f;
        },
        [=](int kk, int a) { return Qs[(kk % L) * dp + a]; },
        [=](int i, int a, float x) { dKa[i * d + a] += x; });
    tile_mm<8, 8>(  // dS0 += Q^T (g^(2t) Y2 + dQS0)
        d, d, L, [=](int a, int t) { return Qs[t * dp + a]; },
        [=](int t, int b) {
          return gp[t + 1] * gp[t + 1] * Y2[t * xw + b] + Y1[t * xw + b];
        },
        [=](int a, int b, float x) { dS[a * d + b] += x; });
    __syncthreads();

    for (int i = tid; i < L * d; i += THREADS) {
      const int t = i / d, a = i - t * d;
      store(dq + (size_t)(c0 + t) * d + a, dQa[i]);
      store(dk + (size_t)(c0 + t) * d + a, dKa[i]);
    }
    for (int i = tid; i < L * dv; i += THREADS) {
      const int t = i / dv, e = i - t * dv;
      store(dvo + (size_t)(c0 + t) * dv + e, dVa[t * dvx + e]);
    }
    __syncthreads();  // scratch and tiles are free for the next chunk
  }

  for (int off = 16; off > 0; off >>= 1)
    dg += __shfl_down_sync(0xffffffffu, dg, off);
  if ((tid & 31) == 0) red[tid >> 5] = dg;
  __syncthreads();
  if (tid == 0 && dgamma) {
    float s = 0.f;
    for (int i = 0; i < THREADS / 32; ++i) s += red[i];
    dgamma[row] = s;
  }
}

// Shared-memory bytes (215,332 at d = dv = 128 unnormalised); a size above
// the 227 KB limit makes cudaFuncSetAttribute fail the launch.
size_t smem_bytes(int d, int dv, int normalize) {
  const int dvx = dv + normalize;
  const size_t floats = (size_t)W * (3 * (d + 1) + 2 * (dvx + 1) +
                                     3 * (W + 1)) +
                        (W + 1) + THREADS / 32;
  return floats * sizeof(float);
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const float* gamma, const void* dout,
                   const float* const* ck, void* dq, void* dk, void* dv_out,
                   float* dgamma, float* scratch, int BH, int n, int d,
                   int dv, int normalize, float eps, float lam,
                   cudaStream_t stream) {
  auto kern = hla2_chunk_bwd_kernel<T>;
  const size_t smem = smem_bytes(d, dv, normalize);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kern<<<BH, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), gamma, static_cast<const T*>(dout), ck[0],
      ck[1], ck[2], ck[3], ck[4], static_cast<T*>(dq), static_cast<T*>(dk),
      static_cast<T*>(dv_out), dgamma, scratch, n, d, dv, normalize, eps,
      lam);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// fp32 scratch floats per row that hla2_chunk_bwd needs.
long hla2_chunk_bwd_scratch_floats(int d, int dv, int normalize) {
  return (long)scratch_floats(d, dv, normalize);
}

// q, k: (BH, n, d); v, dout: (BH, n, dv) in bf16 (is_bf16) or fp32; gamma:
// (BH,) fp32 or null; Sc, Cc, mc, Gc, hc: the forward's fp32 checkpoints
// (BH, ceil(n / 64), ...); dq, dk, dv_out: outputs like q, k, v; dgamma:
// (BH,) fp32 output or null; scratch: BH x hla2_chunk_bwd_scratch_floats
// fp32.  Returns the CUDA error of the launch (0 = launched).
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
