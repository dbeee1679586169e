// Chunkwise masked HLA2 forward for Hopper (sm_90a): prompt prefill.
//
// Replaces: src/repro/kernels/hla2_chunk.py, hla2_chunk_pallas (body
// _hla2_chunk_kernel), save_chunk_states included.
//
// Computes, per (batch*head) row, o = T1 + T2 + T3 for every chunk and the
// final carry (S, C, m, G, h), with optional initial carry, per-row decay
// gamma, ratio normalisation and ridge lam, and optionally each chunk's
// incoming carry for the backward kernel (hla2_chunk_bwd.cu) (see
// src/repro_torch/kernels/chunk_math.py for the math it matches).
//
// Bound on this card: operations.  A 64-token chunk at d = dv = 128 does
// about 18 MFLOP per row against 96 KB of q/k/v/o traffic, far above the
// H100's ~20 FLOP/byte fp32 ridge; this kernel runs fp32 FMAs on the CUDA
// cores, so its floor is the 67 TFLOP/s fp32 rate.
//
// Design: the TPU grid's sequential chunk axis becomes a loop inside one
// CTA per row; CTAs never share a row, so the carry lives in the fp32
// state outputs in device memory (197 KB per row, L2-resident) and is
// read and rewritten in place, chunk after chunk.  Shared memory holds only
// the chunk's tiles: Q, K, V (fp32, rows padded by one float against bank
// conflicts), K Q^T, the intra-chunk weight matrix P and one (w, d) scratch.
// Every product is a register-tiled SIMT loop (tile_mm).  All reads of the
// old carry finish (one barrier) before any element of it is rewritten, so
// G and h read the old C and m.  A ragged tail is one shorter chunk of
// length r with its own decay powers (rho = gamma^r): no zero padding and
// no division by gamma^pad.  Known weakness: one prompt gives only H CTAs
// (16 for hla-1b) on 132 SMs, and nothing uses the tensor cores yet.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int W = 64;  // tokens per chunk tile (outputs do not depend on it)
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

template <typename T>
__global__ void __launch_bounds__(THREADS)
    hla2_chunk_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v,
                          const float* __restrict__ gamma, T* __restrict__ o,
                          float* S, float* C, float* m, float* G, float* h,
                          float* Sc, float* Cc, float* mc, float* Gc,
                          float* hc, int n, int d, int dv, int has_init,
                          int normalize, float eps, float lam) {
  extern __shared__ float smem[];
  const int dp = d + 1, dvp = dv + 1, wp = W + 1;
  const int xp = (d > dv ? d : dv) + 1;
  float* Qs = smem;           // W x dp
  float* Ks = Qs + W * dp;    // W x dp
  float* Vs = Ks + W * dp;    // W x dvp
  float* KQ = Vs + W * dvp;   // W x wp    KQ[i][j] = k_i . q_j
  float* P = KQ + W * wp;     // W x wp    intra-chunk weights
  float* X = P + W * wp;      // W x xp    Q S0, later Z
  float* gp = X + W * xp;     // W + 1     g^i
  float* vec = gp + (W + 1);  // W         den + eps, later zh

  const size_t row = blockIdx.x;
  q += row * n * d;
  k += row * n * d;
  v += row * n * dv;
  o += row * n * dv;
  S += row * d * d;
  C += row * d * dv;
  m += row * d;
  G += row * d * dv;
  h += row * d;
  const int tid = threadIdx.x;
  const float logg = logf(gamma ? gamma[row] : 1.f);

  if (!has_init) {
    for (int i = tid; i < d * d; i += THREADS) S[i] = 0.f;
    for (int i = tid; i < d * dv; i += THREADS) C[i] = G[i] = 0.f;
    for (int i = tid; i < d; i += THREADS) m[i] = h[i] = 0.f;
  }
  for (int i = tid; i <= W; i += THREADS) gp[i] = expf(i * logg);
  __syncthreads();

  const size_t nc = (n + W - 1) / W;
  for (int c0 = 0; c0 < n; c0 += W) {
    const int r = min(W, n - c0);
    if (Sc) {  // checkpoint the incoming carry: chunk c0 / W of this row
      const size_t c = row * nc + c0 / W;
      for (int i = tid; i < d * d; i += THREADS) Sc[c * d * d + i] = S[i];
      for (int i = tid; i < d * dv; i += THREADS) {
        Cc[c * d * dv + i] = C[i];
        Gc[c * d * dv + i] = G[i];
      }
      for (int i = tid; i < d; i += THREADS) {
        mc[c * d + i] = m[i];
        hc[c * d + i] = h[i];
      }
    }
    for (int i = tid; i < r * d; i += THREADS) {
      const int t = i / d, a = i - t * d;
      const size_t src = (size_t)(c0 + t) * d + a;
      Qs[t * dp + a] = to_f(q[src]);
      Ks[t * dp + a] = to_f(k[src]);
    }
    for (int i = tid; i < r * dv; i += THREADS) {
      const int t = i / dv, e = i - t * dv;
      Vs[t * dvp + e] = to_f(v[(size_t)(c0 + t) * dv + e]);
    }
    __syncthreads();
    const float rho = gp[r];

    // KQ = K Q^T and X = Q S0
    tile_mm<4, 4>(
        r, r, d, [=](int i, int a) { return Ks[i * dp + a]; },
        [=](int a, int j) { return Qs[j * dp + a]; },
        [=](int i, int j, float x) { KQ[i * wp + j] = x; });
    tile_mm<4, 8>(
        r, d, d, [=](int t, int a) { return Qs[t * dp + a]; },
        [=](int a, int c) { return S[a * d + c]; },
        [=](int t, int c, float x) { X[t * xp + c] = x; });
    __syncthreads();

    // P = ((Q K^T . Lg)(K Q^T . U)) . Lg            (T3 weights)
    tile_mm<4, 4>(
        r, r, r,
        [=](int t, int i) { return i <= t ? gp[t - i] * KQ[i * wp + t] : 0.f; },
        [=](int i, int j) { return i <= j ? KQ[i * wp + j] : 0.f; },
        [=](int t, int j, float x) {
          P[t * wp + j] = j <= t ? gp[t - j] * x : 0.f;
        });
    __syncthreads();
    //   + g^(t+1) (Q S0 Q^T . Lg)                   (T2 weights)
    tile_mm<4, 4>(
        r, r, d, [=](int t, int a) { return X[t * xp + a]; },
        [=](int a, int j) { return Qs[j * dp + a]; },
        [=](int t, int j, float x) {
          if (j <= t) P[t * wp + j] += gp[t + 1] * gp[t - j] * x;
        });
    if (lam != 0.f) {
      __syncthreads();
      //   + lam (Q Q^T . Lg)                          (ridge weights)
      tile_mm<4, 4>(
          r, r, d, [=](int t, int a) { return Qs[t * dp + a]; },
          [=](int a, int j) { return Qs[j * dp + a]; },
          [=](int t, int j, float x) {
            if (j <= t) P[t * wp + j] += lam * gp[t - j] * x;
          });
    }
    __syncthreads();

    if (normalize) {
      for (int t = tid; t < r; t += THREADS) {
        float xm = 0.f, qh = 0.f, qm = 0.f, ps = 0.f;
        for (int a = 0; a < d; ++a) {
          xm = fmaf(X[t * xp + a], m[a], xm);
          qh = fmaf(Qs[t * dp + a], h[a], qh);
          qm = fmaf(Qs[t * dp + a], m[a], qm);
        }
        for (int j = 0; j <= t; ++j) ps += P[t * wp + j];
        const float pt = gp[t + 1];
        vec[t] = pt * pt * (xm - qh) + ps + lam * pt * qm + eps;
      }
      __syncthreads();
    }

    // o = g^(2t) (Q S0 C0 - Q G0) + P V + lam g^t Q C0   (/ den)
    {
      const int kl = lam != 0.f ? d : 0;
      tile_mm<4, 8>(
          r, dv, 2 * d + r + kl,
          [=](int t, int kk) {
            const float pt = gp[t + 1];
            if (kk < d) return pt * pt * X[t * xp + kk];
            if (kk < 2 * d) return -pt * pt * Qs[t * dp + kk - d];
            if (kk < 2 * d + r) return P[t * wp + kk - 2 * d];
            return lam * pt * Qs[t * dp + kk - 2 * d - r];
          },
          [=](int kk, int e) {
            if (kk < d) return C[kk * dv + e];
            if (kk < 2 * d) return G[(kk - d) * dv + e];
            if (kk < 2 * d + r) return Vs[(kk - 2 * d) * dvp + e];
            return C[(kk - 2 * d - r) * dv + e];
          },
          [=](int t, int e, float x) {
            store(o + (size_t)(c0 + t) * dv + e, normalize ? x / vec[t] : x);
          });
    }
    __syncthreads();

    // Z = N (g^(r-1-j) V) + rho K C0 and zh = N g^(r-1-j) + rho K m0,
    // N[t][j] = k_t . q_j for j < t; then G1 = rho^2 G0 + Kg^T Z and
    // h1 = rho^2 h0 + Kg^T zh with Kg = g^(r-1-t) K.
    tile_mm<4, 8>(
        r, dv, r + d,
        [=](int t, int kk) {
          if (kk < r) return kk < t ? KQ[t * wp + kk] * gp[r - 1 - kk] : 0.f;
          return rho * Ks[t * dp + kk - r];
        },
        [=](int kk, int e) {
          return kk < r ? Vs[kk * dvp + e] : C[(kk - r) * dv + e];
        },
        [=](int t, int e, float x) { X[t * xp + e] = x; });
    for (int t = tid; t < r; t += THREADS) {
      float z = 0.f, km = 0.f;
      for (int j = 0; j < t; ++j) z = fmaf(KQ[t * wp + j], gp[r - 1 - j], z);
      for (int a = 0; a < d; ++a) km = fmaf(Ks[t * dp + a], m[a], km);
      vec[t] = z + rho * km;
    }
    __syncthreads();  // every read of the old carry is done

    tile_mm<8, 8>(
        d, dv, r, [=](int a, int t) { return gp[r - 1 - t] * Ks[t * dp + a]; },
        [=](int t, int e) { return X[t * xp + e]; },
        [=](int a, int e, float x) {
          G[a * dv + e] = rho * rho * G[a * dv + e] + x;
        });
    tile_mm<8, 8>(
        d, d, r, [=](int a, int t) { return gp[r - 1 - t] * Ks[t * dp + a]; },
        [=](int t, int c) { return Ks[t * dp + c]; },
        [=](int a, int c, float x) { S[a * d + c] = rho * S[a * d + c] + x; });
    tile_mm<8, 8>(
        d, dv, r, [=](int a, int t) { return gp[r - 1 - t] * Qs[t * dp + a]; },
        [=](int t, int e) { return Vs[t * dvp + e]; },
        [=](int a, int e, float x) { C[a * dv + e] = rho * C[a * dv + e] + x; });
    for (int a = tid; a < d; a += THREADS) {
      float hz = 0.f, mq = 0.f;
      for (int t = 0; t < r; ++t) {
        const float pr = gp[r - 1 - t];
        hz = fmaf(pr * Ks[t * dp + a], vec[t], hz);
        mq = fmaf(pr, Qs[t * dp + a], mq);
      }
      h[a] = rho * rho * h[a] + hz;
      m[a] = rho * m[a] + mq;
    }
    __syncthreads();  // the new carry and free tiles before the next chunk
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const float* gamma, void* o, float* S, float* C, float* m,
                   float* G, float* h, float* const* ck, int BH, int n,
                   int d, int dv, int has_init, int normalize, float eps,
                   float lam, size_t smem, cudaStream_t stream) {
  auto kern = hla2_chunk_fwd_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kern<<<BH, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), gamma, static_cast<T*>(o), S, C, m, G, h,
      ck[0], ck[1], ck[2], ck[3], ck[4], n, d, dv, has_init, normalize, eps,
      lam);
  return cudaGetLastError();
}

// Shared-memory bytes for head dims d, dv (165,892 at d = dv = 128); a
// size above the 227 KB limit makes cudaFuncSetAttribute fail the launch.
size_t smem_bytes(int d, int dv) {
  const int xp = (d > dv ? d : dv) + 1;
  const size_t floats =
      (size_t)W * (2 * (d + 1) + (dv + 1) + 2 * (W + 1) + xp) + (W + 1) + W;
  return floats * sizeof(float);
}

}  // namespace

extern "C" {

// q, k: (BH, n, d); v, o: (BH, n, dv) in bf16 (is_bf16) or fp32;
// gamma: (BH,) fp32 or null; S, C, m, G, h: fp32 carry, read as the
// initial state when has_init and overwritten with the final state;
// Sc, Cc, mc, Gc, hc: null, or fp32 (BH, ceil(n / 64), ...) buffers that
// receive the carry each chunk starts from.
// Returns the CUDA error of the launch (0 = launched).
int hla2_chunk_fwd(const void* q, const void* k, const void* v,
                   const float* gamma, void* o, float* S, float* C, float* m,
                   float* G, float* h, float* Sc, float* Cc, float* mc,
                   float* Gc, float* hc, int BH, int n, int d, int dv,
                   int is_bf16, int has_init, int normalize, float eps,
                   float lam, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = smem_bytes(d, dv);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* const ck[5] = {Sc, Cc, mc, Gc, hc};
  err = is_bf16 ? launch<__nv_bfloat16>(q, k, v, gamma, o, S, C, m, G, h, ck,
                                        BH, n, d, dv, has_init, normalize,
                                        eps, lam, smem, s)
                : launch<float>(q, k, v, gamma, o, S, C, m, G, h, ck, BH, n,
                                d, dv, has_init, normalize, eps, lam, smem,
                                s);
  return (int)err;
}

}  // extern "C"
