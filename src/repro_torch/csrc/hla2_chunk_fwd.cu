// Chunkwise masked HLA2 forward for Hopper (sm_90a): prompt prefill and the
// training forward.
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
// about 9 M FMAs per row against 96 KB of q/k/v/o traffic.  The floor
// prices each product at the card's fastest fp32-accurate rate for its
// operands (chip_smoke.chunk_fmas, _bound): 989 TFLOP/s for K Q^T (bf16 x
// bf16), 989/3 for an input times an fp32 term (three bf16 parts of the
// fp32 side), 495/3 for fp32 x fp32 (split TF32).  This kernel runs the
// second kind as two TF32 MMAs (495/2, mma_tile.cuh).
//
// Design: the TPU grid's sequential chunk axis becomes a loop inside a CTA,
// and a row is split over CTAs of CW = 32 value columns: grid (rows,
// ceil(dv / CW)), 128 CTAs for the train step's 32 rows, 64 for one
// 16-head prompt.  The forward is linear in the value columns: S, m, h and
// the normaliser depend on Q, K and the row's S0, m0, h0 only, and o, C, G
// of a column tile on that tile's columns of V, C0, G0 only.  So every CTA
// keeps a private fp32 copy of S, m, h and updates it identically, plus
// its columns of C and G, all in shared memory for the whole row: the
// carry is read once (the initial state) and written once (the final
// state), and only the checkpoints leave the chip per chunk.  Tile 0 alone
// writes S, m and h.  Cost: the row-wide products (K Q^T, A Bm, Q S0 Q^T,
// S's update) are repeated by every tile of a row, about 3.3 M of a tile's
// 5.1 M FMAs per chunk at d = 128: twice one CTA's work per row, on four
// times the SMs.  T1 goes through D0 = S0 C0 - G0 (d x CW) rather than
// Q S0 (w x d), and Q S0 Q^T through Q S0 in 64-column halves, which keeps
// the shared memory at 223,492 bytes with fp32 inputs (190,724 with bf16:
// Q and K are kept in their input type).  Every product is a warp-level
// mma.sync (mma_tile.cuh), which masks the edge of a ragged chunk.  The
// next chunk's q, k, v are prefetched into L2 while the current one is
// computed.  G and h read the old C and m through Z and zh,
// which are formed before any carry is updated.  A ragged tail is one
// shorter chunk of length r with its own decay powers (rho = gamma^r): no
// zero padding and no division by gamma^pad.  Products with the carry are
// skipped on a first chunk that has no initial state (its carry is zero).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <type_traits>

#include "mma_tile.cuh"

namespace {

using mma_tile::mma_mm;
using mma_tile::prefetch_l2;
using mma_tile::Tile;

constexpr int W = 64;   // tokens per chunk tile (outputs do not depend on it)
constexpr int CW = 32;  // value columns per CTA
constexpr int XH = 64;  // columns of Q S0 per pass of Q S0 Q^T
constexpr int THREADS = 256;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// One block per SM (its shared memory leaves no room for a second); the
// 1 lets ptxas use the registers that allows, where it otherwise capped
// this kernel at 64 or 128 and spilled.
template <typename T>
__global__ void __launch_bounds__(THREADS, 1)
    hla2_chunk_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v,
                          const float* __restrict__ gamma, const float* S_in,
                          const float* C_in, const float* m_in,
                          const float* G_in, const float* h_in,
                          T* __restrict__ o, float* S_out, float* C_out,
                          float* m_out, float* G_out, float* h_out, float* Sc,
                          float* Cc, float* mc, float* Gc, float* hc, int n,
                          int d, int dv, int normalize, float eps, float lam) {
  constexpr bool kIn = std::is_same<T, __nv_bfloat16>::value;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* fs = reinterpret_cast<float*>(smem_raw);
  const int xsz = W * XH > d * CW ? W * XH : d * CW;
  const Tile<float> S(fs, d);                 // d x d    carry S
  const Tile<float> C(S.p + d * d, CW);       // d x CW   this tile's C
  const Tile<float> G(C.p + d * CW, CW);      // d x CW   this tile's G
  float* m = G.p + d * CW;                    // d        carry m
  float* h = m + d;                           // d        carry h
  float* sm = h + d;                          // d        S0 m0 - h0
  const Tile<float> V(sm + d, CW);            // W x CW   the chunk's V tile
  const Tile<float> KQ(V.p + W * CW, W);      // W x W    KQ[i][j] = k_i . q_j
  const Tile<float> P(KQ.p + W * W, W);       // W x W    intra-chunk weights
  float* X = P.p + W * W;                     // Q S0 half, then D0, then Z
  float* gp = X + xsz;                        // W + 1    g^i
  float* vec = gp + (W + 1);                  // W        den + eps
  float* zh = vec + W;                        // W        zh
  T* tq = reinterpret_cast<T*>(zh + W);
  const Tile<T> Q(tq, d), K(tq + W * d, d);  // W x d each, input type
  const Tile<float> Xh(X, XH), D0(X, CW), Z(X, CW);

  const size_t row = blockIdx.x;
  const int tile = blockIdx.y, e0 = tile * CW;
  const int cw = min(CW, dv - e0);
  const bool lead = tile == 0;  // the one writer of S, m and h
  const bool has_init = S_in != nullptr;
  q += row * n * d;
  k += row * n * d;
  v += row * n * dv;
  o += row * n * dv;
  const int tid = threadIdx.x;
  const float logg = logf(gamma ? gamma[row] : 1.f);

  for (int i = tid; i < d * d; i += THREADS)
    S(i / d, i % d) = has_init ? S_in[row * d * d + i] : 0.f;
  for (int i = tid; i < d * cw; i += THREADS) {
    const int a = i / cw, e = i - a * cw;
    const size_t src = row * d * dv + (size_t)a * dv + e0 + e;
    C(a, e) = has_init ? C_in[src] : 0.f;
    G(a, e) = has_init ? G_in[src] : 0.f;
  }
  for (int i = tid; i < d; i += THREADS) {
    m[i] = has_init ? m_in[row * d + i] : 0.f;
    h[i] = has_init ? h_in[row * d + i] : 0.f;
  }
  for (int i = tid; i <= W; i += THREADS) gp[i] = expf(i * logg);
  __syncthreads();

  const int nc = (n + W - 1) / W;
  for (int c0 = 0; c0 < n; c0 += W) {
    const int r = min(W, n - c0);
    const bool carry = has_init || c0 > 0;  // else S, C, m, G, h are zero
    if (Sc) {  // checkpoint the incoming carry: chunk c0 / W of this row
      const size_t c = row * nc + c0 / W;
      if (lead) {
        for (int i = tid; i < d * d; i += THREADS)
          Sc[c * d * d + i] = S(i / d, i % d);
        for (int i = tid; i < d; i += THREADS) {
          mc[c * d + i] = m[i];
          hc[c * d + i] = h[i];
        }
      }
      for (int i = tid; i < d * cw; i += THREADS) {
        const int a = i / cw, e = i - a * cw;
        const size_t dst = c * d * dv + (size_t)a * dv + e0 + e;
        Cc[dst] = C(a, e);
        Gc[dst] = G(a, e);
      }
    }
    if (c0 + W < n) {  // the next chunk's rows, into L2 while this one runs
      const size_t rn = min(W, n - c0 - W);
      prefetch_l2(q + (size_t)(c0 + W) * d, rn * d * sizeof(T));
      prefetch_l2(k + (size_t)(c0 + W) * d, rn * d * sizeof(T));
      prefetch_l2(v + (size_t)(c0 + W) * dv, rn * dv * sizeof(T));
    }
    for (int i = tid; i < r * d; i += THREADS) {
      const int t = i / d, a = i - t * d;
      Q(t, a) = q[(size_t)(c0 + t) * d + a];
      K(t, a) = k[(size_t)(c0 + t) * d + a];
    }
    for (int i = tid; i < r * cw; i += THREADS) {
      const int t = i / cw, e = i - t * cw;
      V(t, e) = to_f(v[(size_t)(c0 + t) * dv + e0 + e]);
    }
    if (normalize && carry)
      for (int a = tid; a < d; a += THREADS) {
        float s = 0.f;
        for (int c = 0; c < d; ++c) s = fmaf(S(a, c), m[c], s);
        sm[a] = s - h[a];
      }
    __syncthreads();
    const float rho = gp[r];

    // KQ = K Q^T
    mma_mm<2, kIn, kIn>(
        r, r, d, [=](int i, int a) { return to_f(K(i, a)); },
        [=](int a, int j) { return to_f(Q(j, a)); },
        [=](int i, int j, float x) { KQ(i, j) = x; });
    __syncthreads();

    // P = ((Q K^T . Lg)(K Q^T . U)) . Lg                      (T3 weights)
    mma_mm<2, false, false>(
        r, r, r,
        [=](int t, int i) { return i <= t ? gp[t - i] * KQ(i, t) : 0.f; },
        [=](int i, int j) { return i <= j ? KQ(i, j) : 0.f; },
        [=](int t, int j, float x) { P(t, j) = j <= t ? gp[t - j] * x : 0.f; });
    //   + lam (Q Q^T . Lg)                                  (ridge weights)
    if (lam != 0.f)
      mma_mm<2, kIn, kIn>(
          r, r, d, [=](int t, int a) { return to_f(Q(t, a)); },
          [=](int a, int j) { return to_f(Q(j, a)); },
          [=](int t, int j, float x) {
            if (j <= t) P(t, j) += lam * gp[t - j] * x;
          });
    //   + g^(t+1) (Q S0 Q^T . Lg), Q S0 in XH-column passes   (T2 weights)
    if (carry)
      for (int b0 = 0; b0 < d; b0 += XH) {
        const int hw = min(XH, d - b0);
        __syncthreads();  // the previous pass's Xh is read
        mma_mm<2, kIn, false>(
            r, hw, d, [=](int t, int a) { return to_f(Q(t, a)); },
            [=](int a, int c) { return S(a, b0 + c); },
            [=](int t, int c, float x) { Xh(t, c) = x; });
        __syncthreads();
        mma_mm<2, false, kIn>(
            r, r, hw, [=](int t, int c) { return Xh(t, c); },
            [=](int c, int j) { return to_f(Q(j, b0 + c)); },
            [=](int t, int j, float x) {
              if (j <= t) P(t, j) += gp[t + 1] * gp[t - j] * x;
            });
      }
    __syncthreads();

    if (normalize)
      for (int t = tid; t < r; t += THREADS) {
        float qs = 0.f, qm = 0.f, ps = 0.f;
        if (carry)
          for (int a = 0; a < d; ++a) {
            const float qa = to_f(Q(t, a));
            qs = fmaf(qa, sm[a], qs);
            qm = fmaf(qa, m[a], qm);
          }
        for (int j = 0; j <= t; ++j) ps += P(t, j);
        const float pt = gp[t + 1];
        vec[t] = pt * pt * qs + ps + lam * pt * qm + eps;
      }
    // D0 = S0 C0 - G0
    if (carry)
      mma_mm<2, false, false>(
          d, cw, d, [=](int a, int b) { return S(a, b); },
          [=](int b, int e) { return C(b, e); },
          [=](int a, int e, float x) { D0(a, e) = x - G(a, e); });
    __syncthreads();

    // o = g^(2t) Q D0 + P V + lam g^t Q C0   (/ den)
    {
      const int kd = carry ? d : 0, kl = carry && lam != 0.f ? d : 0;
      mma_mm<2, false, false>(
          r, cw, kd + r + kl,
          [=](int t, int kk) {
            const float pt = gp[t + 1];
            if (kk < kd) return pt * pt * to_f(Q(t, kk));
            if (kk < kd + r) return P(t, kk - kd);
            return lam * pt * to_f(Q(t, kk - kd - r));
          },
          [=](int kk, int e) {
            if (kk < kd) return D0(kk, e);
            if (kk < kd + r) return V(kk - kd, e);
            return C(kk - kd - r, e);
          },
          [=](int t, int e, float x) {
            store(o + (size_t)(c0 + t) * dv + e0 + e,
                  normalize ? x / vec[t] : x);
          });
    }
    __syncthreads();  // D0 is read: Z takes its place

    // Z = N (g^(r-1-j) V) + rho K C0 and zh = N g^(r-1-j) + rho K m0,
    // N[t][j] = k_t . q_j for j < t; then G1 = rho^2 G0 + Kg^T Z and
    // h1 = rho^2 h0 + Kg^T zh with Kg = g^(r-1-t) K.
    {
      const int kz = carry ? d : 0;
      mma_mm<2, false, false>(
          r, cw, r + kz,
          [=](int t, int kk) {
            if (kk < r) return kk < t ? KQ(t, kk) * gp[r - 1 - kk] : 0.f;
            return rho * to_f(K(t, kk - r));
          },
          [=](int kk, int e) { return kk < r ? V(kk, e) : C(kk - r, e); },
          [=](int t, int e, float x) { Z(t, e) = x; });
    }
    for (int t = tid; t < r; t += THREADS) {
      float z = 0.f, km = 0.f;
      for (int j = 0; j < t; ++j) z = fmaf(KQ(t, j), gp[r - 1 - j], z);
      if (carry)
        for (int a = 0; a < d; ++a) km = fmaf(to_f(K(t, a)), m[a], km);
      zh[t] = z + rho * km;
    }
    __syncthreads();  // every read of the old carry is done

    mma_mm<2, false, false>(
        d, cw, r, [=](int a, int t) { return gp[r - 1 - t] * to_f(K(t, a)); },
        [=](int t, int e) { return Z(t, e); },
        [=](int a, int e, float x) { G(a, e) = rho * rho * G(a, e) + x; });
    mma_mm<4, false, kIn>(
        d, d, r, [=](int a, int t) { return gp[r - 1 - t] * to_f(K(t, a)); },
        [=](int t, int c) { return to_f(K(t, c)); },
        [=](int a, int c, float x) { S(a, c) = rho * S(a, c) + x; });
    mma_mm<2, false, kIn>(
        d, cw, r, [=](int a, int t) { return gp[r - 1 - t] * to_f(Q(t, a)); },
        [=](int t, int e) { return V(t, e); },
        [=](int a, int e, float x) { C(a, e) = rho * C(a, e) + x; });
    for (int a = tid; a < d; a += THREADS) {
      float hz = 0.f, mq = 0.f;
      for (int t = 0; t < r; ++t) {
        const float pr = gp[r - 1 - t];
        hz = fmaf(pr * to_f(K(t, a)), zh[t], hz);
        mq = fmaf(pr, to_f(Q(t, a)), mq);
      }
      h[a] = rho * rho * h[a] + hz;
      m[a] = rho * m[a] + mq;
    }
    __syncthreads();  // the new carry and free tiles before the next chunk
  }

  if (lead) {
    for (int i = tid; i < d * d; i += THREADS)
      S_out[row * d * d + i] = S(i / d, i % d);
    for (int i = tid; i < d; i += THREADS) {
      m_out[row * d + i] = m[i];
      h_out[row * d + i] = h[i];
    }
  }
  for (int i = tid; i < d * cw; i += THREADS) {
    const int a = i / cw, e = i - a * cw;
    const size_t dst = row * d * dv + (size_t)a * dv + e0 + e;
    C_out[dst] = C(a, e);
    G_out[dst] = G(a, e);
  }
}

// Shared-memory bytes for head dims d, dv and input type size tsize
// (223,492 at d = 128 with fp32 inputs, 190,724 with bf16): the carry
// S (d x d) and this tile's C, G (d x CW), m, h, S0 m0 - h0 (d each), V
// (W x CW), K Q^T and P (W x W), one (W x 64 | d x CW) scratch, three
// vectors of W, and Q, K (W x d) in the input type.  A size above the
// 227 KB limit makes cudaFuncSetAttribute fail the launch.
size_t smem_bytes(int d, size_t tsize) {
  const size_t xsz = W * XH > d * CW ? W * XH : (size_t)d * CW;
  const size_t floats = (size_t)d * d + 2 * (size_t)d * CW + 3 * (size_t)d +
                        W * CW + 2 * W * W + xsz + (W + 1) + 2 * W;
  return floats * sizeof(float) + 2 * (size_t)W * d * tsize;
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const float* gamma, const float* const* init, void* o,
                   float* const* out, float* const* ck, int BH, int n, int d,
                   int dv, int normalize, float eps, float lam,
                   cudaStream_t stream) {
  auto kern = hla2_chunk_fwd_kernel<T>;
  const size_t smem = smem_bytes(d, sizeof(T));
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kern<<<dim3(BH, (dv + CW - 1) / CW), THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), gamma, init[0], init[1], init[2], init[3],
      init[4], static_cast<T*>(o), out[0], out[1], out[2], out[3], out[4],
      ck[0], ck[1], ck[2], ck[3], ck[4], n, d, dv, normalize, eps, lam);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// q, k: (BH, n, d); v, o: (BH, n, dv) in bf16 (is_bf16) or fp32; gamma:
// (BH,) fp32 or null; S0, C0, m0, G0, h0: the fp32 initial carry (read
// only), or all null for a zero carry; S, C, m, G, h: fp32 outputs that
// receive the final carry; Sc, Cc, mc, Gc, hc: null, or fp32 (BH,
// ceil(n / 64), ...) buffers that receive the carry each chunk starts from.
// Returns the CUDA error of the launch (0 = launched).
int hla2_chunk_fwd(const void* q, const void* k, const void* v,
                   const float* gamma, const float* S0, const float* C0,
                   const float* m0, const float* G0, const float* h0, void* o,
                   float* S, float* C, float* m, float* G, float* h,
                   float* Sc, float* Cc, float* mc, float* Gc, float* hc,
                   int BH, int n, int d, int dv, int is_bf16, int normalize,
                   float eps, float lam, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* const init[5] = {S0, C0, m0, G0, h0};
  float* const out[5] = {S, C, m, G, h};
  float* const ck[5] = {Sc, Cc, mc, Gc, hc};
  err = is_bf16 ? launch<__nv_bfloat16>(q, k, v, gamma, init, o, out, ck, BH,
                                        n, d, dv, normalize, eps, lam, s)
                : launch<float>(q, k, v, gamma, init, o, out, ck, BH, n, d,
                                dv, normalize, eps, lam, s);
  return (int)err;
}

// Dynamic shared-memory bytes the kernel asks for (for the tests' record).
long hla2_chunk_fwd_smem_bytes(int d, int is_bf16) {
  return (long)smem_bytes(d, is_bf16 ? 2 : 4);
}

}  // extern "C"
