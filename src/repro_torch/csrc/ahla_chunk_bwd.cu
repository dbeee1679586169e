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
//   dR  = A^T dOb + (r . K) dE1            dA = dOb R^T + dR Vb^T
//   dQ  = (dA . Lg) K + p . (dOb E0^T + dR P0^T)
//   dK  = (dA . Lg)^T Q + r . (Vb dP1^T + R dE1^T)
//   dV  = A^T dR + (r . K) dP1
//   dP0 = rho dP1 + Q^T (p . dR),  dE0 = rho dE1 + Q^T (p . dOb)
//
// Bound on this card: operations.  A 64-token chunk at d = dv = 128 needs
// about 12.6 M FMAs per row (ten d x dv x w products, seven w x w x d or
// dv triangles) against 0.25 MB of q/k/v/do/dq/dk/dv and checkpoint
// traffic.  The products run as fp32 FMAs on the CUDA cores (67 TFLOP/s),
// but the floor prices each at the card's fastest fp32-accurate rate for
// its operands, on the tensor cores (chip_smoke.ahla_chunk_bwd_fmas,
// _bound).
//
// Design: the forward's split of a row over CTAs of CW = 32 columns of
// [V | 1] carries over.  Every term above but dQ, dK and dgamma is
// column-local: each CTA recomputes its columns of R from the checkpoint,
// keeps its columns of the carry cotangents dP, dE in shared memory for the
// whole reverse walk, and writes its columns of dv itself.  dA, and with
// it dQ, dK and dgamma, is a sum over the column tiles, linear in each
// tile's share: each CTA writes its partial dQ, dK of every chunk to a
// per-tile fp32 buffer in device memory and its partial dgamma to a
// per-tile slot, and a second small kernel in this file sums the tiles in
// a fixed order into dq, dk and dgamma (deterministic, unlike atomics; one
// CTA per row instead would leave 100 of 132 SMs idle at batch 2).  Grid
// (rows, ceil(dvx / 32)): 128 CTAs for the train step's 32 rows.
// Unnormalised, every cotangent of the den column (of R, P, E) stays zero
// through the walk, so dvx = dv and no CTA holds that column.  Under
// normalize, dvx = dv + 1 and the den cotangent -rowsum(do . O) / z^2
// needs every value column of O: a first kernel here recomputes O per
// (row, chunk) from the checkpoint and writes 1/z and that cotangent per
// token.  Shared memory (201 KB at d = 128): the chunk's Q, K, the raw
// Q K^T and dA . Lg (w x w), this CTA's columns of Vb, dOb, R, dR, of the
// checkpointed P0, E0 and of dP, dE.  Phases are separated by barriers, and
// each output element of a product belongs to one thread.  Decay powers
// come from a table g^0..g^64; a derivative of g^k is formed only for
// k >= 1 (never g^-1).  A ragged tail is one shorter chunk with its own
// decay powers, as in the forward.  Known weaknesses: fp32 SIMT products,
// no tensor cores; Q K^T and the w x w x d products dQ, dK are recomputed
// by every column CTA of a row.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int W = 64;   // tokens per chunk: the forward's partition
constexpr int CW = 32;  // columns of [V | 1] per CTA
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
// tc + j*CG, so the lanes of a warp read consecutive columns of b.  Two
// calls with the same M, N, TM, TN give each element to the same thread.
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

__host__ __device__ int n_tiles(int dv, int normalize) {
  return (dv + normalize + CW - 1) / CW;
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
  extern __shared__ float smem[];
  const int dp = d + 1, wp = W + 1, vw = dv + 1, vp = dv + 2;
  float* Qs = smem;         // W x dp
  float* Ks = Qs + W * dp;  // W x dp
  float* A = Ks + W * dp;   // W x wp   (Q K^T) . Lg
  float* Vb = A + W * wp;   // W x vp   [V | 1], then [O | den]
  float* Rs = Vb + W * vp;  // W x vp   [R | s]
  float* gp = Rs + W * vp;  // W + 1    g^i

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
    Qs[t * dp + a] = to_f(q[(size_t)(c0 + t) * d + a]);
    Ks[t * dp + a] = to_f(k[(size_t)(c0 + t) * d + a]);
  }
  for (int i = tid; i < L * vw; i += THREADS) {
    const int t = i / vw, e = i - t * vw;
    Vb[t * vp + e] = e < dv ? to_f(v[(size_t)(c0 + t) * dv + e]) : 1.f;
  }
  __syncthreads();
  tile_mm<4, 4>(
      L, L, d, [=](int t, int a) { return Qs[t * dp + a]; },
      [=](int a, int j) { return Ks[j * dp + a]; },
      [=](int t, int j, float x) {
        A[t * wp + j] = j <= t ? gp[t - j] * x : 0.f;
      });
  __syncthreads();
  auto qa = [=](int t, int kk) {
    return kk < d ? gp[t + 1] * Qs[t * dp + kk] : A[t * wp + kk - d];
  };
  tile_mm<4, 8>(  // [R | s] = p . (Q [P0 | m0]) + A [V | 1]
      L, vw, d + L, qa,
      [=](int kk, int e) {
        return kk < d ? P0[kk * vw + e] : Vb[(kk - d) * vp + e];
      },
      [=](int t, int e, float x) { Rs[t * vp + e] = x; });
  __syncthreads();
  tile_mm<4, 8>(  // [O | den] = p . (Q [E0 | n0]) + A [R | s]
      L, vw, d + L, qa,
      [=](int kk, int e) {
        return kk < d ? E0[kk * vw + e] : Rs[(kk - d) * vp + e];
      },
      [=](int t, int e, float x) { Vb[t * vp + e] = x; });
  __syncthreads();
  for (int t = tid; t < L; t += THREADS) {
    const float z = Vb[t * vp + dv] + eps;
    float s = 0.f;
    for (int e = 0; e < dv; ++e)
      s = fmaf(to_f(dout[(size_t)(c0 + t) * dv + e]), Vb[t * vp + e], s);
    zd[2 * (c0 + t)] = 1.f / z;
    zd[2 * (c0 + t) + 1] = -s / (z * z);
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
    ahla_chunk_bwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v,
                          const float* __restrict__ gamma,
                          const T* __restrict__ dout, const float* Pc,
                          const float* Ec, const float* zd, float* dqp,
                          float* dkp, T* dvo, float* dgp, int n, int d,
                          int dv, int normalize) {
  extern __shared__ float smem[];
  const int dp = d + 1, wp = W + 1, cp = CW + 1, vw = dv + 1;
  float* Qs = smem;          // W x dp
  float* Ks = Qs + W * dp;   // W x dp
  float* QK = Ks + W * dp;   // W x wp   raw q_t . k_j for j <= t, else 0
  float* dA = QK + W * wp;   // W x wp   dA . Lg = d(Q K^T), j <= t, else 0
  float* Vb = dA + W * wp;   // W x cp   this CTA's columns of [V | 1]
  float* dO = Vb + W * cp;   // W x cp   their cotangent dOb
  float* Rs = dO + W * cp;   // W x cp   R
  float* dR = Rs + W * cp;   // W x cp   dR
  float* P0 = dR + W * cp;   // d x cp   the checkpointed [P | m] columns
  float* E0 = P0 + d * cp;   // d x cp   the checkpointed [E | n] columns
  float* dP = E0 + d * cp;   // d x cp   carry cotangents, whole walk
  float* dE = dP + d * cp;   // d x cp
  float* gp = dE + d * cp;   // W + 1    g^i
  float* red = gp + W + 1;   // THREADS / 32 partial dgamma sums

  const size_t row = blockIdx.x;
  const int tile = blockIdx.y, T_ = gridDim.y;
  const int e0 = tile * CW, ew = min(CW, dv + normalize - e0);
  const int nc = (n + W - 1) / W;
  q += row * n * d;
  k += row * n * d;
  v += row * n * dv;
  dout += row * n * dv;
  dvo += row * n * dv;
  Pc += row * nc * d * vw;
  Ec += row * nc * d * vw;
  if (zd) zd += 2 * row * n;
  dqp += (row * T_ + tile) * n * d;
  dkp += (row * T_ + tile) * n * d;
  const int tid = threadIdx.x;
  const float logg = logf(gamma ? gamma[row] : 1.f);

  for (int i = tid; i < d * cp; i += THREADS) dP[i] = dE[i] = 0.f;
  for (int i = tid; i <= W; i += THREADS) gp[i] = expf(i * logg);
  float dg = 0.f;  // this thread's share of this tile's dgamma
  __syncthreads();

  for (int c = nc - 1; c >= 0; --c) {
    const int c0 = c * W, L = min(W, n - c0);
    const float rho = gp[L];
    auto pr = [=](int t) { return gp[L - 1 - t]; };  // r[t] = g^(L-1-t)
    // A[t][j] and A^T[t][j] from the raw Q K^T
    auto At = [=](int t, int j) {
      return j >= t ? gp[j - t] * QK[j * wp + t] : 0.f;
    };
    for (int i = tid; i < L * d; i += THREADS) {
      const int t = i / d, a = i - t * d;
      const size_t src = (size_t)(c0 + t) * d + a;
      Qs[t * dp + a] = to_f(q[src]);
      Ks[t * dp + a] = to_f(k[src]);
    }
    for (int i = tid; i < L * ew; i += THREADS) {
      const int t = i / ew, e = i - t * ew, col = e0 + e;
      const size_t src = (size_t)(c0 + t) * dv + col;
      Vb[t * cp + e] = col < dv ? to_f(v[src]) : 1.f;
      if (col == dv)  // the den column (normalize only)
        dO[t * cp + e] = zd[2 * (c0 + t) + 1];
      else
        dO[t * cp + e] = zd ? to_f(dout[src]) * zd[2 * (c0 + t)]
                            : to_f(dout[src]);
    }
    const float* Pck = Pc + (size_t)c * d * vw;
    const float* Eck = Ec + (size_t)c * d * vw;
    for (int i = tid; i < d * ew; i += THREADS) {
      const int a = i / ew, e = i - a * ew;
      P0[a * cp + e] = Pck[a * vw + e0 + e];
      E0[a * cp + e] = Eck[a * vw + e0 + e];
    }
    __syncthreads();

    tile_mm<4, 4>(  // QK = Q K^T, causal triangle
        L, L, d, [=](int t, int a) { return Qs[t * dp + a]; },
        [=](int a, int j) { return Ks[j * dp + a]; },
        [=](int t, int j, float x) { QK[t * wp + j] = j <= t ? x : 0.f; });
    // d rho: <dP1, P0> + <dE1, E0> over this CTA's columns
    float drho = 0.f;
    for (int i = tid; i < d * ew; i += THREADS) {
      const int a = i / ew, e = i - a * ew;
      drho = fmaf(dP[a * cp + e], P0[a * cp + e], drho);
      drho = fmaf(dE[a * cp + e], E0[a * cp + e], drho);
    }
    dg += drho * L * gp[L - 1];
    __syncthreads();

    tile_mm<4, 2>(  // dR = A^T dOb + (r . K) dE1
        L, ew, L + d,
        [=](int t, int kk) {
          return kk < L ? At(t, kk) : pr(t) * Ks[t * dp + kk - L];
        },
        [=](int kk, int e) {
          return kk < L ? dO[kk * cp + e] : dE[(kk - L) * cp + e];
        },
        [=](int t, int e, float x) { dR[t * cp + e] = x; });
    tile_mm<4, 2>(  // d/dp[t] of p . (Q E0): dOb . (Q E0)
        L, ew, d, [=](int t, int a) { return Qs[t * dp + a]; },
        [=](int a, int e) { return E0[a * cp + e]; },
        [&](int t, int e, float x) {
          dg += dO[t * cp + e] * x * (t + 1) * gp[t];
        });
    __syncthreads();

    tile_mm<4, 2>(  // R = p . (Q P0), and d/dp[t] of it: dR . (Q P0)
        L, ew, d, [=](int t, int a) { return Qs[t * dp + a]; },
        [=](int a, int e) { return P0[a * cp + e]; },
        [&](int t, int e, float x) {
          Rs[t * cp + e] = gp[t + 1] * x;
          dg += dR[t * cp + e] * x * (t + 1) * gp[t];
        });
    tile_mm<4, 2>(  // R += A Vb (same thread per element as above)
        L, ew, L,
        [=](int t, int j) {
          return j <= t ? gp[t - j] * QK[t * wp + j] : 0.f;
        },
        [=](int j, int e) { return Vb[j * cp + e]; },
        [=](int t, int e, float x) { Rs[t * cp + e] += x; });
    __syncthreads();

    tile_mm<4, 4>(  // dA = dOb R^T + dR Vb^T; store dA . Lg, and its dLg
        L, L, 2 * ew,
        [=](int t, int kk) {
          return kk < ew ? dO[t * cp + kk] : dR[t * cp + kk - ew];
        },
        [=](int kk, int j) {
          return kk < ew ? Rs[j * cp + kk] : Vb[j * cp + kk - ew];
        },
        [&](int t, int j, float x) {
          dA[t * wp + j] = j <= t ? gp[t - j] * x : 0.f;
          if (j < t) dg += x * QK[t * wp + j] * (t - j) * gp[t - j - 1];
        });
    tile_mm<4, 2>(  // dV = A^T dR + (r . K) dP1, this CTA's value columns
        L, ew, L + d,
        [=](int t, int kk) {
          return kk < L ? At(t, kk) : pr(t) * Ks[t * dp + kk - L];
        },
        [=](int kk, int e) {
          return kk < L ? dR[kk * cp + e] : dP[(kk - L) * cp + e];
        },
        [=](int t, int e, float x) {
          if (e0 + e < dv) store(dvo + (size_t)(c0 + t) * dv + e0 + e, x);
        });
    __syncthreads();

    float* dqc = dqp + (size_t)c0 * d;
    float* dkc = dkp + (size_t)c0 * d;
    tile_mm<4, 8>(  // partial dQ = (dA . Lg) K + p . (dOb E0^T + dR P0^T)
        L, d, L + 2 * ew,
        [=](int t, int kk) {
          if (kk < L) return dA[t * wp + kk];
          kk -= L;
          return gp[t + 1] *
                 (kk < ew ? dO[t * cp + kk] : dR[t * cp + kk - ew]);
        },
        [=](int kk, int a) {
          if (kk < L) return Ks[kk * dp + a];
          kk -= L;
          return kk < ew ? E0[a * cp + kk] : P0[a * cp + kk - ew];
        },
        [=](int t, int a, float x) { dqc[t * d + a] = x; });
    tile_mm<4, 8>(  // partial dK = r . (Vb dP1^T + R dE1^T), and d/dr[t]
        L, d, 2 * ew,
        [=](int t, int kk) {
          return kk < ew ? Vb[t * cp + kk] : Rs[t * cp + kk - ew];
        },
        [=](int kk, int a) {
          return kk < ew ? dP[a * cp + kk] : dE[a * cp + kk - ew];
        },
        [&](int t, int a, float x) {
          dkc[t * d + a] = pr(t) * x;
          if (t < L - 1)
            dg += Ks[t * dp + a] * x * (L - 1 - t) * gp[L - 2 - t];
        });
    tile_mm<4, 8>(  // partial dK += (dA . Lg)^T Q (same thread per element)
        L, d, L, [=](int t, int j) { return dA[j * wp + t]; },
        [=](int j, int a) { return Qs[j * dp + a]; },
        [=](int t, int a, float x) { dkc[t * d + a] += x; });
    __syncthreads();  // every read of dP1, dE1 is done

    tile_mm<4, 4>(  // dP0 = rho dP1 + Q^T (p . dR)
        d, ew, L, [=](int a, int t) { return gp[t + 1] * Qs[t * dp + a]; },
        [=](int t, int e) { return dR[t * cp + e]; },
        [=](int a, int e, float x) {
          dP[a * cp + e] = rho * dP[a * cp + e] + x;
        });
    tile_mm<4, 4>(  // dE0 = rho dE1 + Q^T (p . dOb)
        d, ew, L, [=](int a, int t) { return gp[t + 1] * Qs[t * dp + a]; },
        [=](int t, int e) { return dO[t * cp + e]; },
        [=](int a, int e, float x) {
          dE[a * cp + e] = rho * dE[a * cp + e] + x;
        });
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

// Shared-memory bytes (200,996 at d = 128); a size above the 227 KB limit
// makes cudaFuncSetAttribute fail the launch.
size_t smem_bytes(int d) {
  const size_t floats = (size_t)2 * W * (d + 1) + 2 * W * (W + 1) +
                        4 * W * (CW + 1) + 4 * (size_t)d * (CW + 1) +
                        (W + 1) + THREADS / 32;
  return floats * sizeof(float);
}

size_t den_smem_bytes(int d, int dv) {
  const size_t floats = (size_t)2 * W * (d + 1) + W * (W + 1) +
                        2 * (size_t)W * (dv + 2) + (W + 1);
  return floats * sizeof(float);
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
  cudaError_t err;
  if (normalize) {
    auto den = ahla_bwd_den_kernel<T>;
    const size_t smem = den_smem_bytes(d, dv);
    err = cudaFuncSetAttribute(
        den, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    den<<<dim3(BH, nc), THREADS, smem, stream>>>(qt, kt, vt, gamma, dt, Pc,
                                                 Ec, zd, n, d, dv, eps);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  auto kern = ahla_chunk_bwd_kernel<T>;
  const size_t smem = smem_bytes(d);
  err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kern<<<dim3(BH, T_), THREADS, smem, stream>>>(
      qt, kt, vt, gamma, dt, Pc, Ec, zd, dqp, dkp, static_cast<T*>(dv_out),
      dgp, n, d, dv, normalize);
  err = cudaGetLastError();
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
