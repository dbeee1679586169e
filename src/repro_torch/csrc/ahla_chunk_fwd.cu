// Chunkwise AHLA forward for Hopper (sm_90a): prompt prefill.
//
// Replaces: src/repro/kernels/ahla_chunk.py, ahla_chunk_pallas (body
// _ahla_chunk_kernel), with initial_state and save_chunk_states.
//
// Computes, per (batch*head) row, AHLA = LinAttn(q, k, LinAttn(q, k, v))
// chunk by chunk with the carries [P | m] and [E | n], optional initial
// carry, per-row decay gamma and ratio normalisation.  Per chunk of w
// tokens, with A = (Q K^T) . Lg, p[t] = g^(t+1), r[t] = g^(w-1-t), rho = g^w
// (src/repro_torch/kernels/chunk_math.py, ahla_chunk_math):
//   R  = p . (Q P0) + A V,      s = p . (Q m0) + A 1     (first-order [r|s])
//   O  = p . (Q E0) + A R,    den = p . (Q n0) + A s     (o = O or O / den)
//   P1 = rho P0 + (r . K)^T V,  m1 = rho m0 + (r . K)^T 1
//   E1 = rho E0 + (r . K)^T R,  n1 = rho n0 + (r . K)^T s
// (E1 in this form equals the reference's rho E0 + Kg^T (A V) + rho K^T Q P0,
// since r[t] p[t] = rho; it needs no d x d product.)
//
// Bound on this card: operations.  A 64-token chunk at d = dv = 128 does
// about 5.0 M FMAs per row against 64 KB of q/k/v/o traffic.  The products
// run as fp32 FMAs on the CUDA cores (67 TFLOP/s), but the floor prices
// each at the card's fastest fp32-accurate rate for its operands, on the
// tensor cores (chip_smoke.ahla_chunk_fmas, _bound).
//
// Design: every value column of AHLA is independent of the others (each
// column of P, E, R and O reads only its own column of V), except the den
// column (the ones column of [V | 1]), which is a vector.  So a row is split
// over CTAs of CW = 32 value columns each: grid (rows, dv / 32), 64 CTAs for
// one hla-1b prompt instead of 16.  Each CTA keeps its columns of the carry P
// and E, and a private copy of the vectors m and n, in shared memory for the
// whole prompt: the carry never goes back to device memory between chunks,
// and no CTA reads what another writes (the initial carry is a separate
// input, the final carry is written once at the end; the first column tile
// writes m and n).  For training each CTA also writes its columns of every
// chunk's incoming carry to the checkpoints [P | m], [E | n] (BH, nc, d,
// dv + 1: the reference's layout); the first column tile writes their den
// column (m, n).  Q K^T and the vectors s, den, m, n are computed by every
// CTA of a row: r x r x d and r x d per chunk, small beside the r x 32 x
// (d + r) products.  Every product is a register-tiled SIMT loop (tile_mm).
// A ragged tail is one shorter chunk of length r with its own decay powers
// (rho = gamma^r): no zero padding and no division by gamma^pad.  Known
// weaknesses: fp32 SIMT products, no tensor cores; Q K^T is computed four
// times per row.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int W = 64;   // tokens per chunk tile (outputs do not depend on it)
constexpr int CW = 32;  // value columns per CTA
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
    ahla_chunk_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v,
                          const float* __restrict__ gamma,
                          const float* __restrict__ P0,
                          const float* __restrict__ m0,
                          const float* __restrict__ E0,
                          const float* __restrict__ n0, T* __restrict__ o,
                          float* __restrict__ P, float* __restrict__ m,
                          float* __restrict__ E, float* __restrict__ nv,
                          float* __restrict__ Pc, float* __restrict__ Ec,
                          int n, int d, int dv, int normalize, float eps) {
  extern __shared__ float smem[];
  const int dp = d + 1, wp = W + 1, cp = CW + 1;
  float* Qs = smem;         // W x dp
  float* Ks = Qs + W * dp;  // W x dp
  float* A = Ks + W * dp;   // W x wp   (Q K^T) . Lg
  float* Vs = A + W * wp;   // W x cp   this CTA's columns of V
  float* Rs = Vs + W * cp;  // W x cp   first-order outputs r, same columns
  float* Ps = Rs + W * cp;  // d x cp   carry P, same columns
  float* Es = Ps + d * cp;  // d x cp   carry E, same columns
  float* ms = Es + d * cp;  // d        carry m (private copy)
  float* ns = ms + d;       // d        carry n (private copy)
  float* sv = ns + d;       // W        s = first-order den column
  float* den = sv + W;      // W        O's den column + eps
  float* gp = den + W;      // W + 1    g^i

  const size_t row = blockIdx.x;
  const int e0 = blockIdx.y * CW;
  const int ew = min(CW, dv - e0);
  q += row * n * d;
  k += row * n * d;
  v += row * n * dv;
  o += row * n * dv;
  const size_t so = row * d * dv, sm = row * d;
  const int tid = threadIdx.x;
  const float logg = logf(gamma ? gamma[row] : 1.f);
  const bool has_init = P0 != nullptr;

  for (int i = tid; i < d * ew; i += THREADS) {
    const int a = i / ew, e = i - a * ew;
    const size_t src = so + (size_t)a * dv + e0 + e;
    Ps[a * cp + e] = has_init ? P0[src] : 0.f;
    Es[a * cp + e] = has_init ? E0[src] : 0.f;
  }
  for (int a = tid; a < d; a += THREADS) {
    ms[a] = has_init ? m0[sm + a] : 0.f;
    ns[a] = has_init ? n0[sm + a] : 0.f;
  }
  for (int i = tid; i <= W; i += THREADS) gp[i] = expf(i * logg);
  __syncthreads();

  for (int c0 = 0; c0 < n; c0 += W) {
    const int r = min(W, n - c0);
    // a zero carry (first chunk, no initial state): skip its products
    const int k0 = (c0 == 0 && !has_init) ? d : 0;
    for (int i = tid; i < r * d; i += THREADS) {
      const int t = i / d, a = i - t * d;
      const size_t src = (size_t)(c0 + t) * d + a;
      Qs[t * dp + a] = to_f(q[src]);
      Ks[t * dp + a] = to_f(k[src]);
    }
    for (int i = tid; i < r * ew; i += THREADS) {
      const int t = i / ew, e = i - t * ew;
      Vs[t * cp + e] = to_f(v[(size_t)(c0 + t) * dv + e0 + e]);
    }
    if (Pc) {  // checkpoint the chunk's incoming carry: this CTA's columns
      const size_t ck = (row * ((n + W - 1) / W) + c0 / W) * d * (dv + 1);
      for (int i = tid; i < d * ew; i += THREADS) {
        const int a = i / ew, e = i - a * ew;
        Pc[ck + (size_t)a * (dv + 1) + e0 + e] = Ps[a * cp + e];
        Ec[ck + (size_t)a * (dv + 1) + e0 + e] = Es[a * cp + e];
      }
      if (blockIdx.y == 0)
        for (int a = tid; a < d; a += THREADS) {
          Pc[ck + (size_t)a * (dv + 1) + dv] = ms[a];
          Ec[ck + (size_t)a * (dv + 1) + dv] = ns[a];
        }
    }
    __syncthreads();
    const float rho = gp[r];

    // A = (Q K^T) . Lg
    tile_mm<4, 4>(
        r, r, d, [=](int t, int a) { return Qs[t * dp + a]; },
        [=](int a, int j) { return Ks[j * dp + a]; },
        [=](int t, int j, float x) {
          A[t * wp + j] = j <= t ? gp[t - j] * x : 0.f;
        });
    __syncthreads();

    // [Q | A] against [P0 ; X]: g^(t+1) Q P0 + A X (the carry rows from k0)
    auto qa = [=](int t, int kk) {
      kk += k0;
      return kk < d ? gp[t + 1] * Qs[t * dp + kk] : A[t * wp + kk - d];
    };
    // R = g^(t+1) (Q P0) + A V,  s = g^(t+1) (Q m0) + A 1
    tile_mm<4, 2>(
        r, ew, d + r - k0, qa,
        [=](int kk, int e) {
          kk += k0;
          return kk < d ? Ps[kk * cp + e] : Vs[(kk - d) * cp + e];
        },
        [=](int t, int e, float x) { Rs[t * cp + e] = x; });
    for (int t = tid; t < r; t += THREADS) {
      float qm = 0.f, as = 0.f;
      for (int a = 0; a < d - k0; ++a) qm = fmaf(Qs[t * dp + a], ms[a], qm);
      for (int j = 0; j <= t; ++j) as += A[t * wp + j];
      sv[t] = gp[t + 1] * qm + as;
    }
    __syncthreads();

    if (normalize) {  // den = g^(t+1) (Q n0) + A s
      for (int t = tid; t < r; t += THREADS) {
        float qn = 0.f, as = 0.f;
        for (int a = 0; a < d - k0; ++a) qn = fmaf(Qs[t * dp + a], ns[a], qn);
        for (int j = 0; j <= t; ++j) as = fmaf(A[t * wp + j], sv[j], as);
        den[t] = gp[t + 1] * qn + as + eps;
      }
      __syncthreads();
    }

    // o = g^(t+1) (Q E0) + A R   (/ den)
    tile_mm<4, 2>(
        r, ew, d + r - k0, qa,
        [=](int kk, int e) {
          kk += k0;
          return kk < d ? Es[kk * cp + e] : Rs[(kk - d) * cp + e];
        },
        [=](int t, int e, float x) {
          store(o + (size_t)(c0 + t) * dv + e0 + e,
                normalize ? x / den[t] : x);
        });
    __syncthreads();  // every read of the old carry is done

    // P1 = rho P0 + Kg^T V, E1 = rho E0 + Kg^T R, m1, n1 likewise with 1
    // and s, Kg = g^(r-1-t) K: each element rewritten by the thread that
    // reads its old value
    auto kg = [=](int a, int t) { return gp[r - 1 - t] * Ks[t * dp + a]; };
    tile_mm<4, 4>(
        d, ew, r, kg, [=](int t, int e) { return Vs[t * cp + e]; },
        [=](int a, int e, float x) {
          Ps[a * cp + e] = rho * Ps[a * cp + e] + x;
        });
    tile_mm<4, 4>(
        d, ew, r, kg, [=](int t, int e) { return Rs[t * cp + e]; },
        [=](int a, int e, float x) {
          Es[a * cp + e] = rho * Es[a * cp + e] + x;
        });
    for (int a = tid; a < d; a += THREADS) {
      float km = 0.f, kn = 0.f;
      for (int t = 0; t < r; ++t) {
        const float x = kg(a, t);
        km += x;
        kn = fmaf(x, sv[t], kn);
      }
      ms[a] = rho * ms[a] + km;
      ns[a] = rho * ns[a] + kn;
    }
    __syncthreads();  // the new carry and free tiles before the next chunk
  }

  for (int i = tid; i < d * ew; i += THREADS) {
    const int a = i / ew, e = i - a * ew;
    const size_t dst = so + (size_t)a * dv + e0 + e;
    P[dst] = Ps[a * cp + e];
    E[dst] = Es[a * cp + e];
  }
  if (blockIdx.y == 0) {
    for (int a = tid; a < d; a += THREADS) {
      m[sm + a] = ms[a];
      nv[sm + a] = ns[a];
    }
  }
}

// Shared-memory bytes for head dims d, dv (135,172 at d = 128); a size above
// the 227 KB limit makes cudaFuncSetAttribute fail the launch.
size_t smem_bytes(int d) {
  const size_t floats = (size_t)2 * W * (d + 1) + W * (W + 1) +
                        2 * W * (CW + 1) + 2 * (size_t)d * (CW + 1) + 2 * d +
                        2 * W + W + 1;
  return floats * sizeof(float);
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const float* gamma, const float* const* init, void* o,
                   float* const* out, float* Pc, float* Ec, int BH, int n,
                   int d, int dv, int normalize, float eps,
                   cudaStream_t stream) {
  auto kern = ahla_chunk_fwd_kernel<T>;
  const size_t smem = smem_bytes(d);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(BH, (dv + CW - 1) / CW);
  kern<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), gamma, init[0], init[1], init[2], init[3],
      static_cast<T*>(o), out[0], out[1], out[2], out[3], Pc, Ec, n, d, dv,
      normalize, eps);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// q, k: (BH, n, d); v, o: (BH, n, dv) in bf16 (is_bf16) or fp32;
// gamma: (BH,) fp32 or null; P0, m0, E0, n0: the fp32 initial carry
// ((BH, d, dv), (BH, d), (BH, d, dv), (BH, d)), all four null for a zero
// carry, only read; P, m, E, n: fp32 buffers of the same shapes that
// receive the final carry; Pc, Ec: fp32 (BH, ceil(n / 64), d, dv + 1)
// buffers that receive each chunk's incoming [P | m] and [E | n], or both
// null.  Returns the CUDA error of the launch (0 = launched).
int ahla_chunk_fwd(const void* q, const void* k, const void* v,
                   const float* gamma, const float* P0, const float* m0,
                   const float* E0, const float* n0, void* o, float* P,
                   float* m, float* E, float* n_out, float* Pc, float* Ec,
                   int BH, int n, int d, int dv, int is_bf16, int normalize,
                   float eps, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* const init[4] = {P0, m0, E0, n0};
  float* const out[4] = {P, m, E, n_out};
  err = is_bf16 ? launch<__nv_bfloat16>(q, k, v, gamma, init, o, out, Pc,
                                        Ec, BH, n, d, dv, normalize, eps, s)
                : launch<float>(q, k, v, gamma, init, o, out, Pc, Ec, BH, n,
                                d, dv, normalize, eps, s);
  return (int)err;
}

}  // extern "C"
