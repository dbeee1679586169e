// Chunkwise AHLA forward for Hopper (sm_90a): prompt prefill and the
// training forward.
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
//   P1 = rho P0 + K^T (r . V),  m1 = rho m0 + K^T r
//   E1 = rho E0 + K^T (r . R),  n1 = rho n0 + K^T (r . s)
// (E1 in this form equals the reference's rho E0 + Kg^T (A V) + rho K^T Q P0,
// since r[t] p[t] = rho; it needs no d x d product.)
//
// Bound on this card: operations.  A 64-token chunk at d = dv = 128 does
// about 5.0 M FMAs per row against 64 KB of q/k/v/o traffic.  The floor
// prices each product at the card's fastest fp32-accurate rate for its
// operands (chip_smoke.ahla_chunk_fmas, _bound): 989 TFLOP/s for bf16 x
// bf16, 989/3 for an input times an fp32 term, 495/3 for fp32 x fp32.
//
// Design: every value column of AHLA is independent of the others (each
// column of P, E, R and O reads only its own column of V), except the den
// column (the ones column of [V | 1]), which is a vector.  So a row is split
// over CTAs of CW = 32 value columns each: grid (rows, ceil(dv / 32)), 64
// CTAs for one hla-1b prompt, 128 for the train step's 32 rows.  Each CTA
// keeps its columns of the carry P and E, and a private copy of the vectors
// m and n, in shared memory for the whole row: the carry never goes back to
// device memory between chunks, and no CTA reads what another writes (the
// initial carry is a separate input, the final carry is written once at
// the end; the first column tile writes m and n).  For training each CTA
// also writes its columns of every chunk's incoming carry to the
// checkpoints [P | m], [E | n] (BH, nc, d, dv + 1: the reference's layout);
// the first column tile writes their den column (m, n).  Q K^T and the
// vectors s, den, m, n are computed by every CTA of a row: r x r x d and
// r x d per chunk, small beside the r x 32 x (d + r) products.
//
// Every product is a warp-level mma.sync (mma_tile.cuh): bf16 for Q K^T
// with bf16 inputs, else split TF32, 2 MMAs where one side is a raw input
// (all but A R, which takes 3).  Every operand is a plain tile read: p[t]
// scales an output row and is applied in out(); r[t] lies on the
// contraction index of the carry updates and lives in the fp32 tiles r . V
// and r . R, formed once per chunk, so K stays a raw input operand; A is
// stored once per chunk; a sum of two products is two calls whose second
// accumulates into the first's output (same N, same thread per element).
// The vectors s, den, m, n are SIMT loops.  A ragged tail is one shorter
// chunk of length r with its own decay powers (rho = gamma^r): no zero
// padding and no division by gamma^pad.  Products with the carry are
// skipped on a first chunk that has no initial state (its carry is zero).
//
// Shared memory (157,444 bytes at d = 128 with bf16 inputs, 231,172 with
// fp32): two stages of the chunk's Q, K (w x d) and the tile's V (w x 32)
// in their input type, the next chunk's copied with cp.async while this
// one computes; A (w x w); R, r . V, r . R and O (w x 32); P and E (d x
// 32); m, n, s, den and the decay powers.

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

constexpr int W = 64;   // tokens per chunk tile (outputs do not depend on it)
constexpr int CW = 32;  // value columns per CTA
constexpr int THREADS = 256;
constexpr int S = 2;    // stages of the raw inputs
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

// input-type elements of one stage: Q, K (W x d), the tile's V (W x CW)
__host__ __device__ size_t stage_elems(int d) {
  return 2 * (size_t)W * d + W * CW;
}

// One block per SM (its shared memory leaves no room for a second); the
// 1 lets ptxas use the registers that allows.
template <typename T>
__global__ void __launch_bounds__(THREADS, 1)
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
  constexpr bool kIn = std::is_same<T, __nv_bfloat16>::value;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* tp = reinterpret_cast<T*>(smem_raw);  // S stages of Q, K, V
  float* fs = reinterpret_cast<float*>(tp + S * stage_elems(d));
  const Tile<float> A(fs, W);               // W x W  (Q K^T) . Lg
  const Tile<float> R(A.p + W * W, CW);     // W x CW first-order outputs
  const Tile<float> rV(R.p + W * CW, CW);   // W x CW r . V
  const Tile<float> rR(rV.p + W * CW, CW);  // W x CW r . R
  const Tile<float> O(rR.p + W * CW, CW);   // W x CW p . (Q E0), then O
  const Tile<float> Ps(O.p + W * CW, CW);   // d x CW carry P, this tile's
  const Tile<float> Es(Ps.p + d * CW, CW);  // d x CW carry E, columns
  float* ms = Es.p + d * CW;  // d      carry m (private copy)
  float* ns = ms + d;         // d      carry n (private copy)
  float* sv = ns + d;         // W      s = first-order den column
  float* den = sv + W;        // W      p . (Q n0), then O's den column + eps
  float* gp = den + W;        // W + 1  g^i

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
  const int nc = (n + W - 1) / W;

  auto stage_of = [=](int c) { return tp + (c % S) * stage_elems(d); };
  // start copying chunk c's rows of q, k and the tile's columns of v
  auto load_inputs = [=](int c) {
    const int c0 = c * W, r = min(W, n - c0);
    T* st = stage_of(c);
    stage(Tile<T>(st, d), q + (size_t)c0 * d, r, d, d);
    stage(Tile<T>(st + W * d, d), k + (size_t)c0 * d, r, d, d);
    stage(Tile<T>(st + 2 * W * d, CW), v + (size_t)c0 * dv + e0, r, ew, dv);
  };

  load_inputs(0);
  cp_async_commit();
  for (int i = tid; i < d * ew; i += THREADS) {
    const int a = i / ew, e = i - a * ew;
    const size_t src = so + (size_t)a * dv + e0 + e;
    Ps(a, e) = has_init ? P0[src] : 0.f;
    Es(a, e) = has_init ? E0[src] : 0.f;
  }
  for (int a = tid; a < d; a += THREADS) {
    ms[a] = has_init ? m0[sm + a] : 0.f;
    ns[a] = has_init ? n0[sm + a] : 0.f;
  }
  for (int i = tid; i <= W; i += THREADS) gp[i] = expf(i * logg);

  for (int c = 0; c < nc; ++c) {
    const int c0 = c * W, r = min(W, n - c0);
    // a zero carry (first chunk, no initial state): skip its products
    const bool carry = has_init || c > 0;
    T* st = stage_of(c);
    const Tile<T> Q(st, d), K(st + W * d, d), V(st + 2 * W * d, CW);
    auto q_ = [=](int t, int a) { return to_f(Q(t, a)); };
    auto kt_ = [=](int a, int t) { return to_f(K(t, a)); };  // K^T
    if (c + 1 < nc) load_inputs(c + 1);  // into the stage chunk c - 1 left
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const float rho = gp[r];

    // ---- A = (Q K^T) . Lg, r . V, the checkpoint --------------------------
    mma_mm<2, kIn, kIn>(
        r, r, d, q_, [=](int a, int j) { return to_f(K(j, a)); },
        [=](int t, int j, float x) { A(t, j) = j <= t ? gp[t - j] * x : 0.f; });
    for (int i = tid; i < r * ew; i += THREADS) {
      const int t = i / ew, e = i - t * ew;
      rV(t, e) = gp[r - 1 - t] * to_f(V(t, e));
    }
    if (Pc) {  // checkpoint the chunk's incoming carry: this CTA's columns
      const size_t ck = (row * nc + c) * d * (dv + 1);
      for (int i = tid; i < d * ew; i += THREADS) {
        const int a = i / ew, e = i - a * ew;
        Pc[ck + (size_t)a * (dv + 1) + e0 + e] = Ps(a, e);
        Ec[ck + (size_t)a * (dv + 1) + e0 + e] = Es(a, e);
      }
      if (blockIdx.y == 0)
        for (int a = tid; a < d; a += THREADS) {
          Pc[ck + (size_t)a * (dv + 1) + dv] = ms[a];
          Ec[ck + (size_t)a * (dv + 1) + dv] = ns[a];
        }
    }
    __syncthreads();

    // ---- R = p . (Q P0) + A V and r . R; O = p . (Q E0); s; Q n0 ----------
    if (carry)
      mma_mm<2, kIn, false>(
          r, ew, d, q_, [=](int a, int e) { return Ps(a, e); },
          [=](int t, int e, float x) { R(t, e) = gp[t + 1] * x; });
    mma_mm<2, false, kIn>(
        r, ew, r, [=](int t, int j) { return A(t, j); },
        [=](int j, int e) { return to_f(V(j, e)); },
        [=](int t, int e, float x) {
          const float y = carry ? R(t, e) + x : x;
          R(t, e) = y;
          rR(t, e) = gp[r - 1 - t] * y;
        });
    if (carry)
      mma_mm<2, kIn, false>(
          r, ew, d, q_, [=](int a, int e) { return Es(a, e); },
          [=](int t, int e, float x) { O(t, e) = gp[t + 1] * x; });
    {  // s = p . (Q m0) + A 1 and p . (Q n0): GROUP threads per token
      const int t = tid / GROUP, part = tid % GROUP;
      float qm = 0.f, qn = 0.f, as = 0.f;
      if (t < r) {
        if (carry)
          for (int a = part; a < d; a += GROUP) {
            const float x = q_(t, a);
            qm = fmaf(x, ms[a], qm);
            qn = fmaf(x, ns[a], qn);
          }
        for (int j = part; j <= t; j += GROUP) as += A(t, j);
      }
      qm = group_sum<GROUP>(qm);
      qn = group_sum<GROUP>(qn);
      as = group_sum<GROUP>(as);
      if (part == 0 && t < r) {
        sv[t] = gp[t + 1] * qm + as;
        den[t] = gp[t + 1] * qn;
      }
    }
    __syncthreads();  // every read of the old P, E, m, n is done

    // ---- the carry update; O += A R; den ---------------------------------
    mma_mm<2, kIn, false>(  // P1 = rho P0 + K^T (r . V)
        d, ew, r, kt_, [=](int t, int e) { return rV(t, e); },
        [=](int a, int e, float x) { Ps(a, e) = rho * Ps(a, e) + x; });
    mma_mm<2, kIn, false>(  // E1 = rho E0 + K^T (r . R)
        d, ew, r, kt_, [=](int t, int e) { return rR(t, e); },
        [=](int a, int e, float x) { Es(a, e) = rho * Es(a, e) + x; });
    mma_mm<2, false, false>(  // O += A R; unnormalised, that is o
        r, ew, r, [=](int t, int j) { return A(t, j); },
        [=](int j, int e) { return R(j, e); },
        [=](int t, int e, float x) {
          const float y = carry ? O(t, e) + x : x;
          if (normalize)
            O(t, e) = y;
          else
            store(o + (size_t)(c0 + t) * dv + e0 + e, y);
        });
    if (normalize) {  // den = p . (Q n0) + A s + eps
      const int t = tid / GROUP, part = tid % GROUP;
      float as = 0.f;
      if (t < r)
        for (int j = part; j <= t; j += GROUP) as = fmaf(A(t, j), sv[j], as);
      as = group_sum<GROUP>(as);
      if (part == 0 && t < r) den[t] += as + eps;
    }
    // m1 = rho m0 + K^T r, n1 = rho n0 + K^T (r . s)
    for (int a = tid; a < d; a += THREADS) {
      float km = 0.f, kn = 0.f;
      for (int t = 0; t < r; ++t) {
        const float x = gp[r - 1 - t] * kt_(a, t);
        km += x;
        kn = fmaf(x, sv[t], kn);
      }
      ms[a] = rho * ms[a] + km;
      ns[a] = rho * ns[a] + kn;
    }
    __syncthreads();

    if (normalize) {  // o = O / den
      for (int i = tid; i < r * ew; i += THREADS) {
        const int t = i / ew, e = i - t * ew;
        store(o + (size_t)(c0 + t) * dv + e0 + e, O(t, e) / den[t]);
      }
      __syncthreads();
    }
  }

  for (int i = tid; i < d * ew; i += THREADS) {
    const int a = i / ew, e = i - a * ew;
    const size_t dst = so + (size_t)a * dv + e0 + e;
    P[dst] = Ps(a, e);
    E[dst] = Es(a, e);
  }
  if (blockIdx.y == 0) {
    for (int a = tid; a < d; a += THREADS) {
      m[sm + a] = ms[a];
      nv[sm + a] = ns[a];
    }
  }
}

// Shared-memory bytes for head dim d and input type size tsize (157,444 at
// d = 128 with bf16 inputs, 231,172 with fp32; see the note at the top); a
// size above the 227 KB limit makes cudaFuncSetAttribute fail the launch.
size_t smem_bytes(int d, size_t tsize) {
  const size_t floats = (size_t)W * W + 4 * (size_t)W * CW +
                        2 * (size_t)d * CW + 2 * (size_t)d + 2 * W + (W + 1);
  return S * stage_elems(d) * tsize + floats * sizeof(float);
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const float* gamma, const float* const* init, void* o,
                   float* const* out, float* Pc, float* Ec, int BH, int n,
                   int d, int dv, int normalize, float eps,
                   cudaStream_t stream) {
  auto kern = ahla_chunk_fwd_kernel<T>;
  const size_t smem = smem_bytes(d, sizeof(T));
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

// Dynamic shared-memory bytes the kernel asks for.
long ahla_chunk_fwd_smem_bytes(int d, int is_bf16) {
  return (long)smem_bytes(d, is_bf16 ? 2 : 4);
}

}  // extern "C"
