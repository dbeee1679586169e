// Warp-level tensor-core products for the chunk kernels (sm_80 and later,
// built here for sm_90a), with the call shape of a SIMT tile loop:
//
//   mma_mm<NT, AX, BX>(M, N, K, a, b, out)
//
// calls out(r, c, sum_{kk < K} a(r, kk) * b(kk, c)) once for every r < M,
// c < N.  a and b are element accessors (lambdas returning float), so a
// call site states masks, decay weights and concatenated operands in them;
// an index past M, N or K reads as zero.  AX (BX) says that every value a
// (b) returns is exactly a bf16 number: a raw bf16 input.
//
// Precision: the products must keep fp32 accuracy (the states and
// checkpoints are held to 1e-4 of fp32 plain versions).
//   - AX and BX: mma.m16n8k16 in bf16 with fp32 accumulation.  Exact.
//   - otherwise mma.m16n8k8 in TF32 with each fp32 operand split into a
//     high and a low TF32 part (x = hi + lo to about 22 bits): hi*hi +
//     hi*lo + lo*hi, 3 MMAs, or 2 when one side is exact (bf16 fits in
//     TF32).  The dropped lo*lo term is below 2^-22 of the product.
//     Single-pass TF32 (about 3 decimal digits) is never used.
//
// Issue, not the tensor cores, bounds these products: each fragment
// element costs its accessor's address arithmetic, and a mask would add a
// test to every one.  So an item that lies inside M and N runs its full
// depth steps unmasked; only a last, partial step and the items on the
// edge of a ragged chunk test every index.
//
// Work split: the output is cut into items of 16 rows x 8*NT columns, and
// the warps of the block take items in turn (item = warp, warp + nwarps,
// ...).  The thread that receives element (r, c) depends only on N, NT and
// the block's warp count, never on M or K: two calls with the same N and
// NT hand every element to the same thread, so an out() that accumulates
// into shared memory needs no barrier between such calls.  Every lane of a
// warp runs the same items (mma.sync is warp-wide): call from all threads
// of the block, outside any lane-divergent branch.
//
// Beside it, helpers the chunk kernels use: Tile, a shared-memory tile
// laid out so that fragment reads meet no bank conflict; prefetch_l2;
// stage, which copies a block of rows into a Tile with cp.async (the AHLA
// kernels stage the next chunk while the current one computes); and
// group_sum, a sum over a few neighbouring lanes.

#pragma once

#include <cuda_bf16.h>

#include <cstddef>

#include <cstdint>
#include <type_traits>

namespace mma_tile {

// A row-major tile of width w in shared memory.  Where w is a multiple of
// 32 (or is 16), column c of row r lives at c ^ 4 (r mod 8): the 8 rows x
// 4 columns an mma fragment reads then fall in distinct banks.
template <typename E>
struct Tile {
  E* p;
  int w, mask;
  __device__ Tile(E* p_, int w_)
      : p(p_), w(w_), mask(w_ % 32 == 0 ? 28 : (w_ == 16 ? 12 : 0)) {}
  __device__ __forceinline__ E& operator()(int r, int c) const {
    return p[r * w + (c ^ (((r & 7) << 2) & mask))];
  }
};

// Ask L2 for [base, base + bytes), one 128-byte line per thread in turn
// (a hint: nothing waits for it)
__device__ __forceinline__ void prefetch_l2(const void* base, size_t bytes) {
  const char* p = static_cast<const char*>(base);
  for (size_t off = (size_t)threadIdx.x * 128; off < bytes;
       off += (size_t)blockDim.x * 128)
    asm volatile("prefetch.global.L2 [%0];" ::"l"(p + off));
}

// cp.async of Bytes (4, 8 or 16) from device to shared memory; the copy
// completes asynchronously, in the group that the next commit closes
template <int Bytes>
__device__ __forceinline__ void cp_async(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  if constexpr (Bytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
                 "l"(gmem));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(s),
                 "l"(gmem), "n"(Bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most N of this thread's committed groups are in flight (a
// __syncthreads() after it makes every thread's copies visible)
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Start copying rows x cols of a row-major array in device memory (ld
// elements apart) into t, all threads of the block taking part.  Tile
// keeps every aligned group of 4 columns contiguous, so a group moves as
// one cp.async of 4 elements where the addresses allow; otherwise element
// by element (fp32 by cp.async, a 2-byte element, which cp.async cannot
// move alone, by a plain copy).
template <typename E>
__device__ __forceinline__ void stage(const Tile<E>& t, const E* src,
                                      int rows, int cols, size_t ld) {
  constexpr int G = 4 * sizeof(E);  // bytes of a group of 4 elements
  if (cols % 4 == 0 && ld % 4 == 0 && t.w % 4 == 0 &&
      reinterpret_cast<uintptr_t>(src) % G == 0) {
    const int gc = cols / 4;
    for (int i = threadIdx.x; i < rows * gc; i += blockDim.x) {
      const int r = i / gc, c = (i - r * gc) * 4;
      cp_async<G>(&t(r, c), src + r * ld + c);
    }
  } else {
    for (int i = threadIdx.x; i < rows * cols; i += blockDim.x) {
      const int r = i / cols, c = i - r * cols;
      if constexpr (sizeof(E) == 4)
        cp_async<4>(&t(r, c), src + r * ld + c);
      else
        t(r, c) = src[r * ld + c];
    }
  }
}

// the sum of x over each aligned group of G lanes, in every one of them
template <int G>
__device__ __forceinline__ float group_sum(float x) {
#pragma unroll
  for (int off = G / 2; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}


__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo, both TF32
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32(x);
  lo = tf32(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float* c, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}

template <int NT, bool AX, bool BX, class FA, class FB, class FO>
__device__ __forceinline__ void mma_mm(int M, int N, int K, FA a, FB b,
                                       FO out) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, tg = lane & 3;
  const int nw = blockDim.x >> 5;
  const int RT = (M + 15) >> 4, CT = (N + 8 * NT - 1) / (8 * NT);
  constexpr int KS = AX && BX ? 16 : 8;  // depth of one MMA step
  for (int item = threadIdx.x >> 5; item < RT * CT; item += nw) {
    const int r0 = (item / CT) * 16, c0 = (item % CT) * 8 * NT;
    float acc[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[j][i] = 0.f;
    // one MMA step at depth k0; Checked masks rows, columns and depth
    auto step = [&](int k0, auto checked) {
      constexpr bool C = decltype(checked)::value;
      auto A = [&](int r, int kk) {
        if constexpr (C) return r < M && kk < K ? a(r, kk) : 0.f;
        else return a(r, kk);
      };
      auto B = [&](int kk, int c) {
        if constexpr (C) return c < N && kk < K ? b(kk, c) : 0.f;
        else return b(kk, c);
      };
      if constexpr (AX && BX) {
        const int ka = k0 + 2 * tg;
        uint32_t af[4];
        af[0] = pack_bf16(A(r0 + g, ka), A(r0 + g, ka + 1));
        af[1] = pack_bf16(A(r0 + g + 8, ka), A(r0 + g + 8, ka + 1));
        af[2] = pack_bf16(A(r0 + g, ka + 8), A(r0 + g, ka + 9));
        af[3] = pack_bf16(A(r0 + g + 8, ka + 8), A(r0 + g + 8, ka + 9));
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const int c = c0 + 8 * j + g;
          uint32_t bf[2];
          bf[0] = pack_bf16(B(ka, c), B(ka + 1, c));
          bf[1] = pack_bf16(B(ka + 8, c), B(ka + 9, c));
          mma_bf16(acc[j], af, bf);
        }
      } else {
        const int ka = k0 + tg;
        const float av[4] = {A(r0 + g, ka), A(r0 + g + 8, ka),
                             A(r0 + g, ka + 4), A(r0 + g + 8, ka + 4)};
        uint32_t ah[4], al[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          if constexpr (AX) {
            ah[i] = __float_as_uint(av[i]);
            al[i] = 0u;
          } else {
            split(av[i], ah[i], al[i]);
          }
        }
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const int c = c0 + 8 * j + g;
          const float bv[2] = {B(ka, c), B(ka + 4, c)};
          uint32_t bh[2], bl[2];
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            if constexpr (BX) {
              bh[i] = __float_as_uint(bv[i]);
              bl[i] = 0u;
            } else {
              split(bv[i], bh[i], bl[i]);
            }
          }
          if constexpr (!BX) mma_tf32(acc[j], ah, bl);
          if constexpr (!AX) mma_tf32(acc[j], al, bh);
          mma_tf32(acc[j], ah, bh);
        }
      }
    };
    // unmasked steps while the item and the step lie inside M, N and K
    const int kin = r0 + 16 <= M && c0 + 8 * NT <= N ? K / KS * KS : 0;
    int k0 = 0;
    for (; k0 < kin; k0 += KS) step(k0, std::false_type{});
    for (; k0 < K; k0 += KS) step(k0, std::true_type{});
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = r0 + g + (i >> 1) * 8, c = c0 + 8 * j + 2 * tg + (i & 1);
        if (r < M && c < N) out(r, c, acc[j][i]);
      }
  }
}

}  // namespace mma_tile
