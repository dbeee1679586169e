// What the two decode-step kernels (hla2_step.cu, ahla_step.cu) share:
// one row of (slot*head) state per thread-block cluster of CLUSTER CTAs,
// CTA j of the cluster owning a column slice of every state matrix.
//
//   - Slice / slice_of: the columns rank j owns, ceil(cols / CLUSTER)
//     rounded up to 4 (16 bytes); the last slice narrower, some empty when
//     cols is small.  An empty slice runs empty loops and still reaches
//     every cluster barrier.
//   - slice_map (host) and load_box: the slice's d rows of a matrix into
//     shared memory as one 2D tensor copy of the Tensor Memory Accelerator
//     (TMA), completing on an mbarrier.  One thread issues a CTA's share in
//     a few instructions and the copy engine streams it, so no thread
//     stalls issuing loads, and each matrix is used as soon as its barrier
//     completes.  (16-byte cp.async from every thread stalled the threads
//     behind their own copies; TMA's 1D bulk copies, one per 128-byte row,
//     were serialised by the copy engine.)
//   - update_slice: X1 = alpha X0 + beta x y^T from the shared copy back to
//     device memory with 16-byte stores, each element written once.
//   - col_partials / col_total: column sums x^T X0 over the slice, split
//     over row groups of threads and added up after a barrier.
//   - cluster_arrive / cluster_wait: the two halves of the cluster barrier
//     (barrier.cluster.arrive, default release; .wait, acquire), every
//     thread of every CTA of the cluster taking part.
//   - launch_rows: the cluster launch, BH * CLUSTER CTAs; a launch the card
//     refuses comes back as its cudaError_t.
//
// Limits: d and dv multiples of 4, every state tensor 16-byte aligned (the
// wrapper checks), d <= 256 rows and slices <= 256 columns (a TMA box).

#pragma once

#include <cooperative_groups.h>
#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace step_cluster {

namespace cg = cooperative_groups;

constexpr int CLUSTER = 4;  // CTAs per row
constexpr int THREADS = 256;
constexpr int MAX_BOX = 256;  // rows or columns of one TMA box

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// The arrive releases this thread's earlier writes (shared and device
// memory) to the cluster; the wait returns once every thread of the
// cluster has arrived, and acquires what they released.
__device__ __forceinline__ void cluster_arrive() {
  __cluster_barrier_arrive();
}
__device__ __forceinline__ void cluster_wait() { __cluster_barrier_wait(); }

// columns [c0, c0 + w) of a matrix with `cols` columns, held in shared
// memory as rows of cw floats (every slice but the last is cw wide)
struct Slice {
  int c0, w, cw;
};
__host__ __device__ __forceinline__ int slice_width(int cols) {
  return ((cols + CLUSTER - 1) / CLUSTER + 3) & ~3;
}
__device__ __forceinline__ Slice slice_of(int cols, int rank) {
  const int cw = slice_width(cols);
  const int c0 = min(rank * cw, cols);
  return {c0, min(cw, cols - c0), cw};
}
// floats a slice of d rows takes in shared memory, kept a multiple of 32
// (TMA writes to 128-byte-aligned shared memory)
__host__ __device__ __forceinline__ int slice_floats(int d, int cols) {
  return (d * slice_width(cols) + 31) & ~31;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// mbarriers in shared memory that complete once the bytes they expect have
// landed: init_bars by one thread, then a __syncthreads() before any other
// thread waits on them
__device__ __forceinline__ void init_bars(uint64_t* bars, int n) {
  for (int i = 0; i < n; ++i)
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(
                     smem_addr(bars + i)));
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}
__device__ __forceinline__ void expect_bytes(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   smem_addr(bar)),
               "r"(bytes)
               : "memory");
}
// wait until the copies counted on bar (its first phase) have landed
__device__ __forceinline__ void wait_bar(uint64_t* bar) {
  unsigned done = 0;
  while (!done)
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(smem_addr(bar))
        : "memory");
}
// bytes (a multiple of 16; both addresses 16-byte aligned) from device to
// shared memory, completing on bar
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          unsigned bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}
// the bytes load_box lands for slice s of d rows
__device__ __forceinline__ unsigned box_bytes(int d, Slice s) {
  return s.w ? (unsigned)(d * s.cw) * sizeof(float) : 0u;
}
// Start copying slice s of rows [r0, r0 + d) of the matrix that map
// describes into Xs (rows of s.cw floats; columns past the matrix's edge
// read as zero), completing on bar, which expects box_bytes(d, s).  An
// empty slice copies nothing.
__device__ __forceinline__ void load_box(float* Xs, const CUtensorMap& map,
                                         Slice s, int r0, uint64_t* bar) {
  if (s.w == 0) return;
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];" ::"r"(smem_addr(Xs)),
      "l"(reinterpret_cast<uint64_t>(&map)), "r"(s.c0), "r"(r0),
      "r"(smem_addr(bar))
      : "memory");
}

// X[a, s.c0 + c] <- alpha Xs[a, c] + beta x[a] y[c] over the slice, with
// 16-byte streaming stores (y indexed by the slice's own columns; nothing
// reads the new state before the next step, so it need not stay in L2).
__device__ __forceinline__ void update_slice(float* X, int d, int cols,
                                             Slice s, const float* Xs,
                                             float alpha, float beta,
                                             const float* x, const float* y) {
  const int w4 = s.w / 4;
  for (int i = threadIdx.x; i < d * w4; i += THREADS) {
    const int a = i / w4, c = (i - a * w4) * 4;
    const float4 x0 = *reinterpret_cast<const float4*>(Xs + a * s.cw + c);
    const float bx = beta * x[a];
    float4 x1;
    x1.x = fmaf(bx, y[c], alpha * x0.x);
    x1.y = fmaf(bx, y[c + 1], alpha * x0.y);
    x1.z = fmaf(bx, y[c + 2], alpha * x0.z);
    x1.w = fmaf(bx, y[c + 3], alpha * x0.w);
    __stcs(reinterpret_cast<float4*>(X + (size_t)a * cols + s.c0 + c), x1);
  }
}

// Partial column sums x^T Xs (and y^T Xs where y is given) over the d rows
// of slice s: thread t takes column t % w and rows t / w, + rg, + 2 rg, ...
// (rg = THREADS / w), and leaves its sums in rx[t] (ry[t]).  After a
// barrier, col_total(rx, w, b) adds up column b.
__device__ __forceinline__ void col_partials(const float* Xs, int d, Slice s,
                                             const float* x, float* rx,
                                             const float* y = nullptr,
                                             float* ry = nullptr) {
  const int t = threadIdx.x, w = s.w;
  float sx = 0.f, sy = 0.f;
  if (w > 0 && t < THREADS / w * w) {
    const int rg = THREADS / w, b = t % w;
    for (int a = t / w; a < d; a += rg) {
      const float xv = Xs[a * s.cw + b];
      sx = fmaf(x[a], xv, sx);
      if (y) sy = fmaf(y[a], xv, sy);
    }
  }
  rx[t] = sx;
  if (ry) ry[t] = sy;
}
__device__ __forceinline__ float col_total(const float* r, int w, int b) {
  float s = 0.f;
  for (int j = 0; j < THREADS / w; ++j) s += r[j * w + b];
  return s;
}

// x.y over n elements, in every lane of the warp
__device__ __forceinline__ float warp_dot(const float* x, const float* y,
                                          int n) {
  float s = 0.f;
  for (int i = threadIdx.x % 32; i < n; i += 32) s = fmaf(x[i], y[i], s);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    s += __shfl_xor_sync(0xffffffffu, s, off);
  return s;
}

// Host: the TMA map of the fp32 matrix at p, `rows` rows of `cols`
// columns, whose box is one slice of d rows.
inline cudaError_t slice_map(CUtensorMap* map, const float* p, int rows,
                             int cols, int d) {
  static PFN_cuTensorMapEncodeTiled encode = [] {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &fn,
                                         12000, cudaEnableDefault,
                                         &found) != cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      fn = nullptr;
    return reinterpret_cast<PFN_cuTensorMapEncodeTiled>(fn);
  }();
  if (!encode) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * sizeof(float)};
  const cuuint32_t box[2] = {(cuuint32_t)slice_width(cols), (cuuint32_t)d};
  const cuuint32_t step[2] = {1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<float*>(p), dims,
      strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// Launch kernel over BH rows, one cluster of CLUSTER CTAs each, with smem
// bytes of dynamic shared memory.  Refuses d or dv not a multiple of 4, or
// a box past MAX_BOX.
template <typename... Params, typename... Args>
cudaError_t launch_rows(void (*kernel)(Params...), int BH, int d, int dv,
                        size_t smem, cudaStream_t stream, Args... args) {
  if (d % 4 || dv % 4 || d > MAX_BOX || slice_width(dv) > MAX_BOX)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CLUSTER;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)BH * CLUSTER);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace step_cluster
