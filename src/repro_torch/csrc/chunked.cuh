// Shared pieces of the two chunked kernels (bsp_spmv.cu,
// segment_combine.cu): combiner identities, 1-D bulk async copies completed
// on mbarriers, and the ordered second pass over per-chunk partials.
//
// Both kernels take a chunk plan (repro_torch/kernels/chunks.py): the
// row-sorted item list is cut into chunks of at most `cap` consecutive items
// of one output row (a 128-row window or dst tile row). A row with one chunk
// is written by that chunk's CTA; the chunks of a split row write partials
// [128, K] into their scratch slots, and `combine_partials_kernel` folds a
// row's slots in chunk order. A row with no chunk gets the identity.
#pragma once

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace drone {

constexpr int kRows = 128;  // output rows per window / dst tile
constexpr unsigned kFull = 0xffffffffu;

enum Op { kSum = 0, kMin = 1, kMax = 2 };

template <typename T, int OP>
__device__ __forceinline__ T identity();
template <>
__device__ __forceinline__ float identity<float, kSum>() { return 0.0f; }
template <>
__device__ __forceinline__ float identity<float, kMin>() {
  return __int_as_float(0x7f800000);  // +inf
}
template <>
__device__ __forceinline__ float identity<float, kMax>() {
  return __int_as_float(0xff800000);  // -inf
}
template <>
__device__ __forceinline__ int32_t identity<int32_t, kMin>() {
  return INT_MAX;
}
template <>
__device__ __forceinline__ int32_t identity<int32_t, kMax>() {
  return INT_MIN;
}

// a (+) b, with `a` the earlier operand; min/max keep `a` on ties
template <typename T, int OP>
__device__ __forceinline__ T combine(T a, T b) {
  if constexpr (OP == kSum) {
    return a + b;
  } else if constexpr (OP == kMin) {
    return b < a ? b : a;
  } else {
    return b > a ? b : a;
  }
}

// ---- mbarriers and 1-D bulk copies (sm_90) ------------------------------ //
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// arrive once and expect `bytes` of transactions in the current phase
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

// wait until the phase with parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// global -> shared copy of `bytes` (a multiple of 16; both addresses
// 16-byte aligned), completing on `bar`
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// ---- second pass --------------------------------------------------------- //
// One CTA per split row: out[row] = (+) over the row's scratch slots in
// chunk order (identity for a row with none). Loads run 8 slots ahead of
// the fold so a long row is not one dependent load per slot.
template <typename T, int OP>
__global__ void __launch_bounds__(kRows)
combine_partials_kernel(const T* __restrict__ scratch,
                        const int32_t* __restrict__ split_row,
                        const int32_t* __restrict__ split_ptr,
                        T* __restrict__ out, int K) {
  constexpr int U = 8;
  const int s = blockIdx.x;
  const size_t row = static_cast<size_t>(split_row[s]);
  const int beg = split_ptr[s];
  const int end = split_ptr[s + 1];
  const size_t stride = static_cast<size_t>(kRows) * K;
  for (int i = threadIdx.x; i < kRows * K; i += blockDim.x) {
    T acc = identity<T, OP>();
    int j = beg;
    for (; j + U <= end; j += U) {
      T v[U];
#pragma unroll
      for (int u = 0; u < U; ++u) v[u] = scratch[(j + u) * stride + i];
#pragma unroll
      for (int u = 0; u < U; ++u) acc = combine<T, OP>(acc, v[u]);
    }
    for (; j < end; ++j) acc = combine<T, OP>(acc, scratch[j * stride + i]);
    out[row * stride + i] = acc;
  }
}

template <typename T, int OP>
cudaError_t launch_combine_partials(const T* scratch,
                                    const int32_t* split_row,
                                    const int32_t* split_ptr, T* out,
                                    int n_split, int K, cudaStream_t stream) {
  if (n_split <= 0) return cudaSuccess;
  combine_partials_kernel<T, OP>
      <<<n_split, kRows, 0, stream>>>(scratch, split_row, split_ptr, out, K);
  return cudaGetLastError();
}

// Allow `bytes` of dynamic shared memory for `kernel` (needed above 48 KB);
// `allowed` remembers the largest size already granted to this kernel.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes, int& allowed) {
  if (bytes <= 48 * 1024 || bytes <= allowed) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) allowed = bytes;
  return err;
}

}  // namespace drone
