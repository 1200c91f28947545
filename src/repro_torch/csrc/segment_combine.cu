// Windowed segment combine for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `segment_combine_windowed`
// (src/repro/kernels/segment_combine.py, body `_kernel`). Edge messages are
// laid out in blocks of Be edges; every block lies inside one 128-row
// destination window, blocks are sorted by window and every window has at
// least one block (padding edges carry the combiner identity).
//
//   out[w, r] = (+)_{blocks b of window w} (+)_{e in b: ldst[e] == r} msgs[e]
//
//   sum (float32) | min, max (float32, int32)
//
// Design. One CTA per window (and per group of KB payload lanes): the CTA
// owns its 128 output rows, so no atomics are needed and a window's blocks
// are combined in order, as the TPU's sequential grid did. Block ranges per
// window come from the wrapper. For each block the CTA stages the block's
// destination rows and messages in shared memory (at most 512 edges at a
// time); thread `row` then scans the staged edges in ascending order and
// folds in those whose destination is its row. A block's partial initializes
// the row on the window's first block and combines into it afterwards, as on
// the TPU. The scan order is fixed, so `sum` is deterministic and `min` /
// `max` are exact.
//
// Bound on the H100: memory, B * Be * (K + 1) * 4 bytes read once. The
// row-per-thread scan repeats each edge's compare 128 times per CTA, which
// costs more instruction issue than the bytes need; a segmented reduction
// over the dst-sorted block, or the fused sweep that never writes the
// message buffer, is later work.
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int W = 128;   // output rows per window
constexpr int KB = 8;    // payload lanes per CTA
constexpr int EC = 512;  // edges staged per step

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

template <typename T, int OP>
__global__ void __launch_bounds__(W)
segment_combine_kernel(const T* __restrict__ msgs,
                       const int32_t* __restrict__ ldst,
                       const int32_t* __restrict__ blk_ptr,
                       T* __restrict__ out, int Be, int K) {
  __shared__ int32_t s_dst[EC];
  __shared__ T s_msg[EC][KB];

  const int w = blockIdx.x;
  const int k0 = blockIdx.y * KB;
  const int kb = min(KB, K - k0);  // live payload lanes of this CTA
  const int row = threadIdx.x;
  const T ident = identity<T, OP>();

  T acc[KB];
#pragma unroll
  for (int kk = 0; kk < KB; ++kk) acc[kk] = ident;

  const int beg = blk_ptr[w];
  const int end = blk_ptr[w + 1];
  for (int b = beg; b < end; ++b) {
    T part[KB];
#pragma unroll
    for (int kk = 0; kk < KB; ++kk) part[kk] = ident;

    const size_t base = static_cast<size_t>(b) * Be;
    for (int e0 = 0; e0 < Be; e0 += EC) {
      const int n = min(EC, Be - e0);
      __syncthreads();  // previous chunk fully consumed
      for (int i = threadIdx.x; i < n; i += W) {
        s_dst[i] = ldst[base + e0 + i];
      }
      for (int i = threadIdx.x; i < n * kb; i += W) {
        const int e = i / kb;
        const int kk = i % kb;
        s_msg[e][kk] = msgs[(base + e0 + e) * K + k0 + kk];
      }
      __syncthreads();
      for (int e = 0; e < n; ++e) {
        if (s_dst[e] == row) {
#pragma unroll
          for (int kk = 0; kk < KB; ++kk) {
            part[kk] = combine<T, OP>(part[kk], s_msg[e][kk]);
          }
        }
      }
    }
#pragma unroll
    for (int kk = 0; kk < KB; ++kk) {
      acc[kk] = (b == beg) ? part[kk] : combine<T, OP>(acc[kk], part[kk]);
    }
  }

  T* o = out + (static_cast<size_t>(w) * W + row) * K + k0;
#pragma unroll
  for (int kk = 0; kk < KB; ++kk) {
    if (kk < kb) o[kk] = acc[kk];
  }
}

template <typename T, int OP>
void launch(const void* msgs, const void* ldst, const void* blk_ptr,
            void* out, int n_windows, int Be, int K, cudaStream_t stream) {
  const dim3 grid(n_windows, (K + KB - 1) / KB);
  segment_combine_kernel<T, OP><<<grid, W, 0, stream>>>(
      static_cast<const T*>(msgs), static_cast<const int32_t*>(ldst),
      static_cast<const int32_t*>(blk_ptr), static_cast<T*>(out), Be, K);
}

}  // namespace

// dtype: 0 = float32, 1 = int32. combiner: 0 = sum, 1 = min, 2 = max.
// Returns the CUDA error of the launch (0 on success).
extern "C" int drone_segment_combine(const void* msgs, const void* ldst,
                                     const void* blk_ptr, void* out,
                                     int n_windows, int Be, int K, int dtype,
                                     int combiner, void* stream) {
  if (n_windows <= 0 || K <= 0) return static_cast<int>(cudaSuccess);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && combiner == kSum) {
    launch<float, kSum>(msgs, ldst, blk_ptr, out, n_windows, Be, K, s);
  } else if (dtype == 0 && combiner == kMin) {
    launch<float, kMin>(msgs, ldst, blk_ptr, out, n_windows, Be, K, s);
  } else if (dtype == 0 && combiner == kMax) {
    launch<float, kMax>(msgs, ldst, blk_ptr, out, n_windows, Be, K, s);
  } else if (dtype == 1 && combiner == kMin) {
    launch<int32_t, kMin>(msgs, ldst, blk_ptr, out, n_windows, Be, K, s);
  } else if (dtype == 1 && combiner == kMax) {
    launch<int32_t, kMax>(msgs, ldst, blk_ptr, out, n_windows, Be, K, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
