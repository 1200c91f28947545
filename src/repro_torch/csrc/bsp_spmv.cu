// Block-sparse semiring SpMV for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `bsp_spmv` (src/repro/kernels/bsp_spmv.py,
// body `_kernel`). A partition's adjacency is a list of dense 128x128 tiles
// sorted by (tile_dst, tile_src); every dst tile row appears at least once.
//
//   out[d] = (+)_{t: dst(t) = d}  tiles[t] (x) vals[src(t)]
//
//   plus_times : (+) = sum, (x) = matrix product      (float32)
//   min_plus   : (+) = min, (x) = min_c (tile + val)  (float32, int32)
//
// Design. One CTA per dst tile row (and per group of KB payload lanes), so
// no two CTAs write the same output and no atomics are needed: this takes
// the place of the TPU's sequential grid that revisits one output block.
// Row pointers into the dst-sorted tile list come from the wrapper. The CTA
// walks its tiles in list order; each tile is staged in shared memory in
// 128x32 column chunks (16.5 KB with padding against bank conflicts), and
// thread `row` folds the chunk's columns in ascending order into its KB
// partial results held in registers. The first tile of a row initializes
// the output row and later tiles combine into it, as on the TPU. plus_times
// is an fp32 multiply-add in a fixed order (no TF32, no atomics), so the
// result is deterministic; min_plus is exact.
//
// Bound on the H100: memory. Each tile is read once (T * 128 * 128 * 4
// bytes) and the work per tile byte is a few operations, far below the
// card's operations-per-byte balance. The design reads every tile byte
// exactly once, coalesced (a warp reads 32 consecutive floats of a row);
// making it fast (TMA staging, a ring of tiles, wgmma for plus_times) is
// later work.
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int TM = 128;  // dst rows per tile
constexpr int TN = 128;  // src cols per tile
constexpr int CC = 32;   // tile columns staged per step
constexpr int KB = 8;    // payload lanes per CTA

template <typename T>
__device__ __forceinline__ T min_identity();
template <>
__device__ __forceinline__ float min_identity<float>() {
  return __int_as_float(0x7f800000);  // +inf
}
template <>
__device__ __forceinline__ int32_t min_identity<int32_t>() {
  return INT_MAX;
}

template <typename T, bool PLUS_TIMES>
__global__ void __launch_bounds__(TM)
bsp_spmv_kernel(const T* __restrict__ tiles,
                const int32_t* __restrict__ tile_src,
                const int32_t* __restrict__ row_ptr,
                const T* __restrict__ vals, T* __restrict__ out, int K) {
  __shared__ T s_tile[TM][CC + 1];
  __shared__ T s_val[CC][KB];

  const int d = blockIdx.x;
  const int k0 = blockIdx.y * KB;
  const int kb = min(KB, K - k0);  // live payload lanes of this CTA
  const int row = threadIdx.x;
  const T ident = PLUS_TIMES ? T(0) : min_identity<T>();

  T acc[KB];
#pragma unroll
  for (int kk = 0; kk < KB; ++kk) acc[kk] = ident;

  const int beg = row_ptr[d];
  const int end = row_ptr[d + 1];
  for (int t = beg; t < end; ++t) {
    const T* tile = tiles + static_cast<size_t>(t) * TM * TN;
    const T* v = vals + static_cast<size_t>(tile_src[t]) * TN * K;
    T part[KB];
#pragma unroll
    for (int kk = 0; kk < KB; ++kk) part[kk] = ident;

    for (int c0 = 0; c0 < TN; c0 += CC) {
      __syncthreads();  // previous chunk fully consumed
#pragma unroll
      for (int j = 0; j < CC; ++j) {
        const int i = j * TM + threadIdx.x;
        const int r = i / CC;
        const int c = i % CC;
        s_tile[r][c] = tile[static_cast<size_t>(r) * TN + c0 + c];
      }
      for (int i = threadIdx.x; i < CC * kb; i += TM) {
        const int c = i / kb;
        const int kk = i % kb;
        s_val[c][kk] = v[static_cast<size_t>(c0 + c) * K + k0 + kk];
      }
      __syncthreads();
#pragma unroll 4
      for (int c = 0; c < CC; ++c) {
        const T a = s_tile[row][c];
#pragma unroll
        for (int kk = 0; kk < KB; ++kk) {
          if constexpr (PLUS_TIMES) {
            part[kk] = part[kk] + a * s_val[c][kk];
          } else {
            const T cand = a + s_val[c][kk];
            part[kk] = cand < part[kk] ? cand : part[kk];
          }
        }
      }
    }
#pragma unroll
    for (int kk = 0; kk < KB; ++kk) {
      if (t == beg) {
        acc[kk] = part[kk];
      } else if constexpr (PLUS_TIMES) {
        acc[kk] = acc[kk] + part[kk];
      } else {
        acc[kk] = part[kk] < acc[kk] ? part[kk] : acc[kk];
      }
    }
  }

  T* o = out + (static_cast<size_t>(d) * TM + row) * K + k0;
#pragma unroll
  for (int kk = 0; kk < KB; ++kk) {
    if (kk < kb) o[kk] = acc[kk];
  }
}

template <typename T, bool PLUS_TIMES>
void launch(const void* tiles, const void* tile_src, const void* row_ptr,
            const void* vals, void* out, int n_dst_tiles, int K,
            cudaStream_t stream) {
  const dim3 grid(n_dst_tiles, (K + KB - 1) / KB);
  bsp_spmv_kernel<T, PLUS_TIMES><<<grid, TM, 0, stream>>>(
      static_cast<const T*>(tiles), static_cast<const int32_t*>(tile_src),
      static_cast<const int32_t*>(row_ptr), static_cast<const T*>(vals),
      static_cast<T*>(out), K);
}

}  // namespace

// dtype: 0 = float32, 1 = int32. semiring: 0 = plus_times, 1 = min_plus.
// Returns the CUDA error of the launch (0 on success).
extern "C" int drone_bsp_spmv(const void* tiles, const void* tile_src,
                              const void* row_ptr, const void* vals,
                              void* out, int n_dst_tiles, int K, int dtype,
                              int semiring, void* stream) {
  if (n_dst_tiles <= 0 || K <= 0) return static_cast<int>(cudaSuccess);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && semiring == 0) {
    launch<float, true>(tiles, tile_src, row_ptr, vals, out, n_dst_tiles, K,
                        s);
  } else if (dtype == 0 && semiring == 1) {
    launch<float, false>(tiles, tile_src, row_ptr, vals, out, n_dst_tiles,
                         K, s);
  } else if (dtype == 1 && semiring == 1) {
    launch<int32_t, false>(tiles, tile_src, row_ptr, vals, out, n_dst_tiles,
                           K, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
