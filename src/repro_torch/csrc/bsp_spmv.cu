// Block-sparse semiring SpMV for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `bsp_spmv` (src/repro/kernels/bsp_spmv.py,
// body `_kernel`). A partition's adjacency is a list of dense 128x128 tiles
// sorted by (tile_dst, tile_src).
//
//   out[d] = (+)_{t: dst(t) = d}  tiles[t] (x) vals[src(t)]
//
//   plus_times : (+) = sum, (x) = matrix product      (float32)
//   min_plus   : (+) = min, (x) = min_c (tile + val)  (float32, int32)
//
// Bound on the H100: memory. Each 64 KB tile is read once and used for 2K
// operations per 4-byte element; at the main path's K <= 8 that is at most
// 4 operations per byte, against the card's float32 balance of about 20
// (67 TFLOP/s over 3.35 TB/s). Tensor cores (wgmma) would not move a kernel
// that waits on bytes, and TF32 could not hold PageRank's 1e-5 bar, so the
// product stays in fp32 FMAs in a fixed order.
//
// Design.
// - Work split (chunked.cuh): a chunk plan cuts the dst-sorted tile list
//   into chunks of at most `cap` tiles of one dst row, one CTA each (and per
//   group of NK payload lanes). A dst row with a thousand tiles (the JAX
//   layout's padding tiles all land on a partition's last row) spreads over
//   many CTAs; the second pass folds its partials in chunk order.
// - Streaming: a chunk's tiles are contiguous, so thread 0 streams them in
//   quarter tiles (32 rows x 128 columns, 16 KB) with 1-D bulk async copies
//   through a ring of NSTAGE buffers in dynamic shared memory (64 KB, hence
//   cudaFuncSetAttribute), each completed on its mbarrier.
// - Conflict-free reads: each tile row goes to one warp; lane l reads the
//   row's columns 4l..4l+3 as one 16-byte vector (a warp reads 512
//   consecutive bytes: no bank conflicts and no padding), combines them
//   with the values of those columns held in registers, and a fixed-shape
//   xor-shuffle tree reduces the row across the warp. The lane that owns
//   the row (each lane owns one of the tile's 128 rows) folds it into its
//   accumulator, so a CTA keeps NK accumulators per thread. The next tile's
//   value block is loaded into registers while the current tile streams.
#include "chunked.cuh"

namespace {

using namespace drone;

constexpr int TN = 128;               // src cols per tile
constexpr int QR = 32;                // tile rows per stage
constexpr int NQ = kRows / QR;        // stages per tile
constexpr int NT = 128;               // threads per CTA
constexpr int NWARP = NT / 32;
constexpr int RW = QR / NWARP;        // rows per warp per stage
constexpr int NSTAGE = 4;             // ring depth
constexpr int SMEM_HEAD = 128;        // mbarriers

static_assert(NWARP * RW * NQ == kRows, "every lane owns one tile row");
static_assert(RW * NQ == 32, "every lane owns one tile row");

template <typename T>
struct Vec4;
template <>
struct Vec4<float> {
  using type = float4;
};
template <>
struct Vec4<int32_t> {
  using type = int4;
};

template <typename T, bool PT, int NK>
__global__ void __launch_bounds__(NT)
bsp_spmv_chunks(const T* __restrict__ tiles,
                const int32_t* __restrict__ tile_src,
                const int32_t* __restrict__ chunk_ptr,
                const int32_t* __restrict__ chunk_row,
                const int32_t* __restrict__ chunk_slot,
                const T* __restrict__ vals, T* __restrict__ out,
                T* __restrict__ scratch, int K) {
  constexpr int OP = PT ? kSum : kMin;
  constexpr int QELEMS = QR * TN;
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
  T* ring = reinterpret_cast<T*>(smem + SMEM_HEAD);

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int k0 = blockIdx.y * NK;
  const int kb = min(NK, K - k0);   // live payload lanes of this CTA
  const int c = blockIdx.x;
  const int t_beg = chunk_ptr[c];
  const int n_tiles = chunk_ptr[c + 1] - t_beg;
  const int n_st = n_tiles * NQ;
  const T ident = identity<T, OP>();
  const T* src0 = tiles + static_cast<size_t>(t_beg) * kRows * TN;

  if (tid == 0) {
    for (int b = 0; b < NSTAGE; ++b) mbar_init(&bar[b], 1);
    mbar_fence_init();
  }
  __syncthreads();
  auto load_stage = [&](int i) {
    const int b = i % NSTAGE;
    mbar_expect_tx(&bar[b], QELEMS * sizeof(T));
    bulk_load(ring + b * QELEMS, src0 + static_cast<size_t>(i) * QELEMS,
              QELEMS * sizeof(T), &bar[b]);
  };
  if (tid == 0) {
    for (int i = 0; i < min(NSTAGE, n_st); ++i) load_stage(i);
  }

  // values of this lane's four columns for the current and the next tile
  // (dead payload lanes hold 0: finite, and never stored)
  T v[4][NK];
  T nv[4][NK];
  auto load_vals = [&](T(&dst)[4][NK], int t) {
    const T* vp =
        vals + static_cast<size_t>(tile_src[t_beg + t]) * TN * K + k0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int kk = 0; kk < NK; ++kk) {
        dst[j][kk] =
            kk < kb ? vp[static_cast<size_t>(4 * lane + j) * K + kk] : T(0);
      }
    }
  };
  load_vals(nv, 0);

  T acc[NK];
#pragma unroll
  for (int kk = 0; kk < NK; ++kk) acc[kk] = ident;

  for (int i = 0; i < n_st; ++i) {
    const int q = i % NQ;
    if (q == 0) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int kk = 0; kk < NK; ++kk) v[j][kk] = nv[j][kk];
      }
      if (i / NQ + 1 < n_tiles) load_vals(nv, i / NQ + 1);
    }
    const int b = i % NSTAGE;
    mbar_wait(&bar[b], (i / NSTAGE) & 1);
    const T* st = ring + b * QELEMS;
#pragma unroll
    for (int j = 0; j < RW; ++j) {
      const int r = warp * RW + j;   // row within the quarter
      const auto a = *reinterpret_cast<const typename Vec4<T>::type*>(
          st + r * TN + 4 * lane);
      T p[NK];
#pragma unroll
      for (int kk = 0; kk < NK; ++kk) {
        if constexpr (PT) {
          float s = a.x * v[0][kk];
          s = fmaf(a.y, v[1][kk], s);
          s = fmaf(a.z, v[2][kk], s);
          s = fmaf(a.w, v[3][kk], s);
          p[kk] = s;
        } else {
          T m = a.x + v[0][kk];
          m = combine<T, OP>(m, a.y + v[1][kk]);
          m = combine<T, OP>(m, a.z + v[2][kk]);
          m = combine<T, OP>(m, a.w + v[3][kk]);
          p[kk] = m;
        }
      }
#pragma unroll
      for (int d = 16; d >= 1; d >>= 1) {
#pragma unroll
        for (int kk = 0; kk < NK; ++kk) {
          p[kk] = combine<T, OP>(p[kk], __shfl_xor_sync(kFull, p[kk], d));
        }
      }
      if (lane == q * RW + j) {
#pragma unroll
        for (int kk = 0; kk < NK; ++kk) {
          acc[kk] = combine<T, OP>(acc[kk], p[kk]);
        }
      }
    }
    __syncthreads();  // every warp is done with buffer b
    if (tid == 0 && i + NSTAGE < n_st) load_stage(i + NSTAGE);
  }

  // lane q*RW + j owns row QR*q + RW*warp + j of the tile
  const int row = (lane / RW) * QR + warp * RW + (lane % RW);
  const int slot = chunk_slot[c];
  T* dst = slot < 0
               ? out + (static_cast<size_t>(chunk_row[c]) * kRows + row) * K
               : scratch + (static_cast<size_t>(slot) * kRows + row) * K;
#pragma unroll
  for (int kk = 0; kk < NK; ++kk) {
    if (kk < kb) dst[k0 + kk] = acc[kk];
  }
}

template <typename T, bool PT, int NK>
cudaError_t launch_nk(const void* tiles, const int32_t* tile_src,
                      const int32_t* cptr, const int32_t* crow,
                      const int32_t* cslot, int n_chunks,
                      const int32_t* srow, const int32_t* sptr, int n_split,
                      const void* vals, void* out, void* scratch, int K,
                      cudaStream_t stream) {
  static int allowed = 0;
  constexpr int smem = SMEM_HEAD + NSTAGE * QR * TN * sizeof(T);
  cudaError_t err = allow_smem(bsp_spmv_chunks<T, PT, NK>, smem, allowed);
  if (err != cudaSuccess) return err;
  if (n_chunks > 0) {
    const dim3 grid(n_chunks, (K + NK - 1) / NK);
    bsp_spmv_chunks<T, PT, NK><<<grid, NT, smem, stream>>>(
        static_cast<const T*>(tiles), tile_src, cptr, crow, cslot,
        static_cast<const T*>(vals), static_cast<T*>(out),
        static_cast<T*>(scratch), K);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return launch_combine_partials<T, PT ? kSum : kMin>(
      static_cast<const T*>(scratch), srow, sptr, static_cast<T*>(out),
      n_split, K, stream);
}

template <typename T, bool PT>
cudaError_t launch(const void* tiles, const int32_t* tile_src,
                   const int32_t* cptr, const int32_t* crow,
                   const int32_t* cslot, int n_chunks, const int32_t* srow,
                   const int32_t* sptr, int n_split, const void* vals,
                   void* out, void* scratch, int K, cudaStream_t stream) {
  if (K <= 1) {
    return launch_nk<T, PT, 1>(tiles, tile_src, cptr, crow, cslot, n_chunks,
                               srow, sptr, n_split, vals, out, scratch, K,
                               stream);
  }
  if (K <= 2) {
    return launch_nk<T, PT, 2>(tiles, tile_src, cptr, crow, cslot, n_chunks,
                               srow, sptr, n_split, vals, out, scratch, K,
                               stream);
  }
  if (K <= 4) {
    return launch_nk<T, PT, 4>(tiles, tile_src, cptr, crow, cslot, n_chunks,
                               srow, sptr, n_split, vals, out, scratch, K,
                               stream);
  }
  return launch_nk<T, PT, 8>(tiles, tile_src, cptr, crow, cslot, n_chunks,
                             srow, sptr, n_split, vals, out, scratch, K,
                             stream);
}

}  // namespace

// dtype: 0 = float32, 1 = int32. semiring: 0 = plus_times, 1 = min_plus.
// tiles must be 16-byte aligned (the wrapper checks). Returns the CUDA error
// of the launches (0 on success).
extern "C" int drone_bsp_spmv(const void* tiles, const void* tile_src,
                              const void* chunk_ptr, const void* chunk_row,
                              const void* chunk_slot, int n_chunks,
                              const void* split_row, const void* split_ptr,
                              int n_split, const void* vals, void* out,
                              void* scratch, int K, int dtype, int semiring,
                              void* stream) {
  if (K <= 0 || (n_chunks <= 0 && n_split <= 0)) {
    return static_cast<int>(cudaSuccess);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* ts = static_cast<const int32_t*>(tile_src);
  const auto* cp = static_cast<const int32_t*>(chunk_ptr);
  const auto* cr = static_cast<const int32_t*>(chunk_row);
  const auto* cs = static_cast<const int32_t*>(chunk_slot);
  const auto* sr = static_cast<const int32_t*>(split_row);
  const auto* sp = static_cast<const int32_t*>(split_ptr);
  cudaError_t err;
  if (dtype == 0 && semiring == 0) {
    err = launch<float, true>(tiles, ts, cp, cr, cs, n_chunks, sr, sp,
                              n_split, vals, out, scratch, K, s);
  } else if (dtype == 0 && semiring == 1) {
    err = launch<float, false>(tiles, ts, cp, cr, cs, n_chunks, sr, sp,
                               n_split, vals, out, scratch, K, s);
  } else if (dtype == 1 && semiring == 1) {
    err = launch<int32_t, false>(tiles, ts, cp, cr, cs, n_chunks, sr, sp,
                                 n_split, vals, out, scratch, K, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
