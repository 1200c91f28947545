// Windowed segment combine for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `segment_combine_windowed`
// (src/repro/kernels/segment_combine.py, body `_kernel`). Edge messages are
// laid out in blocks of Be edges; every block lies inside one 128-row
// destination window and blocks ascend by window.
//
//   out[w, r] = (+)_{blocks b of window w} (+)_{e in b: ldst[e] == r} msgs[e]
//
//   sum (float32) | min, max (float32, int32)
//
// Bound on the H100: memory. Every staged byte is used once: B * Be * (K+1)
// * 4 bytes in, n_windows * 128 * K * 4 out, and about one combine per
// message.
//
// Design.
// - Work split (chunked.cuh): a chunk plan cuts the window-sorted block
//   list into chunks of at most `cap` blocks of one window, one CTA each
//   (and per group of KG payload lanes). A window of thousands of blocks
//   (the JAX layout puts every padding block on a partition's last window)
//   spreads over many CTAs; its partials are folded in chunk order by the
//   second pass, so `sum` is the same bits on every launch.
// - Staging: the chunk's edges are one contiguous range. Thread 0 streams it
//   in stages of S edges (the `ldst` slice and the `msgs` slice, two 1-D
//   bulk async copies per stage) through a ring of NSTAGE buffers in dynamic
//   shared memory, each completed on its mbarrier, so NSTAGE - 1 stages load
//   while one is reduced. Bulk copies (not cp.async) because both slices are
//   contiguous: one instruction moves a whole slice without registers.
// - O(edges) reduction: each warp takes 32 consecutive staged edges at a
//   time, finds the runs of equal `ldst` (real edges ascend by row inside a
//   window), reduces each run with a fixed-shape segmented shuffle scan and
//   folds the run's total into the warp's own accumulator rows in shared
//   memory. Runs of one row that meet in the same 32 edges (the identity
//   slots with `ldst` 0 that end a window's last block, or any unsorted
//   input) are folded one after another in lane order, so nothing relies on
//   the sort for being right. At the end the four warps' rows are combined
//   in warp order and written once. No atomics anywhere: `sum` is
//   deterministic and `min` / `max` are exact.
#include "chunked.cuh"

namespace {

using namespace drone;

constexpr int NT = 128;           // threads per CTA; thread t owns row t last
constexpr int NWARP = NT / 32;
constexpr int NSTAGE = 3;         // ring depth
constexpr int KG = 8;             // payload lanes per CTA
constexpr int STAGE_BYTES = 4096; // target bytes per stage

static_assert(NT == kRows, "the epilogue gives one thread per output row");

// edges per stage: about STAGE_BYTES of (ldst + msgs), a multiple of 4 so
// that every slice stays 16-byte aligned
inline int stage_edges(int K, int elem) {
  const int s = STAGE_BYTES / ((K + 1) * elem);
  return s >= 4 ? s & ~3 : 4;
}

template <typename T, int OP>
__global__ void __launch_bounds__(NT)
segment_combine_chunks(const T* __restrict__ msgs,
                       const int32_t* __restrict__ ldst,
                       const int32_t* __restrict__ chunk_ptr,
                       const int32_t* __restrict__ chunk_row,
                       const int32_t* __restrict__ chunk_slot,
                       T* __restrict__ out, T* __restrict__ scratch, int Be,
                       int K, int S) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int k0 = blockIdx.y * KG;
  const int kg = min(KG, K - k0);   // live payload lanes of this CTA
  const int kgm = min(KG, K);       // accumulator lanes (layout)
  const T ident = identity<T, OP>();

  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
  T* acc = reinterpret_cast<T*>(smem + 64);   // [NWARP][kRows][kgm]
  unsigned char* ring = smem + 64 + NWARP * kRows * kgm * sizeof(T);
  const size_t stage_bytes = static_cast<size_t>(S) * (4 + K * sizeof(T));

  const int c = blockIdx.x;
  const size_t e_beg = static_cast<size_t>(chunk_ptr[c]) * Be;
  const int n_edges = (chunk_ptr[c + 1] - chunk_ptr[c]) * Be;
  const int n_st = (n_edges + S - 1) / S;

  auto st_dst = [&](int b) {
    return reinterpret_cast<int32_t*>(ring + b * stage_bytes);
  };
  auto st_msg = [&](int b) {
    return reinterpret_cast<T*>(ring + b * stage_bytes + S * 4);
  };
  auto load_stage = [&](int i) {
    const int b = i % NSTAGE;
    const int n = min(S, n_edges - i * S);
    const size_t e = e_beg + static_cast<size_t>(i) * S;
    const uint32_t nd = n * 4;
    const uint32_t nm = n * K * sizeof(T);
    mbar_expect_tx(&bar[b], nd + nm);
    bulk_load(st_dst(b), ldst + e, nd, &bar[b]);
    bulk_load(st_msg(b), msgs + e * K, nm, &bar[b]);
  };
  // the first stages load while the accumulators are initialized
  if (tid == 0) {
    for (int b = 0; b < NSTAGE; ++b) mbar_init(&bar[b], 1);
    mbar_fence_init();
    for (int i = 0; i < min(NSTAGE, n_st); ++i) load_stage(i);
  }
  for (int i = tid; i < NWARP * kRows * kgm; i += NT) acc[i] = ident;
  __syncthreads();

  T* my_acc = acc + warp * kRows * kgm;
  for (int i = 0; i < n_st; ++i) {
    const int b = i % NSTAGE;
    mbar_wait(&bar[b], (i / NSTAGE) & 1);
    const int n = min(S, n_edges - i * S);
    const int32_t* sd = st_dst(b);
    const T* sm = st_msg(b);
    for (int g = warp * 32; g < n; g += NWARP * 32) {
      const int e = g + lane;
      const bool valid = e < n;
      const int r = valid ? sd[e] : -1;
      const int r_prev = __shfl_up_sync(kFull, r, 1);
      const int r_next = __shfl_down_sync(kFull, r, 1);
      const bool head = lane == 0 || r_prev != r;
      const bool tail = (lane == 31 || r_next != r) && r >= 0;
      const unsigned heads = __ballot_sync(kFull, head);
      const int start = 31 - __clz(heads & (kFull >> (31 - lane)));
      // Rows that never descend in these 32 edges have one run each.
      // Otherwise (a window's identity tail on row 0, unsorted input) the
      // tails of one row are folded in lane order, one round each.
      int rank = 0;
      int rounds = 1;
      if (__any_sync(kFull, valid && r < r_prev && lane > 0)) {
        const unsigned peers =
            __match_any_sync(kFull, r) & __ballot_sync(kFull, tail);
        rank = __popc(peers & ((1u << lane) - 1u));
        rounds = __reduce_max_sync(kFull, tail ? rank + 1 : 0);
      }
      for (int kk = 0; kk < kg; ++kk) {
        T v = valid ? sm[static_cast<size_t>(e) * K + k0 + kk] : ident;
#pragma unroll
        for (int d = 1; d < 32; d <<= 1) {
          const T u = __shfl_up_sync(kFull, v, d);
          if (lane - d >= start) v = combine<T, OP>(u, v);
        }
        for (int q = 0; q < rounds; ++q) {
          if (tail && rank == q) {
            T* a = my_acc + r * kgm + kk;
            *a = combine<T, OP>(*a, v);
          }
          __syncwarp();
        }
      }
    }
    __syncthreads();  // every warp is done with buffer b
    if (tid == 0 && i + NSTAGE < n_st) load_stage(i + NSTAGE);
  }

  const int row = tid;
  const int slot = chunk_slot[c];
  T* dst = slot < 0
               ? out + (static_cast<size_t>(chunk_row[c]) * kRows + row) * K
               : scratch + (static_cast<size_t>(slot) * kRows + row) * K;
  for (int kk = 0; kk < kg; ++kk) {
    T v = acc[row * kgm + kk];
#pragma unroll
    for (int w = 1; w < NWARP; ++w) {
      v = combine<T, OP>(v, acc[(w * kRows + row) * kgm + kk]);
    }
    dst[k0 + kk] = v;
  }
}

template <typename T, int OP>
cudaError_t launch(const void* msgs, const void* ldst, const int32_t* cptr,
                   const int32_t* crow, const int32_t* cslot, int n_chunks,
                   const int32_t* srow, const int32_t* sptr, int n_split,
                   void* out, void* scratch, int Be, int K,
                   cudaStream_t stream) {
  static int allowed = 0;
  const int S = stage_edges(K, sizeof(T));
  const int kgm = K < KG ? K : KG;
  const int smem = 64 + NWARP * kRows * kgm * static_cast<int>(sizeof(T)) +
                   NSTAGE * S * (4 + K * static_cast<int>(sizeof(T)));
  cudaError_t err = allow_smem(segment_combine_chunks<T, OP>, smem, allowed);
  if (err != cudaSuccess) return err;
  if (n_chunks > 0) {
    const dim3 grid(n_chunks, (K + KG - 1) / KG);
    segment_combine_chunks<T, OP><<<grid, NT, smem, stream>>>(
        static_cast<const T*>(msgs), static_cast<const int32_t*>(ldst), cptr,
        crow, cslot, static_cast<T*>(out), static_cast<T*>(scratch), Be, K,
        S);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return launch_combine_partials<T, OP>(static_cast<const T*>(scratch), srow,
                                        sptr, static_cast<T*>(out), n_split,
                                        K, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = int32. combiner: 0 = sum, 1 = min, 2 = max.
// Be must be a multiple of 4 and msgs / ldst 16-byte aligned (the wrapper
// checks). Returns the CUDA error of the launches (0 on success).
extern "C" int drone_segment_combine(
    const void* msgs, const void* ldst, const void* chunk_ptr,
    const void* chunk_row, const void* chunk_slot, int n_chunks,
    const void* split_row, const void* split_ptr, int n_split, void* out,
    void* scratch, int Be, int K, int dtype, int combiner, void* stream) {
  if (K <= 0 || (n_chunks <= 0 && n_split <= 0)) {
    return static_cast<int>(cudaSuccess);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* cp = static_cast<const int32_t*>(chunk_ptr);
  const auto* cr = static_cast<const int32_t*>(chunk_row);
  const auto* cs = static_cast<const int32_t*>(chunk_slot);
  const auto* sr = static_cast<const int32_t*>(split_row);
  const auto* sp = static_cast<const int32_t*>(split_ptr);
  cudaError_t err;
  if (dtype == 0 && combiner == kSum) {
    err = launch<float, kSum>(msgs, ldst, cp, cr, cs, n_chunks, sr, sp,
                              n_split, out, scratch, Be, K, s);
  } else if (dtype == 0 && combiner == kMin) {
    err = launch<float, kMin>(msgs, ldst, cp, cr, cs, n_chunks, sr, sp,
                              n_split, out, scratch, Be, K, s);
  } else if (dtype == 0 && combiner == kMax) {
    err = launch<float, kMax>(msgs, ldst, cp, cr, cs, n_chunks, sr, sp,
                              n_split, out, scratch, Be, K, s);
  } else if (dtype == 1 && combiner == kMin) {
    err = launch<int32_t, kMin>(msgs, ldst, cp, cr, cs, n_chunks, sr, sp,
                                n_split, out, scratch, Be, K, s);
  } else if (dtype == 1 && combiner == kMax) {
    err = launch<int32_t, kMax>(msgs, ldst, cp, cr, cs, n_chunks, sr, sp,
                                n_split, out, scratch, Be, K, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
