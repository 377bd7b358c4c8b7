// Ragged paged attention for Hopper (sm_90a): a flat mixed prefill +
// decode token batch, each span routed on the card by its row count.
//
// Replaces `_ragged_kernel` in dynamo_tpu/ops/pallas/ragged_attention.py
// (called through `ragged_paged_attention_pallas`), both legs. Contract:
//   q        [T, H, D]              flat token batch (budget-padded)
//   k/v      [num_slots, kvH, D]    paged cache, slot = page*bs + offset,
//                                   in q's dtype or int8
//   k/v_scales [num_blocks, kvH] f32  per-(block, kv head) scales of an
//                                   int8 cache (the int8 leg only)
//   block_tables [S, max_blocks] int32, and per span s (int32 [S]):
//   q_start  global position of the span's first row (cached prefix)
//   q_len    rows in the span (0 = idle metadata row)
//   kv_len   context after this step's KV writes (= q_start + q_len)
//   row_start the span's first row in the flat batch
// Row r = row_start[s] + i sits at position q_start[s] + i and attends to
// keys p <= its position, p < kv_len[s] and, with a window, p > position
// - window. Rows that no span owns are written as zeros. Scores scale by
// 1/sqrt(D) at the true D; the softmax is online in f32; windowed spans
// skip whole pages behind the window.
//
// Bound on this card: the K/V bytes each span reads (an int8 cache moves
// half the bytes of bf16). At the families' shapes that is 0.0312 ms for
// mistral-7b's mixed batch (4 decode spans over ~4096-key windows and
// prefill spans of 64 and 96 rows, (H, kvH, D) = (32, 8, 128)) and
// 0.00156 ms for gemma3-1b's ((4, 1, 256), window 512). A serving batch
// mixes spans of two kinds, and each kind needs its own design to come
// near that bound; the host knows only shapes (T, S, max_blocks, heads,
// D, block size, window, SM count), never q_len, which lies on the card,
// so every launch follows from those and each block finds its role from
// q_len on the card:
// - Longer spans, bf16 q: the tensor-core tile of paged_attention_tc.cuh
//   (128 query vectors of one kv head, a cp.async ring of K/V chunks),
//   over the span's rows only: the rows past q_len belong to the next
//   span and are neither read nor written. Grid (tile slot, kv head, key
//   range); block j finds its (span, tile) by a warp scan over the
//   spans' tile counts, each span's heaviest (last) tile first. The
//   slots cover any q_len: sum over spans of ceil(q_len*G/128) <=
//   ceil(T*G/128) + the spans that can hold more than split_rows rows.
//   At D = 64, 128 and 256 its products run on wgmma (two warpgroups of
//   64 vectors; K and V in 128-byte swizzled atoms); else mma.sync.
// - Key ranges. A long span over a long window leaves few tiles (gemma:
//   8 at T = 256, one kv head; mistral: 40 over 8 kv heads) on 132 SMs,
//   each walking ~65 chunks alone. The wrapper's ragged_tile_plan (host
//   shapes only) cuts each tile's visible columns into balanced runs,
//   one block each, until the blocks fill a wave (one range where the
//   grid already fills the card, as at llama3.2-1b's rungs); each range
//   writes f32 partials (o, m, l) to the wrapper's scratch [T, H,
//   ranges, D + 2], which the merge pass combines.
// - Short spans, 1 <= q_len <= split_rows (decode lanes, short
//   spec-verify spans): split-KV. Grid (split x vector group, span, kv
//   head); split s owns the s-th of num_splits balanced runs of the
//   columns its rows can see, from the first column inside their window
//   (so no split lies behind the window or past the context), with
//   num_splits from the wrapper's ragged_split_plan over the columns a
//   windowed span can see, not the table's width. bf16 q at D = 64, 128
//   and 256: a one-warpgroup tile (64 query vectors: split_rows x G) on
//   the wgmma entry, 1-4 blocks an SM; else paged_split.cuh (the decode
//   kernel's core) on CUDA cores. Partials go to the wrapper's scratch
//   [S, split_rows, H, splits, D + 2] f32, or, with one split, straight
//   to out.
// - Longer spans, bf16 q, head dims past 256 (MLA's one 576-wide
//   latent head for 16 query heads): the wide tile of
//   paged_attention_wide.cuh (16 query vectors a block, scores, P and
//   the P.V columns split over its 4 warps), picked by the same scan.
// - Longer spans, f32 q: the CUDA-core walk attend_tile
//   (paged_attention.cuh), grid (query tile, span, kv head): a float32
//   product on tensor cores would be TF32 and miss the 1e-4 tolerance
//   (at D = 576: 18 dims a lane, one query vector a warp).
// - Head dims past 256 also take the split path's wide instantiation
//   (72 accumulators a thread, a shallower ring, one block per SM).
// - int8 caches take the same paths with the scales folded into the f32
//   side of the products (S = (q.k_int) k_s, O += (P v_s) v_int): the
//   tiles convert int8 pages to bf16 unscaled, which is exact, and
//   paged_split.cuh dequantizes in registers.
// - A merge pass, grid (row, group of 256 (head, d) elements): the
//   block's threads find the row's owner by scanning the spans between
//   them, then each merges one element of a row from its splits or key
//   ranges by the logsumexp law of ops/attention.py merge_stats, or
//   writes a zero in a row no span owns. One element per thread: the
//   merge is a chain of dependent loads over the splits, so it is spread
//   as wide as it goes.
// Launches per call: 3. The split kernel runs on a second stream beside
// the tile (bf16) or the walk (f32) on `stream`, forked and joined by
// events, since each alone is latency-bound and leaves most SMs idle;
// the merge pass follows both on `stream`. The kernels keep their own
// block shapes (256-thread tiles, 128-thread splits), which one launch
// assigning both roles by blockIdx would have to share.
// Not done, and not tried on the card: TMA staging by a producer warp
// (a page's box would also load the keys past the context or behind the
// window that the cp.async ring zero-fills key by key, so V's rows there
// would need masking in shared memory; an argument, not a measurement);
// overlapping a chunk's softmax with the next chunk's products (each
// wgmma group is waited on at once); int8 pages converted in registers
// on the A side (they pass through a bf16 chunk in shared memory, since
// wgmma's B comes from shared memory); the merge folded into the last
// block to arrive.

#include <algorithm>
#include <climits>
#include <mutex>
#include <type_traits>

#include "paged_attention.cuh"
#include "paged_attention_tc.cuh"
#include "paged_attention_wide.cuh"
#include "paged_split.cuh"

namespace {

using paged::from_f;
using paged_split::SplitArgs;
using paged_split::SplitSpan;
using paged_tc::TileArgs;
using paged_tc::TileSpan;
using bf16 = __nv_bfloat16;

constexpr int kSplitVecs = 16;     // query vectors per split block
constexpr int kMergeThreads = 256;

struct SpanMeta {
  const int* tables;
  const int* q_start;
  const int* q_len;
  const int* kv_len;
  const int* row_start;
  int S, max_blocks, split_rows;
};

// Warp 0 scans the spans' tile counts (ceil(q_len * G / kTileM) for each
// span of more than split_rows rows), 32 spans a step, for the span whose
// tiles hold slot blockIdx.x; each lane reads its span's metadata at
// once, so the pick costs one round of loads. pick = (span or -1, tile
// counted from its last, row_start, q_len, q_start, kv_len).
template <int kTileM>
__device__ __forceinline__ void pick_tile(const SpanMeta& m, int G, int* pick) {
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    const int j = blockIdx.x;
    int base = 0;
    bool found = false;
    for (int s0 = 0; s0 < m.S && !found; s0 += 32) {
      const int s = s0 + lane;
      int n = 0, ql = 0, rs = 0, q0 = 0, kv = 0;
      if (s < m.S) {
        ql = m.q_len[s];
        rs = m.row_start[s];
        q0 = m.q_start[s];
        kv = m.kv_len[s];
        n = ql > m.split_rows ? (ql * G + kTileM - 1) / kTileM : 0;
      }
      int inc = n;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, inc, o);
        if (lane >= o) inc += y;
      }
      const int first = base + inc - n;
      const bool mine = j >= first && j < first + n;
      found = __ballot_sync(0xffffffffu, mine) != 0;
      if (mine) {   // one lane at most
        pick[0] = s;
        pick[1] = j - first;
        pick[2] = rs;
        pick[3] = ql;
        pick[4] = q0;
        pick[5] = kv;
      }
      base += __shfl_sync(0xffffffffu, inc, 31);
    }
    if (lane == 0 && !found) pick[0] = -1;
  }
  __syncthreads();
}

// -- multi-row spans, bf16 q: the tensor-core tile --------------------------
template <typename C, int DP, bool kWg>
__global__ void __launch_bounds__(paged_tc::kThreads, DP <= 64 ? 2 : 1)
ragged_tc_kernel(const TileArgs<C> a, const SpanMeta m) {
  constexpr int kM = paged_tc::kM;
  __shared__ int pick[6];
  const int G = a.H / a.kvH;
  pick_tile<kM>(m, G, pick);
  const int s = pick[0];
  if (s < 0) return;   // a slot past every span's tiles
  const int ql = pick[3];
  const int ntiles = (ql * G + kM - 1) / kM;
  const TileSpan sp{pick[2], ql, pick[4], pick[5], 0, m.tables + (size_t)s * m.max_blocks,
                    pick[2]};
  paged_tc::tc_tile<C, DP, kWg>(a, sp, blockIdx.y, (ntiles - 1 - pick[1]) * kM, blockIdx.z);
}

// -- multi-row spans, bf16 q, head dims past 256: the wide tile -------------
template <typename C>
__global__ void __launch_bounds__(paged_wide::kThreads, 1)
ragged_wide_kernel(const TileArgs<C> a, const SpanMeta m) {
  constexpr int kM = paged_wide::kM;
  __shared__ int pick[6];
  const int G = a.H / a.kvH;
  pick_tile<kM>(m, G, pick);
  const int s = pick[0];
  if (s < 0) return;
  const int ql = pick[3];
  const int ntiles = (ql * G + kM - 1) / kM;
  const TileSpan sp{pick[2], ql, pick[4], pick[5], 0, m.tables + (size_t)s * m.max_blocks,
                    pick[2]};
  paged_wide::wide_tile<C>(a, sp, blockIdx.y, (ntiles - 1 - pick[1]) * kM);
}

// -- multi-row spans, f32 q: the walk ---------------------------------------
template <typename C, int DPL>
__global__ void __launch_bounds__(paged::kThreads)
ragged_walk_kernel(paged::Call<float, C> a, const SpanMeta m) {
  const int s = blockIdx.y;
  const int ql = m.q_len[s];
  if (ql <= m.split_rows) return;   // the split path's span
  const paged::Span sp{m.row_start[s], ql, m.q_start[s], m.kv_len[s],
                       m.tables + (size_t)s * m.max_blocks, m.max_blocks};
  paged::attend_tile<float, C, DPL>(a, sp, blockIdx.z, 0);
}

// -- short spans: split-KV ----------------------------------------------------
// At most 128 registers a thread, so 4 blocks share an SM: the plan aims
// for 4 blocks per SM (ragged_split_plan). kWide (head dims past 256):
// one block per SM, its accumulators and shared memory being 4 times as
// large.
template <typename T, typename C, bool kWide>
__global__ void __launch_bounds__(paged_split::kThreads, kWide ? 1 : 4)
ragged_split_kernel(const SplitArgs<T, C> a, const SpanMeta m) {
  const int span = blockIdx.y;
  const int ql = m.q_len[span];
  if (ql <= 0 || ql > m.split_rows) return;   // idle, or the tile's span
  const int s = blockIdx.x / a.vec_groups;
  const int vg = blockIdx.x - s * a.vec_groups;
  const SplitSpan sp{m.row_start[span], span * m.split_rows, ql, m.q_start[span],
                     m.kv_len[span], 0, m.tables + (size_t)span * m.max_blocks};
  paged_split::split_block<T, C, kSplitVecs, true, kWide, true>(a, sp, s, vg, blockIdx.z);
}

// -- short spans, bf16 q at D = 64, 128, 256: split-KV on the wgmma tile ---
// One warpgroup's tile (64 query vectors: a short span's split_rows x G,
// in vector groups of 64) over split s's balanced run of the columns its
// rows can see, the run paged_split.cuh's ragged splits take; partials to
// the split path's scratch rows span * split_rows + i, or with one split
// the output rows themselves.
template <typename C, int DP>
__global__ void __launch_bounds__(128, DP <= 64 ? 4 : 2)
ragged_tc_split_kernel(const TileArgs<C> a, const SpanMeta m, int vec_groups) {
  const int span = blockIdx.y;
  const int ql = m.q_len[span];
  if (ql <= 0 || ql > m.split_rows) return;   // idle, or the tile's span
  const int s = blockIdx.x / vec_groups;
  const int vg = blockIdx.x - s * vec_groups;
  const int rs = m.row_start[span];
  const TileSpan sp{rs, ql, m.q_start[span], m.kv_len[span], 0,
                    m.tables + (size_t)span * m.max_blocks,
                    a.ranges > 1 ? span * m.split_rows : rs};
  paged_tc::tc_tile<C, DP, true, 4>(a, sp, blockIdx.z, vg * 64, s);
}

// The scratch of both paths' partials: the split path's [S, split_rows,
// H, splits] (o with D more), and the tile's [rows, H, ranges] when it
// cuts its keys into ranges.
struct Parts {
  float *o, *m, *l;
  float *tile_o, *tile_m, *tile_l;
  int ranges;
};

// -- the merge pass -----------------------------------------------------------
// Block (row r, element group): its threads find r's owner among the spans
// (atomicMin in shared memory, so the first owner wins, as the plain
// version's argmax); then each thread merges one (head, d) element of a
// short span's row from its splits or of a longer span's row from its
// tile's key ranges, writes a zero in a row no span owns, or leaves a
// row that its span's path has written.
template <typename T>
__global__ void __launch_bounds__(kMergeThreads)
ragged_merge_kernel(T* __restrict__ out, const Parts pt, const SpanMeta m, int H, int D,
                    int num_splits) {
  __shared__ int owner;
  const int r = blockIdx.x;
  if (threadIdx.x == 0) owner = INT_MAX;
  __syncthreads();
  for (int s = threadIdx.x; s < m.S; s += kMergeThreads) {
    const int ql = m.q_len[s];
    const int rs = m.row_start[s];
    if (ql > 0 && r >= rs && r < rs + ql) atomicMin(&owner, s);
  }
  __syncthreads();
  const int s = owner;
  const int e = blockIdx.y * kMergeThreads + threadIdx.x;
  if (e >= H * D) return;
  T* o = out + (size_t)r * H * D + e;
  if (s == INT_MAX) {
    *o = from_f<T>(0.f);
    return;
  }
  const int head = e / D;
  if (m.q_len[s] > m.split_rows) {
    if (pt.ranges == 1) return;
    const size_t ph = ((size_t)r * H + head) * pt.ranges;
    *o = from_f<T>(paged_split::merge_parts(pt.tile_m + ph, pt.tile_l + ph,
                                            pt.tile_o + ph * D + (e - head * D), pt.ranges, D)
                       .o);
    return;
  }
  if (num_splits == 1) return;
  const size_t ph =
      ((size_t)(s * m.split_rows + r - m.row_start[s]) * H + head) * num_splits;
  *o = from_f<T>(paged_split::merge_parts(pt.m + ph, pt.l + ph, pt.o + ph * D + (e - head * D),
                                          num_splits, D)
                     .o);
}

struct Plan {
  int T_rows, num_splits, ranges;
};

// A second stream per device, with the fork and join events, made on
// first use: the split path runs on it beside the tile or the walk, since
// the two kinds of span share nothing until the merge and each alone
// leaves most SMs idle. The fork and join are event waits, which a CUDA
// graph captures as edges. One caller thread per device, as the engine's
// dispatch loop is.
struct Side {
  cudaStream_t stream;
  cudaEvent_t fork, join;
};

cudaError_t side_for_current_device(Side** out) {
  constexpr int kMaxDevices = 64;
  static Side sides[kMaxDevices];
  static std::mutex mu;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  std::lock_guard<std::mutex> lock(mu);
  Side& side = sides[dev];
  if (side.stream == nullptr) {
    Side made{};
    err = cudaStreamCreateWithFlags(&made.stream, cudaStreamNonBlocking);
    if (err == cudaSuccess) err = cudaEventCreateWithFlags(&made.fork, cudaEventDisableTiming);
    if (err == cudaSuccess) err = cudaEventCreateWithFlags(&made.join, cudaEventDisableTiming);
    if (err != cudaSuccess) return err;
    side = made;
  }
  *out = &side;
  return cudaSuccess;
}

// The split kernel at the call's width on `stream`.
template <typename T, typename C, bool kWide>
cudaError_t launch_split(const SplitArgs<T, C>& a, const SpanMeta& m, const Plan& p,
                         cudaStream_t stream) {
  const size_t smem = paged_split::split_smem_bytes<C, kSplitVecs, kWide>(a.D);
  cudaError_t err = paged_split::set_smem(ragged_split_kernel<T, C, kWide>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(p.num_splits * a.vec_groups, m.S, a.kvH);
  ragged_split_kernel<T, C, kWide><<<grid, paged_split::kThreads, smem, stream>>>(a, m);
  return cudaGetLastError();
}

// The wgmma split at the call's width on `stream`.
template <typename C, int DP>
cudaError_t launch_tc_split(const TileArgs<C>& a, const SpanMeta& m, const Plan& p,
                            cudaStream_t stream) {
  const size_t smem = paged_tc::smem_bytes<C, DP, true, 4>(a.D);
  cudaError_t err = paged_tc::set_tile_smem(ragged_tc_split_kernel<C, DP>, smem);
  if (err != cudaSuccess) return err;
  const int vec_groups = (m.split_rows * (a.H / a.kvH) + 63) / 64;
  const dim3 grid(p.num_splits * vec_groups, m.S, a.kvH);
  ragged_tc_split_kernel<C, DP><<<grid, 128, smem, stream>>>(a, m, vec_groups);
  return cudaGetLastError();
}

// The paged_split.cuh split at the call's width on `stream`.
template <typename T, typename C>
cudaError_t launch_split_any(const SplitArgs<T, C>& a, const SpanMeta& m, const Plan& p,
                             cudaStream_t stream) {
  return a.D > paged::kMaxHeadDim ? launch_split<T, C, true>(a, m, p, stream)
                                  : launch_split<T, C, false>(a, m, p, stream);
}

// `split` (the short spans' kernel) on the side stream, `body` (the tile
// or the walk) on `st`, then, once both are done, the merge pass on `st`.
template <typename T, typename C, typename Split, typename Body>
cudaError_t run_paths(const SplitArgs<T, C>& a, const Parts& pt, const SpanMeta& m,
                      const Plan& p, cudaStream_t st, Split split, Body body) {
  cudaError_t err;
  Side* side = nullptr;
  if (m.S > 0) {
    err = side_for_current_device(&side);
    if (err == cudaSuccess) err = cudaEventRecord(side->fork, st);
    if (err == cudaSuccess) err = cudaStreamWaitEvent(side->stream, side->fork, 0);
    if (err != cudaSuccess) return err;
    err = split(side->stream);
    if (err != cudaSuccess) return err;
  }
  err = body();
  if (err != cudaSuccess) return err;
  if (side != nullptr) {
    err = cudaEventRecord(side->join, side->stream);
    if (err == cudaSuccess) err = cudaStreamWaitEvent(st, side->join, 0);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid(p.T_rows, (a.H * a.D + kMergeThreads - 1) / kMergeThreads);
  ragged_merge_kernel<T><<<grid, kMergeThreads, 0, st>>>(static_cast<T*>(a.out), pt, m, a.H,
                                                         a.D, p.num_splits);
  return cudaGetLastError();
}

template <typename C, int DP, bool kWg = false>
cudaError_t launch_tc(const TileArgs<C>& a, const SpanMeta& m, int T_rows, cudaStream_t st) {
  const size_t smem = paged_tc::smem_bytes<C, DP, kWg>(a.D);
  cudaError_t err = paged_tc::set_tile_smem(ragged_tc_kernel<C, DP, kWg>, smem);
  if (err != cudaSuccess) return err;
  const int G = a.H / a.kvH;
  const int slots = (T_rows * G + paged_tc::kM - 1) / paged_tc::kM +
                    std::min(m.S, T_rows / (m.split_rows + 1));
  if (slots == 0) return cudaSuccess;
  const dim3 grid(slots, a.kvH, std::max(a.ranges, 1));
  ragged_tc_kernel<C, DP, kWg><<<grid, paged_tc::kThreads, smem, st>>>(a, m);
  return cudaGetLastError();
}

template <typename C>
cudaError_t launch_wide(const TileArgs<C>& a, const SpanMeta& m, int T_rows, cudaStream_t st) {
  const size_t smem = paged_wide::smem_bytes<C>(a.D);
  cudaError_t err = paged_tc::set_tile_smem(ragged_wide_kernel<C>, smem);
  if (err != cudaSuccess) return err;
  const int G = a.H / a.kvH;
  const int slots = (T_rows * G + paged_wide::kM - 1) / paged_wide::kM +
                    std::min(m.S, T_rows / (m.split_rows + 1));
  if (slots == 0) return cudaSuccess;
  ragged_wide_kernel<C><<<dim3(slots, a.kvH), paged_wide::kThreads, smem, st>>>(a, m);
  return cudaGetLastError();
}

template <typename C, int DPL>
cudaError_t launch_walk(const paged::Call<float, C>& a, const SpanMeta& m, int T_rows,
                        cudaStream_t st) {
  constexpr int QV = paged::Tile<DPL>::QV;
  const int G = a.H / a.kvH;
  const dim3 grid((T_rows * G + QV - 1) / QV, m.S, a.kvH);
  return paged::launch_tiles<DPL>(ragged_walk_kernel<C, DPL>, grid, a.D, st, a, m);
}

template <typename T, typename C>
SplitArgs<T, C> split_args(const void* q, const void* k, const void* v, const float* ks,
                           const float* vs, void* out, const Parts& pt, const SpanMeta& m,
                           const Plan& p, int H, int kvH, int D, int bs, int window) {
  return SplitArgs<T, C>{static_cast<const T*>(q), static_cast<const C*>(k),
                         static_cast<const C*>(v), ks, vs, out, nullptr, nullptr, pt.o, pt.m,
                         pt.l,
                         H, kvH, D, m.max_blocks, bs, window, 1, p.num_splits, 0,
                         (m.split_rows * (H / kvH) + kSplitVecs - 1) / kSplitVecs,
                         1.0f / sqrtf((float)D)};
}

// bf16 q: the tile (its key ranges' partials in pt.tile_* when it cuts
// its keys) beside the split path, then the merge.
template <typename C>
cudaError_t run_bf16(const void* q, const void* k, const void* v, const float* ks,
                     const float* vs, void* out, const Parts& pt, const SpanMeta& m,
                     const Plan& p, int H, int kvH, int D, int bs, int window, cudaStream_t st) {
  const int bs_log = paged_tc::bs_log2(bs);
  if (bs_log < 0) return cudaErrorInvalidValue;
  const bool cut = p.ranges > 1;
  const TileArgs<C> ta{static_cast<const bf16*>(q), static_cast<const C*>(k),
                       static_cast<const C*>(v), ks, vs, cut ? pt.tile_o : out,
                       cut ? pt.tile_m : nullptr, cut ? pt.tile_l : nullptr, H, kvH, D,
                       m.max_blocks, bs, bs_log, window, 1, 1.0f / sqrtf((float)D), p.ranges};
  // The short spans' splits on the wgmma tile: partials in the split
  // path's scratch, its num_splits runs as the tile's ranges.
  const bool many = p.num_splits > 1;
  const TileArgs<C> sa{static_cast<const bf16*>(q), static_cast<const C*>(k),
                       static_cast<const C*>(v), ks, vs, many ? pt.o : out,
                       many ? pt.m : nullptr, many ? pt.l : nullptr, H, kvH, D,
                       m.max_blocks, bs, bs_log, window, 1, 1.0f / sqrtf((float)D),
                       p.num_splits};
  const SplitArgs<bf16, C> a =
      split_args<bf16, C>(q, k, v, ks, vs, out, pt, m, p, H, kvH, D, bs, window);
  return run_paths(
      a, pt, m, p, st,
      [&](cudaStream_t side) {
        switch (D) {
          case 64: return launch_tc_split<C, 64>(sa, m, p, side);
          case 128: return launch_tc_split<C, 128>(sa, m, p, side);
          case 256: return launch_tc_split<C, 256>(sa, m, p, side);
          default: return launch_split_any(a, m, p, side);
        }
      },
      [&]() {
        if (D > paged::kMaxHeadDim) return launch_wide<C>(ta, m, p.T_rows, st);
        switch (D) {   // the wgmma entry at its head dims, else mma.sync
          case 64: return launch_tc<C, 64, true>(ta, m, p.T_rows, st);
          case 128: return launch_tc<C, 128, true>(ta, m, p.T_rows, st);
          case 256: return launch_tc<C, 256, true>(ta, m, p.T_rows, st);
        }
        switch (paged_tc::dp_for(D)) {
          case 16: return launch_tc<C, 16>(ta, m, p.T_rows, st);
          case 32: return launch_tc<C, 32>(ta, m, p.T_rows, st);
          case 64: return launch_tc<C, 64>(ta, m, p.T_rows, st);
          case 128: return launch_tc<C, 128>(ta, m, p.T_rows, st);
          case 256: return launch_tc<C, 256>(ta, m, p.T_rows, st);
          default: return cudaErrorInvalidValue;
        }
      });
}

// f32 q: the walk beside the split path, then the merge.
template <typename C>
cudaError_t run_f32(const void* q, const void* k, const void* v, const float* ks,
                    const float* vs, void* out, const Parts& pt, const SpanMeta& m,
                    const Plan& p, int H, int kvH, int D, int bs, int window, cudaStream_t st) {
  const paged::Call<float, C> wa{static_cast<const float*>(q), static_cast<const C*>(k),
                                 static_cast<const C*>(v), ks, vs, out, nullptr, nullptr, 0,
                                 H, kvH, D, bs, window, 1, 1.0f / sqrtf((float)D)};
  const SplitArgs<float, C> a =
      split_args<float, C>(q, k, v, ks, vs, out, pt, m, p, H, kvH, D, bs, window);
  return run_paths(
      a, pt, m, p, st, [&](cudaStream_t side) { return launch_split_any(a, m, p, side); },
      [&]() {
        switch (paged::dpl_for(D)) {
          case 1: return launch_walk<C, 1>(wa, m, p.T_rows, st);
          case 2: return launch_walk<C, 2>(wa, m, p.T_rows, st);
          case 4: return launch_walk<C, 4>(wa, m, p.T_rows, st);
          case 8: return launch_walk<C, 8>(wa, m, p.T_rows, st);
          case 18: return launch_walk<C, 18>(wa, m, p.T_rows, st);   // D = 576
          default: return cudaErrorInvalidValue;
        }
      });
}

}  // namespace

extern "C" {

// Launches the three kernels on `stream`; returns cudaGetLastError() (0 =
// ok). dtype: 0 = float32, 1 = bfloat16 (q and out). kv_int8: 0 = the
// caches share q's dtype, 1 = int8 caches with k_scales/v_scales.
// part_* are the wrapper's scratch for the split path ([S, split_rows,
// H, num_splits, D] f32 and [S, split_rows, H, num_splits] twice),
// unused with one split; tile_* the tile's ([T_rows, H, tile_ranges, D]
// and [T_rows, H, tile_ranges] twice), unused with one range (and by
// f32 q and head dims past 256, which take one).
int ragged_paged_attention(const void* q, const void* k_cache, const void* v_cache,
                           const void* k_scales, const void* v_scales, void* out,
                           void* part_o, void* part_m, void* part_l, void* tile_o, void* tile_m,
                           void* tile_l, const void* block_tables, const void* q_start,
                           const void* q_len, const void* kv_len, const void* row_start,
                           int T_rows, int H, int kvH, int D, int S, int max_blocks,
                           int block_size, int window, int num_splits, int tile_ranges,
                           int split_rows, int dtype, int kv_int8, void* stream) {
  if (!paged::ragged_head_dim_ok(D, H, kvH) || block_size < 1 || max_blocks < 1 ||
      split_rows < 1)
    return cudaErrorInvalidValue;
  if (kv_int8 && (k_scales == nullptr || v_scales == nullptr)) return cudaErrorInvalidValue;
  if (num_splits < 1 || tile_ranges < 1) return cudaErrorInvalidValue;
  if (num_splits > 1 && (part_o == nullptr || part_m == nullptr || part_l == nullptr))
    return cudaErrorInvalidValue;
  if (tile_ranges > 1 && (dtype != 1 || D > paged::kMaxHeadDim || tile_o == nullptr ||
                          tile_m == nullptr || tile_l == nullptr))
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* ks = static_cast<const float*>(k_scales);
  const float* vs = static_cast<const float*>(v_scales);
  const Parts pt{static_cast<float*>(part_o), static_cast<float*>(part_m),
                 static_cast<float*>(part_l), static_cast<float*>(tile_o),
                 static_cast<float*>(tile_m), static_cast<float*>(tile_l), tile_ranges};
  const SpanMeta m{static_cast<const int*>(block_tables), static_cast<const int*>(q_start),
                   static_cast<const int*>(q_len), static_cast<const int*>(kv_len),
                   static_cast<const int*>(row_start), S, max_blocks, split_rows};
  const Plan p{T_rows, num_splits, tile_ranges};
  if (T_rows == 0) return cudaSuccess;
  cudaError_t err;
  if (dtype == 1 && !kv_int8) {
    err = run_bf16<bf16>(q, k_cache, v_cache, nullptr, nullptr, out, pt, m, p, H, kvH, D,
                         block_size, window, st);
  } else if (dtype == 1) {
    err = run_bf16<int8_t>(q, k_cache, v_cache, ks, vs, out, pt, m, p, H, kvH, D, block_size,
                           window, st);
  } else if (dtype == 0 && !kv_int8) {
    err = run_f32<float>(q, k_cache, v_cache, nullptr, nullptr, out, pt, m, p, H, kvH, D,
                         block_size, window, st);
  } else if (dtype == 0) {
    err = run_f32<int8_t>(q, k_cache, v_cache, ks, vs, out, pt, m, p, H, kvH, D, block_size,
                          window, st);
  } else {
    err = cudaErrorInvalidValue;
  }
  return (int)err;
}

const char* ragged_paged_attention_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
