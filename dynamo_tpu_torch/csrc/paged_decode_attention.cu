// Paged decode attention for Hopper (sm_90a): one query token per lane
// over the lane's paged KV cache, split over the table's columns
// ("flash-decoding") and merged by a second kernel.
//
// Replaces `_decode_kernel` in dynamo_tpu/ops/pallas/attention.py
// (called through `paged_decode_attention_pallas`). Contract:
//   q            [B, H, D]            one query row per lane
//   k/v          [num_slots, kvH, D]  paged cache (q's dtype)
//   block_tables [B, max_blocks] int32, the lane's pages; in the striped
//                kv_sp scan the shard's LOCAL compacted stripe
//   context_lens [B] int32            keys of the lane (0 = idle lane)
//   page_offset  [1] int32 on the card (null = 0): the shard's residue
//   page_stride  1, or sp: local page j is logical page off + j*stride
// Lane b's query sits at position ctx - 1 and attends to key positions
// p < ctx (with a window: p >= ctx - window) on the pages the table
// lists. An idle lane writes zeros. With stats the output is f32 and
// m, l [B, H] hold each head's running max and softmax denominator
// (m = -1e30, l = 0 where nothing was seen) for the cross-shard merge.
//
// Bound on this card: the K/V bytes of each lane's visible pages (G = 4
// query vectors per key at llama3.2-1b: ~1 flop per byte, so tensor
// cores buy nothing and the math stays on CUDA cores in f32 for both
// dtypes). A decode batch has only B x kvH (lane, kv head) pairs, 32 at
// 4 lanes against 132 SMs, so the design splits the keys:
// - split_kernel, grid (split x head group, lane, kv head). Split s owns
//   table columns [s*P, (s+1)*P) and is exactly the plain version over
//   those columns with page_offset + s*P*stride and stats: it writes
//   (out_s f32 normalized, m_s, l_s) to the wrapper's scratch. Splits
//   past the context or wholly behind the window write m = -1e30, l = 0
//   and exit. The wrapper's decode_split_plan picks S and P from host
//   shapes alone (never from context_lens, which lies on the card).
// - The split's body is the core shared with the ragged kernel
//   (paged_split.cuh split_block: cp.async ring of 32-key chunks, warp
//   per head in the score pass, thread per (head, d pair) in P.V); at
//   G = 4, D = 64 every thread of the block works in both passes.
// - merge_kernel combines the splits by the logsumexp law of
//   ops/attention.py merge_stats (splits with l = 0 weigh 0) and writes
//   q's dtype, or f32 out plus the merged (m, l). With one split the
//   split kernel writes the output itself and no merge runs.
// A block takes up to 8 query heads of its kv head; more heads take more
// head groups in grid.x.

#include "paged_split.cuh"

namespace {

using namespace paged_split;

constexpr int kHeads = 8;              // query heads per block (head group)

template <typename T>
using DecodeArgs = SplitArgs<T, T>;

// Lane b is a span of one row (row b of q/out and of the partials) at
// position ctx - 1 with keys < ctx; its G heads are vector groups of kHeads.
template <typename T>
__global__ void __launch_bounds__(kThreads) split_kernel(const DecodeArgs<T> a,
                                                         const int* __restrict__ block_tables,
                                                         const int* __restrict__ context_lens,
                                                         const int* __restrict__ page_offset) {
  const int s = blockIdx.x / a.vec_groups;
  const int hg = blockIdx.x - s * a.vec_groups;
  const int b = blockIdx.y;
  const int ctx = context_lens[b];
  const SplitSpan sp{b, b, 1, ctx - 1, ctx, page_offset != nullptr ? page_offset[0] : 0,
                     block_tables + (size_t)b * a.max_blocks};
  split_block<T, T, kHeads, false>(a, sp, s, hg, blockIdx.z);
}

// One thread per (lane, head, d): the splits' partials merged by
// merge_parts.
template <typename T>
__global__ void __launch_bounds__(kThreads) merge_kernel(const DecodeArgs<T> a) {
  const int b = blockIdx.y;
  const int e = blockIdx.x * kThreads + threadIdx.x;
  if (e >= a.H * a.D) return;
  const int head = e / a.D;
  const int d = e - head * a.D;
  const int S = a.num_splits;
  const size_t bh = (size_t)b * a.H + head;
  const Merged r = merge_parts(a.part_m + bh * S, a.part_l + bh * S,
                               a.part_o + bh * S * a.D + d, S, a.D);
  if (a.m_out != nullptr) {
    static_cast<float*>(a.out)[bh * a.D + d] = r.o;
    if (d == 0) {
      a.m_out[bh] = r.m;
      a.l_out[bh] = r.l;
    }
  } else {
    static_cast<T*>(a.out)[bh * a.D + d] = from_f<T>(r.o);
  }
}

template <typename T>
cudaError_t run(const DecodeArgs<T>& a, const int* tables, const int* ctx, const int* off,
                int B, cudaStream_t st) {
  const size_t smem = split_smem_bytes<T, kHeads>(a.D);
  cudaError_t err = set_smem(split_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  if (B == 0) return cudaSuccess;
  const dim3 grid(a.num_splits * a.vec_groups, B, a.kvH);
  split_kernel<T><<<grid, kThreads, smem, st>>>(a, tables, ctx, off);
  err = cudaGetLastError();
  if (err != cudaSuccess || a.num_splits == 1) return err;
  const dim3 mgrid((a.H * a.D + kThreads - 1) / kThreads, B);
  merge_kernel<T><<<mgrid, kThreads, 0, st>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches the split kernel and, with more than one split, the merge
// kernel on `stream`; returns cudaGetLastError() (0 = ok). dtype: 0 =
// float32, 1 = bfloat16 (q and caches). m_out/l_out non-null = with
// stats, and then out is float32. part_* are the wrapper's scratch
// ([B, H, S, D] f32 and [B, H, S] twice), unused with one split.
int paged_decode_attention(const void* q, const void* k_cache, const void* v_cache, void* out,
                           void* m_out, void* l_out, void* part_o, void* part_m, void* part_l,
                           const void* block_tables, const void* context_lens,
                           const void* page_offset, int B, int H, int kvH, int D, int max_blocks,
                           int block_size, int window, int page_stride, int num_splits,
                           int pages_per_split, int dtype, void* stream) {
  if (!paged::head_dim_ok(D, H, kvH) || page_stride < 1 || block_size < 1 || max_blocks < 1)
    return cudaErrorInvalidValue;
  if ((m_out == nullptr) != (l_out == nullptr)) return cudaErrorInvalidValue;
  if (num_splits < 1 || pages_per_split < 1 ||
      (long long)num_splits * pages_per_split < max_blocks)
    return cudaErrorInvalidValue;
  if (num_splits > 1 && (part_o == nullptr || part_m == nullptr || part_l == nullptr))
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int G = H / kvH;
  const int head_groups = (G + kHeads - 1) / kHeads;
  const float scale = 1.0f / sqrtf((float)D);
  auto args = [&](auto* tag) {
    using T = std::remove_pointer_t<decltype(tag)>;
    return DecodeArgs<T>{static_cast<const T*>(q), static_cast<const T*>(k_cache),
                         static_cast<const T*>(v_cache), nullptr, nullptr, out,
                         static_cast<float*>(m_out), static_cast<float*>(l_out),
                         static_cast<float*>(part_o), static_cast<float*>(part_m),
                         static_cast<float*>(part_l), H, kvH, D, max_blocks, block_size,
                         window, page_stride, num_splits, pages_per_split, head_groups, scale};
  };
  const int* tb = static_cast<const int*>(block_tables);
  const int* cl = static_cast<const int*>(context_lens);
  const int* po = static_cast<const int*>(page_offset);
  cudaError_t err;
  if (dtype == 1) {
    err = run(args(static_cast<__nv_bfloat16*>(nullptr)), tb, cl, po, B, st);
  } else if (dtype == 0) {
    err = run(args(static_cast<float*>(nullptr)), tb, cl, po, B, st);
  } else {
    err = cudaErrorInvalidValue;
  }
  return (int)err;
}

const char* paged_decode_attention_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
