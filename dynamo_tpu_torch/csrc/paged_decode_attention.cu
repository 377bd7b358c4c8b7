// Paged decode attention for Hopper (sm_90a): one query token per lane
// over the lane's paged KV cache.
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
// Bound on this card: the K/V bytes of each lane's visible pages. The
// design (paged_attention.cuh): grid (query tile, lane, kv head), the G
// query heads of a kv head folded into one tile, so each page crosses
// HBM once per lane. A decode batch fills lanes x kvH blocks, fewer than
// the card's SMs at small batch; splitting a long context over blocks is
// not done yet.

#include "paged_attention.cuh"

namespace {

using namespace paged;

template <typename T, int DPL>
__global__ void __launch_bounds__(kThreads)
decode_attn_kernel(Call<T, T> a, const int* __restrict__ block_tables,
                   const int* __restrict__ context_lens, const int* __restrict__ page_offset,
                   int max_blocks) {
  const int b = blockIdx.y;
  const int ctx = context_lens[b];
  const Span sp{b, 1, ctx - 1, ctx, block_tables + (size_t)b * max_blocks, max_blocks};
  attend_tile<T, T, DPL>(a, sp, blockIdx.z, page_offset != nullptr ? page_offset[0] : 0);
}

template <typename T, int DPL>
cudaError_t launch(const Call<T, T>& a, const int* tables, const int* ctx, const int* off,
                   int B, int max_blocks, cudaStream_t st) {
  constexpr int QV = Tile<DPL>::QV;
  const int G = a.H / a.kvH;
  const dim3 grid((G + QV - 1) / QV, B, a.kvH);
  return launch_tiles<DPL>(decode_attn_kernel<T, DPL>, grid, a.D, st, a, tables, ctx, off,
                           max_blocks);
}

template <typename T>
cudaError_t run(const Call<T, T>& a, const int* tables, const int* ctx, const int* off, int B,
                int max_blocks, cudaStream_t st) {
  switch (dpl_for(a.D)) {
    case 1: return launch<T, 1>(a, tables, ctx, off, B, max_blocks, st);
    case 2: return launch<T, 2>(a, tables, ctx, off, B, max_blocks, st);
    case 4: return launch<T, 4>(a, tables, ctx, off, B, max_blocks, st);
    case 8: return launch<T, 8>(a, tables, ctx, off, B, max_blocks, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Launches the kernel on `stream`; returns cudaGetLastError() (0 = ok).
// dtype: 0 = float32, 1 = bfloat16 (q and caches). m_out/l_out non-null
// = with stats, and then out is float32.
int paged_decode_attention(const void* q, const void* k_cache, const void* v_cache, void* out,
                           void* m_out, void* l_out, const void* block_tables,
                           const void* context_lens, const void* page_offset, int B, int H,
                           int kvH, int D, int max_blocks, int block_size, int window,
                           int page_stride, int dtype, void* stream) {
  if (!head_dim_ok(D, H, kvH) || page_stride < 1) return cudaErrorInvalidValue;
  if ((m_out == nullptr) != (l_out == nullptr)) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* tb = static_cast<const int*>(block_tables);
  const int* ctx = static_cast<const int*>(context_lens);
  const int* off = static_cast<const int*>(page_offset);
  float* m = static_cast<float*>(m_out);
  float* l = static_cast<float*>(l_out);
  const int out_f32 = m != nullptr;
  const float scale = 1.0f / sqrtf((float)D);
  cudaError_t err;
  if (dtype == 1) {
    using T = __nv_bfloat16;
    const Call<T, T> a{static_cast<const T*>(q), static_cast<const T*>(k_cache),
                       static_cast<const T*>(v_cache), nullptr, nullptr, out, m, l, out_f32,
                       H, kvH, D, block_size, window, page_stride, scale};
    err = run<T>(a, tb, ctx, off, B, max_blocks, st);
  } else if (dtype == 0) {
    const Call<float, float> a{static_cast<const float*>(q), static_cast<const float*>(k_cache),
                               static_cast<const float*>(v_cache), nullptr, nullptr, out, m, l,
                               out_f32, H, kvH, D, block_size, window, page_stride, scale};
    err = run<float>(a, tb, ctx, off, B, max_blocks, st);
  } else {
    err = cudaErrorInvalidValue;
  }
  return (int)err;
}

const char* paged_decode_attention_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
