// Paged prefill attention for Hopper (sm_90a): N lanes' new tokens over
// their cached prefix and themselves.
//
// Replaces `_prefill_kernel` in dynamo_tpu/ops/pallas/attention.py
// (called through `paged_prefill_attention_pallas`). Contract:
//   q            [N, T, H, D]         new tokens' queries per lane
//   k/v          [num_slots, kvH, D]  paged cache (q's dtype), the new
//                                     tokens' K/V already written
//   block_tables [N, max_blocks] int32, or the shard's LOCAL stripe
//   q_start      [N] int32            prefix length per lane
//   total_len    [N] int32            prefix + real new tokens (0 = idle)
//   page_offset / page_stride         the striped kv_sp scan, as in
//                                     paged_decode_attention.cu
// Row t of lane n sits at position q_start + t and attends to key
// positions p <= q_start + t, p < total_len (with a window: p > q_start
// + t - window). A padded row (t >= total_len - q_start) therefore sees
// every key below total_len, as in the TPU kernel; it is not zeroed. An
// idle lane writes zeros. With stats the output is f32 and m, l
// [N, T, H] hold each head's softmax stats for the cross-shard merge.
//
// Bound on this card: the K/V bytes of each lane's visible pages, read
// once per query tile (a tile holds QV/G rows, so long prompts re-read
// their prefix once per tile: bytes, not flops, still bound it at the
// serving shapes). Design in paged_attention.cuh: grid (query tile, lane,
// kv head); the TPU kernel's q_tile is a layout choice of the TPU and is
// replaced by the register tile.

#include "paged_attention.cuh"

namespace {

using namespace paged;

template <typename T, int DPL>
__global__ void __launch_bounds__(kThreads)
prefill_attn_kernel(Call<T, T> a, const int* __restrict__ block_tables,
                    const int* __restrict__ q_start, const int* __restrict__ total_len,
                    const int* __restrict__ page_offset, int T_rows, int max_blocks) {
  const int n = blockIdx.y;
  const Span sp{n * T_rows, T_rows, q_start[n], total_len[n],
                block_tables + (size_t)n * max_blocks, max_blocks};
  attend_tile<T, T, DPL>(a, sp, blockIdx.z, page_offset != nullptr ? page_offset[0] : 0);
}

template <typename T, int DPL>
cudaError_t launch(const Call<T, T>& a, const int* tables, const int* qs, const int* tl,
                   const int* off, int N, int T_rows, int max_blocks, cudaStream_t st) {
  constexpr int QV = Tile<DPL>::QV;
  const int G = a.H / a.kvH;
  const dim3 grid((T_rows * G + QV - 1) / QV, N, a.kvH);
  return launch_tiles<DPL>(prefill_attn_kernel<T, DPL>, grid, a.D, st, a, tables, qs, tl, off,
                           T_rows, max_blocks);
}

template <typename T>
cudaError_t run(const Call<T, T>& a, const int* tables, const int* qs, const int* tl,
                const int* off, int N, int T_rows, int max_blocks, cudaStream_t st) {
  switch (dpl_for(a.D)) {
    case 1: return launch<T, 1>(a, tables, qs, tl, off, N, T_rows, max_blocks, st);
    case 2: return launch<T, 2>(a, tables, qs, tl, off, N, T_rows, max_blocks, st);
    case 4: return launch<T, 4>(a, tables, qs, tl, off, N, T_rows, max_blocks, st);
    case 8: return launch<T, 8>(a, tables, qs, tl, off, N, T_rows, max_blocks, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Launches the kernel on `stream`; returns cudaGetLastError() (0 = ok).
// dtype: 0 = float32, 1 = bfloat16 (q and caches). m_out/l_out non-null
// = with stats, and then out is float32.
int paged_prefill_attention(const void* q, const void* k_cache, const void* v_cache, void* out,
                            void* m_out, void* l_out, const void* block_tables,
                            const void* q_start, const void* total_len, const void* page_offset,
                            int N, int T_rows, int H, int kvH, int D, int max_blocks,
                            int block_size, int window, int page_stride, int dtype,
                            void* stream) {
  if (!head_dim_ok(D, H, kvH) || page_stride < 1) return cudaErrorInvalidValue;
  if ((m_out == nullptr) != (l_out == nullptr)) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* tb = static_cast<const int*>(block_tables);
  const int* qs = static_cast<const int*>(q_start);
  const int* tl = static_cast<const int*>(total_len);
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
    err = run<T>(a, tb, qs, tl, off, N, T_rows, max_blocks, st);
  } else if (dtype == 0) {
    const Call<float, float> a{static_cast<const float*>(q), static_cast<const float*>(k_cache),
                               static_cast<const float*>(v_cache), nullptr, nullptr, out, m, l,
                               out_f32, H, kvH, D, block_size, window, page_stride, scale};
    err = run<float>(a, tb, qs, tl, off, N, T_rows, max_blocks, st);
  } else {
    err = cudaErrorInvalidValue;
  }
  return (int)err;
}

const char* paged_prefill_attention_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
