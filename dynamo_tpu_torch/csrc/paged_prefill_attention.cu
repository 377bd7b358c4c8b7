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
// Two entry points, chosen by dtype in the Python wrapper:
// - paged_prefill_attention_tc (bf16): the tensor-core tile of
//   paged_attention_tc.cuh. At T=512 the bytes of q, out and K/V
//   (0.0059 ms) and the tensor-core flops (0.0039 ms) bound it about
//   equally; the tile folds the G query heads into 128 MMA rows, stages
//   64-key chunks as bf16 by cp.async and runs S = QK^T and PV through
//   mma.sync (design notes and bound in that header).
// - paged_prefill_attention (f32): the CUDA-core walk of
//   paged_attention.cuh, grid (query tile, lane, kv head). A float32
//   product on tensor cores would be TF32 and miss the 1e-4 f32
//   tolerance, so the f32 leg stays in f32 on CUDA cores, bound by its
//   serial 32-key walk. It refuses bf16: a bf16 call never reaches it.

#include "paged_attention.cuh"
#include "paged_attention_tc.cuh"

namespace {

using namespace paged;

template <int DPL>
__global__ void __launch_bounds__(kThreads)
prefill_attn_kernel(Call<float, float> a, const int* __restrict__ block_tables,
                    const int* __restrict__ q_start, const int* __restrict__ total_len,
                    const int* __restrict__ page_offset, int T_rows, int max_blocks) {
  const int n = blockIdx.y;
  const Span sp{n * T_rows, T_rows, q_start[n], total_len[n],
                block_tables + (size_t)n * max_blocks, max_blocks};
  attend_tile<float, float, DPL>(a, sp, blockIdx.z, page_offset != nullptr ? page_offset[0] : 0);
}

template <int DPL>
cudaError_t launch(const Call<float, float>& a, const int* tables, const int* qs, const int* tl,
                   const int* off, int N, int T_rows, int max_blocks, cudaStream_t st) {
  constexpr int QV = Tile<DPL>::QV;
  const int G = a.H / a.kvH;
  const dim3 grid((T_rows * G + QV - 1) / QV, N, a.kvH);
  return launch_tiles<DPL>(prefill_attn_kernel<DPL>, grid, a.D, st, a, tables, qs, tl, off,
                           T_rows, max_blocks);
}

}  // namespace

extern "C" {

// Launches the f32 walk on `stream`; returns cudaGetLastError() (0 =
// ok). m_out/l_out non-null = with stats (out is float32 either way).
int paged_prefill_attention(const void* q, const void* k_cache, const void* v_cache, void* out,
                            void* m_out, void* l_out, const void* block_tables,
                            const void* q_start, const void* total_len, const void* page_offset,
                            int N, int T_rows, int H, int kvH, int D, int max_blocks,
                            int block_size, int window, int page_stride, void* stream) {
  if (!head_dim_ok(D, H, kvH) || page_stride < 1) return cudaErrorInvalidValue;
  if ((m_out == nullptr) != (l_out == nullptr)) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* tb = static_cast<const int*>(block_tables);
  const int* qs = static_cast<const int*>(q_start);
  const int* tl = static_cast<const int*>(total_len);
  const int* off = static_cast<const int*>(page_offset);
  const Call<float, float> a{static_cast<const float*>(q), static_cast<const float*>(k_cache),
                             static_cast<const float*>(v_cache), nullptr, nullptr, out,
                             static_cast<float*>(m_out), static_cast<float*>(l_out), 1, H, kvH,
                             D, block_size, window, page_stride, 1.0f / sqrtf((float)D)};
  cudaError_t err;
  switch (dpl_for(D)) {
    case 1: err = launch<1>(a, tb, qs, tl, off, N, T_rows, max_blocks, st); break;
    case 2: err = launch<2>(a, tb, qs, tl, off, N, T_rows, max_blocks, st); break;
    case 4: err = launch<4>(a, tb, qs, tl, off, N, T_rows, max_blocks, st); break;
    case 8: err = launch<8>(a, tb, qs, tl, off, N, T_rows, max_blocks, st); break;
    default: err = cudaErrorInvalidValue;
  }
  return (int)err;
}

// Launches the bf16 tensor-core tile on `stream`; returns
// cudaGetLastError() (0 = ok). m_out/l_out non-null = with stats, and
// then out is float32, else bf16.
int paged_prefill_attention_tc(const void* q, const void* k_cache, const void* v_cache,
                               void* out, void* m_out, void* l_out, const void* block_tables,
                               const void* q_start, const void* total_len,
                               const void* page_offset, int N, int T_rows, int H, int kvH,
                               int D, int max_blocks, int block_size, int window,
                               int page_stride, void* stream) {
  const int bs_log = paged_tc::bs_log2(block_size);
  if (!head_dim_ok(D, H, kvH) || page_stride < 1 || bs_log < 0 || max_blocks < 1)
    return cudaErrorInvalidValue;
  if ((m_out == nullptr) != (l_out == nullptr)) return cudaErrorInvalidValue;
  using paged_tc::bf16;
  const paged_tc::TileArgs<bf16> a{
      static_cast<const bf16*>(q), static_cast<const bf16*>(k_cache),
      static_cast<const bf16*>(v_cache), nullptr, nullptr, out, static_cast<float*>(m_out),
      static_cast<float*>(l_out), H, kvH, D, max_blocks, block_size, bs_log, window,
      page_stride, 1.0f / sqrtf((float)D)};
  const int* tb = static_cast<const int*>(block_tables);
  const int* qs = static_cast<const int*>(q_start);
  const int* tl = static_cast<const int*>(total_len);
  const int* off = static_cast<const int*>(page_offset);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (paged_tc::dp_for(D)) {
    case 16: err = paged_tc::launch_prefill_tc<16>(a, tb, qs, tl, off, N, T_rows, st); break;
    case 32: err = paged_tc::launch_prefill_tc<32>(a, tb, qs, tl, off, N, T_rows, st); break;
    case 64: err = paged_tc::launch_prefill_tc<64>(a, tb, qs, tl, off, N, T_rows, st); break;
    case 128: err = paged_tc::launch_prefill_tc<128>(a, tb, qs, tl, off, N, T_rows, st); break;
    case 256: err = paged_tc::launch_prefill_tc<256>(a, tb, qs, tl, off, N, T_rows, st); break;
    default: err = cudaErrorInvalidValue;
  }
  return (int)err;
}

const char* paged_prefill_attention_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

const char* paged_prefill_attention_tc_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
