// Ragged paged attention for Hopper (sm_90a): ONE kernel for a flat
// mixed prefill+decode token batch.
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
// - window. Rows that no span owns are written as zeros.
//
// Bound on this card: the K/V bytes read (an int8 cache moves half the
// bytes of bf16); see paged_attention.cuh for the design shared with the
// decode and prefill kernels. The int8 leg stages 16 int8 values per
// 16-byte load and dequantizes them in registers by the page's [kvH]
// scale row, read by physical page id (the TPU kernel's VMEM scale load).

#include "paged_attention.cuh"

namespace {

using namespace paged;

template <typename T, typename C, int DPL>
__global__ void __launch_bounds__(kThreads)
ragged_attn_kernel(Call<T, C> a, const int* __restrict__ block_tables,
                   const int* __restrict__ q_start, const int* __restrict__ q_len,
                   const int* __restrict__ kv_len, const int* __restrict__ row_start,
                   int max_blocks) {
  const int s = blockIdx.y;
  const Span sp{row_start[s], q_len[s], q_start[s], kv_len[s],
                block_tables + (size_t)s * max_blocks, max_blocks};
  attend_tile<T, C, DPL>(a, sp, blockIdx.z, 0);
}

// Rows that no span owns (budget padding between and after spans) are
// written as zeros, the reference's contract, so padding can never leak
// into the residual stream.
template <typename T>
__global__ void zero_unowned_rows(T* __restrict__ out, const int* __restrict__ q_len,
                                  const int* __restrict__ row_start, int S, int HD) {
  const int row = blockIdx.x;
  for (int s = 0; s < S; ++s) {
    const int ql = q_len[s];
    const int r0 = row_start[s];
    if (ql > 0 && row >= r0 && row < r0 + ql) return;
  }
  for (int e = threadIdx.x; e < HD; e += blockDim.x) out[(size_t)row * HD + e] = from_f<T>(0.f);
}

template <typename T, typename C, int DPL>
cudaError_t launch(const Call<T, C>& a, const int* tables, const int* q_start,
                   const int* q_len, const int* kv_len, const int* row_start, int T_rows,
                   int S, int max_blocks, cudaStream_t stream) {
  constexpr int QV = Tile<DPL>::QV;
  const int G = a.H / a.kvH;
  const dim3 grid((T_rows * G + QV - 1) / QV, S, a.kvH);
  cudaError_t err = launch_tiles<DPL>(ragged_attn_kernel<T, C, DPL>, grid, a.D, stream, a,
                                      tables, q_start, q_len, kv_len, row_start, max_blocks);
  if (err != cudaSuccess) return err;
  if (T_rows > 0) {
    zero_unowned_rows<T><<<T_rows, 128, 0, stream>>>(static_cast<T*>(a.out), q_len, row_start,
                                                     S, a.H * a.D);
  }
  return cudaGetLastError();
}

template <typename T, typename C>
cudaError_t run(const void* q, const void* k, const void* v, const float* ks, const float* vs,
                void* out, const int* tables, const int* q_start, const int* q_len,
                const int* kv_len, const int* row_start, int T_rows, int H, int kvH, int D,
                int S, int max_blocks, int block_size, int window, cudaStream_t st) {
  const Call<T, C> a{static_cast<const T*>(q), static_cast<const C*>(k),
                     static_cast<const C*>(v), ks, vs, out, nullptr, nullptr, 0, H, kvH, D,
                     block_size, window, 1, 1.0f / sqrtf((float)D)};
  switch (dpl_for(D)) {
    case 1: return launch<T, C, 1>(a, tables, q_start, q_len, kv_len, row_start, T_rows, S, max_blocks, st);
    case 2: return launch<T, C, 2>(a, tables, q_start, q_len, kv_len, row_start, T_rows, S, max_blocks, st);
    case 4: return launch<T, C, 4>(a, tables, q_start, q_len, kv_len, row_start, T_rows, S, max_blocks, st);
    case 8: return launch<T, C, 8>(a, tables, q_start, q_len, kv_len, row_start, T_rows, S, max_blocks, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Launches the kernel on `stream`; returns cudaGetLastError() (0 = ok).
// dtype: 0 = float32, 1 = bfloat16 (q and out). kv_int8: 0 = the caches
// share q's dtype, 1 = int8 caches with k_scales/v_scales.
int ragged_paged_attention(const void* q, const void* k_cache, const void* v_cache,
                           const void* k_scales, const void* v_scales, void* out,
                           const void* block_tables, const void* q_start, const void* q_len,
                           const void* kv_len, const void* row_start, int T_rows, int H,
                           int kvH, int D, int S, int max_blocks, int block_size, int window,
                           int dtype, int kv_int8, void* stream) {
  if (!head_dim_ok(D, H, kvH)) return cudaErrorInvalidValue;
  if (kv_int8 && (k_scales == nullptr || v_scales == nullptr)) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* ks = static_cast<const float*>(k_scales);
  const float* vs = static_cast<const float*>(v_scales);
  const int* tb = static_cast<const int*>(block_tables);
  const int* qs = static_cast<const int*>(q_start);
  const int* ql = static_cast<const int*>(q_len);
  const int* kl = static_cast<const int*>(kv_len);
  const int* rs = static_cast<const int*>(row_start);
  cudaError_t err;
  if (dtype == 1 && !kv_int8) {
    err = run<__nv_bfloat16, __nv_bfloat16>(q, k_cache, v_cache, nullptr, nullptr, out, tb, qs,
                                            ql, kl, rs, T_rows, H, kvH, D, S, max_blocks,
                                            block_size, window, st);
  } else if (dtype == 0 && !kv_int8) {
    err = run<float, float>(q, k_cache, v_cache, nullptr, nullptr, out, tb, qs, ql, kl, rs,
                            T_rows, H, kvH, D, S, max_blocks, block_size, window, st);
  } else if (dtype == 1) {
    err = run<__nv_bfloat16, int8_t>(q, k_cache, v_cache, ks, vs, out, tb, qs, ql, kl, rs,
                                     T_rows, H, kvH, D, S, max_blocks, block_size, window, st);
  } else if (dtype == 0) {
    err = run<float, int8_t>(q, k_cache, v_cache, ks, vs, out, tb, qs, ql, kl, rs, T_rows, H,
                             kvH, D, S, max_blocks, block_size, window, st);
  } else {
    err = cudaErrorInvalidValue;
  }
  return (int)err;
}

const char* ragged_paged_attention_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
