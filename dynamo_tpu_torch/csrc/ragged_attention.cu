// Ragged paged attention for Hopper (sm_90a): ONE kernel for a flat
// mixed prefill+decode token batch.
//
// Replaces `_ragged_kernel` in dynamo_tpu/ops/pallas/ragged_attention.py
// (called through `ragged_paged_attention_pallas`). Same contract:
//   q        [T, H, D]              flat token batch (budget-padded)
//   k/v      [num_slots, kvH, D]    paged cache, slot = page*bs + offset
//   block_tables [S, max_blocks] int32, and per span s (int32 [S]):
//   q_start  global position of the span's first row (cached prefix)
//   q_len    rows in the span (0 = idle metadata row)
//   kv_len   context after this step's KV writes (= q_start + q_len)
//   row_start the span's first row in the flat batch
// Row r = row_start[s] + i sits at position q_pos = q_start[s] + i and
// attends to keys key_pos with key_pos <= q_pos, key_pos < kv_len[s] and,
// with a window, key_pos > q_pos - window. Scores scale by 1/sqrt(D) at
// the true head dim; the softmax is online in f32; rows that no span
// owns are written as zeros.
//
// Bound on this card: the K/V bytes read. Each span's visible keys have
// to cross HBM once (kv_len x kvH x D x 2 tensors x element size); divided
// by the H100's 3.35 TB/s that is the least time the call can take. The
// arithmetic (4 x rows x visible keys x H x D flops) sits far below the
// tensor-core roof at these shapes, so bytes bound it.
//
// What the design does about that bound: GQA query heads are folded per
// kv head, so one block reads each K/V page ONCE for all G query heads of
// up to QV/G rows of a span; pages are staged with 16-byte loads as f32
// in shared memory in 32-key chunks (one key per lane in the score pass,
// one head-dim slice per lane in the P.V pass); windowed spans skip whole
// pages behind the window. The caches must be 16-byte aligned (the
// wrapper checks). What it does not do yet: split long contexts over several
// blocks (decode-only batches fill fewer blocks than the card has SMs),
// stage pages with TMA/cp.async, or use wgmma. Those are for a later PR.
//
// Grid: (query tile, span, kv head). A span's query vectors are the
// (row, group head) pairs of its rows, G per row; tile t covers vectors
// [t*QV, (t+1)*QV). Tiles past a span's end exit at once. The TPU
// kernel's DMA ring, RAGGED_PP/NBUF constants and 128-lane padding are
// layout artefacts of the TPU and have no counterpart here.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include <cmath>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kChunk = 32;            // keys staged per step: one per lane
constexpr float kNegInf = -1e30f;     // the reference's NEG_INF

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

// 16 bytes of a cache row (8 bf16 or 4 f32) as floats.
template <typename T> struct Vec;
template <> struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  static __device__ __forceinline__ void load(const __nv_bfloat16* p, float* out) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      out[2 * i] = f.x;
      out[2 * i + 1] = f.y;
    }
  }
};
template <> struct Vec<float> {
  static constexpr int N = 4;
  static __device__ __forceinline__ void load(const float* p, float* out) {
    const float4 f = *reinterpret_cast<const float4*>(p);
    out[0] = f.x; out[1] = f.y; out[2] = f.z; out[3] = f.w;
  }
};

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Query vectors each warp keeps in registers: acc holds NQ x DPL floats
// per lane (DPL = head-dim elements per lane: ceil(D / 32) rounded up to a
// power of two, so four instantiations cover every D up to 256).
template <int DPL>
struct Tile {
  static constexpr int NQ = (16 / DPL) > 0 ? (16 / DPL) : 1;
  static constexpr int QV = NQ * kWarps;     // query vectors per block
};

template <typename T, int DPL>
__global__ void __launch_bounds__(kThreads)
ragged_attn_kernel(const T* __restrict__ q, const T* __restrict__ k_cache,
                   const T* __restrict__ v_cache, T* __restrict__ out,
                   const int* __restrict__ block_tables,
                   const int* __restrict__ q_start, const int* __restrict__ q_len,
                   const int* __restrict__ kv_len, const int* __restrict__ row_start,
                   int H, int kvH, int D, int max_blocks, int block_size,
                   int window, float scale) {
  constexpr int NQ = Tile<DPL>::NQ;
  constexpr int QV = Tile<DPL>::QV;
  const int s = blockIdx.y;
  const int h = blockIdx.z;
  const int G = H / kvH;
  const int ql = q_len[s];
  const int qv0 = blockIdx.x * QV;
  if (ql <= 0 || qv0 >= ql * G) return;   // idle span / tile past its end

  const int q0 = q_start[s];
  const int kv = kv_len[s];
  const int rs0 = row_start[s];
  const int nqv = min(QV, ql * G - qv0);
  const int first_row = qv0 / G;
  const int last_row = (qv0 + nqv - 1) / G;
  // Keys this tile can see: causal bound of its last row clipped to the
  // context; with a window, pages wholly behind its first row's window
  // are skipped.
  const int hi = min(q0 + last_row + 1, kv);
  int lo = 0;
  if (window > 0) lo = max(q0 + first_row - window + 1, 0) / block_size * block_size;

  extern __shared__ float smem[];
  float* q_s = smem;                           // [QV][D], pre-scaled
  float* k_s = q_s + QV * D;                   // [kChunk][D + 1] (odd stride: no bank conflicts)
  float* v_s = k_s + kChunk * (D + 1);         // [kChunk][D]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  for (int e = tid; e < QV * D; e += kThreads) {
    const int i = e / D;
    const int d = e - i * D;
    float val = 0.f;
    if (i < nqv) {
      const int g = qv0 + i;
      const int row = rs0 + g / G;
      const int head = h * G + g % G;
      val = to_f(q[((size_t)row * H + head) * D + d]) * scale;
    }
    q_s[e] = val;
  }

  float m[NQ], l[NQ], acc[NQ][DPL];
#pragma unroll
  for (int i = 0; i < NQ; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int t = 0; t < DPL; ++t) acc[i][t] = 0.f;
  }

  const int* table = block_tables + (size_t)s * max_blocks;
  constexpr int VEC = Vec<T>::N;
  const int row_vecs = D / VEC;        // 16-byte loads per key row
  for (int c0 = lo; c0 < hi; c0 += kChunk) {
    __syncthreads();  // previous chunk consumed (first pass: q staged)
    // Stage the chunk's K/V rows with 16-byte loads; each load's cache
    // slot is computed once, and all loads of the chunk are independent.
    for (int e = tid; e < kChunk * row_vecs; e += kThreads) {
      const int j = e / row_vecs;
      const int d0 = (e - j * row_vecs) * VEC;
      const int pos = c0 + j;
      float kv_k[VEC], kv_v[VEC];
      if (pos < hi) {  // keys past the bound are never fetched: zeros, masked
        const int page = pos / block_size;
        const int slot = table[page] * block_size + (pos - page * block_size);
        const size_t off = ((size_t)slot * kvH + h) * D + d0;
        Vec<T>::load(k_cache + off, kv_k);
        Vec<T>::load(v_cache + off, kv_v);
      } else {
#pragma unroll
        for (int t = 0; t < VEC; ++t) kv_k[t] = kv_v[t] = 0.f;
      }
#pragma unroll
      for (int t = 0; t < VEC; ++t) {
        k_s[j * (D + 1) + d0 + t] = kv_k[t];
        v_s[j * D + d0 + t] = kv_v[t];
      }
    }
    __syncthreads();

    const int key = c0 + lane;
#pragma unroll
    for (int i = 0; i < NQ; ++i) {
      const int qi = i * kWarps + warp;   // warp-uniform
      if (qi < nqv) {
        const int qpos = q0 + (qv0 + qi) / G;
        const bool ok = key < kv && key <= qpos && (window <= 0 || key > qpos - window);
        float sc = kNegInf;
        if (ok) {
          const float* qr = q_s + qi * D;
          const float* kr = k_s + lane * (D + 1);
          float dot = 0.f;
#pragma unroll 8
          for (int d = 0; d < D; ++d) dot = fmaf(qr[d], kr[d], dot);
          sc = dot;
        }
        const float m_new = fmaxf(m[i], warp_max(sc));
        const float corr = expf(m[i] - m_new);
        const float p = ok ? expf(sc - m_new) : 0.f;
        l[i] = l[i] * corr + warp_sum(p);
#pragma unroll
        for (int t = 0; t < DPL; ++t) acc[i][t] *= corr;
        for (int j = 0; j < kChunk; ++j) {
          const float pj = __shfl_sync(0xffffffffu, p, j);
          const float* vr = v_s + j * D;
#pragma unroll
          for (int t = 0; t < DPL; ++t) {
            const int d = lane + 32 * t;
            if (d < D) acc[i][t] = fmaf(pj, vr[d], acc[i][t]);
          }
        }
        m[i] = m_new;
      }
    }
  }

#pragma unroll
  for (int i = 0; i < NQ; ++i) {
    const int qi = i * kWarps + warp;
    if (qi < nqv) {
      const int g = qv0 + qi;
      const int row = rs0 + g / G;
      const int head = h * G + g % G;
      T* o = out + ((size_t)row * H + head) * D;
      const float li = l[i];
#pragma unroll
      for (int t = 0; t < DPL; ++t) {
        const int d = lane + 32 * t;
        if (d < D) o[d] = from_f<T>(li > 0.f ? acc[i][t] / fmaxf(li, 1e-30f) : 0.f);
      }
    }
  }
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

template <typename T, int DPL>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   const int* tables, const int* q_start, const int* q_len,
                   const int* kv_len, const int* row_start, int T_rows, int H,
                   int kvH, int D, int S, int max_blocks, int block_size,
                   int window, cudaStream_t stream) {
  constexpr int QV = Tile<DPL>::QV;
  const int G = H / kvH;
  const int tiles = (T_rows * G + QV - 1) / QV;
  const size_t smem = (size_t)(QV * D + kChunk * (D + 1) + kChunk * D) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      ragged_attn_kernel<T, DPL>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const float scale = 1.0f / sqrtf((float)D);
  if (tiles > 0 && S > 0) {
    ragged_attn_kernel<T, DPL><<<dim3(tiles, S, kvH), kThreads, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<T*>(out), tables, q_start, q_len, kv_len, row_start, H, kvH, D,
        max_blocks, block_size, window, scale);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  if (T_rows > 0) {
    zero_unowned_rows<T><<<T_rows, 128, 0, stream>>>(static_cast<T*>(out), q_len, row_start,
                                                     S, H * D);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_dpl(int dpl, const void* q, const void* k, const void* v, void* out,
                         const int* tables, const int* q_start, const int* q_len,
                         const int* kv_len, const int* row_start, int T_rows, int H,
                         int kvH, int D, int S, int max_blocks, int block_size, int window,
                         cudaStream_t st) {
#define DYN_CASE(N)                                                                     \
  case N:                                                                               \
    return launch<T, N>(q, k, v, out, tables, q_start, q_len, kv_len, row_start, T_rows, \
                        H, kvH, D, S, max_blocks, block_size, window, st);
  switch (dpl) {
    DYN_CASE(1) DYN_CASE(2) DYN_CASE(4) DYN_CASE(8)
    default:
      return cudaErrorInvalidValue;
  }
#undef DYN_CASE
}

}  // namespace

extern "C" {

// Launches the kernel on `stream`; returns cudaGetLastError() (0 = ok).
// dtype: 0 = float32, 1 = bfloat16 (q, caches and out share it).
int ragged_paged_attention(const void* q, const void* k_cache, const void* v_cache, void* out,
                           const void* block_tables, const void* q_start, const void* q_len,
                           const void* kv_len, const void* row_start, int T_rows, int H,
                           int kvH, int D, int S, int max_blocks, int block_size, int window,
                           int dtype, void* stream) {
  if (D <= 0 || D > 256 || D % 16 != 0 || kvH <= 0 || H % kvH != 0) return cudaErrorInvalidValue;
  int dpl = 1;
  while (dpl * 32 < D) dpl *= 2;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* tb = static_cast<const int*>(block_tables);
  const int* qs = static_cast<const int*>(q_start);
  const int* ql = static_cast<const int*>(q_len);
  const int* kl = static_cast<const int*>(kv_len);
  const int* rs = static_cast<const int*>(row_start);
  cudaError_t err;
  if (dtype == 1) {
    err = dispatch_dpl<__nv_bfloat16>(dpl, q, k_cache, v_cache, out, tb, qs, ql, kl, rs, T_rows,
                                      H, kvH, D, S, max_blocks, block_size, window, st);
  } else if (dtype == 0) {
    err = dispatch_dpl<float>(dpl, q, k_cache, v_cache, out, tb, qs, ql, kl, rs, T_rows, H, kvH,
                              D, S, max_blocks, block_size, window, st);
  } else {
    err = cudaErrorInvalidValue;
  }
  return (int)err;
}

const char* ragged_paged_attention_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
