// Shared core of the port's paged-attention kernels for Hopper (sm_90a):
// the f32 legs of ragged_attention.cu (its multi-row spans) and of
// paged_prefill_attention.cu launch `attend_tile` from a kernel of their
// own that maps blockIdx onto one SPAN of query rows:
//   row0   flat row of the span's first query row in q / out
//   nrows  rows of the span
//   q0     position of the span's first row (row i sits at q0 + i)
//   kv     the span's keys are its positions < kv
//   table  its page table row: physical page of each logical page, or,
//          in the striped kv_sp scan, the shard's LOCAL compacted stripe
//          (column j = local page of logical page off + j*stride)
// Row i attends to key positions p with p <= q0 + i, p < kv and, with a
// window, p > q0 + i - window. A row that sees no key writes zeros.
// Scores scale by 1/sqrt(D) at the true head dim; the softmax is online
// in f32; int8 caches dequantize in registers by the page's per-(block,
// kv head) f32 scale, read by physical page id.
//
// Grid of every kernel: (query tile, span, kv head). A span's query
// vectors are its (row, group head) pairs, G = H / kvH per row; tile t
// covers vectors [t*QV, (t+1)*QV), so one block reads each K/V page ONCE
// for all G query heads of up to QV/G rows. Pages are staged with
// 16-byte loads as f32 in shared memory in 32-key chunks (one key per
// lane in the score pass, one head-dim slice per lane in the P.V pass);
// windowed spans skip whole pages behind the window, and a striped scan
// walks only its shard's pages. Blocks share nothing, so a TPU kernel's
// sequential grid, DMA ring and fold alignment have no counterpart here.
//
// Bound on this card: the K/V bytes read. Each span's visible keys cross
// HBM once; the arithmetic (4 x rows x visible keys x H x D flops) sits
// far below the tensor-core roof at the serving shapes. The walk itself
// is serial: synchronous staging, scalar f32 products, one query vector
// at a time per warp, so only the f32 legs keep it (a float32 product on
// tensor cores would be TF32). Decode and the ragged kernel's short spans
// split a span's keys over blocks and stage them by cp.async
// (paged_split.cuh); bf16 prefill and the ragged kernel's longer bf16
// spans run tensor-core tiles with a cp.async ring
// (paged_attention_tc.cuh). None uses TMA or wgmma.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include <cmath>
#include <cstdint>
#include <type_traits>

namespace paged {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kChunk = 32;            // keys staged per step: one per lane
constexpr float kNegInf = -1e30f;     // the reference's NEG_INF
constexpr int kMaxHeadDim = 256;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// 16 bytes of a cache row (8 bf16, 4 f32 or 16 int8) as floats.
template <typename C> struct Vec;
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
template <> struct Vec<int8_t> {
  static constexpr int N = 16;
  static __device__ __forceinline__ void load(const int8_t* p, float* out) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const int8_t* b = reinterpret_cast<const int8_t*>(&raw);
#pragma unroll
    for (int i = 0; i < 16; ++i) out[i] = static_cast<float>(b[i]);
  }
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 (or 4) bytes global -> shared; src_bytes 0 zero-fills the destination.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(src_bytes));
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
// per lane (DPL = head-dim elements per lane: ceil(D / 32) rounded up to
// a power of two, so four instantiations cover every D up to 256).
template <int DPL>
struct Tile {
  static constexpr int NQ = (16 / DPL) > 0 ? (16 / DPL) : 1;
  static constexpr int QV = NQ * kWarps;     // query vectors per block
};

inline int dpl_for(int D) {
  int dpl = 1;
  while (dpl * 32 < D) dpl *= 2;
  return dpl;
}

template <int DPL>
inline size_t smem_bytes(int D) {
  return (size_t)(Tile<DPL>::QV * D + kChunk * (D + 1) + kChunk * D) * sizeof(float);
}

// Logical key position of local key index u (u = local page * bs + e).
__device__ __forceinline__ int key_pos(int u, int bs, int off, int stride) {
  const int lp = u / bs;
  return (off + lp * stride) * bs + (u - lp * bs);
}

struct Span {
  int row0, nrows, q0, kv;
  const int* table;
  int table_len;
};

// What every launch shares: operands, shapes and the page walk.
template <typename T, typename C>
struct Call {
  const T* q;
  const C* k_cache;
  const C* v_cache;
  const float* k_scales;   // [num_blocks, kvH] for an int8 cache, else null
  const float* v_scales;
  void* out;               // T, or float when out_f32
  float* m_out;            // [rows, H] online-softmax stats, or null
  float* l_out;
  int out_f32;
  int H, kvH, D, block_size, window;
  int page_stride;         // 1, or sp for a striped scan
  float scale;
};

template <typename T, typename C, int DPL>
__device__ __forceinline__ void attend_tile(const Call<T, C>& a, const Span& sp, int h,
                                            int page_off) {
  constexpr int NQ = Tile<DPL>::NQ;
  constexpr int QV = Tile<DPL>::QV;
  const int G = a.H / a.kvH;
  const int qv0 = blockIdx.x * QV;
  if (sp.nrows <= 0 || qv0 >= sp.nrows * G) return;   // idle span / tile past its end

  const int D = a.D;
  const int bs = a.block_size;
  const int stride = a.page_stride;
  const int nqv = min(QV, sp.nrows * G - qv0);
  const int first_row = qv0 / G;
  const int last_row = (qv0 + nqv - 1) / G;
  // Keys this tile can see: causal bound of its last row clipped to the
  // context. Local pages: those whose logical page lies below that bound
  // and, with a window, not wholly behind its first row's window.
  const int hi = min(sp.q0 + last_row + 1, sp.kv);
  const int hi_pages = (hi + bs - 1) / bs;
  int lo_page = 0;
  if (a.window > 0) lo_page = max(sp.q0 + first_row - a.window + 1, 0) / bs;
  const int lo_u = max((lo_page - page_off + stride - 1) / stride, 0) * bs;
  const int hi_u = max((hi_pages - page_off + stride - 1) / stride, 0) * bs;

  extern __shared__ float smem[];
  float* q_s = smem;                           // [QV][D], pre-scaled
  float* k_s = q_s + QV * D;                   // [kChunk][D + 1] (odd stride: no bank conflicts)
  float* v_s = k_s + kChunk * (D + 1);         // [kChunk][D]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int H = a.H;

  for (int e = tid; e < QV * D; e += kThreads) {
    const int i = e / D;
    const int d = e - i * D;
    float val = 0.f;
    if (i < nqv) {
      const int g = qv0 + i;
      const int row = sp.row0 + g / G;
      const int head = h * G + g % G;
      val = to_f(a.q[((size_t)row * H + head) * D + d]) * a.scale;
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

  constexpr int VEC = Vec<C>::N;
  constexpr bool kScaled = std::is_same<C, int8_t>::value;
  const int row_vecs = D / VEC;        // 16-byte loads per key row
  for (int c0 = lo_u; c0 < hi_u; c0 += kChunk) {
    __syncthreads();  // previous chunk consumed (first pass: q staged)
    // Stage the chunk's K/V rows with 16-byte loads; keys at or past the
    // tile's bound are never fetched (zeros, masked below).
    for (int e = tid; e < kChunk * row_vecs; e += kThreads) {
      const int j = e / row_vecs;
      const int d0 = (e - j * row_vecs) * VEC;
      const int u = c0 + j;
      const int lp = u / bs;
      const int pos = (page_off + lp * stride) * bs + (u - lp * bs);
      float kk[VEC], vv[VEC];
      if (u < hi_u && pos < hi) {
        const int page = sp.table[min(lp, sp.table_len - 1)];
        const size_t off = ((size_t)(page * bs + (u - lp * bs)) * a.kvH + h) * D + d0;
        Vec<C>::load(a.k_cache + off, kk);
        Vec<C>::load(a.v_cache + off, vv);
        if constexpr (kScaled) {
          const float ks = a.k_scales[(size_t)page * a.kvH + h];
          const float vs = a.v_scales[(size_t)page * a.kvH + h];
#pragma unroll
          for (int t = 0; t < VEC; ++t) {
            kk[t] *= ks;
            vv[t] *= vs;
          }
        }
      } else {
#pragma unroll
        for (int t = 0; t < VEC; ++t) kk[t] = vv[t] = 0.f;
      }
#pragma unroll
      for (int t = 0; t < VEC; ++t) {
        k_s[j * (D + 1) + d0 + t] = kk[t];
        v_s[j * D + d0 + t] = vv[t];
      }
    }
    __syncthreads();

    const int key = key_pos(c0 + lane, bs, page_off, stride);
    const bool in_scan = c0 + lane < hi_u;
#pragma unroll
    for (int i = 0; i < NQ; ++i) {
      const int qi = i * kWarps + warp;   // warp-uniform
      if (qi < nqv) {
        const int qpos = sp.q0 + (qv0 + qi) / G;
        const bool ok = in_scan && key < sp.kv && key <= qpos &&
                        (a.window <= 0 || key > qpos - a.window);
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
      const size_t rh = (size_t)(sp.row0 + g / G) * H + h * G + g % G;
      const float li = l[i];
#pragma unroll
      for (int t = 0; t < DPL; ++t) {
        const int d = lane + 32 * t;
        if (d < D) {
          const float o = li > 0.f ? acc[i][t] / fmaxf(li, 1e-30f) : 0.f;
          if (a.out_f32) {
            static_cast<float*>(a.out)[rh * D + d] = o;
          } else {
            static_cast<T*>(a.out)[rh * D + d] = from_f<T>(o);
          }
        }
      }
      if (a.m_out != nullptr && lane == 0) {
        a.m_out[rh] = m[i];
        a.l_out[rh] = li;
      }
    }
  }
}

// Sets the kernel's dynamic shared memory and launches it on `stream`.
template <int DPL, typename Kernel, typename... Args>
cudaError_t launch_tiles(Kernel kernel, dim3 grid, int D, cudaStream_t stream, Args... args) {
  const size_t smem = smem_bytes<DPL>(D);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  if (grid.x == 0 || grid.y == 0 || grid.z == 0) return cudaSuccess;
  kernel<<<grid, kThreads, smem, stream>>>(args...);
  return cudaGetLastError();
}

inline bool head_dim_ok(int D, int H, int kvH) {
  return D > 0 && D <= kMaxHeadDim && D % 16 == 0 && kvH > 0 && H % kvH == 0;
}

}  // namespace paged
