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
// - Inside a split, 32-key chunks are staged by 16-byte cp.async into a
//   ring of kStages (4 bf16, 3 f32), so up to 128 keys are in flight;
//   keys outside the lane's visible range are zero-filled, never read.
//   Threads cover (head, key) in the score pass (warp per head, lane per
//   key: a warp's 32 scores reduce by shuffles) and (head, d pair) in the
//   P.V pass, with the accumulators in registers: at G = 4, D = 64 every
//   thread of the block works in both passes.
// - merge_kernel combines the splits by the logsumexp law of
//   ops/attention.py merge_stats (splits with l = 0 weigh 0) and writes
//   q's dtype, or f32 out plus the merged (m, l). With one split the
//   split kernel writes the output itself and no merge runs.
// A block takes up to 8 query heads of its kv head; more heads take more
// head groups in grid.x.

#include "paged_attention.cuh"

namespace {

using paged::from_f;
using paged::kNegInf;
using paged::to_f;
using paged::warp_max;
using paged::warp_sum;

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kN = 32;                 // keys per chunk: one per lane
constexpr int kHeads = 8;              // query heads per block (head group)
constexpr int kPairsPerThread = kHeads * paged::kMaxHeadDim / 2 / kThreads;

template <typename T> struct Ring;
template <> struct Ring<__nv_bfloat16> { static constexpr int kStages = 4; };
template <> struct Ring<float> { static constexpr int kStages = 3; };

template <typename T>
struct DecodeArgs {
  const T* q;
  const T* k_cache;
  const T* v_cache;
  void* out;               // final output: T, or float with stats
  float* m_out;            // [B, H] with stats, else null
  float* l_out;
  float* part_o;           // [B, H, S, D] scratch (S > 1)
  float* part_m;           // [B, H, S]
  float* part_l;
  const int* block_tables;
  const int* context_lens;
  const int* page_offset;
  int H, kvH, D, max_blocks, block_size, window, page_stride;
  int num_splits, pages_per_split, head_groups;
  float scale;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ int ceil_div_pos(int x, int s) { return x > 0 ? (x + s - 1) / s : 0; }

template <typename T>
size_t split_smem_bytes(int D) {
  const int SD = D + 16 / (int)sizeof(T);
  return (size_t)Ring<T>::kStages * 2 * kN * SD * sizeof(T) +
         (size_t)kHeads * D * sizeof(float) + (size_t)kHeads * kN * sizeof(float) +
         (size_t)kHeads * 3 * sizeof(float);
}

// 2 neighbouring elements of a staged row as floats.
__device__ __forceinline__ float2 pair_f(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 pair_f(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

template <typename T>
__global__ void __launch_bounds__(kThreads) split_kernel(const DecodeArgs<T> a) {
  constexpr int kStages = Ring<T>::kStages;
  constexpr int VEC = 16 / sizeof(T);
  const int s = blockIdx.x / a.head_groups;
  const int hg = blockIdx.x - s * a.head_groups;
  const int b = blockIdx.y;
  const int h = blockIdx.z;
  const int G = a.H / a.kvH;
  const int g0 = hg * kHeads;
  const int HB = min(kHeads, G - g0);                 // heads of this block
  const int D = a.D;
  const int bs = a.block_size;
  const int stride = a.page_stride;
  const int off = a.page_offset != nullptr ? a.page_offset[0] : 0;
  const int ctx = a.context_lens[b];
  const int lo_pos = a.window > 0 ? max(ctx - a.window, 0) : 0;

  // Visible columns of this split: logical pages [lo_pos / bs, ceil(ctx / bs)).
  const int col_lo = max(ceil_div_pos(lo_pos / bs - off, stride), s * a.pages_per_split);
  const int col_hi = min(min(ceil_div_pos((ctx + bs - 1) / bs - off, stride),
                             (s + 1) * a.pages_per_split),
                         a.max_blocks);
  const int u_lo = col_lo * bs;
  const int u_hi = col_hi * bs;
  const int chunks = u_hi > u_lo ? (u_hi - u_lo + kN - 1) / kN : 0;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int SD = D + VEC;                              // padded row, elements
  T* const kv_s = reinterpret_cast<T*>(smem_raw);
  const int stage_elems = 2 * kN * SD;
  float* const q_s = reinterpret_cast<float*>(kv_s + kStages * stage_elems);   // [HB][D]
  float* const p_s = q_s + kHeads * D;                 // [HB][kN]
  float* const corr_s = p_s + kHeads * kN;             // [HB]
  float* const m_s = corr_s + kHeads;
  float* const l_s = m_s + kHeads;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int* table = a.block_tables + (size_t)b * a.max_blocks;

  // kTPK threads stage one key's K and V rows: one page lookup each.
  constexpr int kTPK = kThreads / kN;
  const int ld_j = tid / kTPK;
  const int ld_d0 = (tid % kTPK) * VEC;
  auto issue = [&](int c) {
    T* ks = kv_s + (c % kStages) * stage_elems + ld_j * SD;
    T* vs = ks + kN * SD;
    const int u = u_lo + c * kN + ld_j;
    const int col = u / bs;
    const int pos = (off + col * stride) * bs + (u - col * bs);
    const bool ok = u < u_hi && pos < ctx && pos >= lo_pos;
    size_t row = 0;
    if (ok) row = ((size_t)(table[col] * bs + (u - col * bs)) * a.kvH + h) * D;
    for (int d0 = ld_d0; d0 < D; d0 += kTPK * VEC) {
      cp_async16(ks + d0, a.k_cache + row + d0, ok ? 16 : 0);
      cp_async16(vs + d0, a.v_cache + row + d0, ok ? 16 : 0);
    }
  };

  // Keep kStages - 1 chunks in flight; one commit group per chunk slot,
  // empty past the end, so wait_group counts stay uniform.
#pragma unroll
  for (int c = 0; c < kStages - 1; ++c) {
    if (c < chunks) issue(c);
    asm volatile("cp.async.commit_group;\n");
  }

  for (int e = tid; e < HB * D; e += kThreads) {
    const int g = e / D;
    q_s[e] = to_f(a.q[((size_t)b * a.H + h * G + g0 + g) * D + e - g * D]) * a.scale;
  }

  // Score pass: warp w owns heads w and w + 4 for the whole split.
  float m_r[2] = {kNegInf, kNegInf};
  float l_r[2] = {0.f, 0.f};
  // P.V pass: thread owns (head, d pair) pr = tid + i * kThreads.
  const int npairs = HB * (D / 2);
  float acc[kPairsPerThread][2];
#pragma unroll
  for (int i = 0; i < kPairsPerThread; ++i) acc[i][0] = acc[i][1] = 0.f;

  for (int c = 0; c < chunks; ++c) {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 2));
    __syncthreads();   // chunk c landed everywhere; chunk c - 1 fully consumed
    if (c + kStages - 1 < chunks) issue(c + kStages - 1);
    asm volatile("cp.async.commit_group;\n");

    const T* ks = kv_s + (c % kStages) * stage_elems;
    const T* vs = ks + kN * SD;
    const int u = u_lo + c * kN + lane;
    const int col = u / bs;
    const int pos = (off + col * stride) * bs + (u - col * bs);
    const bool ok = u < u_hi && pos < ctx && pos >= lo_pos;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int g = warp + i * kWarps;
      if (g < HB) {   // warp-uniform
        float sc = kNegInf;
        if (ok) {
          // 16-byte reads: the padded rows put 8 lanes on 32 distinct banks.
          const float* qr = q_s + g * D;
          const T* kr = ks + lane * SD;
          float dot = 0.f;
          for (int d = 0; d < D; d += VEC) {
            float kk[VEC];
            paged::Vec<T>::load(kr + d, kk);
#pragma unroll
            for (int t = 0; t < VEC; ++t) dot = fmaf(qr[d + t], kk[t], dot);
          }
          sc = dot;
        }
        const float m_new = fmaxf(m_r[i], warp_max(sc));
        const float corr = expf(m_r[i] - m_new);
        const float p = ok ? expf(sc - m_new) : 0.f;
        l_r[i] = l_r[i] * corr + warp_sum(p);
        m_r[i] = m_new;
        p_s[g * kN + lane] = p;
        if (lane == 0) corr_s[g] = corr;
      }
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < kPairsPerThread; ++i) {
      const int pr = tid + i * kThreads;
      if (pr < npairs) {
        const int g = pr / (D / 2);
        const int d = 2 * (pr - g * (D / 2));
        const float corr = corr_s[g];
        const float* pg = p_s + g * kN;
        float x0 = acc[i][0] * corr, x1 = acc[i][1] * corr;
#pragma unroll 8
        for (int j = 0; j < kN; ++j) {
          const float pj = pg[j];
          const float2 vv = pair_f(vs + j * SD + d);
          x0 = fmaf(pj, vv.x, x0);
          x1 = fmaf(pj, vv.y, x1);
        }
        acc[i][0] = x0;
        acc[i][1] = x1;
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int g = warp + i * kWarps;
    if (g < HB && lane == 0) {
      m_s[g] = m_r[i];
      l_s[g] = l_r[i];
    }
  }
  __syncthreads();

  const bool single = a.num_splits == 1;
#pragma unroll
  for (int i = 0; i < kPairsPerThread; ++i) {
    const int pr = tid + i * kThreads;
    if (pr < npairs) {
      const int g = pr / (D / 2);
      const int d = 2 * (pr - g * (D / 2));
      const int head = h * G + g0 + g;
      const float l = l_s[g];
      const float den = fmaxf(l, 1e-30f);
      const float x0 = l > 0.f ? acc[i][0] / den : 0.f;
      const float x1 = l > 0.f ? acc[i][1] / den : 0.f;
      const size_t bh = (size_t)b * a.H + head;
      if (!single) {
        const size_t r = bh * a.num_splits + s;
        *reinterpret_cast<float2*>(a.part_o + r * D + d) = make_float2(x0, x1);
        if (d == 0) {
          a.part_m[r] = m_s[g];
          a.part_l[r] = l;
        }
      } else if (a.m_out != nullptr) {
        *reinterpret_cast<float2*>(static_cast<float*>(a.out) + bh * D + d) = make_float2(x0, x1);
        if (d == 0) {
          a.m_out[bh] = m_s[g];
          a.l_out[bh] = l;
        }
      } else {
        T* o = static_cast<T*>(a.out) + bh * D + d;
        o[0] = from_f<T>(x0);
        o[1] = from_f<T>(x1);
      }
    }
  }
}

// One thread per (lane, head, d): the splits' partials merged by
// m = max m_s, w_s = exp(m_s - m) l_s, out = sum w_s out_s / sum w_s.
template <typename T>
__global__ void __launch_bounds__(kThreads) merge_kernel(const DecodeArgs<T> a) {
  const int b = blockIdx.y;
  const int e = blockIdx.x * kThreads + threadIdx.x;
  if (e >= a.H * a.D) return;
  const int head = e / a.D;
  const int d = e - head * a.D;
  const int S = a.num_splits;
  const size_t bh = (size_t)b * a.H + head;
  const float* pm = a.part_m + bh * S;
  const float* pl = a.part_l + bh * S;
  const float* po = a.part_o + bh * S * a.D + d;
  float m = kNegInf;
  for (int s = 0; s < S; ++s) m = fmaxf(m, pm[s]);
  float l = 0.f, acc = 0.f;
  for (int s = 0; s < S; ++s) {
    const float w = expf(pm[s] - m) * pl[s];
    l += w;
    acc = fmaf(po[(size_t)s * a.D], w, acc);
  }
  const float o = l > 0.f ? acc / fmaxf(l, 1e-30f) : 0.f;
  if (a.m_out != nullptr) {
    static_cast<float*>(a.out)[bh * a.D + d] = o;
    if (d == 0) {
      a.m_out[bh] = m;
      a.l_out[bh] = l;
    }
  } else {
    static_cast<T*>(a.out)[bh * a.D + d] = from_f<T>(o);
  }
}

template <typename T>
cudaError_t run(const DecodeArgs<T>& a, int B, cudaStream_t st) {
  // Above the default 48 KB only (D > 64 in bf16): the attribute write
  // is a CUDA API call the host would otherwise pay on every decode step.
  const size_t smem = split_smem_bytes<T>(a.D);
  cudaError_t err = cudaSuccess;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(split_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return err;
  }
  if (B == 0) return cudaSuccess;
  const dim3 grid(a.num_splits * a.head_groups, B, a.kvH);
  split_kernel<T><<<grid, kThreads, smem, st>>>(a);
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
                         static_cast<const T*>(v_cache), out, static_cast<float*>(m_out),
                         static_cast<float*>(l_out), static_cast<float*>(part_o),
                         static_cast<float*>(part_m), static_cast<float*>(part_l),
                         static_cast<const int*>(block_tables),
                         static_cast<const int*>(context_lens),
                         static_cast<const int*>(page_offset), H, kvH, D, max_blocks, block_size,
                         window, page_stride, num_splits, pages_per_split, head_groups, scale};
  };
  cudaError_t err;
  if (dtype == 1) {
    err = run(args(static_cast<__nv_bfloat16*>(nullptr)), B, st);
  } else if (dtype == 0) {
    err = run(args(static_cast<float*>(nullptr)), B, st);
  } else {
    err = cudaErrorInvalidValue;
  }
  return (int)err;
}

const char* paged_decode_attention_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
