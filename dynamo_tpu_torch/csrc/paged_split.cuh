// Split-KV core of the port's decode and ragged attention kernels for
// Hopper (sm_90a): one block attends up to VB query vectors of one span
// over the keys of one column range of the span's block table.
//
// Shared by paged_decode_attention.cu (a lane is a span of one row at
// position ctx - 1 with keys < ctx, VB = 8) and ragged_attention.cu
// (decode and short spec-verify spans of the flat batch, VB = 16, where
// its wgmma split does not apply: float32 q, head dims other than 64,
// 128 and 256).
//
// - Work. Block (split s, vector group vg, span, kv head) owns a run of
//   table columns and the span's query vectors [vg*VB, vg*VB + VB);
//   vector v is row v / G, head h*G + v % G (G = H / kvH), as in
//   attend_tile. The decode kernel's split s owns columns [s*P,
//   (s+1)*P); the ragged kernel's owns the s-th of num_splits balanced
//   runs of the columns its rows can see, from the first column inside
//   their window ([s*n/num_splits, (s+1)*n/num_splits) of the n visible),
//   so no split of a span that sees at least num_splits columns is empty,
//   lies behind its window or past its context. It is exactly the plain version over those columns with
//   stats: it writes (out_s f32 normalized, m_s, l_s) to the caller's
//   scratch, or, with one split, the output itself. A split that holds
//   no visible column writes m = -1e30, l = 0 and exits.
// - Staging. 32-key chunks are staged by 16-byte cp.async into a ring of
//   kStages (4 bf16 and int8, 3 f32; at head dims past 256, 2 bf16 and
//   1 f32: Ring<C, true>), so up to 128 keys are in flight;
//   keys outside the block's visible range are zero-filled, never read.
//   An int8 cache stages 16 values per copy, and each key's page scales
//   (k_scales/v_scales, per (block, kv head), read by physical page id)
//   ride in the same ring by 4-byte cp.async.
// - Passes. Score pass: warp per query vector, lane per key (a warp's 32
//   scores reduce by shuffles; each lane's dot product in four partial
//   sums, so its chain of dependent FMAs is D / 4 long); the row's causal
//   and window bounds mask per vector. P.V pass: thread per (vector, d pair), accumulators in
//   registers. An int8 page dequantizes in registers: the key's k scale
//   multiplies its f32 score, and its v scale multiplies P before P.V
//   (S = (q.k_int) k_s, O += (P v_s) v_int), the plain version's math.
// - merge_parts combines the splits by the logsumexp law of
//   ops/attention.py merge_stats (splits with l = 0 weigh 0).
//
// Bound on this card: the K/V bytes of the visible pages (G = 4 query
// vectors per key at llama3.2-1b: ~1 flop per byte, so tensor cores buy
// nothing and the math stays on CUDA cores in f32). The split exists to
// put enough blocks on 132 SMs when few spans carry many keys.

#pragma once

#include "paged_attention.cuh"

namespace paged_split {

using paged::cp_async16;
using paged::cp_async4;
using paged::from_f;
using paged::kNegInf;
using paged::to_f;
using paged::warp_max;
using paged::warp_sum;

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kN = 32;                 // keys per chunk: one per lane

// Ring depth per cache type; kWide: head dims past 256 (MLA's 576-wide
// entry), where a 32-key stage of K and V takes 73 KB in bf16 and 145 KB
// in f32, so the ring holds 2 and 1 stages (a block then takes one SM's
// shared memory, ~188 KB with q).
template <typename C, bool kWide = false> struct Ring;
template <bool W> struct Ring<__nv_bfloat16, W> { static constexpr int kStages = W ? 2 : 4; };
template <bool W> struct Ring<float, W> { static constexpr int kStages = W ? 1 : 3; };
template <bool W> struct Ring<int8_t, W> { static constexpr int kStages = 4; };

template <typename C>
constexpr bool kIsInt8 = std::is_same<C, int8_t>::value;

// q and out in T; caches in C (T, or int8 with per-(block, kv head) f32
// scales).
template <typename T, typename C>
struct SplitArgs {
  const T* q;              // [rows, H, D]
  const C* k_cache;
  const C* v_cache;
  const float* k_scales;   // [num_blocks, kvH] for an int8 cache, else null
  const float* v_scales;
  void* out;               // final output: T, or float with stats
  float* m_out;            // [rows, H] with stats, else null
  float* l_out;
  float* part_o;           // [prows, H, num_splits, D] scratch (num_splits > 1)
  float* part_m;           // [prows, H, num_splits]
  float* part_l;
  int H, kvH, D, max_blocks, block_size, window, page_stride;
  int num_splits, pages_per_split, vec_groups;
  float scale;
};

// The rows one block attends: row i of the span is flat row row0 + i of
// q/out (prow0 + i of the partials) at position q0 + i; keys < kv.
struct SplitSpan {
  int row0, prow0, nrows, q0, kv, page_off;
  const int* table;
};

__device__ __forceinline__ int ceil_div_pos(int x, int s) { return x > 0 ? (x + s - 1) / s : 0; }

// One ring stage: K rows [kN][SD], V rows [kN][SD] (SD = D + one 16-byte
// vector of padding), then, for int8, the keys' k and v scales [kN] each.
template <typename C>
__host__ __device__ inline int stage_bytes(int D) {
  const int SD = D + 16 / (int)sizeof(C);
  return 2 * kN * SD * (int)sizeof(C) + (kIsInt8<C> ? 2 * kN * (int)sizeof(float) : 0);
}

template <typename C, int VB, bool kWide = false>
size_t split_smem_bytes(int D) {
  return (size_t)Ring<C, kWide>::kStages * stage_bytes<C>(D) + (size_t)VB * D * sizeof(float) +
         (size_t)VB * kN * sizeof(float) + (size_t)VB * 3 * sizeof(float);
}

// 2 neighbouring elements of a staged row as floats.
__device__ __forceinline__ float2 pair_f(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 pair_f(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ float2 pair_f(const int8_t* p) {
  const char2 c = *reinterpret_cast<const char2*>(p);
  return make_float2(static_cast<float>(c.x), static_cast<float>(c.y));
}

// One split of one vector group of a span (see the header note). kRows:
// the span may hold more than one row, so each vector masks by its own
// row's causal and window bounds (a one-row span's bounds are the key
// range itself). kWide: head dims up to paged::kMaxWideHeadDim (the
// accumulators grow to VB x 576 / 2 pairs over 128 threads, 72 floats a
// thread, so the caller's kernel takes one block per SM), with the
// shallower ring of Ring<C, true>; a one-stage ring loads each chunk
// after the last one is consumed. kVisible (the ragged kernel): split s
// owns the s-th of num_splits balanced runs of the columns its rows see,
// counted from the first column inside their window, and
// pages_per_split is not read; else split s owns table columns [s*P,
// (s+1)*P) (the decode kernel, whose striped shards plan by column).
template <typename T, typename C, int VB, bool kRows, bool kWide = false,
          bool kVisible = false>
__device__ __forceinline__ void split_block(const SplitArgs<T, C>& a, const SplitSpan& sp,
                                            int s, int vg, int h) {
  constexpr int kStages = Ring<C, kWide>::kStages;
  constexpr int VEC = 16 / sizeof(C);
  constexpr bool kInt8 = kIsInt8<C>;
  constexpr int kVW = VB / kWarps;                              // vectors per warp
  constexpr int kMaxD = kWide ? paged::kMaxWideHeadDim : paged::kMaxHeadDim;
  constexpr int kPairs = VB * kMaxD / 2 / kThreads;
  const int G = a.H / a.kvH;
  const int v0 = vg * VB;
  const int NV = min(VB, sp.nrows * G - v0);                    // vectors of this block
  if (NV <= 0) return;
  const int D = a.D;
  const int bs = a.block_size;
  const int stride = a.page_stride;
  const int off = sp.page_off;
  const int first_row = v0 / G;
  const int last_row = (v0 + NV - 1) / G;
  // Keys the block's rows can see: below its last row's causal bound and
  // the context, at or after its first row's window start.
  const int hi = min(sp.q0 + last_row + 1, sp.kv);
  const int lo_pos = a.window > 0 ? max(sp.q0 + first_row - a.window + 1, 0) : 0;

  // Visible columns: logical pages [lo_pos / bs, ceil(hi / bs)).
  const int vis_lo = ceil_div_pos(lo_pos / bs - off, stride);
  const int vis_hi = min(ceil_div_pos((hi + bs - 1) / bs - off, stride), a.max_blocks);
  int col_lo, col_hi;   // this split's
  if constexpr (kVisible) {
    const int n = max(vis_hi - vis_lo, 0);
    col_lo = vis_lo + s * n / a.num_splits;
    col_hi = vis_lo + (s + 1) * n / a.num_splits;
  } else {
    col_lo = max(vis_lo, s * a.pages_per_split);
    col_hi = min(vis_hi, (s + 1) * a.pages_per_split);
  }
  const int u_lo = col_lo * bs;
  const int u_hi = col_hi * bs;
  const int chunks = u_hi > u_lo ? (u_hi - u_lo + kN - 1) / kN : 0;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int SD = D + VEC;                                       // padded row, elements
  const int sbytes = stage_bytes<C>(D);
  float* const q_s = reinterpret_cast<float*>(smem_raw + kStages * sbytes);   // [NV][D]
  float* const p_s = q_s + VB * D;                              // [NV][kN]
  float* const corr_s = p_s + VB * kN;                          // [NV]
  float* const m_s = corr_s + VB;
  float* const l_s = m_s + VB;
  auto k_stage = [&](int c) { return reinterpret_cast<C*>(smem_raw + (c % kStages) * sbytes); };
  auto scale_stage = [&](int c) {   // int8: [kN] k scales, then [kN] v scales
    return reinterpret_cast<float*>(smem_raw + (c % kStages) * sbytes + 2 * kN * SD * sizeof(C));
  };

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int* table = sp.table;

  // kTPK threads stage one key's K and V rows: one page lookup each.
  constexpr int kTPK = kThreads / kN;
  const int ld_j = tid / kTPK;
  const int ld_d0 = (tid % kTPK) * VEC;
  auto issue = [&](int c) {
    C* ks = k_stage(c) + ld_j * SD;
    C* vs = ks + kN * SD;
    const int u = u_lo + c * kN + ld_j;
    const int col = u / bs;
    const int pos = (off + col * stride) * bs + (u - col * bs);
    const bool ok = u < u_hi && pos < hi && pos >= lo_pos;
    int page = 0;
    size_t row = 0;
    if (ok) {
      page = table[col];
      row = ((size_t)(page * bs + (u - col * bs)) * a.kvH + h) * D;
    }
    for (int d0 = ld_d0; d0 < D; d0 += kTPK * VEC) {
      cp_async16(ks + d0, a.k_cache + row + d0, ok ? 16 : 0);
      cp_async16(vs + d0, a.v_cache + row + d0, ok ? 16 : 0);
    }
    if constexpr (kInt8) {
      if (ld_d0 == 0) {
        float* sc = scale_stage(c);
        const size_t si = (size_t)page * a.kvH + h;
        cp_async4(sc + ld_j, a.k_scales + si, ok ? 4 : 0);
        cp_async4(sc + kN + ld_j, a.v_scales + si, ok ? 4 : 0);
      }
    }
  };

  // Keep kStages - 1 chunks in flight; one commit group per chunk slot,
  // empty past the end, so wait_group counts stay uniform.
#pragma unroll
  for (int c = 0; c < kStages - 1; ++c) {
    if (c < chunks) issue(c);
    asm volatile("cp.async.commit_group;\n");
  }

  for (int e = tid; e < NV * D; e += kThreads) {
    const int vi = e / D;
    const int v = v0 + vi;
    const size_t row = sp.row0 + v / G;
    q_s[e] = to_f(a.q[(row * a.H + h * G + v % G) * D + e - vi * D]) * a.scale;
  }

  // Score pass: warp w owns vectors w, w + 4, ... for the whole split.
  float m_r[kVW], l_r[kVW];
#pragma unroll
  for (int i = 0; i < kVW; ++i) {
    m_r[i] = kNegInf;
    l_r[i] = 0.f;
  }
  // P.V pass: thread owns (vector, d pair) pr = tid + i * kThreads.
  const int npairs = NV * (D / 2);
  float acc[kPairs][2];
#pragma unroll
  for (int i = 0; i < kPairs; ++i) acc[i][0] = acc[i][1] = 0.f;

  for (int c = 0; c < chunks; ++c) {
    if constexpr (kStages == 1) {
      __syncthreads();   // chunk c - 1 fully consumed: its stage is free
      issue(c);
      asm volatile("cp.async.commit_group;\n");
      asm volatile("cp.async.wait_group 0;\n");
      __syncthreads();   // chunk c landed everywhere
    } else {
      asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 2));
      __syncthreads();   // chunk c landed everywhere; chunk c - 1 fully consumed
      if (c + kStages - 1 < chunks) issue(c + kStages - 1);
      asm volatile("cp.async.commit_group;\n");
    }

    const C* ks = k_stage(c);
    const C* vs = ks + kN * SD;
    const int u = u_lo + c * kN + lane;
    const int col = u / bs;
    const int pos = (off + col * stride) * bs + (u - col * bs);
    const bool key_ok = u < u_hi && pos < hi && pos >= lo_pos;
    float k_sc = 1.f, v_sc = 1.f;
    if constexpr (kInt8) {
      const float* sc = scale_stage(c);
      k_sc = sc[lane];
      v_sc = sc[kN + lane];
    }
#pragma unroll
    for (int i = 0; i < kVW; ++i) {
      const int vi = warp + i * kWarps;
      if (vi < NV) {   // warp-uniform
        bool ok = key_ok;
        if constexpr (kRows) {
          const int qpos = sp.q0 + (v0 + vi) / G;
          ok = ok && pos <= qpos && (a.window <= 0 || pos > qpos - a.window);
        }
        float sc = kNegInf;
        if (ok) {
          // 16-byte reads: the padded rows put 8 lanes on 32 distinct banks.
          // Four partial sums: the chain of dependent FMAs a key waits
          // on is D / 4 long, not D.
          const float* qr = q_s + vi * D;
          const C* kr = ks + lane * SD;
          float dot[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 2
          for (int d = 0; d < D; d += VEC) {
            float kk[VEC];
            paged::Vec<C>::load(kr + d, kk);
#pragma unroll
            for (int t = 0; t < VEC; ++t) dot[t & 3] = fmaf(qr[d + t], kk[t], dot[t & 3]);
          }
          const float sum = (dot[0] + dot[1]) + (dot[2] + dot[3]);
          sc = kInt8 ? sum * k_sc : sum;
        }
        const float m_new = fmaxf(m_r[i], warp_max(sc));
        const float corr = expf(m_r[i] - m_new);
        const float p = ok ? expf(sc - m_new) : 0.f;
        l_r[i] = l_r[i] * corr + warp_sum(p);
        m_r[i] = m_new;
        p_s[vi * kN + lane] = kInt8 ? p * v_sc : p;
        if (lane == 0) corr_s[vi] = corr;
      }
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < kPairs; ++i) {
      const int pr = tid + i * kThreads;
      if (pr < npairs) {
        const int vi = pr / (D / 2);
        const int d = 2 * (pr - vi * (D / 2));
        const float corr = corr_s[vi];
        const float* pg = p_s + vi * kN;
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
  for (int i = 0; i < kVW; ++i) {
    const int vi = warp + i * kWarps;
    if (vi < NV && lane == 0) {
      m_s[vi] = m_r[i];
      l_s[vi] = l_r[i];
    }
  }
  __syncthreads();

  const bool single = a.num_splits == 1;
#pragma unroll
  for (int i = 0; i < kPairs; ++i) {
    const int pr = tid + i * kThreads;
    if (pr < npairs) {
      const int vi = pr / (D / 2);
      const int d = 2 * (pr - vi * (D / 2));
      const int v = v0 + vi;
      const int head = h * G + v % G;
      const float l = l_s[vi];
      const float den = fmaxf(l, 1e-30f);
      const float x0 = l > 0.f ? acc[i][0] / den : 0.f;
      const float x1 = l > 0.f ? acc[i][1] / den : 0.f;
      if (!single) {
        const size_t r = ((size_t)(sp.prow0 + v / G) * a.H + head) * a.num_splits + s;
        *reinterpret_cast<float2*>(a.part_o + r * D + d) = make_float2(x0, x1);
        if (d == 0) {
          a.part_m[r] = m_s[vi];
          a.part_l[r] = l;
        }
      } else {
        const size_t rh = (size_t)(sp.row0 + v / G) * a.H + head;
        if (a.m_out != nullptr) {
          *reinterpret_cast<float2*>(static_cast<float*>(a.out) + rh * D + d) =
              make_float2(x0, x1);
          if (d == 0) {
            a.m_out[rh] = m_s[vi];
            a.l_out[rh] = l;
          }
        } else {
          T* o = static_cast<T*>(a.out) + rh * D + d;
          o[0] = from_f<T>(x0);
          o[1] = from_f<T>(x1);
        }
      }
    }
  }
}

// The splits' partials of one (row, head) at element d merged by
// m = max m_s, w_s = exp(m_s - m) l_s, out = sum w_s out_s / sum w_s.
struct Merged {
  float o, m, l;
};
__device__ __forceinline__ Merged merge_parts(const float* pm, const float* pl, const float* po,
                                              int S, int D) {
  float m = kNegInf;
  for (int s = 0; s < S; ++s) m = fmaxf(m, pm[s]);
  float l = 0.f, acc = 0.f;
  for (int s = 0; s < S; ++s) {
    const float w = expf(pm[s] - m) * pl[s];
    l += w;
    acc = fmaf(po[(size_t)s * D], w, acc);
  }
  return {l > 0.f ? acc / fmaxf(l, 1e-30f) : 0.f, m, l};
}

// Sets the split kernel's dynamic shared memory where it exceeds the
// default 48 KB (only then: the attribute write is a CUDA API call the
// host would otherwise pay on every call).
template <typename Kernel>
cudaError_t set_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

}  // namespace paged_split
