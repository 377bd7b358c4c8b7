// Tensor-core tile of the ragged kernel's bf16 leg at wide head dims
// (sm_90a): D in (256, 576], multiples of 64. MLA caches one shared
// [latent ‖ roped k_pe] entry of 512 + 64 = 576 dims per token, and its
// 16 query heads attend to it as one kv head (G = 16).
//
// Replaces, at those widths, `_ragged_kernel` in
// dynamo_tpu/ops/pallas/ragged_attention.py for the ragged kernel's
// spans of more than split_rows rows (ragged_attention.cu routes them
// here); the contract is paged_attention_tc.cuh's tile, row for row:
// row i of the span sits at q0 + i and sees keys p <= q0 + i, p < kv and,
// with a window, p > q0 + i - window; the softmax is online in f32 at
// scale 1/sqrt(D); int8 pages fold their per-(block, kv head) scales
// into the f32 side of the products.
//
// Why a second tile. paged_attention_tc.cuh keeps each warp's q
// fragments and its O accumulators (16 rows x D) in registers: at
// D = 576 that is 144 + 288 registers a thread, past the 255 a thread
// has. Here a block of 4 warps owns kM = 16 query vectors (one MLA
// row's 16 heads; in general vectors v of (row v / G, head h*G + v % G)),
// one m16 MMA tile, and splits the work three ways per 32-key chunk:
// - S = Q K^T: each warp takes 8 keys (one n8 block) and reduces over
//   D in 16-wide k-steps, Q's A fragments and K's B fragments both by
//   ldmatrix from shared memory (Q staged once per tile), f32 out;
// - softmax: each warp takes 4 rows, one key per lane, through a
//   16 x 32 f32 score tile in shared memory; P goes back to shared
//   memory as two bf16 terms (value and remainder, as the narrow tile
//   splits it, for the 1e-2 bf16 tolerance);
// - O += P V: each warp owns D / 4 output columns (144 at 576: 18 n8
//   blocks, 72 f32 accumulators a thread), P's A fragments and V's B
//   fragments (ldmatrix.trans) from shared memory.
// K and V chunks are staged by 16-byte cp.async into a 2-stage ring
// (bf16: 2 x 73 KB), so chunk c + 1 loads while chunk c computes; the
// block takes ~173 KB of shared memory, one block per SM.
//
// Bound on this card: the K/V bytes of each span (at G = 16, 2 flops a
// byte per head in bf16, under the tensor cores' ridge). Each block
// reads its span's visible pages for one row of 16 heads, so a long
// prefill span reads its pages once per row, from L2 after the first:
// right and simple first; a tile over several rows is later work.
// Not done: wgmma, TMA, more rows per block.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include <cstdint>

#include "paged_attention.cuh"
#include "paged_attention_tc.cuh"

namespace paged_wide {

using bf16 = __nv_bfloat16;
using paged::kNegInf;
using paged::warp_max;
using paged::warp_sum;
using paged_tc::cp_async_commit;
using paged_tc::cp_async_wait;
using paged_tc::kPTerms;
using paged_tc::ldmatrix_x4;
using paged_tc::ldmatrix_x4_trans;
using paged_tc::mma_bf16;
using paged_tc::TileArgs;
using paged_tc::TileSpan;

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kM = 16;                       // query vectors per block
constexpr int kN = 32;                       // keys per chunk
constexpr int kStages = 2;
constexpr int kMaxD = paged::kMaxWideHeadDim;
constexpr int kNB = kMaxD / kWarps / 8;      // n8 output blocks per warp at kMaxD
constexpr int kPS = kN + 8;                  // P row, bf16 (80 bytes: ldmatrix bank spread)
constexpr int kSS = kN + 1;                  // score row, f32

template <typename C>
constexpr bool kIsInt8 = std::is_same<C, int8_t>::value;

// One ring stage: K rows [kN][D + VEC] and V rows in C, then, for int8,
// the keys' k and v scales [kN] each.
template <typename C>
__host__ __device__ inline int stage_bytes(int D) {
  return 2 * kN * (D + 16 / (int)sizeof(C)) * (int)sizeof(C) +
         (kIsInt8<C> ? 2 * kN * (int)sizeof(float) : 0);
}

// ring | int8: chunk as bf16 [2 kN][D + 8] | q [kM][D + 8] bf16 |
// scores [kM][kSS] f32 | P terms [kPTerms][kM][kPS] bf16 | corr, l [kM] f32.
template <typename C>
inline size_t smem_bytes(int D) {
  return (size_t)kStages * stage_bytes<C>(D) +
         (kIsInt8<C> ? (size_t)2 * kN * (D + 8) * sizeof(bf16) : 0) +
         (size_t)kM * (D + 8) * sizeof(bf16) + (size_t)kM * kSS * sizeof(float) +
         (size_t)kPTerms * kM * kPS * sizeof(bf16) + (size_t)2 * kM * sizeof(float);
}

// One tile: query vectors [qv0, qv0 + kM) of span sp, kv head h. Only
// the ragged kernel's layout: table column j is logical page j
// (page_off 0, stride 1).
template <typename C>
__device__ __forceinline__ void wide_tile(const TileArgs<C>& a, const TileSpan& sp, int h,
                                          int qv0) {
  constexpr bool kInt8 = kIsInt8<C>;
  constexpr int VEC = 16 / sizeof(C);

  const int G = a.H / a.kvH;
  const int nvec = sp.nrows * G;
  if (qv0 >= nvec) return;
  const int D = a.D;
  const int bs = a.block_size;
  const int bs_log = a.bs_log;
  const int q0 = sp.q0;
  const int kv = sp.kv;
  const int* table = sp.table;

  // The tile's keys, as tc_tile computes them.
  const int nqv = min(kM, nvec - qv0);
  const int first_row = qv0 / G;
  const int last_row = (qv0 + nqv - 1) / G;
  const int hi = min(q0 + last_row + 1, kv);
  const int hi_u = ((hi + bs - 1) / bs) * bs;
  const int lo_u = a.window > 0 ? (max(q0 + first_row - a.window + 1, 0) / bs) * bs : 0;
  const int chunks = hi_u > lo_u ? (hi_u - lo_u + kN - 1) / kN : 0;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int SD = D + 8;                      // bf16 rows for ldmatrix, elements
  const int SDc = D + VEC;                   // staged rows, elements of C
  const int sbytes = stage_bytes<C>(D);
  auto stage = [&](int c) { return reinterpret_cast<C*>(smem_raw + (c % kStages) * sbytes); };
  unsigned char* p = smem_raw + kStages * sbytes;
  bf16* const cv = reinterpret_cast<bf16*>(p);          // int8 only
  if (kInt8) p += (size_t)2 * kN * SD * sizeof(bf16);
  bf16* const q_s = reinterpret_cast<bf16*>(p);
  p += (size_t)kM * SD * sizeof(bf16);
  float* const s_s = reinterpret_cast<float*>(p);
  p += (size_t)kM * kSS * sizeof(float);
  bf16* const p_s = reinterpret_cast<bf16*>(p);
  p += (size_t)kPTerms * kM * kPS * sizeof(bf16);
  float* const corr_s = reinterpret_cast<float*>(p);
  float* const l_s = corr_s + kM;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  // kTPK threads stage one key's K and V rows: one page lookup each.
  constexpr int kTPK = kThreads / kN;
  const int ld_j = tid / kTPK;
  const int ld_d0 = (tid % kTPK) * VEC;
  auto issue = [&](int c) {
    C* ks = stage(c) + ld_j * SDc;
    C* vs = ks + kN * SDc;
    const int u = lo_u + c * kN + ld_j;
    const bool ok = u < hi_u && u < hi;
    int page = 0;
    size_t row = 0;
    if (ok) {
      page = table[min(u >> bs_log, a.max_blocks - 1)];
      row = ((size_t)(page * bs + (u & (bs - 1))) * a.kvH + h) * D;
    }
    for (int d0 = ld_d0; d0 < D; d0 += kTPK * VEC) {
      paged::cp_async16(ks + d0, a.k_cache + row + d0, ok ? 16 : 0);
      paged::cp_async16(vs + d0, a.v_cache + row + d0, ok ? 16 : 0);
    }
    if constexpr (kInt8) {
      if (ld_d0 == 0) {
        float* sc = reinterpret_cast<float*>(stage(c) + 2 * kN * SDc);
        const size_t si = (size_t)page * a.kvH + h;
        paged::cp_async4(sc + ld_j, a.k_scales + si, ok ? 4 : 0);
        paged::cp_async4(sc + kN + ld_j, a.v_scales + si, ok ? 4 : 0);
      }
    }
  };

  if (chunks > 0) issue(0);
  cp_async_commit();

  // Q once: vector i of the tile is row q0 + (qv0 + i) / G; vectors past
  // the span are zeros.
  for (int e = tid; e < kM * (D / 8); e += kThreads) {
    const int i = e / (D / 8);
    const int d0 = (e - i * (D / 8)) * 8;
    const int v = qv0 + i;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (v < nvec)
      val = *reinterpret_cast<const uint4*>(
          a.q + (((size_t)sp.row0 + v / G) * a.H + h * G + v % G) * D + d0);
    *reinterpret_cast<uint4*>(q_s + i * SD + d0) = val;
  }

  const int g = lane >> 2;
  const int t4 = lane & 3;
  // The softmax rows of this warp (4w .. 4w+3): their running max and sum.
  float m_r[4], l_r[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    m_r[r] = kNegInf;
    l_r[r] = 0.f;
  }
  // O columns [col0, col0 + D/4) for rows g and g + 8.
  const int cw = D / kWarps;
  const int col0 = warp * cw;
  float o[kNB][4];
#pragma unroll
  for (int i = 0; i < kNB; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
  const int posA = q0 + (qv0 + g) / G;
  const int posB = q0 + (qv0 + g + 8) / G;

  for (int c = 0; c < chunks; ++c) {
    cp_async_wait<0>();
    __syncthreads();   // chunk c landed everywhere; chunk c - 1 fully consumed
    if (c + 1 < chunks) issue(c + 1);
    cp_async_commit();

    const bf16* ks;
    const float* k_sc = nullptr;
    const float* v_sc = nullptr;
    if constexpr (kInt8) {
      // int8 -> bf16, unscaled and exact (|x| <= 127).
      const int8_t* src = stage(c);
      const int vecs = D / 16;
      for (int e = tid; e < 2 * kN * vecs; e += kThreads) {
        const int r = e / vecs;
        const int d0 = (e - r * vecs) * 16;
        const uint4 raw = *reinterpret_cast<const uint4*>(src + r * SDc + d0);
        const int8_t* b = reinterpret_cast<const int8_t*>(&raw);
        uint32_t w[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const __nv_bfloat162 h2 = __floats2bfloat162_rn(static_cast<float>(b[2 * i]),
                                                          static_cast<float>(b[2 * i + 1]));
          w[i] = *reinterpret_cast<const uint32_t*>(&h2);
        }
        uint4* dst = reinterpret_cast<uint4*>(cv + r * SD + d0);
        dst[0] = make_uint4(w[0], w[1], w[2], w[3]);
        dst[1] = make_uint4(w[4], w[5], w[6], w[7]);
      }
      k_sc = reinterpret_cast<const float*>(src + 2 * kN * SDc);
      v_sc = k_sc + kN;
      ks = cv;
      __syncthreads();
    } else {
      ks = stage(c);
    }
    const bf16* vs = ks + kN * SD;
    const int c0 = lo_u + c * kN;

    // S for this warp's 8 keys: two k-steps per ldmatrix of K.
    {
      float s[4] = {0.f, 0.f, 0.f, 0.f};
      const bf16* kr = ks + (warp * 8 + (lane & 7)) * SD + (lane >> 3) * 8;
      const bf16* qr = q_s + (lane & 15) * SD + (lane >> 4) * 8;
      for (int k0 = 0; k0 < D; k0 += 32) {
        uint32_t b[4], qa[4], qb[4];
        ldmatrix_x4(b, kr + k0);
        ldmatrix_x4(qa, qr + k0);
        ldmatrix_x4(qb, qr + k0 + 16);
        mma_bf16(s, qa, b[0], b[1]);
        mma_bf16(s, qb, b[2], b[3]);
      }
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int j = warp * 8 + 2 * t4 + e;
        const int key = c0 + j;
        const float f = kInt8 ? k_sc[j] * a.scale : a.scale;
        const bool in = key < hi;
        const bool okA = in && key <= posA && (a.window <= 0 || key > posA - a.window);
        const bool okB = in && key <= posB && (a.window <= 0 || key > posB - a.window);
        s_s[g * kSS + j] = okA ? s[e] * f : kNegInf;
        s_s[(g + 8) * kSS + j] = okB ? s[2 + e] * f : kNegInf;
      }
    }
    __syncthreads();

    // Online softmax: rows 4w .. 4w+3, one key per lane.
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = warp * 4 + r;
      const float x = s_s[row * kSS + lane];
      const float m_new = fmaxf(m_r[r], warp_max(x));
      const float corr = expf(m_r[r] - m_new);
      const float pr = x > kNegInf ? expf(x - m_new) : 0.f;
      l_r[r] = l_r[r] * corr + warp_sum(pr);
      m_r[r] = m_new;
      float pv = kInt8 ? pr * v_sc[lane] : pr;
#pragma unroll
      for (int t = 0; t < kPTerms; ++t) {
        const bf16 hv = __float2bfloat16_rn(pv);
        p_s[(t * kM + row) * kPS + lane] = hv;
        pv -= __bfloat162float(hv);
      }
      if (lane == 0) corr_s[row] = corr;
    }
    __syncthreads();

    // O += P V over this warp's columns.
    const float cA = corr_s[g], cB = corr_s[g + 8];
#pragma unroll
    for (int i = 0; i < kNB; ++i) {
      o[i][0] *= cA;
      o[i][1] *= cA;
      o[i][2] *= cB;
      o[i][3] *= cB;
    }
#pragma unroll
    for (int kk = 0; kk < kN / 16; ++kk) {
      uint32_t pa[kPTerms][4];
#pragma unroll
      for (int t = 0; t < kPTerms; ++t)
        ldmatrix_x4(pa[t], p_s + (t * kM + (lane & 15)) * kPS + kk * 16 + (lane >> 4) * 8);
      const bf16* vr = vs + (kk * 16 + (((lane >> 3) & 1) << 3) + (lane & 7)) * SD + col0 +
                       ((lane >> 4) << 3);
#pragma unroll
      for (int nb = 0; nb < kNB; nb += 2) {
        if (nb * 8 < cw) {
          uint32_t b[4];
          ldmatrix_x4_trans(b, vr + nb * 8);
#pragma unroll
          for (int t = kPTerms - 1; t >= 0; --t) {   // smallest terms first
            mma_bf16(o[nb], pa[t], b[0], b[1]);
            mma_bf16(o[nb + 1], pa[t], b[2], b[3]);
          }
        }
      }
    }
  }

  if (lane == 0) {
#pragma unroll
    for (int r = 0; r < 4; ++r) l_s[warp * 4 + r] = l_r[r];
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int v = qv0 + g + 8 * r;
    if (v >= nvec) continue;
    const float l = l_s[g + 8 * r];
    const float den = fmaxf(l, 1e-30f);
    bf16* out = static_cast<bf16*>(a.out) + (((size_t)sp.row0 + v / G) * a.H + h * G + v % G) * D;
#pragma unroll
    for (int nb = 0; nb < kNB; ++nb) {
      if (nb * 8 < cw) {
        const int d = col0 + nb * 8 + 2 * t4;
        const float x0 = l > 0.f ? o[nb][2 * r] / den : 0.f;
        const float x1 = l > 0.f ? o[nb][2 * r + 1] / den : 0.f;
        *reinterpret_cast<__nv_bfloat162*>(out + d) = __floats2bfloat162_rn(x0, x1);
      }
    }
  }
}

}  // namespace paged_wide
