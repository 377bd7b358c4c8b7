// Tensor-core tile of the port's bf16 paged attention for Hopper
// (sm_90a), a FlashAttention-2-style block over a paged KV cache: the
// body of the bf16 prefill kernel (paged_prefill_attention.cu, lane n is
// the span of rows [n*T, (n+1)*T)) and of the ragged kernel's multi-row
// spans and, at D = 64, 128 and 256, its short spans' splits
// (ragged_attention.cu, span s is rows [row_start, row_start + q_len) of
// the flat batch; the tile neither reads nor writes a row past its span,
// which belongs to the next span).
//
// Replaces, for bf16, the walk `attend_tile` (paged_attention.cuh) as the
// body of `_prefill_kernel` in dynamo_tpu/ops/pallas/attention.py and of
// `_ragged_kernel` in dynamo_tpu/ops/pallas/ragged_attention.py; the f32
// legs keep that walk, since a float32 product on tensor cores would be
// TF32 and break the f32 tolerance. The contract is the walk's, row for
// row.
//
// Bound on this card. Causal prefill does 4 x rows x visible keys x H x D
// flops: at the phase-split run's T=512 ~3.8 GFLOP, 0.0039 ms on the
// tensor cores (989 TFLOP/s bf16), against ~20 MB of q, out and K/V,
// 0.0059 ms at 3.35 TB/s; mistral-7b's prefill spans over their 4096-key
// windows (ragged kernel) ~11 GFLOP, 0.011 ms, against 0.011 ms of
// bytes. Both floors sit an order of magnitude below a tile that issues
// its products, softmax and staging from few warps, so the design spends
// the tensor cores on the products and keeps every other instruction per
// key few:
// - Tile. A block owns kM = 128 query VECTORS of one (lane, kv head), 8
//   warps of 16 (the m16 of mma.m16n8k16). Vector v sits at row v / G and
//   head h*G + v % G, as in attend_tile: the G query heads of the kv head
//   fold into M, so every staged K/V chunk serves all of them (at
//   llama3.2-1b's G = 4 a tile is 32 positions x 4 heads), and 8 warps
//   share each chunk's staging. The ragged kernel also runs one-warpgroup
//   tiles (kW = 4, 64 vectors) as the split blocks of its short spans.
// - K/V. Chunks of kN keys (64; 32 at D = 256, for registers) gathered
//   page by page through the block table and staged by 16-byte cp.async
//   into a ring of kStages = 3, so chunks c+1 and c+2 load while chunk c
//   computes. Keys the tile cannot see are zero-filled by the copy itself
//   (src-size 0), never read from the cache.
// - Products, the wgmma entry (kWg: the ragged kernel at D = 64, 128 and
//   256). Each warpgroup's 64 vectors take S = Q K^T as one m64n{kN}k16
//   per 16 d (Q's fragments from registers; at D = 256 from 128-byte
//   swizzled atoms in shared memory, so the accumulators fit without a
//   spill) and O += P V as m64n64k16 per 64 d columns and 16 keys. K and
//   V are staged as 128-byte swizzled atoms (64 d x kN keys): K is a
//   K-major B and V, read through the same atoms, an MN-major one.
// - Products, the mma.sync entry (the prefill kernel; other head dims).
//   S = Q K^T and O += P V are mma.sync m16n8k16 bf16 with f32
//   accumulators on rows padded to D + 8 elements (the 8 rows of every
//   ldmatrix phase on distinct banks); K fragments come by ldmatrix, V's
//   by ldmatrix.trans, Q's once per tile into registers (at D = 256 from
//   a shared Q tile per k-step, which keeps the tile under 255 registers
//   with no spill).
// - Both entries: bf16 values of q unchanged; the 1/sqrt(D) scale
//   multiplies the f32 scores, so S is exact products summed in f32. P
//   enters P V from registers as two bf16 terms, value and remainder
//   (split_bf16: one bf16 P, as FlashAttention-2 rounds it, misses the
//   1e-2 tolerance by a bf16 ulp), two products per step. The
//   accumulators of either entry sit in the m16n8 layout, so the
//   softmax, masks and epilogue are one code.
// - Softmax. Online in f32 registers; each MMA row lives in a quad of 4
//   threads, whose max reduces by __shfl_xor_sync 1 and 2; row sums stay
//   per thread until the end. Each weight is one FMA and one ex2.approx:
//   2^(s * scale*log2e - m*log2e), whose error (~3e-7 relative) sits far
//   below the split's 2^-17.
// - Occupancy. At D <= 64 the tile is held to 128 registers a thread
//   (__launch_bounds__(256, 2)): two blocks of 8 warps per SM.
// - Masks. The chunk range is attend_tile's (the tile's first row's
//   window page to its last row's causal bound; whole chunks outside are
//   never loaded), cut into a.ranges balanced runs of columns when the
//   caller splits the keys; the element mask (causal, total_len, window,
//   striped positions) runs only where a chunk crosses an edge of the
//   warp's rows. Grid (lane, kv head, tile), tiles reversed: the
//   heaviest tiles of every (lane, kv head) start first.
// - int8 caches (the ragged kernel's int8 leg): pages are staged as int8
//   by the same cp.async ring (16 values per copy) with each key's page
//   scales (4-byte cp.async), converted to bf16 WITHOUT scaling (|x| <=
//   127 is exact in bf16) into one bf16 chunk (swizzled atoms on the
//   wgmma entry), and the scales are folded into the f32 side of the
//   products: S = (q.k_int) k_s column by column, and P v_s before P's
//   two-term split (O += (P v_s) v_int). The products stay exact as the
//   bf16 leg's do; dequantizing to bf16 would round k*s to 8 bits.
// - Head dims. Templated on DP, D rounded up to a power of two (16..256);
//   on mma.sync, k-steps and d-blocks at or past the true D are skipped,
//   so nothing is zero-filled for D = 96; the wgmma entry takes D = DP.
// Not done, and not tried on the card: TMA staging and a producer warp,
// int8 pages converted in registers, overlap of one chunk's softmax with
// the next chunk's products, a persistent grid.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include <cstdint>

#include "hopper.cuh"            // wgmma, the swizzled tile's descriptor
#include "paged_attention.cuh"   // kNegInf

namespace paged_tc {

using bf16 = __nv_bfloat16;

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kM = 16 * kWarps;       // query vectors per block
constexpr int kStages = 3;            // K/V ring depth
constexpr float kLog2e = 1.4426950408889634f;

template <int DP> struct Shape {
  static constexpr int kN = DP >= 256 ? 32 : 64;   // keys per chunk
  // Q's fragments: in registers (KS x 4 a thread), or at DP = 256 read
  // from a shared [kM][D + 8] tile per k-step, which keeps the tile
  // under 255 registers with no spill.
  static constexpr bool kQSmem = DP >= 256;
};

// log2 of a power-of-two block size, or -1.
inline int bs_log2(int bs) {
  int lg = 0;
  while ((1 << lg) < bs) ++lg;
  return (1 << lg) == bs ? lg : -1;
}

inline int dp_for(int D) {
  int dp = 16;
  while (dp < D) dp *= 2;
  return dp;
}

template <typename C>
constexpr bool kIsInt8 = std::is_same<C, int8_t>::value;

// One ring stage: K rows [kN][D + VEC] and V rows in C (VEC = 16 bytes
// of padding), then, for int8, the keys' k and v scales [kN] each. kWg
// (the wgmma entry, D a multiple of 64) with bf16 caches: K then V, each
// D / 64 swizzled atoms of kN 128-byte rows (hopper::smem_desc_sw128),
// no padding.
template <typename C, int DP, bool kWg = false>
__host__ __device__ inline int stage_bytes(int D) {
  constexpr int kN = Shape<DP>::kN;
  if (kWg && !kIsInt8<C>) return 2 * kN * D * (int)sizeof(bf16);
  return 2 * kN * (D + 16 / (int)sizeof(C)) * (int)sizeof(C) +
         (kIsInt8<C> ? 2 * kN * (int)sizeof(float) : 0);
}

// The ring, for int8 the chunk converted to bf16 (K rows then V rows),
// and at DP = 256 the Q tile; kWg: for int8 the converted chunk in
// swizzled atoms, at DP = 256 the Q tile in swizzled atoms (kW / 4
// warpgroups of 64 vectors), then the ring, from a 1024-byte boundary.
template <typename C, int DP, bool kWg = false, int kW = kWarps>
inline size_t smem_bytes(int D) {
  if (kWg)
    return (size_t)kStages * stage_bytes<C, DP, true>(D) +
           (kIsInt8<C> ? (size_t)2 * Shape<DP>::kN * D * sizeof(bf16) : 0) +
           (DP == 256 ? (size_t)16 * kW * D * sizeof(bf16) : 0) + 1024;
  return (size_t)kStages * stage_bytes<C, DP>(D) +
         (kIsInt8<C> ? (size_t)2 * Shape<DP>::kN * (D + 8) * sizeof(bf16) : 0) +
         (Shape<DP>::kQSmem ? (size_t)kM * (D + 8) * sizeof(bf16) : 0);
}

template <typename C>
struct TileArgs {
  const bf16* q;            // [rows, H, D]
  const C* k_cache;         // [slots, kvH, D], bf16 or int8
  const C* v_cache;
  const float* k_scales;    // [num_blocks, kvH] for an int8 cache, else null
  const float* v_scales;
  void* out;                // bf16, or float with stats
  float* m_out;             // [rows, H] or null
  float* l_out;
  int H, kvH, D, max_blocks, block_size, bs_log, window, page_stride;
  float scale;
  // Key ranges (0 or 1: one): balanced runs of the columns a tile's rows
  // can see. With more, the block of range r writes its rows' partials
  // (f32 out normalized, m, l) at [row, head, r] of out [rows, H, ranges,
  // D] and m_out/l_out [rows, H, ranges].
  int ranges;
};

// The rows one tile serves: row i of the span is flat row row0 + i of q
// (orow0 + i of out) at position q0 + i; keys < kv; table column j is
// logical page page_off + j*stride.
struct TileSpan {
  int row0, nrows, q0, kv, page_off;
  const int* table;
  int orow0;
};

using paged::cp_async16;
using paged::cp_async4;
using paged::smem_addr;
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// d[0..3] += a (16x16 bf16, row) * b (16x8 bf16, col), f32 accumulate.
__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// (x0, x1) as kPTerms bf16 pairs whose sum is (x0, x1) to ~2^-17
// relative: pa[0][r] the rounded values, pa[1][r] the rounded
// remainders. One bf16 P (FlashAttention-2) moves an output by up to
// 2^-9 relative, which flips its final bf16 rounding in [2, 4) by an ulp
// of 0.0156, past the 1e-2 tolerance: dynamo_tpu_torch/tools/
// p_split_precision.py, emulating the split on the main prefill case's
// shapes, puts 13 of 24 lanes past 1e-2 with one term and 0 of 160 with
// two (worst 0.0078, a flip in [1, 2)); one term measured 0.0156 on the
// card. The second term costs one more MMA per P.V step.
constexpr int kPTerms = 2;

__device__ __forceinline__ float ex2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t (*pa)[4], int r) {
#pragma unroll
  for (int t = 0; t < kPTerms; ++t) {
    const __nv_bfloat162 v = __floats2bfloat162_rn(x0, x1);
    pa[t][r] = *reinterpret_cast<const uint32_t*>(&v);
    const float2 back = __bfloat1622float2(v);
    x0 -= back.x;
    x1 -= back.y;
  }
}

// Logical position of local key u (bs = 1 << bs_log).
__device__ __forceinline__ int tc_key_pos(int u, int bs_log, int off, int stride) {
  const int lp = u >> bs_log;
  return ((off + lp * stride) << bs_log) + (u & ((1 << bs_log) - 1));
}

// One tile: 16 * kW query vectors from qv0 of span sp, kv head h, over
// key range `range` of a.ranges: the range-th of a.ranges balanced runs
// of the table columns the tile's rows can see (from its first row's
// window page to its last row's causal bound). A run with no column
// writes l = 0.
// kWg: the products on wgmma (D = DP a multiple of 64): each warpgroup's
// 64 query vectors take S = Q K^T as m64n{kN}k16 with Q's fragments from
// registers and K from swizzled atoms, and O += P V as m64n64k16 per 64 d
// columns with P's two bf16 terms from registers and V from the same
// atoms read MN-major. bf16 pages are staged into the atoms' swizzle by
// cp.async; int8 pages are staged as before and converted into the
// atoms. Accumulators sit in mma.sync's m16n8 layout, so the softmax,
// masks and epilogue are the same code.
//
// kW warps a block: 8 (the tile of 128 query vectors), or 4 on the wgmma
// entry (one warpgroup of 64: the split blocks of short spans).
template <typename C, int DP, bool kWg = false, int kW = kWarps>
__device__ __forceinline__ void tc_tile(const TileArgs<C>& a, const TileSpan& sp, int h,
                                        int qv0, int range = 0) {
  constexpr int kT = 32 * kW;      // threads
  constexpr int kMW = 16 * kW;     // query vectors
  static_assert(kW == kWarps || (kWg && kW == 4), "4-warp tiles are one wgmma warpgroup");
  constexpr int kN = Shape<DP>::kN;
  constexpr int KS = DP / 16;      // k-steps of S = Q K^T
  constexpr int ND = DP / 8;       // 8-wide d blocks of O
  constexpr int NB = kN / 8;       // 8-key blocks of S
  constexpr bool kInt8 = kIsInt8<C>;
  constexpr bool kQS = Shape<DP>::kQSmem && !kWg;
  constexpr bool kQA = kWg && DP == 256;   // Q's atoms in shared memory, wgmma's A
  constexpr int VEC = 16 / sizeof(C);
  static_assert(!kWg || DP % 64 == 0, "the wgmma entry takes D = 64, 128 or 256");

  const int G = a.H / a.kvH;
  const int nvec = sp.nrows * G;
  if (qv0 >= nvec) return;
  const int D = a.D;
  const int bs = a.block_size;
  const int bs_log = a.bs_log;
  const int stride = a.page_stride;
  const int off = sp.page_off;
  const int q0 = sp.q0;
  const int kv = sp.kv;
  const int* table = sp.table;

  // The tile's scan, as attend_tile computes it.
  const int nqv = min(kMW, nvec - qv0);
  const int first_row = qv0 / G;
  const int last_row = (qv0 + nqv - 1) / G;
  const int hi = min(q0 + last_row + 1, kv);
  const int hi_pages = (hi + bs - 1) / bs;
  int lo_page = 0;
  if (a.window > 0) lo_page = max(q0 + first_row - a.window + 1, 0) / bs;
  int lo_col = max((lo_page - off + stride - 1) / stride, 0);
  int hi_col = max((hi_pages - off + stride - 1) / stride, 0);
  if (a.ranges > 1) {   // this block's balanced run of the visible columns
    const int n = max(hi_col - lo_col, 0);
    hi_col = lo_col + (range + 1) * n / a.ranges;
    lo_col += range * n / a.ranges;
  }
  const int lo_u = lo_col * bs;
  const int hi_u = hi_col * bs;
  const int chunks = hi_u > lo_u ? (hi_u - lo_u + kN - 1) / kN : 0;

  extern __shared__ __align__(16) unsigned char smem_dyn[];
  // kWg: the swizzled atoms need 1024-byte alignment.
  unsigned char* const smem_raw =
      kWg ? smem_dyn + ((1024 - (hopper::smem_addr(smem_dyn) & 1023)) & 1023) : smem_dyn;
  const int SD = D + 8;                               // bf16 row for ldmatrix, elements
  const int SDc = D + VEC;                            // staged row, elements of C
  const int sbytes = stage_bytes<C, DP, kWg>(D);
  // kWg: int8's converted chunk first, on the aligned base, then kQA's
  // Q atoms, then the ring.
  const int cv_bytes = kWg && kInt8 ? 2 * kN * D * (int)sizeof(bf16) : 0;
  const int ring0 = cv_bytes + (kQA ? kMW * D * (int)sizeof(bf16) : 0);
  auto stage = [&](int c) {
    return reinterpret_cast<C*>(smem_raw + ring0 + (c % kStages) * sbytes);
  };
  // int8: the chunk being computed, converted to bf16 (K rows, then V rows).
  bf16* const cv = reinterpret_cast<bf16*>(kWg ? smem_raw : smem_raw + kStages * sbytes);
  // kQS: the Q tile [kM][SD], after the ring (and the int8 chunk).
  bf16* const qs = cv + (kInt8 ? 2 * kN * SD : 0);
  bf16* const qa = reinterpret_cast<bf16*>(smem_raw + cv_bytes);   // kQA

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  // kTPK threads stage one key's K and V rows: one page lookup each.
  constexpr int kTPK = kT / kN;
  const int ld_j = tid / kTPK;
  const int ld_d0 = (tid % kTPK) * VEC;
  auto issue = [&](int c) {
    C* ks = stage(c) + ld_j * SDc;
    C* vs = ks + kN * SDc;
    const int u = lo_u + c * kN + ld_j;
    const int lp = u >> bs_log;
    const int pos = ((off + lp * stride) << bs_log) + (u & (bs - 1));
    const bool ok = u < hi_u && pos < hi;
    int page = 0;
    size_t row = 0;
    if (ok) {
      page = table[min(lp, a.max_blocks - 1)];
      row = ((size_t)(page * bs + (u & (bs - 1))) * a.kvH + h) * D;
    }
    for (int d0 = ld_d0; d0 < D; d0 += kTPK * VEC) {
      if constexpr (kWg && !kInt8) {   // atom d0 / 64, row ld_j, 16-byte chunk swizzled
        const int cidx = d0 / 8;
        const int at = (cidx >> 3) * kN * 64 + ld_j * 64 + (((cidx & 7) ^ (ld_j & 7)) << 3);
        C* const kb = stage(c);
        cp_async16(kb + at, a.k_cache + row + d0, ok ? 16 : 0);
        cp_async16(kb + kN * D + at, a.v_cache + row + d0, ok ? 16 : 0);
      } else {
        cp_async16(ks + d0, a.k_cache + row + d0, ok ? 16 : 0);
        cp_async16(vs + d0, a.v_cache + row + d0, ok ? 16 : 0);
      }
    }
    if constexpr (kInt8) {
      if (ld_d0 == 0) {
        float* sc = reinterpret_cast<float*>(stage(c) + 2 * kN * SDc);
        const size_t si = (size_t)page * a.kvH + h;
        cp_async4(sc + ld_j, a.k_scales + si, ok ? 4 : 0);
        cp_async4(sc + kN + ld_j, a.v_scales + si, ok ? 4 : 0);
      }
    }
  };

  // Keep kStages - 1 chunks in flight; one commit group per chunk slot,
  // empty past the end, so the wait_group count stays uniform.
#pragma unroll
  for (int c = 0; c < kStages - 1; ++c) {
    if (c < chunks) issue(c);
    cp_async_commit();
  }

  // This thread's two MMA rows: vectors vA (row g of the warp's 16) and
  // vB (row g + 8).
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int wv0 = qv0 + warp * 16;
  const int vA = wv0 + g;
  const int vB = vA + 8;
  const bool warp_live = wv0 < nvec;
  // kWg: a warpgroup's four warps issue its products together.
  const bool compute_live = kWg ? qv0 + (warp >> 2) * 64 < nvec : warp_live;
  const int posA = q0 + vA / G;
  const int posB = q0 + vB / G;
  const int wpos_lo = q0 + wv0 / G;
  const int wpos_hi = q0 + (min(wv0 + 15, nvec - 1)) / G;

  // Q fragments, once: a0 (vA, k 2t..), a1 (vB, k 2t..), a2 (vA, k 8+2t..),
  // a3 (vB, k 8+2t..) of each k-step. Vectors past the span read nothing.
  // kQS: the Q tile staged instead (vectors past the span zero), its
  // fragments read per k-step by ldmatrix after the loop's first barrier.
  uint32_t qf[kQS || kQA ? 1 : KS][4];
  if constexpr (kQA) {
    // Warpgroup vi / 64's atoms: d columns [64j, 64j + 64) of its 64
    // vectors, 128-byte rows, 16-byte chunks swizzled.
    const int per_vec = D / 8;
    for (int e = tid; e < kMW * per_vec; e += kT) {
      const int vi = e / per_vec;
      const int cidx = e - vi * per_vec;
      const int v = qv0 + vi;
      uint4 x = make_uint4(0u, 0u, 0u, 0u);
      if (v < nvec)
        x = *reinterpret_cast<const uint4*>(
            a.q + (((size_t)sp.row0 + v / G) * a.H + h * G + v % G) * D + cidx * 8);
      const int r = vi & 63;
      *reinterpret_cast<uint4*>(qa + (vi >> 6) * 64 * D + (cidx >> 3) * 64 * 64 + r * 64 +
                                (((cidx & 7) ^ (r & 7)) << 3)) = x;
    }
    hopper::fence_async_shared();
  } else if constexpr (kQS) {
    const int per_vec = D / 8;
    for (int e = tid; e < kMW * per_vec; e += kT) {
      const int vi = e / per_vec;
      const int d0 = (e - vi * per_vec) * 8;
      const int v = qv0 + vi;
      uint4 x = make_uint4(0u, 0u, 0u, 0u);
      if (v < nvec)
        x = *reinterpret_cast<const uint4*>(
            a.q + (((size_t)sp.row0 + v / G) * a.H + h * G + v % G) * D + d0);
      *reinterpret_cast<uint4*>(qs + vi * SD + d0) = x;
    }
  } else {
    const bf16* qa = a.q + (((size_t)sp.row0 + vA / G) * a.H + h * G + vA % G) * D;
    const bf16* qb = a.q + (((size_t)sp.row0 + vB / G) * a.H + h * G + vB % G) * D;
    const bool okA = vA < nvec, okB = vB < nvec;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      if (ks * 16 < D) {
        const int c = ks * 16 + 2 * t4;
        qf[ks][0] = okA ? *reinterpret_cast<const uint32_t*>(qa + c) : 0u;
        qf[ks][1] = okB ? *reinterpret_cast<const uint32_t*>(qb + c) : 0u;
        qf[ks][2] = okA ? *reinterpret_cast<const uint32_t*>(qa + c + 8) : 0u;
        qf[ks][3] = okB ? *reinterpret_cast<const uint32_t*>(qb + c + 8) : 0u;
      } else {
        qf[ks][0] = qf[ks][1] = qf[ks][2] = qf[ks][3] = 0u;
      }
    }
  }

  float o[ND][4];
#pragma unroll
  for (int i = 0; i < ND; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
  float m_row[2] = {paged::kNegInf, paged::kNegInf};
  float l_row[2] = {0.f, 0.f};

  // ldmatrix lane offsets: K (non-trans) key = (l/16)*8 + l%8, d = ((l/8)%2)*8;
  // V (trans) key = ((l/8)%2)*8 + l%8, d = (l/16)*8.
  const int k_row = ((lane >> 4) << 3) + (lane & 7);
  const int k_col = ((lane >> 3) & 1) << 3;
  const int v_row = (((lane >> 3) & 1) << 3) + (lane & 7);
  const int v_col = (lane >> 4) << 3;

  for (int c = 0; c < chunks; ++c) {
    cp_async_wait<kStages - 2>();
    // kWg: the copies' writes made visible to wgmma's (async proxy) reads.
    if constexpr (kWg && !kInt8) hopper::fence_async_shared();
    __syncthreads();   // chunk c landed everywhere; chunk c - 1 fully consumed
    if (c + kStages - 1 < chunks) issue(c + kStages - 1);
    cp_async_commit();

    const bf16* ks;
    const float* k_sc = nullptr;   // int8: the chunk's per-key scales
    const float* v_sc = nullptr;
    if constexpr (kInt8) {
      // int8 -> bf16, unscaled and exact, 16 values per thread and step.
      const int8_t* src = stage(c);
      const int vecs = D / 16;
      for (int e = tid; e < 2 * kN * vecs; e += kT) {
        const int r = e / vecs;
        const int d0 = (e - r * vecs) * 16;
        const uint4 raw = *reinterpret_cast<const uint4*>(src + r * SDc + d0);
        const uint32_t b[4] = {raw.x, raw.y, raw.z, raw.w};
        uint32_t w[8];
#pragma unroll
        for (int i = 0; i < 4; ++i) hopper::int8x4_to_bf16(b[i], w[2 * i], w[2 * i + 1]);
        if constexpr (kWg) {   // row r % kN of K's (V's) atom d0 / 64, swizzled
          const int rr = r % kN;
          const int cidx = d0 / 8;
          bf16* const at = cv + (r / kN) * kN * D + (cidx >> 3) * kN * 64 + rr * 64;
          *reinterpret_cast<uint4*>(at + (((cidx & 7) ^ (rr & 7)) << 3)) =
              make_uint4(w[0], w[1], w[2], w[3]);
          *reinterpret_cast<uint4*>(at + ((((cidx + 1) & 7) ^ (rr & 7)) << 3)) =
              make_uint4(w[4], w[5], w[6], w[7]);
        } else {
          uint4* dst = reinterpret_cast<uint4*>(cv + r * SD + d0);
          dst[0] = make_uint4(w[0], w[1], w[2], w[3]);
          dst[1] = make_uint4(w[4], w[5], w[6], w[7]);
        }
      }
      if constexpr (kWg) hopper::fence_async_shared();
      k_sc = reinterpret_cast<const float*>(src + 2 * kN * SDc);
      v_sc = k_sc + kN;
      ks = cv;
      __syncthreads();
    } else {
      ks = stage(c);
    }
    const bf16* vs = ks + kN * (kWg ? D : SD);

    if (compute_live) {
      const int c0 = lo_u + c * kN;

      // Mask only where the chunk crosses an edge of this warp's rows.
      const int pos_first = tc_key_pos(c0, bs_log, off, stride);
      const int pos_last = tc_key_pos(c0 + kN - 1, bs_log, off, stride);
      const bool clean = c0 + kN <= hi_u && pos_last < kv && pos_last <= wpos_lo &&
                         (a.window <= 0 || pos_first > wpos_hi - a.window);

      float s[NB][4];
#pragma unroll
      for (int i = 0; i < NB; ++i) s[i][0] = s[i][1] = s[i][2] = s[i][3] = 0.f;
      if constexpr (kWg) {
        hopper::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < KS; ++kk) {
          // Atom kk / 4, +32 bytes a k-step inside it.
          const uint64_t desc =
              hopper::smem_desc_sw128(ks + (kk >> 2) * kN * 64) + 2 * (kk & 3);
          if constexpr (kQA) {
            const uint64_t desc_q =
                hopper::smem_desc_sw128(qa + (warp >> 2) * 64 * D + (kk >> 2) * 64 * 64) +
                2 * (kk & 3);
            hopper::WgmmaSS<kN>::mma(&s[0][0], desc_q, desc);
          } else {
            hopper::Wgmma<kN>::mma(&s[0][0], qf[kk], desc);
          }
        }
        hopper::wgmma_commit();
        hopper::wgmma_wait<0>();
        hopper::fence_operands<NB * 4>(&s[0][0]);
      }
#pragma unroll
      for (int kk = 0; kk < (kWg ? 0 : KS); ++kk) {
        if (kk * 16 < D) {
          const uint32_t* qa = qf[kQS ? 0 : kk];
          if constexpr (kQS)
            ldmatrix_x4(qf[0], qs + (warp * 16 + (lane & 15)) * SD + kk * 16 + ((lane >> 4) << 3));
#pragma unroll
          for (int nb = 0; nb < NB; nb += 2) {
            uint32_t b[4];
            ldmatrix_x4(b, ks + (nb * 8 + k_row) * SD + kk * 16 + k_col);
            mma_bf16(s[nb], qa, b[0], b[1]);
            mma_bf16(s[nb + 1], qa, b[2], b[3]);
          }
        }
      }

      if constexpr (kInt8) {   // S = (q.k_int) k_s, column by column
#pragma unroll
        for (int nb = 0; nb < NB; ++nb) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float f = k_sc[nb * 8 + 2 * t4 + e];
            s[nb][e] *= f;
            s[nb][2 + e] *= f;
          }
        }
      }

      if (!clean) {
#pragma unroll
        for (int nb = 0; nb < NB; ++nb) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int u = c0 + nb * 8 + 2 * t4 + e;
            const int key = tc_key_pos(u, bs_log, off, stride);
            const bool in = u < hi_u && key < kv;
            const bool okA = in && key <= posA && (a.window <= 0 || key > posA - a.window);
            const bool okB = in && key <= posB && (a.window <= 0 || key > posB - a.window);
            if (!okA) s[nb][e] = paged::kNegInf;
            if (!okB) s[nb][2 + e] = paged::kNegInf;
          }
        }
      }

      // Online softmax per row (r = 0: vA, r = 1: vB), on the unscaled
      // scores: m is kept scaled (the stats' unit), and each weight is
      // 2^(s * scale*log2e - m*log2e), one fma and one ex2.
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mx = paged::kNegInf;
#pragma unroll
        for (int nb = 0; nb < NB; ++nb) mx = fmaxf(mx, fmaxf(s[nb][2 * r], s[nb][2 * r + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new =
            fmaxf(m_row[r], mx == paged::kNegInf ? paged::kNegInf : mx * a.scale);
        const float corr = __expf(m_row[r] - m_new);
        const bool empty = m_new == paged::kNegInf;   // nothing seen yet
        float sum = 0.f;
        const float scale2 = a.scale * kLog2e;
        const float m2 = m_new * kLog2e;
#pragma unroll
        for (int nb = 0; nb < NB; ++nb) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float p = empty ? 0.f : ex2_approx(fmaf(s[nb][2 * r + e], scale2, -m2));
            s[nb][2 * r + e] = p;
            sum += p;
          }
        }
        l_row[r] = l_row[r] * corr + sum;
        m_row[r] = m_new;
#pragma unroll
        for (int i = 0; i < ND; ++i) {
          o[i][2 * r] *= corr;
          o[i][2 * r + 1] *= corr;
        }
      }

      if constexpr (kInt8) {   // P v_s, before P's split into bf16 terms
#pragma unroll
        for (int nb = 0; nb < NB; ++nb) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float f = v_sc[nb * 8 + 2 * t4 + e];
            s[nb][e] *= f;
            s[nb][2 + e] *= f;
          }
        }
      }

      // O += P V: P's A fragments straight from the score registers, as
      // kPTerms bf16 terms (see split_bf16).
      if constexpr (kWg) {
        uint32_t pa[kN / 16][kPTerms][4];
#pragma unroll
        for (int kk = 0; kk < kN / 16; ++kk) {
          split_bf16(s[2 * kk][0], s[2 * kk][1], pa[kk], 0);
          split_bf16(s[2 * kk][2], s[2 * kk][3], pa[kk], 1);
          split_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1], pa[kk], 2);
          split_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3], pa[kk], 3);
        }
        hopper::fence_operands<ND * 4>(&o[0][0]);
        hopper::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kN / 16; ++kk) {
#pragma unroll
          for (int t = kPTerms - 1; t >= 0; --t) {   // smallest terms first
#pragma unroll
            for (int hb = 0; hb < DP / 64; ++hb) {
              // V's atom hb read MN-major: 16 keys (2048 bytes) a k-step.
              const uint64_t desc = hopper::smem_desc_sw128(vs + hb * kN * 64 + kk * 16 * 64);
              hopper::Wgmma<64, 1>::mma(&o[8 * hb][0], pa[kk][t], desc);
            }
          }
        }
        hopper::wgmma_commit();
        hopper::wgmma_wait<0>();
        hopper::fence_operands<ND * 4>(&o[0][0]);
      }
#pragma unroll
      for (int kk = 0; kk < (kWg ? 0 : kN / 16); ++kk) {
        uint32_t pa[kPTerms][4];
        split_bf16(s[2 * kk][0], s[2 * kk][1], pa, 0);
        split_bf16(s[2 * kk][2], s[2 * kk][3], pa, 1);
        split_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1], pa, 2);
        split_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3], pa, 3);
        // 64 d columns at a time: their V fragments first, then each
        // term over all 8 accumulators, so no MMA waits on the one before.
#pragma unroll
        for (int ng = 0; ng < ND; ng += 8) {
          uint32_t b[4][4];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            if (ng + 2 * j < ND && (ng + 2 * j) * 8 < D)
              ldmatrix_x4_trans(b[j], vs + (kk * 16 + v_row) * SD + (ng + 2 * j) * 8 + v_col);
          }
#pragma unroll
          for (int t = kPTerms - 1; t >= 0; --t) {   // smallest terms first
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              if (ng + 2 * j < ND && (ng + 2 * j) * 8 < D) {
                mma_bf16(o[ng + 2 * j], pa[t], b[j][0], b[j][1]);
                mma_bf16(o[ng + 2 * j + 1], pa[t], b[j][2], b[j][3]);
              }
            }
          }
        }
      }
    }
  }

  if (!warp_live) return;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_row[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const int v = r == 0 ? vA : vB;
    if (v >= nvec) continue;
    size_t rh = ((size_t)sp.orow0 + v / G) * a.H + h * G + v % G;
    if (a.ranges > 1) rh = rh * a.ranges + range;
    const float den = fmaxf(l, 1e-30f);
#pragma unroll
    for (int nd = 0; nd < ND; ++nd) {
      if (nd * 8 < D) {
        const int d = nd * 8 + 2 * t4;
        const float x0 = l > 0.f ? o[nd][2 * r] / den : 0.f;
        const float x1 = l > 0.f ? o[nd][2 * r + 1] / den : 0.f;
        if (a.m_out != nullptr) {
          *reinterpret_cast<float2*>(static_cast<float*>(a.out) + rh * D + d) =
              make_float2(x0, x1);
        } else {
          *reinterpret_cast<__nv_bfloat162*>(static_cast<bf16*>(a.out) + rh * D + d) =
              __floats2bfloat162_rn(x0, x1);
        }
      }
    }
    if (a.m_out != nullptr && t4 == 0) {
      a.m_out[rh] = m_row[r];
      a.l_out[rh] = l;
    }
  }
}

// Sets the tile kernel's dynamic shared memory (above the default 48 KB
// at every head dim but 16).
template <typename Kernel>
cudaError_t set_tile_smem(Kernel kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

// Prefill: lane n is the span of rows [n*T, (n+1)*T) at q_start[n];
// grid (lane, kv head, tile), tiles reversed: the heaviest tiles of
// every (lane, kv head) start first.
template <int DP>
__global__ void __launch_bounds__(kThreads, DP <= 64 ? 2 : 1)
prefill_tc_kernel(const TileArgs<bf16> a, const int* __restrict__ block_tables,
                  const int* __restrict__ q_start, const int* __restrict__ total_len,
                  const int* __restrict__ page_offset, int T) {
  const int n = blockIdx.x;
  const TileSpan sp{n * T, T, q_start[n], total_len[n],
                    page_offset != nullptr ? page_offset[0] : 0,
                    block_tables + (size_t)n * a.max_blocks, n * T};
  tc_tile<bf16, DP>(a, sp, blockIdx.y, (gridDim.z - 1 - blockIdx.z) * kM);
}

template <int DP>
cudaError_t launch_prefill_tc(const TileArgs<bf16>& a, const int* tables, const int* q_start,
                              const int* total_len, const int* page_offset, int N, int T,
                              cudaStream_t stream) {
  const size_t smem = smem_bytes<bf16, DP>(a.D);
  cudaError_t err = set_tile_smem(prefill_tc_kernel<DP>, smem);
  if (err != cudaSuccess) return err;
  const int G = a.H / a.kvH;
  const dim3 grid(N, a.kvH, (T * G + kM - 1) / kM);
  if (grid.x == 0 || grid.y == 0 || grid.z == 0) return cudaSuccess;
  prefill_tc_kernel<DP><<<grid, kThreads, smem, stream>>>(a, tables, q_start, total_len,
                                                          page_offset, T);
  return cudaGetLastError();
}

}  // namespace paged_tc
