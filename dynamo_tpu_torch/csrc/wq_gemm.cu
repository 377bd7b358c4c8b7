// Weight-quantized GEMM for Hopper (sm_90a): the dequantize-in-register
// product of weight-only int8 / fp8 (e4m3) quantization.
//
// Replaces no pl.pallas_call: the JAX package has no Pallas kernel here.
// It writes the XLA fusion of dynamo_tpu/ops/quant.py:119-131 (`qmm` /
// `qdot`): `(x @ q.astype(x.dtype)) * s`, where XLA folds the convert into
// the contraction's operand read, so the int8 bytes stream from HBM and no
// dequantized copy of the weight is ever written. Eager PyTorch has no
// such fusion (x @ q.to(bf16) writes a bf16 copy and reads it back: ~5
// bytes a weight instead of 1), so the port writes the law as one kernel.
//
// Contract (one launch = one batched product, strides in elements):
//   out[b, m, n] = (sum_k A[b, m, k] * deq(Q[b, k, n])) * s[b, n]
//   A    [B, M, K] bf16 or f32, k contiguous, rows and batches strided
//        (batch stride 0: one block of rows for every batch)
//   Q    [B, K, N] int8 or e4m3, contiguous (the reference's [in, out]);
//        transposed: [B, N, K] (the tied head's [V, D] table scaled per
//        row, MLA's w_uv [H, v, dc] contracted over dc)
//   s    [B, N] bf16 or f32 (the weight's dtype, as the reference keeps it)
//   out  [B, M, N] bf16 or f32, n contiguous, rows and batches strided
// Sums are f32; the scale multiplies the f32 sum once, in the epilogue,
// and the result rounds once to out's dtype. The bytes are the same on
// every replay: no atomics touch a sum.
//
// Bound on this card: the bytes of Q + s + A + out at 3.35 TB/s, or the
// operations at 989 TFLOP/s (bf16 tensor cores), whichever is larger.
// Up to ~150 rows the weight's bytes set the pace, past it the operations.
//
// Design (bf16 activations, `wq_wgmma_kernel`): the product is computed
// transposed, out^T = Q^T . A^T, so the weight is wgmma's A operand, read
// from registers, and the activations are its B operand, read from shared
// memory; the tokens are wgmma's N (a token tile of BT = 16, 64, 128 or
// 256 rows), so one kernel covers decode and prefill rows and the column
// scale is a per-row scale held in registers for the epilogue.
// - Tiles: 128 weight columns x BT rows a block, three warpgroups. One
//   producer thread keeps a ring of stages in flight by TMA (a stage: 64 k
//   of the 128 columns, 8 KB, and 64 k of the BT rows; 8 stages at BT <=
//   64, 7 at 128, 5 at 256; each stage 1024-byte aligned and waited on by
//   an mbarrier, given back by an mbarrier the consumers' 8 warps arrive
//   on). Two consumer warpgroups own 64 columns each: per 16 k one
//   m64nBTk16 wgmma, f32 accumulators in registers (128 a thread at BT =
//   256: setmaxnreg gives the consumers 232 registers, the producer 40).
//   The TMA boxes zero the ragged edges (rows past M, columns past N, k
//   past K); the epilogue masks its stores.
// - The ring: a consumer converts stage i + 1's fragments while stage i's
//   four wgmma run (two register sets in turn), and gives stage i back
//   once they are done (wgmma.wait_group 1 after issuing i + 1).
// - A's fragment (rows = weight columns, k pairs) is read from the stage
//   with 16-bit loads and converted exactly in registers (deq4 / deq2:
//   int8 as the float 2^23 + u less a constant, e4m3 by the hardware's
//   x2 convert to half; bf16 is the float's upper half). [K, N] stages
//   (128-byte rows, 128-byte swizzle): a load takes two adjacent columns
//   of one k row and __byte_perm of two rows' loads makes both columns'
//   k pairs, so fragment row g is column 2g and row g + 8 column 2g + 1
//   (the epilogue stores the pair as one bf16x2 / float2). [N, K] stages
//   (64-byte rows, 64-byte swizzle): a load is one column's k pair.
//   Either layout is read without bank conflicts.
// - The activations come as TMA boxes of 64 k x BT rows with the 128-byte
//   swizzle, the canonical K-major layout wgmma's descriptor names (SBO
//   1024 bytes; +32 bytes a step of 16 k).
// - The grid is persistent: at most a wave of blocks (two an SM at BT =
//   16) walks the work items, so the producer loads the next item while
//   the consumers finish the last one's epilogue, straight from the
//   accumulators (rows and columns masked, the scales in registers).
// - Few output tiles (decode rows, small weights) split K. Each split
//   writes f32 partials and bumps its tile's arrival counter (a
//   __threadfence, then atomicAdd); the last to arrive reads every
//   split's partials back, its own too, and sums them in split order (so
//   the bytes never depend on which split came last), scales, rounds,
//   stores and puts the counter back to 0. The counters are this
//   library's device array, zero from load, so nothing is reset on the
//   graph's path. One launch, no reduce pass.
// The host plan (ops/kernels/wq_gemm.py kernel_plan, shapes only) picks
// BT, the split and the grid; the TMA descriptors are encoded on the host
// per call (cuTensorMapEncodeTiled through cudaGetDriverEntryPoint, so
// the library links against cudart alone) and passed as __grid_constant__
// parameters, so a captured graph keeps them.
// What bounds it on the H100: at BT = 256 the activation tiles' reads
// from L2 (every 128-column tile reads all of A) and the wgmma issue; at
// BT <= 64 the convert (about 3.5 instructions a weight byte) and the
// wgmma latency of one group in flight; at decode rows the weight stream,
// 50-80% of its byte bound; on small weights a launch's fixed cost
// (prologue, pipeline fill and, when split, the partials' round trips).
// Converting each stage once into a bf16 tile in shared memory and
// running wgmma with both operands there measured slower on the [K, N]
// gate/up case, so the weight stays in registers.
// f32 activations (the float32 witnesses) take a SIMT loop with f32
// FMAs: a thread per column over [K, N], a warp per column over [N, K].
// Not done: TMA multicast of A across a cluster (half its L2 reads),
// 256-column tiles at BT <= 128, programmatic dependent launch for the
// small products' fixed cost; two launches that run on different streams
// at once may share a tile counter (the port runs one stream per engine);
// an fp8 wgmma (activations quantized per row) would compute another
// function.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

constexpr int kBN = 128;                // weight columns a block
constexpr int kBK = 64;                 // contraction depth a stage
constexpr int kThreads = 384;           // 2 consumer warpgroups + the producer's
constexpr int kConsumers = 256;
constexpr int kCounterSlots = 16384;    // tiles a split launch may have
constexpr int kSimtThreads = 256;
constexpr int kSimtRows = 8;            // rows a SIMT thread (or warp) sums

__device__ unsigned int g_tile_arrivals[kCounterSlots];

struct Args {
  const void* a;
  long long a_bs, a_rs;
  const uint8_t* q;
  long long q_bs;
  const void* s;
  long long s_bs;
  void* out;
  long long o_bs, o_rs;
  float* part;                          // [S, B, M, N] with more than one split
  int B, M, N, K;
  int num_splits, k_per_split;
  int s_bf16, out_bf16;
  int a_batched;                        // A's TMA batch coordinate is b, else 0
  int m_tiles, n_tiles, items;
};

template <int BT>
struct Tile {
  static constexpr int kStages = BT == 256 ? 5 : BT == 128 ? 7 : 8;
  static constexpr int kQBytes = kBN * kBK;
  static constexpr int kABytes = BT * kBK * 2;
  static constexpr int kStage = kQBytes + kABytes;
  static constexpr int kSmem = kStages * kStage + 1024 + 2 * kStages * 8 + 16;
  static constexpr int kBlocksPerSm = BT == 16 ? 2 : 1;
  static constexpr bool kMoveRegisters = BT >= 128;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// -- mbarriers and TMA -------------------------------------------------------
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count));
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// -- wgmma ---------------------------------------------------------------------
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keeps the compiler from moving accumulator accesses across the async
// products.
template <int N>
__device__ __forceinline__ void fence_operands(float* d) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
// A K-major tile of 128-byte rows under the 128-byte swizzle: 8-row
// groups 1024 bytes apart.
__device__ __forceinline__ uint64_t smem_desc_sw128(const void* p) {
  return static_cast<uint64_t>((smem_addr(p) & 0x3FFFF) >> 4) | (uint64_t(1) << 16) |
         (uint64_t(1024 >> 4) << 32) | (uint64_t(1) << 62);
}

// d[m64 x BT] += a (64 x 16 bf16, registers) * B (16 x BT bf16, the
// descriptor's K-major tile).
template <int BT>
struct Wgmma;

template <>
struct Wgmma<16> {
  __device__ __forceinline__ static void mma(float* d, const uint32_t* a, uint64_t desc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7"
        "}, {%8, %9, %10, %11}, %12, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
  }
};

template <>
struct Wgmma<64> {
  __device__ __forceinline__ static void mma(float* d, const uint32_t* a, uint64_t desc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
        "}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
  }
};

template <>
struct Wgmma<128> {
  __device__ __forceinline__ static void mma(float* d, const uint32_t* a, uint64_t desc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
        "}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
          "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
  }
};

template <>
struct Wgmma<256> {
  __device__ __forceinline__ static void mma(float* d, const uint32_t* a, uint64_t desc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
        "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
        "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
        "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
        "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
        "}, {%128, %129, %130, %131}, %132, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
          "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
          "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
          "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
          "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
          "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
          "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
          "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),
          "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
          "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]),
          "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
          "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
          "+f"(d[126]), "+f"(d[127])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
  }
};

// -- the convert ---------------------------------------------------------------
// Two stored weights (low byte: the lower k) → bf16x2, exactly. int8: each
// byte, biased to unsigned, is the low byte of the float 2^23 + u, so one
// subtraction gives it (no integer→float convert); e4m3: the hardware's x2
// convert to half. Either value has at most 8 significant bits, so its
// bf16 is the float's upper half (no rounding convert either).
template <bool kFp8>
__device__ __forceinline__ uint32_t deq2(uint32_t pair) {
  float2 f;
  if constexpr (kFp8) {
    const __half2_raw h =
        __nv_cvt_fp8x2_to_halfraw2(static_cast<__nv_fp8x2_storage_t>(pair & 0xffffu), __NV_E4M3);
    f = __half22float2(__half2(h));
  } else {
    const uint32_t u = pair ^ 0x8080u;
    f.x = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540)) - 8388736.f;
    f.y = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7541)) - 8388736.f;
  }
  return __byte_perm(__float_as_uint(f.x), __float_as_uint(f.y), 0x7632);
}

// Two pairs (bytes [a_k, a_k+1, b_k, b_k+1]) → {bf16x2 a, bf16x2 b}.
template <bool kFp8>
__device__ __forceinline__ void deq4(uint32_t x, uint32_t& a, uint32_t& b) {
  if constexpr (kFp8) {
    a = deq2<true>(x);
    b = deq2<true>(x >> 16);
  } else {
    const uint32_t u = x ^ 0x80808080u;
    const float f0 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540)) - 8388736.f;
    const float f1 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7541)) - 8388736.f;
    const float f2 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7542)) - 8388736.f;
    const float f3 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7543)) - 8388736.f;
    a = __byte_perm(__float_as_uint(f0), __float_as_uint(f1), 0x7632);
    b = __byte_perm(__float_as_uint(f2), __float_as_uint(f3), 0x7632);
  }
}

template <bool kFp8>
__device__ __forceinline__ float deq1(uint8_t v) {
  if constexpr (kFp8) {
    return __half2float(__half(__nv_cvt_fp8_to_halfraw(static_cast<__nv_fp8_storage_t>(v),
                                                       __NV_E4M3)));
  } else {
    return static_cast<float>(static_cast<int8_t>(v));
  }
}

__device__ __forceinline__ uint32_t lds16(const uint8_t* p) {
  return *reinterpret_cast<const uint16_t*>(p);
}

// Consumer warpgroup `c`'s A fragment for the 16 k at `kk` of a stage:
// registers {row g, row g+8} x {k 2t..2t+1, k 2t+8..2t+9} of its 64 rows
// (warp w: rows 16w..16w+15); rows g and g + 8 stand for the weight
// columns the epilogue names col0 and col1.
template <bool kNK, bool kFp8>
__device__ __forceinline__ void a_fragment(uint32_t* a, const uint8_t* qs, int c, int w, int g,
                                           int t, int kk) {
  if constexpr (kNK) {
    // [128 n rows][64 k bytes], 64-byte swizzle: 16-byte chunk ^ ((row >> 1) & 3).
    const int n0 = 64 * c + 16 * w + g, n1 = n0 + 8;
    const uint8_t* r0 = qs + n0 * 64 + ((kk ^ ((n0 >> 1) & 3)) << 4) + 2 * t;
    const uint8_t* r1 = qs + n1 * 64 + ((kk ^ ((n1 >> 1) & 3)) << 4) + 2 * t;
    deq4<kFp8>(__byte_perm(lds16(r0), lds16(r1), 0x5410), a[0], a[1]);
    deq4<kFp8>(__byte_perm(lds16(r0 + 8), lds16(r1 + 8), 0x5410), a[2], a[3]);
  } else {
    // [64 k rows][128 n bytes], 128-byte swizzle: 16-byte chunk ^ (row & 7).
    const int chunk = 4 * c + w;
    uint32_t v[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int k = 16 * kk + 2 * t + (j & 1) + 8 * (j >> 1);
      v[j] = lds16(qs + k * 128 + ((chunk ^ (k & 7)) << 4) + 2 * g);
    }
    // Column 2g's k pair, then column 2g + 1's: k 2t..2t+1, then 2t+8..2t+9.
    deq4<kFp8>(__byte_perm(v[0], v[1], 0x5140), a[0], a[1]);
    deq4<kFp8>(__byte_perm(v[2], v[3], 0x5140), a[2], a[3]);
  }
}

__device__ __forceinline__ float scale_at(const Args& p, int b, int n) {
  const long long i = b * p.s_bs + n;
  return p.s_bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p.s)[i])
                  : static_cast<const float*>(p.s)[i];
}

__device__ __forceinline__ void store_out(const Args& p, int b, int m, int n, float v) {
  const long long i = b * p.o_bs + m * p.o_rs + n;
  if (p.out_bf16) {
    static_cast<__nv_bfloat16*>(p.out)[i] = __float2bfloat16(v);
  } else {
    static_cast<float*>(p.out)[i] = v;
  }
}

// Columns n and n + 1 (kAdjacent) or n and n + 8 of one row.
template <bool kAdjacent>
__device__ __forceinline__ void store_two(const Args& p, int b, int m, int n0, int n1, float v0,
                                          float v1) {
  if constexpr (kAdjacent) {
    const long long i = b * p.o_bs + m * p.o_rs + n0;
    if (p.out_bf16) {
      *reinterpret_cast<__nv_bfloat162*>(static_cast<__nv_bfloat16*>(p.out) + i) =
          __floats2bfloat162_rn(v0, v1);
    } else {
      *reinterpret_cast<float2*>(static_cast<float*>(p.out) + i) = make_float2(v0, v1);
    }
  } else {
    store_out(p, b, m, n0, v0);
    store_out(p, b, m, n1, v1);
  }
}

// The f32 partials of columns n0 and n1 (n0 + 1 when kAdjacent) of a row.
template <bool kAdjacent>
__device__ __forceinline__ void store_f32_two(float* row, int n0, int n1, float v0, float v1) {
  if constexpr (kAdjacent) {
    *reinterpret_cast<float2*>(row + n0) = make_float2(v0, v1);
  } else {
    row[n0] = v0;
    row[n1] = v1;
  }
}
template <bool kAdjacent>
__device__ __forceinline__ float2 load_f32_two(const float* row, int n0, int n1) {
  if constexpr (kAdjacent) return __ldcg(reinterpret_cast<const float2*>(row + n0));
  return make_float2(__ldcg(row + n0), __ldcg(row + n1));
}

struct Item {
  int b, m0, n0, split, tile, k0, iters;   // m0: the first row, BT rows a tile
};

template <int BT>
__device__ __forceinline__ Item item_at(const Args& p, int item) {
  Item it;
  it.split = item % p.num_splits;
  it.tile = item / p.num_splits;
  const int tm = it.tile % p.m_tiles;
  const int rest = it.tile / p.m_tiles;
  it.n0 = (rest % p.n_tiles) * kBN;
  it.b = rest / p.n_tiles;
  it.m0 = tm * BT;
  it.k0 = it.split * p.k_per_split;
  const int k1 = min(p.K, it.k0 + p.k_per_split);
  it.iters = (k1 - it.k0 + kBK - 1) / kBK;
  return it;
}

// grid: at most a wave of blocks over p.items work items (tile x split);
// block: 2 consumer warpgroups, then the producer's.
template <int BT, bool kNK, bool kFp8>
__global__ void __launch_bounds__(kThreads, Tile<BT>::kBlocksPerSm)
    wq_wgmma_kernel(const __grid_constant__ CUtensorMap tma_q,
                    const __grid_constant__ CUtensorMap tma_a, const Args p) {
  using T = Tile<BT>;
  extern __shared__ unsigned char smem_raw[];
  // The swizzled tiles want 1024-byte aligned shared addresses.
  unsigned char* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + T::kStages * T::kStage);
  uint64_t* empty = full + T::kStages;
  volatile int* last_flag = reinterpret_cast<volatile int*>(empty + T::kStages);
  const int tid = threadIdx.x;
  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < T::kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers / 32);   // one arrival a consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= kConsumers) {
    // The producer: one thread keeps the ring full.
    if constexpr (T::kMoveRegisters) asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (tid == kConsumers) {
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&tma_q))
                   : "memory");
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&tma_a))
                   : "memory");
      int stage = 0;
      uint32_t phase = 0;
      for (int item = blockIdx.x; item < p.items; item += gridDim.x) {
        const Item it = item_at<BT>(p, item);
        for (int i = 0; i < it.iters; ++i) {
          const int k = it.k0 + i * kBK;
          mbar_wait(&empty[stage], phase ^ 1);
          unsigned char* st = smem + stage * T::kStage;
          mbar_expect_tx(&full[stage], T::kStage);
          if constexpr (kNK) {
            tma_load_3d(st, &tma_q, &full[stage], k, it.n0, it.b);
          } else {
            tma_load_3d(st, &tma_q, &full[stage], it.n0, k, it.b);
          }
          tma_load_3d(st + T::kQBytes, &tma_a, &full[stage], k, it.m0,
                      p.a_batched ? it.b : 0);
          if (++stage == T::kStages) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {
    if constexpr (T::kMoveRegisters) asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int c = tid >> 7, w = (tid >> 5) & 3, lane = tid & 31, g = lane >> 2, t = lane & 3;
    // Fragment rows g and g + 8 stand for these columns of the tile.
    const int col0 = 64 * c + 16 * w + (kNK ? g : 2 * g);
    const int col1 = col0 + (kNK ? 8 : 1);
    const long long total = (long long)p.B * p.M * p.N;
    // A stage's four fragments are converted while the products of the
    // stage before run (two register sets in turn); then one fence and
    // four wgmma (a group), and a stage goes back to the producer once its
    // group is done: one group runs while the next converts. (Three sets
    // and two groups in flight, or two blocks an SM at BT = 64, measured
    // slower on the H100.)
    auto convert = [&](uint32_t* f, int st) {
      const uint8_t* qs = smem + st * T::kStage;
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) a_fragment<kNK, kFp8>(f + 4 * kk, qs, c, w, g, t, kk);
    };
    int stage = 0;
    uint32_t phase = 0;
    auto release = [&](int back) {          // the stage `back` groups before `stage`
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[(stage - back + T::kStages) % T::kStages]);
    };
    for (int item = blockIdx.x; item < p.items; item += gridDim.x) {
      const Item it = item_at<BT>(p, item);
      float acc[BT / 2];
#pragma unroll
      for (int i = 0; i < BT / 2; ++i) acc[i] = 0.f;
      uint32_t frag[2][16];
      // Group i from set J; then stage i + 1 converts into the other set,
      // whose last group (i - 1) is done by then.
      auto step = [&](auto set, int i) {
        constexpr int J = decltype(set)::value;
        const uint64_t desc = smem_desc_sw128(smem + stage * T::kStage + T::kQBytes);
        fence_operands<BT / 2>(acc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kBK / 16; ++kk) Wgmma<BT>::mma(acc, frag[J] + 4 * kk, desc + 2 * kk);
        wgmma_commit();
        wgmma_wait<1>();
        if (i >= 1) release(1);
        if (++stage == T::kStages) {
          stage = 0;
          phase ^= 1;
        }
        if (i + 1 < it.iters) {
          mbar_wait(&full[stage], phase);
          convert(frag[J ^ 1], stage);
        }
      };
      mbar_wait(&full[stage], phase);
      convert(frag[0], stage);
      for (int i = 0; i < it.iters; i += 2) {
        step(std::integral_constant<int, 0>{}, i);
        if (i + 1 < it.iters) step(std::integral_constant<int, 1>{}, i + 1);
      }
      wgmma_wait<0>();
      fence_operands<BT / 2>(acc);
      release(1);

      // Epilogue: accumulator (i, h, e) is row m0 + 8i + 2t + e, column
      // col0 (h = 0) or col1 (h = 1).
      const int m_base = it.m0 + 2 * t;
      const int n_a = it.n0 + col0, n_b = it.n0 + col1;
      const bool n_ok = n_a < p.N;          // N is a multiple of 16: n_b too
      if (p.num_splits > 1) {
        // Partials out, then the last split to arrive sums them all in
        // split order (its own read back too, so the order never depends
        // on which split came last).
        float* mine = p.part + it.split * total + (long long)it.b * p.M * p.N;
        if (n_ok) {
#pragma unroll
          for (int i = 0; i < BT / 8; ++i)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int m = m_base + 8 * i + e;
              if (m < p.M)
                store_f32_two<!kNK>(mine + (long long)m * p.N, n_a, n_b, acc[4 * i + e],
                                    acc[4 * i + 2 + e]);
            }
        }
        __threadfence();
        asm volatile("bar.sync 1, 256;\n" ::: "memory");
        if (tid == 0) {
          const unsigned prev = atomicAdd(&g_tile_arrivals[it.tile], 1u);
          *last_flag = prev == static_cast<unsigned>(p.num_splits - 1);
        }
        asm volatile("bar.sync 1, 256;\n" ::: "memory");
        if (!*last_flag) continue;
        __threadfence();
        if (tid == 0) g_tile_arrivals[it.tile] = 0;
#pragma unroll
        for (int i = 0; i < BT / 2; ++i) acc[i] = 0.f;
        // Loads in groups with no branch between them (rows past M read
        // row M - 1 and are never stored), so a group is one round trip.
        constexpr int kGroup = BT / 8 < 8 ? BT / 8 : 8;
        const float* base = p.part + (long long)it.b * p.M * p.N;
        for (int s = 0; n_ok && s < p.num_splits; ++s) {
          const float* r = base + s * total;
#pragma unroll
          for (int i0 = 0; i0 < BT / 8; i0 += kGroup) {
            float2 v[kGroup][2];
#pragma unroll
            for (int i = 0; i < kGroup; ++i)
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const int m = min(m_base + 8 * (i0 + i) + e, p.M - 1);
                v[i][e] = load_f32_two<!kNK>(r + (long long)m * p.N, n_a, n_b);
              }
#pragma unroll
            for (int i = 0; i < kGroup; ++i)
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                acc[4 * (i0 + i) + e] += v[i][e].x;
                acc[4 * (i0 + i) + 2 + e] += v[i][e].y;
              }
          }
        }
      }
      if (n_ok) {
        const float sa = scale_at(p, it.b, n_a), sb = scale_at(p, it.b, n_b);
#pragma unroll
        for (int i = 0; i < BT / 8; ++i)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int m = m_base + 8 * i + e;
            if (m < p.M)
              store_two<!kNK>(p, it.b, m, n_a, n_b, acc[4 * i + e] * sa,
                              acc[4 * i + 2 + e] * sb);
          }
      }
    }
  }
}

// f32 activations, [K, N]: grid (N / 256, M / 8, B), a thread per column.
template <bool kFp8>
__global__ void __launch_bounds__(kSimtThreads) wq_f32_kn_kernel(const Args p) {
  const int n = blockIdx.x * kSimtThreads + threadIdx.x;
  const int m0 = blockIdx.y * kSimtRows;
  const int b = blockIdx.z;
  if (n >= p.N) return;
  const float* A = static_cast<const float*>(p.a) + b * p.a_bs;
  const uint8_t* Q = p.q + b * p.q_bs;
  const int rows = min(kSimtRows, p.M - m0);
  float acc[kSimtRows] = {};
  for (int k = 0; k < p.K; ++k) {
    const float w = deq1<kFp8>(Q[(long long)k * p.N + n]);
#pragma unroll
    for (int r = 0; r < kSimtRows; ++r)
      if (r < rows) acc[r] = fmaf(A[(m0 + r) * p.a_rs + k], w, acc[r]);
  }
  const float sc = scale_at(p, b, n);
#pragma unroll
  for (int r = 0; r < kSimtRows; ++r)
    if (r < rows) store_out(p, b, m0 + r, n, acc[r] * sc);
}

// f32 activations, [N, K]: grid (N / 8, M / 8, B), a warp per column.
template <bool kFp8>
__global__ void __launch_bounds__(kSimtThreads) wq_f32_nk_kernel(const Args p) {
  const int lane = threadIdx.x & 31;
  const int n = blockIdx.x * (kSimtThreads / 32) + (threadIdx.x >> 5);
  const int m0 = blockIdx.y * kSimtRows;
  const int b = blockIdx.z;
  if (n >= p.N) return;
  const float* A = static_cast<const float*>(p.a) + b * p.a_bs;
  const uint8_t* Q = p.q + b * p.q_bs + (long long)n * p.K;
  const int rows = min(kSimtRows, p.M - m0);
  float acc[kSimtRows] = {};
  for (int k = lane; k < p.K; k += 32) {
    const float w = deq1<kFp8>(Q[k]);
#pragma unroll
    for (int r = 0; r < kSimtRows; ++r)
      if (r < rows) acc[r] = fmaf(A[(m0 + r) * p.a_rs + k], w, acc[r]);
  }
#pragma unroll
  for (int r = 0; r < kSimtRows; ++r)
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) acc[r] += __shfl_xor_sync(0xffffffffu, acc[r], o);
  if (lane != 0) return;
  const float sc = scale_at(p, b, n);
#pragma unroll
  for (int r = 0; r < kSimtRows; ++r)
    if (r < rows) store_out(p, b, m0 + r, n, acc[r] * sc);
}

// -- host side -------------------------------------------------------------------
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// The driver's encoder, reached through the runtime so the library links
// against nothing but cudart.
EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr,
                                                             12000, cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// A 3-d tiled map (dims and box innermost first, strides in bytes of
// dims 1 and 2); out-of-bounds boxes read zeros.
bool encode_3d(CUtensorMap* map, CUtensorMapDataType type, const void* base, cuuint64_t d0,
               cuuint64_t d1, cuuint64_t d2, cuuint64_t s1, cuuint64_t s2, cuuint32_t b0,
               cuuint32_t b1, CUtensorMapSwizzle swizzle) {
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return false;
  const cuuint64_t dims[3] = {d0, d1, d2};
  const cuuint64_t strides[2] = {s1, s2};
  const cuuint32_t box[3] = {b0, b1, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return fn(map, type, 3, const_cast<void*>(base), dims, strides, box, elem,
            CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int BT, bool kNK, bool kFp8>
cudaError_t run_wgmma(const Args& p, int grid, cudaStream_t st) {
  using T = Tile<BT>;
  CUtensorMap tq, ta;
  const cuuint64_t qb = (cuuint64_t)p.N * p.K;
  const bool ok_q =
      kNK ? encode_3d(&tq, CU_TENSOR_MAP_DATA_TYPE_UINT8, p.q, p.K, p.N, p.B, p.K, qb, kBK, kBN,
                      CU_TENSOR_MAP_SWIZZLE_64B)
          : encode_3d(&tq, CU_TENSOR_MAP_DATA_TYPE_UINT8, p.q, p.N, p.K, p.B, p.N, qb, kBN, kBK,
                      CU_TENSOR_MAP_SWIZZLE_128B);
  const cuuint64_t row = (cuuint64_t)p.a_rs * 2;
  const bool ok_a = encode_3d(&ta, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, p.a, p.K, p.M,
                              p.a_batched ? p.B : 1, row,
                              p.a_batched ? (cuuint64_t)p.a_bs * 2 : row * p.M, kBK, BT,
                              CU_TENSOR_MAP_SWIZZLE_128B);
  if (!ok_q || !ok_a) return cudaErrorInvalidValue;
  auto kernel = wq_wgmma_kernel<BT, kNK, kFp8>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::kSmem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, T::kSmem, st>>>(tq, ta, p);
  return cudaGetLastError();
}

template <bool kNK, bool kFp8>
cudaError_t run_bt(const Args& p, int bt, int grid, cudaStream_t st) {
  switch (bt) {
    case 16: return run_wgmma<16, kNK, kFp8>(p, grid, st);
    case 64: return run_wgmma<64, kNK, kFp8>(p, grid, st);
    case 128: return run_wgmma<128, kNK, kFp8>(p, grid, st);
    case 256: return run_wgmma<256, kNK, kFp8>(p, grid, st);
    default: return cudaErrorInvalidValue;
  }
}

template <bool kFp8>
cudaError_t run_f32(const Args& p, bool nk, cudaStream_t st) {
  const unsigned gy = (p.M + kSimtRows - 1) / kSimtRows;
  if (nk) {
    const dim3 grid((p.N + kSimtThreads / 32 - 1) / (kSimtThreads / 32), gy, p.B);
    wq_f32_nk_kernel<kFp8><<<grid, kSimtThreads, 0, st>>>(p);
  } else {
    const dim3 grid((p.N + kSimtThreads - 1) / kSimtThreads, gy, p.B);
    wq_f32_kn_kernel<kFp8><<<grid, kSimtThreads, 0, st>>>(p);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches the product on `stream`; returns a CUDA error code (0 = ok).
// a_bf16: A is bf16 (the wgmma kernel: bt rows a token tile, 16, 64, 128
// or 256; `grid` blocks over the work items) or f32 (the SIMT loop; one
// split). transposed: Q is [B, N, K]. fp8: Q is e4m3, else int8. With
// num_splits > 1, `part` is f32 scratch of num_splits * B * M * N and
// k_per_split a multiple of 64 that covers K in num_splits non-empty
// pieces.
int wq_gemm(const void* a, long long a_bs, long long a_rs, const void* q, long long q_bs,
            const void* s, long long s_bs, void* out, long long o_bs, long long o_rs, void* part,
            int B, int M, int N, int K, int a_bf16, int transposed, int fp8, int s_bf16,
            int out_bf16, int bt, int num_splits, int k_per_split, int grid, void* stream) {
  if (B < 1 || M < 1 || N < 1 || K < 1 || num_splits < 1 || k_per_split < 1)
    return cudaErrorInvalidValue;
  if ((long long)num_splits * k_per_split < K) return cudaErrorInvalidValue;
  if ((long long)(num_splits - 1) * k_per_split >= K) return cudaErrorInvalidValue;
  Args p{a, a_bs, a_rs, static_cast<const uint8_t*>(q), q_bs, s, s_bs, out, o_bs, o_rs,
         static_cast<float*>(part), B, M, N, K, num_splits, k_per_split, s_bf16, out_bf16,
         a_bs != 0, 0, 0, 0};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (!a_bf16) {
    if (num_splits != 1) return cudaErrorInvalidValue;
    err = fp8 ? run_f32<true>(p, transposed, st) : run_f32<false>(p, transposed, st);
    return static_cast<int>(err);
  }
  if (K % 16 != 0 || N % 16 != 0 || k_per_split % kBK != 0 || grid < 1 || bt < 16)
    return cudaErrorInvalidValue;
  p.m_tiles = (M + bt - 1) / bt;
  p.n_tiles = (N + kBN - 1) / kBN;
  const long long tiles = (long long)B * p.m_tiles * p.n_tiles;
  if (tiles * num_splits > 0x7fffffffLL) return cudaErrorInvalidValue;
  if (num_splits > 1 && (part == nullptr || tiles > kCounterSlots)) return cudaErrorInvalidValue;
  p.items = static_cast<int>(tiles * num_splits);
  if (transposed) {
    err = fp8 ? run_bt<true, true>(p, bt, grid, st) : run_bt<true, false>(p, bt, grid, st);
  } else {
    err = fp8 ? run_bt<false, true>(p, bt, grid, st) : run_bt<false, false>(p, bt, grid, st);
  }
  return static_cast<int>(err);
}

const char* wq_gemm_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
