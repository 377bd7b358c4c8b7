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
//   Q    [B, K, N] int8 or e4m3, contiguous (the reference's [in, out]);
//        transposed: [B, N, K] (the tied head's [V, D] table scaled per
//        row, MLA's w_uv [H, v, dc] contracted over dc)
//   s    [B, N] bf16 or f32 (the weight's dtype, as the reference keeps it)
//   out  [B, M, N] bf16 or f32, n contiguous, rows and batches strided
// Sums are f32; the scale multiplies the f32 sum once, in the epilogue,
// and the result rounds once to out's dtype (the reference rounds x @ q
// to bf16 first, then multiplies by a bf16 scale).
//
// Bound on this card: the bytes of Q + s + A + out at 3.35 TB/s, or the
// operations at 989 TFLOP/s (bf16 tensor cores), whichever is larger.
// Decode's M is 1-64 rows, so the bytes of Q set the pace there.
//
// Design (bf16 activations, `wq_tc_kernel`): a block of 4 warps owns 128
// output columns x BM = 16 * MT rows (MT = 1 for M <= 16, else 4) and a
// range of K. Q and A tiles of 64 k stream through a cp.async ring of 4
// stages (3 at 64 rows), 16 bytes a thread. Each k16 step converts the
// warp's 32 columns' bytes in registers to bf16 (exact: int8 through the
// float 2^23 + u, e4m3 through the hardware's x2 convert to half; see
// deq2) and runs mma.sync m16n8k16 with f32 accumulators; A's fragments
// come by ldmatrix.
// - [K, N] tiles: a thread reads one 32-bit word from each of the rows
//   2t, 2t+1, 2t+8, 2t+9 at columns 4g..4g+3 of its warp's 32; byte i of
//   the words feeds n-tile i, column g (a column permutation the
//   epilogue undoes: n-tile i, mma column j is warp column 4j + i), so
//   each word is one load for four MMAs. Rows of 144 bytes keep the
//   warp's 32 loads on 32 banks.
// - [N, K] tiles: the B fragment's k pairs are contiguous, 16-bit loads
//   from rows of 80 bytes (conflict-free).
// Decode's few rows give few blocks over N, so K splits: the host plan
// (ops/kernels/wq_gemm.py split_plan, shapes only) aims for two blocks
// per SM with at least 4 stages of K a split; splits write f32 partials
// and `reduce_kernel` sums them in split order, scales and rounds.
// f32 activations (the float32 witnesses) take a SIMT loop with f32
// FMAs: a thread per column over [K, N], a warp per column over [N, K].
// At 64 rows this design runs near 200 TFLOP/s, 2-5x behind cuBLAS on bf16
// weights; tiles that dequantize each stage once into shared memory and
// feed ldmatrix (64x128 over 8 warps, 128x128 over 4 warps of 64x64)
// measured no faster on the H100, so the rows path waits for wgmma.
// Not done: wgmma, TMA, a persistent grid (ROADMAP B10).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 128;           // 4 warps
constexpr int kBN = 128;                // output columns a block
constexpr int kBK = 64;                 // contraction depth a stage
constexpr int kARow = kBK + 8;          // bf16 per A row in shared memory (144 B)
constexpr int kQRowKN = kBN + 16;       // bytes per k row of a [K, N] tile
constexpr int kQRowNK = kBK + 16;       // bytes per n row of an [N, K] tile
constexpr int kQStage = 10240;          // max(64 * 144, 128 * 80)
constexpr int kSimtThreads = 256;
constexpr int kSimtRows = 8;            // rows a SIMT thread (or warp) sums

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
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}
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
// d[0..3] += a (16x16 bf16, row) * b (16x8 bf16, col), f32 accumulate.
__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

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

template <bool kFp8>
__device__ __forceinline__ float deq1(uint8_t v) {
  if constexpr (kFp8) {
    return __half2float(__half(__nv_cvt_fp8_to_halfraw(static_cast<__nv_fp8_storage_t>(v),
                                                       __NV_E4M3)));
  } else {
    return static_cast<float>(static_cast<int8_t>(v));
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

// The cp.async ring's depth: 4 stages at 16 rows (the weight stream wants
// bytes in flight), 3 at 64 (three blocks an SM instead of two).
template <int MT>
constexpr int kStages = MT == 1 ? 4 : 3;

template <int MT>
constexpr int tc_smem_bytes() {
  return kStages<MT> * (kQStage + 16 * MT * kARow * 2);
}

// grid (N / 128, M / BM, B * num_splits); block 4 warps.
template <int MT, bool kNK, bool kFp8>
__global__ void __launch_bounds__(kThreads) wq_tc_kernel(const Args p) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int BM = 16 * MT;
  constexpr int kStage = kQStage + BM * kARow * 2;
  const int n0 = blockIdx.x * kBN;
  const int m0 = blockIdx.y * BM;
  const int b = blockIdx.z / p.num_splits;
  const int split = blockIdx.z - b * p.num_splits;
  const int kb = split * p.k_per_split;
  const int ke = min(p.K, kb + p.k_per_split);
  const int iters = (ke - kb + kBK - 1) / kBK;
  const __nv_bfloat16* A = static_cast<const __nv_bfloat16*>(p.a) + b * p.a_bs;
  const uint8_t* Q = p.q + b * p.q_bs;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;

  auto load = [&](int it) {
    unsigned char* st = smem + (it % kStages<MT>) * kStage;
    const int k0 = kb + it * kBK;
#pragma unroll
    for (int c = tid; c < 512; c += kThreads) {
      if constexpr (kNK) {
        const int r = c >> 2, col = (c & 3) * 16;         // n row, k byte
        const int n = n0 + r, k = k0 + col;
        const bool ok = n < p.N && k < ke;
        cp_async16(st + r * kQRowNK + col, ok ? Q + (long long)n * p.K + k : Q, ok ? 16 : 0);
      } else {
        const int r = c >> 3, col = (c & 7) * 16;         // k row, n byte
        const int k = k0 + r, n = n0 + col;
        const bool ok = k < ke && n < p.N;
        cp_async16(st + r * kQRowKN + col, ok ? Q + (long long)k * p.N + n : Q, ok ? 16 : 0);
      }
    }
    __nv_bfloat16* as = reinterpret_cast<__nv_bfloat16*>(st + kQStage);
#pragma unroll
    for (int c = tid; c < BM * 8; c += kThreads) {
      const int r = c >> 3, col = (c & 7) * 8;
      const int m = m0 + r, k = k0 + col;
      const bool ok = m < p.M && k < ke;
      cp_async16(as + r * kARow + col, ok ? A + m * p.a_rs + k : A, ok ? 16 : 0);
    }
  };

  float acc[MT][4][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][i][e] = 0.f;

#pragma unroll
  for (int s = 0; s < kStages<MT> - 1; ++s) {
    if (s < iters) load(s);
    cp_async_commit();
  }
  for (int it = 0; it < iters; ++it) {
    cp_async_wait<kStages<MT> - 2>();
    __syncthreads();
    if (it + kStages<MT> - 1 < iters) load(it + kStages<MT> - 1);
    cp_async_commit();
    const unsigned char* qs = smem + (it % kStages<MT>) * kStage;
    const __nv_bfloat16* as = reinterpret_cast<const __nv_bfloat16*>(qs + kQStage);
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      uint32_t af[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
        ldmatrix_x4(af[mt], as + (mt * 16 + (lane & 15)) * kARow + kk * 16 + (lane >> 4) * 8);
      uint32_t b0[4], b1[4];
      if constexpr (kNK) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const uint8_t* row = qs + (warp * 32 + 8 * i + g) * kQRowNK + kk * 16 + 2 * t;
          b0[i] = deq2<kFp8>(*reinterpret_cast<const uint16_t*>(row));
          b1[i] = deq2<kFp8>(*reinterpret_cast<const uint16_t*>(row + 8));
        }
      } else {
        const uint8_t* base = qs + (kk * 16 + 2 * t) * kQRowKN + warp * 32 + 4 * g;
        const uint32_t w0 = *reinterpret_cast<const uint32_t*>(base);
        const uint32_t w1 = *reinterpret_cast<const uint32_t*>(base + kQRowKN);
        const uint32_t w8 = *reinterpret_cast<const uint32_t*>(base + 8 * kQRowKN);
        const uint32_t w9 = *reinterpret_cast<const uint32_t*>(base + 9 * kQRowKN);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const uint32_t sel = i | ((i + 4) << 4);
          b0[i] = deq2<kFp8>(__byte_perm(w0, w1, sel));
          b1[i] = deq2<kFp8>(__byte_perm(w8, w9, sel));
        }
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int i = 0; i < 4; ++i) mma_bf16(acc[mt][i], af[mt], b0[i], b1[i]);
    }
  }
  cp_async_wait<0>();

  const long long total = (long long)p.B * p.M * p.N;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = m0 + mt * 16 + g + 8 * (e >> 1);
        const int j = 2 * t + (e & 1);
        const int col = n0 + warp * 32 + (kNK ? 8 * i + j : 4 * j + i);
        if (row >= p.M || col >= p.N) continue;
        if (p.num_splits > 1) {
          p.part[split * total + ((long long)b * p.M + row) * p.N + col] = acc[mt][i][e];
        } else {
          store_out(p, b, row, col, acc[mt][i][e] * scale_at(p, b, col));
        }
      }
}

// The splits' partials summed in split order, scaled and rounded: one
// thread per output element.
__global__ void __launch_bounds__(256) reduce_kernel(const Args p) {
  const long long total = (long long)p.B * p.M * p.N;
  const long long e = (long long)blockIdx.x * 256 + threadIdx.x;
  if (e >= total) return;
  float v = 0.f;
  for (int s = 0; s < p.num_splits; ++s) v += p.part[s * total + e];
  const int n = static_cast<int>(e % p.N);
  const long long bm = e / p.N;
  const int m = static_cast<int>(bm % p.M);
  const int b = static_cast<int>(bm / p.M);
  store_out(p, b, m, n, v * scale_at(p, b, n));
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

template <int MT, bool kNK, bool kFp8>
cudaError_t run_tc(const Args& p, cudaStream_t st) {
  constexpr int smem = tc_smem_bytes<MT>();
  auto kernel = wq_tc_kernel<MT, kNK, kFp8>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.N + kBN - 1) / kBN, (p.M + 16 * MT - 1) / (16 * MT), p.B * p.num_splits);
  kernel<<<grid, kThreads, smem, st>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess || p.num_splits == 1) return err;
  const long long total = (long long)p.B * p.M * p.N;
  reduce_kernel<<<static_cast<unsigned>((total + 255) / 256), 256, 0, st>>>(p);
  return cudaGetLastError();
}

template <bool kNK, bool kFp8>
cudaError_t run_tc_mt(const Args& p, int m_tiles, cudaStream_t st) {
  if (m_tiles == 1) return run_tc<1, kNK, kFp8>(p, st);
  if (m_tiles == 4) return run_tc<4, kNK, kFp8>(p, st);
  return cudaErrorInvalidValue;
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

// Launches the product on `stream`; returns cudaGetLastError() (0 = ok).
// a_bf16: A is bf16 (the tensor-core kernel, m_tiles 1 or 4 row tiles of
// 16) or f32 (the SIMT loop; one split). transposed: Q is [B, N, K].
// fp8: Q is e4m3, else int8. With num_splits > 1, `part` is f32 scratch
// of num_splits * B * M * N and k_per_split a multiple of 64 that covers
// K in num_splits pieces.
int wq_gemm(const void* a, long long a_bs, long long a_rs, const void* q, long long q_bs,
            const void* s, long long s_bs, void* out, long long o_bs, long long o_rs, void* part,
            int B, int M, int N, int K, int a_bf16, int transposed, int fp8, int s_bf16,
            int out_bf16, int m_tiles, int num_splits, int k_per_split, void* stream) {
  if (B < 1 || M < 1 || N < 1 || K < 1 || num_splits < 1 || k_per_split < 1)
    return cudaErrorInvalidValue;
  if ((long long)num_splits * k_per_split < K) return cudaErrorInvalidValue;
  if ((long long)(num_splits - 1) * k_per_split >= K) return cudaErrorInvalidValue;
  if (num_splits > 1 && (part == nullptr || !a_bf16 || k_per_split % kBK != 0))
    return cudaErrorInvalidValue;
  if (a_bf16 && (K % 16 != 0 || N % 16 != 0)) return cudaErrorInvalidValue;
  const Args p{a, a_bs, a_rs, static_cast<const uint8_t*>(q), q_bs, s, s_bs, out, o_bs, o_rs,
               static_cast<float*>(part), B, M, N, K, num_splits, k_per_split, s_bf16, out_bf16};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (!a_bf16) {
    err = fp8 ? run_f32<true>(p, transposed, st) : run_f32<false>(p, transposed, st);
  } else if (transposed) {
    err = fp8 ? run_tc_mt<true, true>(p, m_tiles, st) : run_tc_mt<true, false>(p, m_tiles, st);
  } else {
    err = fp8 ? run_tc_mt<false, true>(p, m_tiles, st) : run_tc_mt<false, false>(p, m_tiles, st);
  }
  return static_cast<int>(err);
}

const char* wq_gemm_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
