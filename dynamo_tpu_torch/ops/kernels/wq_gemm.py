"""Weight-quantized GEMM — the CUDA kernel's wrapper.

Replaces no ``pl.pallas_call``: it writes the XLA fusion of
``qmm``/``qdot`` (dynamo_tpu/ops/quant.py:119-131), the int8/e4m3 →
activation-dtype convert folded into the product's operand read. The
source, with its bound and design, is ``dynamo_tpu_torch/csrc/wq_gemm.cu``.

``wq_gemm_cuda(a, q, s)`` computes ``out[b, m, n] = (Σ_k a[b, m, k] ·
q[b, k, n]) · s[b, n]`` (``transposed``: ``q[b, n, k]``) with float32
sums, the scale on the float32 sum and one rounding to the output's
dtype. For a CUDA tensor it launches the kernel (building it on first
use) or raises; for a CPU tensor it runs the plain version
``wq_gemm_plain``, the same arithmetic in torch ops. Each call that
launches adds one to ``wq_gemm_cuda.launches`` (bf16 activations, the
tensor-core kernel) or ``wq_gemm_cuda.launches_f32`` (float32, the SIMT
loop), however many kernels run behind it. ``split_plan`` picks the K
split from shapes alone, so the wrapper reads nothing back from the card
and runs inside a captured CUDA graph (its scratch comes from torch's
allocator, the graph's pool during a capture).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from dynamo_tpu_torch.ops.kernels import _build

NAME = "wq_gemm"
_P, _L, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
ARGTYPES = [_P, _L, _L, _P, _L, _P, _L, _P, _L, _L, _P] + [_I] * 12 + [_P]

BN, BK = 128, 64            # the tile's columns and its stage of K
MIN_SPLIT_STAGES = 4        # stages of K a split covers at least
MAX_SPLITS = 32
BLOCKS_PER_SM = 2           # blocks the plan aims for per SM
FORMATS = {torch.int8: 0, torch.float8_e4m3fn: 1}
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_GRID_YZ = 65535


def build() -> None:
    """Build and load the kernel library (a no-op once loaded)."""
    _build.load(NAME)


@functools.lru_cache(maxsize=4096, typed=True)
def split_plan(B: int, M: int, N: int, K: int, num_sms: int = 132,
               a_bf16: bool = True) -> tuple[int, int, int]:
    """(num_splits, k_per_split, m_tiles) of one product, from host
    integers only. m_tiles: 16-row mma tiles a block takes (1 for M <= 16,
    else 4). The split aims for BLOCKS_PER_SM blocks per SM, with at least
    MIN_SPLIT_STAGES stages of K each and f32 partials of at most half the
    weight's bytes; float32 activations (the SIMT loop) never split."""
    shape = (B, M, N, K, num_sms)
    if not all(isinstance(x, int) for x in shape):
        raise TypeError("split_plan takes host integers only")
    m_tiles = 1 if M <= 16 else 4
    if not a_bf16:
        return 1, K, m_tiles
    tiles = -(-N // BN) * -(-M // (16 * m_tiles)) * B
    stages = -(-K // BK)
    splits = min(
        -(-BLOCKS_PER_SM * num_sms // tiles),
        stages // MIN_SPLIT_STAGES,
        MAX_SPLITS,
        K // (8 * M),
    )
    splits = max(splits, 1)
    per = -(-stages // splits)
    return -(-stages // per), per * BK, m_tiles


@functools.cache
def _num_sms(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def operand_ok(a: torch.Tensor) -> bool:
    """Whether ``a [B, M, K]`` can be the kernel's activation as it lies:
    k contiguous; for bf16 also 16-byte aligned rows and batches (the
    cp.async copies)."""
    if a.stride(-1) != 1:
        return False
    if a.dtype == torch.bfloat16:
        return a.data_ptr() % 16 == 0 and a.stride(0) % 8 == 0 and a.stride(1) % 8 == 0
    return True


def wq_gemm_plain(a: torch.Tensor, q: torch.Tensor, s: torch.Tensor,
                  out_dtype: torch.dtype, transposed: bool = False) -> torch.Tensor:
    """The kernel's arithmetic in torch ops: float32 products and sums,
    the scale on the float32 sum, one rounding to ``out_dtype``."""
    qf = q.float()
    if transposed:
        qf = qf.transpose(-1, -2)
    return (torch.matmul(a.float(), qf) * s.float()[:, None, :]).to(out_dtype)


def check_kernel_args(a, q, s, out, transposed: bool) -> tuple[int, int, int, int]:
    """Everything the kernel does not take raises here, before launch.
    Returns (B, M, N, K)."""
    if a.dim() != 3 or q.dim() != 3 or s.dim() != 2:
        raise ValueError("a must be [B, M, K], q [B, K, N] (or [B, N, K]) and s [B, N]")
    B, M, K = a.shape
    N = q.shape[1] if transposed else q.shape[2]
    want_q = (B, N, K) if transposed else (B, K, N)
    if tuple(q.shape) != want_q:
        raise ValueError(f"q is {list(q.shape)}, expected {list(want_q)}")
    if tuple(s.shape) != (B, N):
        raise ValueError(f"s is {list(s.shape)}, expected {[B, N]}")
    if tuple(out.shape) != (B, M, N):
        raise ValueError(f"out is {list(out.shape)}, expected {[B, M, N]}")
    if q.dtype not in FORMATS:
        raise TypeError(f"q dtype {q.dtype} not in {list(FORMATS)}")
    for name, t in (("a", a), ("s", s), ("out", out)):
        if t.dtype not in DTYPES:
            raise TypeError(f"{name} dtype {t.dtype} not in {list(DTYPES)}")
    if any(t.device != a.device for t in (q, s, out)):
        raise ValueError("all operands must lie on one device")
    if not (q.is_contiguous() and s.is_contiguous()):
        raise ValueError("q and s must be contiguous")
    if out.stride(-1) != 1:
        raise ValueError("out must be contiguous along n")
    if not operand_ok(a):
        raise ValueError("a must be contiguous along k (bf16: 16-byte aligned rows)")
    if a.dtype == torch.bfloat16 and (K % 16 or N % 16 or q.data_ptr() % 16):
        raise ValueError("bf16 products take K and N in multiples of 16 and a 16-byte aligned q")
    if min(B, M, N, K) < 1:
        raise ValueError("empty product")
    if -(-M // 8) > MAX_GRID_YZ or B * MAX_SPLITS > MAX_GRID_YZ:
        raise ValueError("too many rows or batches for one launch")
    return B, M, N, K


def wq_gemm_cuda(
    a: torch.Tensor,                     # [B, M, K] bf16 | f32
    q: torch.Tensor,                     # [B, K, N] (transposed: [B, N, K]) int8 | e4m3
    s: torch.Tensor,                     # [B, N] bf16 | f32
    out: torch.Tensor | None = None,     # [B, M, N], written; default a new tensor
    *,
    out_dtype: torch.dtype | None = None,
    transposed: bool = False,
) -> torch.Tensor:
    """The scaled product (see the module docstring); returns ``out``.
    ``out_dtype`` (default a's) applies when ``out`` is not given."""
    if out is None:
        B, M = a.shape[0], a.shape[1]
        N = q.shape[1] if transposed else q.shape[-1]
        out = torch.empty((B, M, N), dtype=out_dtype or a.dtype, device=a.device)
    if a.device.type == "cpu":
        out.copy_(wq_gemm_plain(a, q, s, out.dtype, transposed))
        return out
    if a.device.type != "cuda":
        raise ValueError(f"no weight-quantized product for device {a.device}")
    B, M, N, K = check_kernel_args(a, q, s, out, transposed)
    bf16 = a.dtype == torch.bfloat16
    splits, per, m_tiles = split_plan(B, M, N, K, _num_sms(a.device), bf16)
    part = None
    if splits > 1:
        part = torch.empty(splits * B * M * N, dtype=torch.float32, device=a.device)
    _build.launch(
        NAME, NAME, ARGTYPES,
        a.data_ptr(), a.stride(0), a.stride(1), q.data_ptr(), q.stride(0),
        s.data_ptr(), s.stride(0), out.data_ptr(), out.stride(0), out.stride(1),
        part.data_ptr() if part is not None else None,
        B, M, N, K, int(bf16), int(transposed), FORMATS[q.dtype],
        DTYPES[s.dtype], DTYPES[out.dtype], m_tiles, splits, per,
        torch.cuda.current_stream(a.device).cuda_stream,
    )
    if bf16:
        wq_gemm_cuda.launches += 1
    else:
        wq_gemm_cuda.launches_f32 += 1
    return out


wq_gemm_cuda.launches = 0
wq_gemm_cuda.launches_f32 = 0
