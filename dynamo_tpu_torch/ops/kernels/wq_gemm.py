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
``wq_gemm_plain``, the same arithmetic in torch ops. Each launch adds one
to the counter of its entry (``kernel_plan``): ``launches_decode`` (bf16
activations, at most DECODE_ROWS rows), ``launches_rows`` (bf16, more
rows; both the wgmma kernel) or ``launches_f32`` (float32, the SIMT
loop); ``launches`` counts the two bf16 entries. The plan comes from
shapes alone and the TMA descriptors are encoded on the host, so the
wrapper reads nothing back from the card and runs inside a captured CUDA
graph (its scratch comes from torch's allocator, the graph's pool during
a capture; the split's arrival counters are a slice of that scratch, the
launch's own, tagged with a number drawn per launch so that they need
no zeroing).
"""

from __future__ import annotations

import ctypes
import functools
import itertools
from typing import NamedTuple

import torch

from dynamo_tpu_torch.ops.kernels import _build

NAME = "wq_gemm"
_P, _L, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
ARGTYPES = [_P, _L, _L, _P, _L, _P, _L, _P, _L, _L, _P, _P, ctypes.c_ulonglong] + [_I] * 13 + [_P]

BN, BK = 128, 64            # a tile's weight columns and a stage of K
DECODE_ROWS = 16            # rows the decode entry's token tile holds
TOKEN_TILES = (256, 128, 64)  # the rows entry's token tiles, largest first
BLOCKS_PER_SM = {16: 2, 64: 1, 128: 1, 256: 1}
MIN_SPLIT_STAGES = 4        # stages of K a split covers at least
MAX_SPLITS = 32
COUNTER_SLOTS = 16384       # arrival counters (one a tile) a split launch holds at most
TAG_BITS = 48               # a launch's tag, beside the counters' 16 count bits
FORMATS = {torch.int8: 0, torch.float8_e4m3fn: 1}
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_GRID_YZ = 65535
MAX_TMA_STRIDE = 1 << 39    # bytes: a TMA descriptor's strides stay below 2^40


class Plan(NamedTuple):
    """One launch, from shapes: ``entry`` ("decode", "rows" or "f32"),
    the token tile ``bt`` (0 for f32), ``splits`` of ``k_per_split``
    each, the output ``tiles`` (each an arrival counter when split), the
    ``grid`` of blocks and the f32 partials' element count ``part``."""
    entry: str
    bt: int
    splits: int
    k_per_split: int
    tiles: int
    grid: int
    part: int


def build() -> None:
    """Build and load the kernel library (a no-op once loaded)."""
    _build.load(NAME)


# The rows entry's cost model (microseconds, fitted on an H100 to the
# timings of forced plans; dynamo_tpu_torch/tools/wq_sweep.py measures
# them against it): a work item costs ITEM_US plus STAGE_US[bt] a stage
# of K; a split adds SPLIT_US and, in the last block to arrive,
# REDUCE_US a round trip (one per split and 64 rows).
ITEM_US, SPLIT_US, REDUCE_US = 3.0, 3.0, 0.65
STAGE_US = {64: 0.41, 128: 0.49, 256: 0.80}


def _rows_cost(B: int, M: int, N: int, K: int, num_sms: int, bt: int, splits: int) -> float:
    tiles = B * -(-N // BN) * -(-M // bt)
    waves = -(-tiles * splits // (num_sms * BLOCKS_PER_SM[bt]))
    item = ITEM_US + -(-K // (BK * splits)) * STAGE_US[bt]
    if splits > 1:
        item += SPLIT_US + splits * (bt // 64) * REDUCE_US
    return waves * item


def _max_splits(tiles: int, M: int, K: int) -> int:
    """The most splits a product may take: each at least MIN_SPLIT_STAGES
    stages, f32 partials of at most twice the weight's bytes, one arrival
    counter a tile."""
    if tiles > COUNTER_SLOTS:
        return 1
    return max(1, min(-(-K // BK) // MIN_SPLIT_STAGES, MAX_SPLITS, K // (2 * M)))


@functools.lru_cache(maxsize=4096, typed=True)
def kernel_plan(B: int, M: int, N: int, K: int, num_sms: int = 132,
                a_bf16: bool = True) -> Plan:
    """The launch of one product, from host integers only. bf16
    activations take the wgmma kernel. At most DECODE_ROWS rows: the
    decode entry (a 16-row token tile, two blocks an SM), K split until
    the tiles fill a wave. More rows: the rows entry, the token tile of
    TOKEN_TILES (no wider than twice the rows) and the split (none at
    256 rows a tile) that the cost model prices lowest, ties to the wider
    tile and the fewer splits. The grid is at most a wave of blocks
    (persistent). float32 activations take the SIMT loop, unsplit."""
    shape = (B, M, N, K, num_sms)
    if not all(isinstance(x, int) for x in shape):
        raise TypeError("kernel_plan takes host integers only")
    if not a_bf16:
        return Plan("f32", 0, 1, K, 0, 0, 0)
    col_tiles = -(-N // BN)
    if M <= DECODE_ROWS:
        entry, bt = "decode", DECODE_ROWS
        tiles = B * col_tiles
        slots = num_sms * BLOCKS_PER_SM[bt]
        splits = min(max(1, slots // tiles), _max_splits(tiles, M, K))
    else:
        entry = "rows"
        best = None
        for bt in TOKEN_TILES:
            if bt >= 2 * M and bt != TOKEN_TILES[-1]:
                continue
            tiles = B * col_tiles * -(-M // bt)
            most = 1 if bt == 256 else _max_splits(tiles, M, K)
            for s in range(1, most + 1):
                cost = _rows_cost(B, M, N, K, num_sms, bt, s)
                if best is None or cost < best[0] - 1e-9:
                    best = (cost, bt, s)
        _, bt, splits = best
        tiles = B * col_tiles * -(-M // bt)
    stages = -(-K // BK)
    per = -(-stages // splits)
    splits = -(-stages // per)
    part = splits * B * M * N if splits > 1 else 0
    slots = num_sms * BLOCKS_PER_SM[bt]
    return Plan(entry, bt, splits, per * BK, tiles, min(tiles * splits, slots), part)


_launch_numbers = itertools.count(1)


def launch_tag() -> int:
    """A new launch's tag: nonzero, below 2^TAG_BITS, the launch number
    times an odd constant, so tags of launches near in time differ in
    many bits."""
    return next(_launch_numbers) * 0x9E3779B97F4B % (1 << TAG_BITS) or 1


@functools.cache
def _num_sms(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def operand_ok(a: torch.Tensor) -> bool:
    """Whether ``a [B, M, K]`` can be the kernel's activation as it lies:
    k contiguous; for bf16 also what a TMA descriptor takes: a 16-byte
    aligned start, rows and batches 16-byte multiples apart (a batch
    stride of 0 too) and below MAX_TMA_STRIDE."""
    if a.stride(-1) != 1:
        return False
    if a.dtype == torch.bfloat16:
        return (a.data_ptr() % 16 == 0 and a.stride(0) % 8 == 0 and a.stride(1) % 8 == 0
                and 2 * max(a.stride(0), a.stride(1)) < MAX_TMA_STRIDE)
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
        raise ValueError("a must be contiguous along k (bf16: a 16-byte aligned start, rows "
                         "and batches 16-byte multiples apart, as a TMA descriptor takes them)")
    if a.dtype == torch.bfloat16:
        if K % 16 or N % 16 or q.data_ptr() % 16:
            raise ValueError("bf16 products take K and N in multiples of 16 and a 16-byte "
                             "aligned q")
        # The epilogue stores two adjacent columns as one bf16x2 / float2.
        pair = 2 * out.element_size()
        if out.data_ptr() % pair or out.stride(0) % 2 or out.stride(1) % 2:
            raise ValueError("out rows must start on column pairs (an even stride and an "
                             "aligned start) for bf16 products")
    if min(B, M, N, K) < 1:
        raise ValueError("empty product")
    if -(-M // 8) > MAX_GRID_YZ or B > MAX_GRID_YZ:
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
    plan = kernel_plan(B, M, N, K, _num_sms(a.device), bf16)
    part = arrivals = None
    if plan.part:
        # The f32 partials, then the launch's 8-byte arrival counters.
        start = -(-plan.part // 2) * 2
        scratch = torch.empty(start + 2 * plan.tiles, dtype=torch.float32, device=a.device)
        part, arrivals = scratch.data_ptr(), scratch.data_ptr() + 4 * start
    _build.launch(
        NAME, NAME, ARGTYPES,
        a.data_ptr(), a.stride(0), a.stride(1), q.data_ptr(), q.stride(0),
        s.data_ptr(), s.stride(0), out.data_ptr(), out.stride(0), out.stride(1),
        part, arrivals, launch_tag(), B, M, N, K, int(bf16), int(transposed), FORMATS[q.dtype],
        DTYPES[s.dtype], DTYPES[out.dtype], plan.bt, plan.splits, plan.k_per_split,
        plan.grid, torch.cuda.current_stream(a.device).cuda_stream,
    )
    counter = f"launches_{plan.entry}"
    setattr(wq_gemm_cuda, counter, getattr(wq_gemm_cuda, counter) + 1)
    if bf16:
        wq_gemm_cuda.launches += 1
    return out


wq_gemm_cuda.launches = 0           # launches_decode + launches_rows
wq_gemm_cuda.launches_decode = 0
wq_gemm_cuda.launches_rows = 0
wq_gemm_cuda.launches_f32 = 0
