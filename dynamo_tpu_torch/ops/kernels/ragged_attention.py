"""Ragged unified paged attention — the CUDA kernels' wrapper.

Replaces ``_ragged_kernel`` (dynamo_tpu/ops/pallas/ragged_attention.py,
called through ``ragged_paged_attention_pallas``) on the card, both its
legs: caches in q's dtype, and int8 caches with per-(block, kv head)
float32 scales. The kernels' source, with its bound and design notes,
is ``dynamo_tpu_torch/csrc/ragged_attention.cu``. The bound is the K/V
bytes each span must read divided by the H100's 3.35 TB/s.

Each block of the kernels finds its span's kind on the card from
``q_len``: spans of at most ``SPLIT_ROWS`` rows (decode lanes, short
spec-verify spans) take the split-KV path, longer spans the tensor-core
tile (bf16 q, ``csrc/paged_attention_tc.cuh``; at head dims past 256,
MLA's 576-wide entry, ``csrc/paged_attention_wide.cuh``) or the
CUDA-core walk (float32 q, ``csrc/paged_attention.cuh``), and a merge
pass combines the splits and the tile's key ranges and zeroes rows no
span owns. At head dims 64, 128 and 256 (``WGMMA_SPLIT_BLOCKS_PER_SM``)
the tile takes its products on ``wgmma``, and with bf16 q a short span's
split is a one-warpgroup tile on the same entry; elsewhere the tile
takes them on ``mma.sync`` and the split is ``csrc/paged_split.cuh`` on
CUDA cores. Three
launches per call, the split kernel on a second stream beside the tile
or walk, all planned from host shapes: ``ragged_split_plan`` (the short
spans' splits) and ``ragged_tile_plan`` (the key ranges of each bf16
tile), each range or split a balanced run of the columns its rows can
see inside their window, never read ``q_len`` or any other tensor, so
the call issues without a device-to-host copy.

``ragged_paged_attention_cuda`` takes the TPU function's arguments. For a
CUDA tensor it launches the kernels (building them on first use) or
raises; for a CPU tensor it runs the plain version from ops/attention.py.
Each call that launches adds one to ``ragged_paged_attention_cuda.launches``,
and one to the counter of each path it launches: ``launches_tc`` (the
tile), ``launches_walk`` (the walk) and ``launches_split`` (the split
path, with its merge pass), and of those split launches, the ones on the
wgmma tile to ``launches_split_wgmma`` (the rest ran paged_split.cuh).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from dynamo_tpu_torch.ops.attention import ragged_paged_attention, span_tokens
from dynamo_tpu_torch.ops.kernels import _build
from dynamo_tpu_torch.ops.kernels._checks import (
    SUPPORTED_DTYPES,
    check_lane_args,
    check_paged_args,
)
from dynamo_tpu_torch.ops.kernels.paged_decode_attention import _num_sms, decode_split_plan

NAME = "ragged_attention"
_P, _I = ctypes.c_void_p, ctypes.c_int
ARGTYPES = [_P] * 17 + [_I] * 13 + [_P]

SPLIT_ROWS = 4           # spans of at most this many rows take the split path
SPLIT_VECS = 16          # query vectors a split block takes (kSplitVecs)
BLOCKS_PER_SM = 4        # paged_split.cuh blocks the plan aims for per SM
TILE_VECS = 128          # query vectors a tile takes (paged_tc::kM)
MIN_RANGE_WORK = 1 << 15  # keys x head dim a tile's key range walks at least
# The head dims of the wgmma entry, and the blocks of its split an SM
# holds (its registers and shared memory: 128 registers and 49 KB at
# D = 64, ~240 and 97 KB at 128, 129 KB at 256).
WGMMA_SPLIT_BLOCKS_PER_SM = {64: 4, 128: 2, 256: 1}


def build() -> None:
    """Build and load the kernel library (a no-op once loaded)."""
    _build.load(NAME)


@functools.lru_cache(maxsize=1024)
def ragged_split_plan(
    spans: int, kv_heads: int, max_blocks: int, block_size: int,
    window: int = 0, num_sms: int = 132, head_groups: int = 1,
    blocks_per_sm: int = BLOCKS_PER_SM,
) -> tuple[int, int]:
    """(num_splits, pages_per_split) for the short spans of a ragged
    call: the pages P of ``decode_split_plan`` over S spans, each a lane
    whose rows reach ``window + SPLIT_ROWS - 1`` keys back, aiming at a
    wave of the split kernel's blocks, ``blocks_per_sm`` an SM (a ragged
    batch's short spans are only some of its S); then as many splits as
    P-page runs cover the columns
    such a span can see (``visible_columns``), not the table's width. On
    the card each split takes a balanced run of its span's visible
    columns (``split_columns``), at most P. ``head_groups`` is the split blocks
    one row of a span needs: ceil(G / SPLIT_VECS). Plain integers only,
    never ``q_len``: the plan must not read the card."""
    shape = (spans, kv_heads, max_blocks, block_size, window, num_sms, head_groups,
             blocks_per_sm)
    if not all(isinstance(x, int) for x in shape):
        raise TypeError("ragged_split_plan takes host integers only")
    reach = window + SPLIT_ROWS - 1 if window else 0
    _, pages = decode_split_plan(
        spans, kv_heads, max_blocks, block_size, reach, 1, num_sms, head_groups,
        blocks_per_sm=blocks_per_sm,
    )
    return -(-visible_columns(max_blocks, block_size, reach) // pages), pages


def visible_columns(max_blocks: int, block_size: int, reach: int = 0) -> int:
    """The most table columns one span's rows can see: all of them, or
    with ``reach`` (the keys from a span's first row's window start to
    its last row) the ceil(reach / bs) + 1 pages those keys can touch."""
    if not reach:
        return max_blocks
    return min(max_blocks, -(-reach // block_size) + 1)


def span_columns(
    q_start: int, first_row: int, last_row: int, kv_len: int, window: int,
    block_size: int, max_blocks: int,
) -> tuple[int, int]:
    """The table columns [first, end) that rows [first_row, last_row] of
    a span can see: from the page of the first row's window start to the
    page of the last row's causal bound (``split_block`` and ``tc_tile``
    on the card)."""
    lo_pos = max(q_start + first_row - window + 1, 0) if window else 0
    hi = min(q_start + last_row + 1, kv_len)
    return lo_pos // block_size, min(-(-hi // block_size), max_blocks)


def split_columns(first: int, end: int, num_splits: int, s: int) -> tuple[int, int]:
    """Split s's columns [lo, hi) of a split block whose rows see columns
    [first, end): the s-th of num_splits balanced runs, none empty while
    the rows see at least num_splits columns."""
    n = max(end - first, 0)
    return first + s * n // num_splits, first + (s + 1) * n // num_splits


@functools.lru_cache(maxsize=1024)
def ragged_tile_plan(
    rows: int, heads: int, kv_heads: int, head_dim: int, max_blocks: int,
    block_size: int, window: int = 0, num_sms: int = 132,
) -> int:
    """The key ranges each bf16 tile's chunks are cut into (1 = the tile
    walks all its keys and writes the output). A batch too small to hold
    one full tile of rows (a decode rung) takes one: its long spans, if
    any, are a few rows, and its ranges' blocks would mostly find no
    tile. The tiles of a full batch of long spans, ceil(rows * G /
    TILE_VECS) per kv head, are counted against a wave (two tiles an SM
    at head dims up to 64, one past); ranges are added until they fill
    it, each walking at least
    MIN_RANGE_WORK keys x head dim of the keys a tile sees: with a
    window, the window and the tile's rows; without one, half the table
    (a causal tile's mean over the positions the table holds). At
    llama3.2-1b's serve rungs (64-column tables, D = 64) one range.
    Plain integers only, never ``q_len``."""
    shape = (rows, heads, kv_heads, head_dim, max_blocks, block_size, window, num_sms)
    if not all(isinstance(x, int) for x in shape):
        raise TypeError("ragged_tile_plan takes host integers only")
    G = heads // kv_heads
    if rows * G < TILE_VECS:
        return 1
    tiles = -(-rows * G // TILE_VECS) * kv_heads
    wave = num_sms * (2 if head_dim <= 64 else 1)
    if window:
        reach = min(max_blocks * block_size, window + -(-TILE_VECS // G) - 1 + block_size - 1)
    else:
        reach = max_blocks * block_size // 2
    return max(1, min(-(-wave // tiles), reach * head_dim // MIN_RANGE_WORK))


def call_tile_plan(q, k_cache, block_tables, block_size: int, window: int = 0) -> int:
    """The key ranges one call's tile takes: ``ragged_tile_plan`` for bf16
    q at head dims up to 256, else 1 (the f32 walk and the wide tile do
    not cut their keys)."""
    T, H, D = q.shape
    if q.dtype != torch.bfloat16 or D > 256:
        return 1
    return ragged_tile_plan(T, H, k_cache.shape[1], D, block_tables.shape[1], block_size,
                            window, _num_sms(q.device))


def split_blocks_per_sm(dtype: torch.dtype, head_dim: int) -> int:
    """Blocks an SM holds of the split kernel a call launches: the wgmma
    split's (bf16 q at its head dims), else paged_split.cuh's."""
    if split_on_wgmma(dtype, head_dim):
        return WGMMA_SPLIT_BLOCKS_PER_SM[head_dim]
    return BLOCKS_PER_SM


def split_on_wgmma(dtype: torch.dtype, head_dim: int) -> bool:
    """Whether a call's short spans split on the wgmma tile (bf16 q at
    D = 64, 128, 256) rather than on paged_split.cuh."""
    return dtype == torch.bfloat16 and head_dim in WGMMA_SPLIT_BLOCKS_PER_SM


def call_split_plan(q, k_cache, block_tables, block_size: int, window: int = 0):
    """``ragged_split_plan`` for one call's CUDA operands: their shapes and
    the card's SM count, nothing read from the card."""
    _, H, D = q.shape
    kvH = k_cache.shape[1]
    S, max_blocks = block_tables.shape
    return ragged_split_plan(
        S, kvH, max_blocks, block_size, window, _num_sms(q.device),
        -(-(H // kvH) // SPLIT_VECS), split_blocks_per_sm(q.dtype, D),
    )


def check_kernel_args(
    q, k_cache, v_cache, block_tables, q_start, q_len, kv_len, row_start,
    block_size: int, window: int, k_scales=None, v_scales=None,
) -> None:
    """Everything the kernels do not take raises here, before launch."""
    if q.dim() != 3:
        raise ValueError("q must be [T, H, D]")
    check_paged_args(
        q, k_cache, v_cache, block_tables, (q_start, q_len, kv_len, row_start),
        block_size, window, k_scales, v_scales, wide=True,
    )
    check_lane_args(q, block_tables)


def ragged_paged_attention_cuda(
    q: torch.Tensor,             # [T, H, D] flat token batch (budget-padded)
    k_cache: torch.Tensor,       # [num_slots, kvH, D], q's dtype or int8
    v_cache: torch.Tensor,
    block_tables: torch.Tensor,  # [S, max_blocks] int32
    q_start: torch.Tensor,       # [S] int32 — prefix length per span
    q_len: torch.Tensor,         # [S] int32 — span rows (0 = idle)
    kv_len: torch.Tensor,        # [S] int32 — context incl. this step
    row_start: torch.Tensor,     # [S] int32 — span's first flat row
    block_size: int,
    window: int = 0,
    k_scales: torch.Tensor | None = None,  # [num_blocks, kvH] f32 (int8 cache)
    v_scales: torch.Tensor | None = None,
) -> torch.Tensor:
    """Mixed prefill+decode attention over one flat ragged batch; returns
    ``[T, H, D]`` with rows no span owns zeroed."""
    if q.device.type == "cpu":
        token_seq, token_pos = span_tokens(q_start, q_len, row_start, q.shape[0])
        return ragged_paged_attention(
            q, k_cache, v_cache, block_tables, token_seq, token_pos,
            block_size, window, k_scales=k_scales, v_scales=v_scales,
        )
    if q.device.type != "cuda":
        raise ValueError(f"no ragged attention for device {q.device}")
    check_kernel_args(
        q, k_cache, v_cache, block_tables, q_start, q_len, kv_len,
        row_start, block_size, window, k_scales, v_scales,
    )
    T, H, D = q.shape
    S, max_blocks = block_tables.shape
    out = torch.empty_like(q)
    if T == 0:
        return out
    num_splits, _ = call_split_plan(q, k_cache, block_tables, block_size, window)
    ranges = call_tile_plan(q, k_cache, block_tables, block_size, window)
    # One float32 scratch buffer: the split path's partial outs [S,
    # SPLIT_ROWS, H, splits, D], m and l [S, SPLIT_ROWS, H, splits]; then
    # the tile's [T, H, ranges, D], m and l [T, H, ranges].
    n = S * SPLIT_ROWS * H * num_splits if num_splits > 1 else 0
    nt = T * H * ranges if ranges > 1 else 0
    parts = [None] * 6
    if n + nt:
        scratch = torch.empty((n + nt) * (D + 2), dtype=torch.float32, device=q.device)
        base = scratch.data_ptr()
        if n:
            parts[:3] = base, base + 4 * n * D, base + 4 * n * (D + 1)
        if nt:
            base += 4 * n * (D + 2)
            parts[3:] = base, base + 4 * nt * D, base + 4 * nt * (D + 1)
    int8 = k_scales is not None
    _build.launch(
        NAME, "ragged_paged_attention", ARGTYPES,
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        k_scales.data_ptr() if int8 else None,
        v_scales.data_ptr() if int8 else None, out.data_ptr(), *parts,
        block_tables.data_ptr(), q_start.data_ptr(), q_len.data_ptr(),
        kv_len.data_ptr(), row_start.data_ptr(),
        T, H, k_cache.shape[1], D, S, max_blocks, block_size, window,
        num_splits, ranges, SPLIT_ROWS, SUPPORTED_DTYPES[q.dtype], int(int8),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    fn = ragged_paged_attention_cuda
    fn.launches += 1
    if q.dtype == torch.bfloat16:
        fn.launches_tc += 1
    elif S:
        fn.launches_walk += 1
    if S:
        fn.launches_split += 1
        fn.launches_split_wgmma += split_on_wgmma(q.dtype, D)
    return out


def reset_counts() -> None:
    """Set the wrapper's launch counters to 0."""
    fn = ragged_paged_attention_cuda
    fn.launches = fn.launches_tc = fn.launches_walk = fn.launches_split = 0
    fn.launches_split_wgmma = 0


reset_counts()
