"""Ragged unified paged attention — the CUDA kernels' wrapper.

Replaces ``_ragged_kernel`` (dynamo_tpu/ops/pallas/ragged_attention.py,
called through ``ragged_paged_attention_pallas``) on the card, both its
legs: caches in q's dtype, and int8 caches with per-(block, kv head)
float32 scales. The kernels' source, with its bound and design notes,
is ``dynamo_tpu_torch/csrc/ragged_attention.cu``. The bound is the K/V
bytes each span must read divided by the H100's 3.35 TB/s.

Each block of the kernels finds its span's kind on the card from
``q_len``: spans of at most ``SPLIT_ROWS`` rows (decode lanes, short
spec-verify spans) take the split-KV path (``csrc/paged_split.cuh``),
longer spans the tensor-core tile (bf16 q, ``csrc/paged_attention_tc.cuh``;
at head dims past 256, MLA's 576-wide entry, ``csrc/paged_attention_wide.cuh``)
or the CUDA-core walk (float32 q, ``csrc/paged_attention.cuh``), and a
merge pass combines the splits and zeroes rows no span owns. Three
launches per call, the split kernel on a second stream beside the tile
or walk, all planned from host shapes: ``ragged_split_plan``
never reads ``q_len`` or any other tensor, so the call issues without a
device-to-host copy.

``ragged_paged_attention_cuda`` takes the TPU function's arguments. For a
CUDA tensor it launches the kernels (building them on first use) or
raises; for a CPU tensor it runs the plain version from ops/attention.py.
Each call that launches adds one to ``ragged_paged_attention_cuda.launches``,
and one to the counter of each path it launches: ``launches_tc`` (the
tile), ``launches_walk`` (the walk) and ``launches_split`` (the split
kernel, with its merge pass).
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
ARGTYPES = [_P] * 14 + [_I] * 13 + [_P]

SPLIT_ROWS = 4           # spans of at most this many rows take the split path
SPLIT_VECS = 16          # query vectors a split block takes (kSplitVecs)
BLOCKS_PER_SM = 4        # split blocks the plan aims for per SM


def build() -> None:
    """Build and load the kernel library (a no-op once loaded)."""
    _build.load(NAME)


@functools.lru_cache(maxsize=1024)
def ragged_split_plan(
    spans: int, kv_heads: int, max_blocks: int, block_size: int,
    window: int = 0, num_sms: int = 132, head_groups: int = 1,
) -> tuple[int, int]:
    """(num_splits, pages_per_split) for the short spans of a ragged
    call: ``decode_split_plan`` over S spans, each a lane whose rows reach
    ``window + SPLIT_ROWS - 1`` keys back, aiming at BLOCKS_PER_SM blocks
    per SM (a ragged batch's short spans are only some of its S).
    ``head_groups`` is the split blocks one row of a span needs:
    ceil(G / SPLIT_VECS). Plain integers only, never ``q_len``: the plan
    must not read the card."""
    shape = (spans, kv_heads, max_blocks, block_size, window, num_sms, head_groups)
    if not all(isinstance(x, int) for x in shape):
        raise TypeError("ragged_split_plan takes host integers only")
    reach = window + SPLIT_ROWS - 1 if window else 0
    return decode_split_plan(
        spans, kv_heads, max_blocks, block_size, reach, 1, num_sms, head_groups,
        blocks_per_sm=BLOCKS_PER_SM,
    )


def call_split_plan(q, k_cache, block_tables, block_size: int, window: int = 0):
    """``ragged_split_plan`` for one call's CUDA operands: their shapes and
    the card's SM count, nothing read from the card."""
    H, kvH = q.shape[1], k_cache.shape[1]
    S, max_blocks = block_tables.shape
    return ragged_split_plan(
        S, kvH, max_blocks, block_size, window, _num_sms(q.device),
        -(-(H // kvH) // SPLIT_VECS),
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
    num_splits, pages = call_split_plan(q, k_cache, block_tables, block_size, window)
    parts = (None, None, None)
    if num_splits > 1:
        # One float32 scratch buffer: partial outs [S, SPLIT_ROWS, H,
        # splits, D], then m and l [S, SPLIT_ROWS, H, splits].
        n = S * SPLIT_ROWS * H * num_splits
        scratch = torch.empty(n * (D + 2), dtype=torch.float32, device=q.device)
        base = scratch.data_ptr()
        parts = (base, base + 4 * n * D, base + 4 * n * (D + 1))
    int8 = k_scales is not None
    _build.launch(
        NAME, "ragged_paged_attention", ARGTYPES,
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        k_scales.data_ptr() if int8 else None,
        v_scales.data_ptr() if int8 else None, out.data_ptr(), *parts,
        block_tables.data_ptr(), q_start.data_ptr(), q_len.data_ptr(),
        kv_len.data_ptr(), row_start.data_ptr(),
        T, H, k_cache.shape[1], D, S, max_blocks, block_size, window,
        num_splits, pages, SPLIT_ROWS, SUPPORTED_DTYPES[q.dtype], int(int8),
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
    return out


def reset_counts() -> None:
    """Set the wrapper's launch counters to 0."""
    fn = ragged_paged_attention_cuda
    fn.launches = fn.launches_tc = fn.launches_walk = fn.launches_split = 0


reset_counts()
