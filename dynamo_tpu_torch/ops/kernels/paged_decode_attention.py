"""Paged decode attention — the CUDA kernels' wrapper.

Replaces ``_decode_kernel`` (dynamo_tpu/ops/pallas/attention.py, called
through ``paged_decode_attention_pallas``) on the card; the kernels'
source, with its bound and design notes, is
``dynamo_tpu_torch/csrc/paged_decode_attention.cu``: a split-KV kernel
over column ranges of the block table, then a merge kernel. The bound is
the K/V bytes each lane must read divided by the H100's 3.35 TB/s.

``paged_decode_attention_cuda`` takes the TPU function's arguments,
striped kv_sp scan (``page_offset`` as a ``[1]`` int32 tensor on the
card, so the shard index never crosses to the host) and ``with_stats``
included. For a CUDA tensor it launches the kernels (building them on
first use) or raises; for a CPU tensor it runs the plain version from
ops/attention.py. Each call that launches adds one to
``paged_decode_attention_cuda.launches``, however many kernels run
behind it.

``decode_split_plan`` picks the split from host shapes alone, so the
wrapper reads nothing back from the card and ``decode_multi`` issues its
steps back to back.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from dynamo_tpu_torch.ops.attention import paged_decode_attention
from dynamo_tpu_torch.ops.kernels import _build
from dynamo_tpu_torch.ops.kernels._checks import (
    SUPPORTED_DTYPES,
    check_lane_args,
    check_paged_args,
)

NAME = "paged_decode_attention"
_P, _I = ctypes.c_void_p, ctypes.c_int
ARGTYPES = [_P] * 12 + [_I] * 11 + [_P]

BLOCKS_PER_SM = 2        # split-kernel blocks the plan aims for per SM
MIN_SPLIT_KEYS = 64      # keys a split covers at least (two 32-key chunks)
MAX_SPLITS = 64          # bounds the scratch and the merge's loop
HEADS_PER_BLOCK = 8      # query heads a split-kernel block takes (kHeads)


def build() -> None:
    """Build and load the kernel library (a no-op once loaded)."""
    _build.load(NAME)


@functools.lru_cache(maxsize=1024)
def decode_split_plan(
    batch: int, kv_heads: int, max_blocks: int, block_size: int,
    window: int = 0, page_stride: int = 1, num_sms: int = 132,
    head_groups: int = 1, blocks_per_sm: int = BLOCKS_PER_SM,
) -> tuple[int, int]:
    """(num_splits, pages_per_split) for a decode call: split s owns the
    table's columns [s*P, (s+1)*P), and the splits together cover all
    ``max_blocks`` columns. Plain integers only, never ``context_lens``:
    the plan must not read the card. It aims for ``blocks_per_sm`` blocks
    per SM over the columns a lane can see (all of them, or with a window
    the ceil(window / (bs*stride)) + 1 that the window can touch), with
    at least MIN_SPLIT_KEYS keys per split and at most MAX_SPLITS
    splits."""
    shape = (batch, kv_heads, max_blocks, block_size, window, page_stride,
             num_sms, head_groups, blocks_per_sm)
    if not all(isinstance(x, int) for x in shape):
        raise TypeError("decode_split_plan takes host integers only")
    pairs = max(batch * kv_heads * head_groups, 1)
    target = max(1, -(-blocks_per_sm * num_sms // pairs))
    visible = max_blocks
    if window:
        visible = min(max_blocks, -(-window // (block_size * page_stride)) + 1)
    pages = max(-(-MIN_SPLIT_KEYS // block_size), -(-visible // target))
    pages = max(min(pages, max_blocks), -(-max_blocks // MAX_SPLITS))
    return -(-max_blocks // pages), pages


@functools.cache
def _num_sms(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def call_split_plan(
    q, k_cache, block_tables, block_size: int, window: int = 0, page_stride: int = 1,
) -> tuple[int, int]:
    """``decode_split_plan`` for one call's CUDA operands: their shapes
    and the card's SM count, nothing read from the card."""
    B, H, _ = q.shape
    kvH = k_cache.shape[1]
    return decode_split_plan(
        B, kvH, block_tables.shape[1], block_size, window, page_stride,
        _num_sms(q.device), -(-(H // kvH) // HEADS_PER_BLOCK),
    )


def check_kernel_args(
    q, k_cache, v_cache, block_tables, context_lens, block_size: int,
    window: int = 0, page_offset=None, page_stride: int = 1,
) -> None:
    """Everything the kernels do not take raises here, before launch."""
    if q.dim() != 3:
        raise ValueError("q must be [B, H, D]")
    if block_tables.dim() == 2 and q.shape[0] != block_tables.shape[0]:
        raise ValueError("q and block_tables disagree on the lane count")
    check_paged_args(
        q, k_cache, v_cache, block_tables, (context_lens,), block_size,
        window, page_offset=page_offset, page_stride=page_stride,
    )
    check_lane_args(q, block_tables)


def paged_decode_attention_cuda(
    q: torch.Tensor,             # [B, H, D]
    k_cache: torch.Tensor,       # [num_slots, kvH, D]
    v_cache: torch.Tensor,
    block_tables: torch.Tensor,  # [B, max_blocks] int32 (LOCAL stripe when strided)
    context_lens: torch.Tensor,  # [B] int32 (0 = idle lane -> zeros)
    block_size: int,
    window: int = 0,
    page_offset: torch.Tensor | None = None,  # [1] int32 — shard residue
    page_stride: int = 1,
    with_stats: bool = False,
):
    """Returns out [B, H, D]; with ``with_stats`` (out float32, m [B, H],
    l [B, H]) for the kv_sp shard merge (ops/attention.py merge_stats)."""
    if q.device.type == "cpu":
        return paged_decode_attention(
            q, k_cache, v_cache, block_tables, context_lens, block_size,
            window, page_offset, page_stride, with_stats,
        )
    if q.device.type != "cuda":
        raise ValueError(f"no decode attention for device {q.device}")
    check_kernel_args(
        q, k_cache, v_cache, block_tables, context_lens, block_size, window,
        page_offset, page_stride,
    )
    B, H, D = q.shape
    S, P = call_split_plan(q, k_cache, block_tables, block_size, window, page_stride)
    if with_stats:
        out = torch.empty(q.shape, dtype=torch.float32, device=q.device)
        m = torch.empty((B, H), dtype=torch.float32, device=q.device)
        l = torch.empty_like(m)
    else:
        out, m, l = torch.empty_like(q), None, None
    parts = (None, None, None)
    if S > 1:
        # One float32 scratch buffer: partial outs [B, H, S, D], then m
        # and l [B, H, S].
        n = B * H * S
        scratch = torch.empty(n * (D + 2), dtype=torch.float32, device=q.device)
        base = scratch.data_ptr()
        parts = (base, base + 4 * n * D, base + 4 * n * (D + 1))
    _build.launch(
        NAME, NAME, ARGTYPES,
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), out.data_ptr(),
        m.data_ptr() if with_stats else None,
        l.data_ptr() if with_stats else None,
        *parts,
        block_tables.data_ptr(), context_lens.data_ptr(),
        page_offset.data_ptr() if page_offset is not None else None,
        B, H, k_cache.shape[1], D, block_tables.shape[1], block_size, window,
        page_stride, S, P,
        SUPPORTED_DTYPES[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    paged_decode_attention_cuda.launches += 1
    return (out, m, l) if with_stats else out


paged_decode_attention_cuda.launches = 0
