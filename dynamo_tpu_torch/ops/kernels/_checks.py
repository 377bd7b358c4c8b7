"""Operand checks shared by the paged-attention kernels' wrappers:
everything a kernel does not take raises here, before its launch."""

from __future__ import annotations

import torch

SUPPORTED_BLOCK_SIZES = (4, 16)
SUPPORTED_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 256
# The ragged kernel's wide entry: head dims in (256, 576], multiples of
# 64 (MLA's one shared [latent ‖ roped k_pe] head of 512 + 64).
MAX_WIDE_HEAD_DIM = 576


def check_head_dim(D: int, wide: bool) -> None:
    """Head dims every kernel takes: multiples of 16 up to 256; with
    ``wide`` (the ragged kernel) also the wide entry. The decode and
    prefill kernels refuse the wide entry by name."""
    if 0 < D <= MAX_HEAD_DIM and D % 16 == 0:
        return
    if MAX_HEAD_DIM < D <= MAX_WIDE_HEAD_DIM and D % 64 == 0:
        if wide:
            return
        raise ValueError(
            f"head dim {D}: the decode and prefill kernels stop at "
            f"{MAX_HEAD_DIM}; MLA's {MAX_WIDE_HEAD_DIM}-wide entry in them is "
            "ROADMAP B8 (the unified step's ragged kernel takes it)"
        )
    top = MAX_WIDE_HEAD_DIM if wide else MAX_HEAD_DIM
    raise ValueError(
        f"head dim {D} must be a multiple of 16 up to {MAX_HEAD_DIM}"
        + (f", or of 64 up to {top}" if wide else "")
    )


def check_paged_args(
    q, k_cache, v_cache, block_tables, meta, block_size: int, window: int,
    k_scales=None, v_scales=None, page_offset=None, page_stride: int = 1,
    wide: bool = False,
) -> None:
    """q ``[..., H, D]``; caches ``[slots, kvH, D]`` (``check_head_dim``:
    ``wide`` for the ragged kernel) in q's dtype, or
    int8 together with f32 scales ``[num_blocks, kvH]``; int32 block
    tables ``[S, max_blocks]`` and per-row metadata ``[S]``; an optional
    ``[1]`` int32 page offset. All on one device, contiguous, the caches
    16-byte aligned (the kernels' vector loads)."""
    if k_cache.dim() != 3 or q.dim() < 3:
        raise ValueError("q must be [..., H, D] and the caches [slots, kvH, D]")
    H, D = q.shape[-2:]
    slots, kvH, Dc = k_cache.shape
    if v_cache.shape != k_cache.shape:
        raise ValueError("k_cache and v_cache shapes differ")
    if Dc != D:
        raise ValueError(f"cache head dim {Dc} != query head dim {D}")
    check_head_dim(D, wide)
    if H % kvH:
        raise ValueError(f"{H} query heads do not group over {kvH} kv heads")
    if block_size not in SUPPORTED_BLOCK_SIZES:
        raise ValueError(f"block_size {block_size} not in {SUPPORTED_BLOCK_SIZES}")
    if slots % block_size:
        raise ValueError("cache slots are not a whole number of blocks")
    if window < 0:
        raise ValueError("window must be >= 0")
    if page_stride < 1:
        raise ValueError("page_stride must be >= 1")
    if q.dtype not in SUPPORTED_DTYPES:
        raise TypeError(f"dtype {q.dtype} not in {list(SUPPORTED_DTYPES)}")
    tensors = [q, k_cache, v_cache, block_tables, *meta]
    if (k_scales is None) != (v_scales is None):
        raise ValueError("k_scales and v_scales come together")
    if k_scales is None:
        if k_cache.dtype == torch.int8:
            raise TypeError("an int8 cache needs k_scales and v_scales")
        if k_cache.dtype != q.dtype or v_cache.dtype != q.dtype:
            raise TypeError("q and the caches must share one dtype")
    else:
        if k_cache.dtype != torch.int8 or v_cache.dtype != torch.int8:
            raise TypeError("scales go with int8 caches")
        want = (slots // block_size, kvH)
        for s in (k_scales, v_scales):
            if s.dtype != torch.float32 or tuple(s.shape) != want:
                raise TypeError(f"scales must be float32 {list(want)}")
        tensors += [k_scales, v_scales]
    if block_tables.dim() != 2:
        raise ValueError("block_tables must be [S, max_blocks]")
    S = block_tables.shape[0]
    for t in (block_tables, *meta):
        if t.dtype != torch.int32:
            raise TypeError("block tables and metadata must be int32")
    for t in meta:
        if t.shape != (S,):
            raise ValueError(f"metadata must be [S={S}]")
    if page_offset is not None:
        if page_offset.dtype != torch.int32 or page_offset.shape != (1,):
            raise TypeError("page_offset must be an int32 [1] tensor")
        tensors.append(page_offset)
    if any(t.device != q.device for t in tensors):
        raise ValueError("all operands must lie on one device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("all operands must be contiguous")
    if k_cache.data_ptr() % 16 or v_cache.data_ptr() % 16:
        raise ValueError("the caches must be 16-byte aligned (vector loads)")


MAX_GRID_YZ = 65535


def check_lane_args(q, block_tables) -> None:
    """What the decode, prefill and ragged kernels add to
    ``check_paged_args``: lanes (spans) map onto grid.y, the split plan
    divides the table's columns, and q's fragments are read in whole
    words."""
    if block_tables.shape[0] > MAX_GRID_YZ:
        raise ValueError(f"at most {MAX_GRID_YZ} lanes per call")
    if block_tables.shape[1] < 1:
        raise ValueError("block_tables needs at least one column")
    if q.data_ptr() % 16:
        raise ValueError("q must be 16-byte aligned")
