"""Paged decode attention — the CUDA kernel's wrapper.

Replaces ``_decode_kernel`` (dynamo_tpu/ops/pallas/attention.py, called
through ``paged_decode_attention_pallas``) on the card; the kernel's
source, with its bound and design notes, is
``dynamo_tpu_torch/csrc/paged_decode_attention.cu``. The bound is the
K/V bytes each lane must read divided by the H100's 3.35 TB/s.

``paged_decode_attention_cuda`` takes the TPU function's arguments,
striped kv_sp scan (``page_offset`` as a ``[1]`` int32 tensor on the
card, so the shard index never crosses to the host) and ``with_stats``
included. For a CUDA tensor it launches the kernel (building it on first
use) or raises; for a CPU tensor it runs the plain version from
ops/attention.py. Each launch adds one to
``paged_decode_attention_cuda.launches``.
"""

from __future__ import annotations

import ctypes

import torch

from dynamo_tpu_torch.ops.attention import paged_decode_attention
from dynamo_tpu_torch.ops.kernels import _build
from dynamo_tpu_torch.ops.kernels._checks import SUPPORTED_DTYPES, check_paged_args

NAME = "paged_decode_attention"
_P, _I = ctypes.c_void_p, ctypes.c_int
ARGTYPES = [_P] * 9 + [_I] * 9 + [_P]


def build() -> None:
    """Build and load the kernel library (a no-op once loaded)."""
    _build.load(NAME)


def check_kernel_args(
    q, k_cache, v_cache, block_tables, context_lens, block_size: int,
    window: int = 0, page_offset=None, page_stride: int = 1,
) -> None:
    """Everything the kernel does not take raises here, before launch."""
    if q.dim() != 3:
        raise ValueError("q must be [B, H, D]")
    if block_tables.dim() == 2 and q.shape[0] != block_tables.shape[0]:
        raise ValueError("q and block_tables disagree on the lane count")
    check_paged_args(
        q, k_cache, v_cache, block_tables, (context_lens,), block_size,
        window, page_offset=page_offset, page_stride=page_stride,
    )


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
    if with_stats:
        out = torch.empty(q.shape, dtype=torch.float32, device=q.device)
        m = torch.empty((B, H), dtype=torch.float32, device=q.device)
        l = torch.empty_like(m)
    else:
        out, m, l = torch.empty_like(q), None, None
    _build.launch(
        NAME, NAME, ARGTYPES,
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), out.data_ptr(),
        m.data_ptr() if with_stats else None,
        l.data_ptr() if with_stats else None,
        block_tables.data_ptr(), context_lens.data_ptr(),
        page_offset.data_ptr() if page_offset is not None else None,
        B, H, k_cache.shape[1], D, block_tables.shape[1], block_size, window,
        page_stride, SUPPORTED_DTYPES[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    paged_decode_attention_cuda.launches += 1
    return (out, m, l) if with_stats else out


paged_decode_attention_cuda.launches = 0
