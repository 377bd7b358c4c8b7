"""Paged prefill attention — the CUDA kernels' wrapper.

Replaces ``_prefill_kernel`` (dynamo_tpu/ops/pallas/attention.py, called
through ``paged_prefill_attention_pallas``) on the card; the kernels'
source, with its bound and design notes, is
``dynamo_tpu_torch/csrc/paged_prefill_attention.cu``. Two entry points,
chosen by dtype (``kernel_entry``): bf16 runs the tensor-core tile
(``paged_prefill_attention_tc``), float32 the CUDA-core walk
(``paged_prefill_attention``), since a float32 product on tensor cores
would be TF32. The choice is this module's, in Python; neither entry
falls back to the other.

``paged_prefill_attention_cuda`` takes the TPU function's arguments,
striped kv_sp scan and ``with_stats`` included. ``q_tile`` is kept for
the signature: the TPU kernel tiles its rows by it, the CUDA kernels by
their own tiles, and neither changes the result. For a CUDA tensor it
launches a kernel (building it on first use) or raises; for a CPU tensor
it runs the plain version from ops/attention.py. Each launch adds one to
``paged_prefill_attention_cuda.launches``, and a launch of the
tensor-core tile one to ``paged_prefill_attention_cuda.launches_tc``.
"""

from __future__ import annotations

import ctypes

import torch

from dynamo_tpu_torch.ops.attention import paged_prefill_attention
from dynamo_tpu_torch.ops.kernels import _build
from dynamo_tpu_torch.ops.kernels._checks import check_lane_args, check_paged_args

NAME = "paged_prefill_attention"
TC_ENTRY = "paged_prefill_attention_tc"
_P, _I = ctypes.c_void_p, ctypes.c_int
ARGTYPES = [_P] * 10 + [_I] * 9 + [_P]


def build() -> None:
    """Build and load the kernel library (a no-op once loaded)."""
    _build.load(NAME)


def kernel_entry(dtype: torch.dtype) -> str:
    """The C entry point a CUDA call in ``dtype`` launches."""
    entries = {torch.bfloat16: TC_ENTRY, torch.float32: NAME}
    if dtype not in entries:
        raise TypeError(f"dtype {dtype} not in {list(entries)}")
    return entries[dtype]


def check_kernel_args(
    q, k_cache, v_cache, block_tables, q_start, total_len, block_size: int,
    window: int = 0, page_offset=None, page_stride: int = 1,
) -> None:
    """Everything the kernels do not take raises here, before launch."""
    if q.dim() != 4:
        raise ValueError("q must be [N, T, H, D]")
    if block_tables.dim() == 2 and q.shape[0] != block_tables.shape[0]:
        raise ValueError("q and block_tables disagree on the lane count")
    check_paged_args(
        q, k_cache, v_cache, block_tables, (q_start, total_len), block_size,
        window, page_offset=page_offset, page_stride=page_stride,
    )
    check_lane_args(q, block_tables)


def paged_prefill_attention_cuda(
    q: torch.Tensor,             # [N, T, H, D] — new tokens' queries per lane
    k_cache: torch.Tensor,       # [num_slots, kvH, D]
    v_cache: torch.Tensor,
    block_tables: torch.Tensor,  # [N, max_blocks] int32 (LOCAL stripe when strided)
    q_start: torch.Tensor,       # [N] int32 — prefix length per lane
    total_len: torch.Tensor,     # [N] int32 — prefix + real new tokens (0 = idle)
    block_size: int,
    q_tile: int = 64,
    window: int = 0,
    page_offset: torch.Tensor | None = None,  # [1] int32 — shard residue
    page_stride: int = 1,
    with_stats: bool = False,
):
    """Returns out [N, T, H, D]; with ``with_stats`` (out float32,
    m [N, T, H], l [N, T, H]) for the kv_sp shard merge."""
    if q.device.type == "cpu":
        return paged_prefill_attention(
            q, k_cache, v_cache, block_tables, q_start, total_len, block_size,
            q_tile, window, page_offset, page_stride, with_stats,
        )
    if q.device.type != "cuda":
        raise ValueError(f"no prefill attention for device {q.device}")
    if q_tile < 1:
        raise ValueError("q_tile must be >= 1")
    check_kernel_args(
        q, k_cache, v_cache, block_tables, q_start, total_len, block_size,
        window, page_offset, page_stride,
    )
    entry = kernel_entry(q.dtype)
    N, T, H, D = q.shape
    if with_stats:
        out = torch.empty(q.shape, dtype=torch.float32, device=q.device)
        m = torch.empty((N, T, H), dtype=torch.float32, device=q.device)
        l = torch.empty_like(m)
    else:
        out, m, l = torch.empty_like(q), None, None
    _build.launch(
        NAME, entry, ARGTYPES,
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), out.data_ptr(),
        m.data_ptr() if with_stats else None,
        l.data_ptr() if with_stats else None,
        block_tables.data_ptr(), q_start.data_ptr(), total_len.data_ptr(),
        page_offset.data_ptr() if page_offset is not None else None,
        N, T, H, k_cache.shape[1], D, block_tables.shape[1], block_size,
        window, page_stride,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    paged_prefill_attention_cuda.launches += 1
    if entry == TC_ENTRY:
        paged_prefill_attention_cuda.launches_tc += 1
    return (out, m, l) if with_stats else out


paged_prefill_attention_cuda.launches = 0
paged_prefill_attention_cuda.launches_tc = 0
