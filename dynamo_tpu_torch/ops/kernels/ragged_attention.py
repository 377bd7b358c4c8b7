"""Ragged unified paged attention — the CUDA kernel's wrapper.

Replaces ``_ragged_kernel`` (dynamo_tpu/ops/pallas/ragged_attention.py,
called through ``ragged_paged_attention_pallas``) on the card, both its
legs: caches in q's dtype, and int8 caches with per-(block, kv head)
float32 scales. The kernel's source, with its bound and design notes,
is ``dynamo_tpu_torch/csrc/ragged_attention.cu`` (core in
``paged_attention.cuh``). The bound is the K/V bytes each span must read
divided by the H100's 3.35 TB/s.

``ragged_paged_attention_cuda`` takes the TPU function's arguments. For a
CUDA tensor it launches the kernel (building it on first use) or raises;
for a CPU tensor it runs the plain version from ops/attention.py. Each
launch adds one to ``ragged_paged_attention_cuda.launches``.
"""

from __future__ import annotations

import ctypes

import torch

from dynamo_tpu_torch.ops.attention import ragged_paged_attention, span_tokens
from dynamo_tpu_torch.ops.kernels import _build
from dynamo_tpu_torch.ops.kernels._checks import SUPPORTED_DTYPES, check_paged_args

NAME = "ragged_attention"
_P, _I = ctypes.c_void_p, ctypes.c_int
ARGTYPES = [_P] * 11 + [_I] * 10 + [_P]


def build() -> None:
    """Build and load the kernel library (a no-op once loaded)."""
    _build.load(NAME)


def check_kernel_args(
    q, k_cache, v_cache, block_tables, q_start, q_len, kv_len, row_start,
    block_size: int, window: int, k_scales=None, v_scales=None,
) -> None:
    """Everything the kernel does not take raises here, before launch."""
    if q.dim() != 3:
        raise ValueError("q must be [T, H, D]")
    check_paged_args(
        q, k_cache, v_cache, block_tables, (q_start, q_len, kv_len, row_start),
        block_size, window, k_scales, v_scales,
    )


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
    out = torch.empty_like(q)
    int8 = k_scales is not None
    _build.launch(
        NAME, "ragged_paged_attention", ARGTYPES,
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        k_scales.data_ptr() if int8 else None,
        v_scales.data_ptr() if int8 else None, out.data_ptr(),
        block_tables.data_ptr(), q_start.data_ptr(), q_len.data_ptr(),
        kv_len.data_ptr(), row_start.data_ptr(),
        T, H, k_cache.shape[1], D, block_tables.shape[0],
        block_tables.shape[1], block_size, window, SUPPORTED_DTYPES[q.dtype],
        int(int8), torch.cuda.current_stream(q.device).cuda_stream,
    )
    ragged_paged_attention_cuda.launches += 1
    return out


ragged_paged_attention_cuda.launches = 0
