"""Ragged unified paged attention — the CUDA kernel's wrapper.

Replaces ``_ragged_kernel`` (dynamo_tpu/ops/pallas/ragged_attention.py,
called through ``ragged_paged_attention_pallas``) on the card; the
kernel's source, with its bound and design notes, is
``dynamo_tpu_torch/csrc/ragged_attention.cu``. The bound is the K/V
bytes each span must read divided by the H100's 3.35 TB/s.

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

NAME = "ragged_attention"
SUPPORTED_BLOCK_SIZES = (4, 16)
SUPPORTED_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 256


def _lib() -> ctypes.CDLL:
    """The kernel library, built and loaded on first use, with its C
    signatures declared (pointers as c_void_p so none is cut to 32 bits)."""
    lib = _build.load(NAME)
    if not getattr(lib, "signatures_declared", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        fn = lib.ragged_paged_attention
        fn.argtypes = [p] * 9 + [i] * 9 + [p]
        fn.restype = i
        lib.ragged_paged_attention_error.argtypes = [i]
        lib.ragged_paged_attention_error.restype = ctypes.c_char_p
        lib.signatures_declared = True
    return lib


def build() -> None:
    """Build and load the kernel library (a no-op once loaded)."""
    _lib()


def check_kernel_args(
    q, k_cache, v_cache, block_tables, q_start, q_len, kv_len, row_start,
    block_size: int, window: int,
) -> None:
    """Everything the kernel does not take raises here, before launch."""
    if q.dim() != 3 or k_cache.dim() != 3:
        raise ValueError("q must be [T, H, D] and the caches [slots, kvH, D]")
    T, H, D = q.shape
    slots, kvH, Dc = k_cache.shape
    if v_cache.shape != k_cache.shape:
        raise ValueError("k_cache and v_cache shapes differ")
    if Dc != D:
        raise ValueError(f"cache head dim {Dc} != query head dim {D}")
    if D % 16 or D > MAX_HEAD_DIM:
        raise ValueError(f"head dim {D} must be a multiple of 16 up to {MAX_HEAD_DIM}")
    if H % kvH:
        raise ValueError(f"{H} query heads do not group over {kvH} kv heads")
    if block_size not in SUPPORTED_BLOCK_SIZES:
        raise ValueError(
            f"block_size {block_size} not in {SUPPORTED_BLOCK_SIZES}"
        )
    if slots % block_size:
        raise ValueError("cache slots are not a whole number of blocks")
    if window < 0:
        raise ValueError("window must be >= 0")
    if q.dtype not in SUPPORTED_DTYPES:
        raise TypeError(f"dtype {q.dtype} not in {list(SUPPORTED_DTYPES)}")
    if k_cache.dtype != q.dtype or v_cache.dtype != q.dtype:
        raise TypeError("q and the caches must share one dtype")
    meta = (q_start, q_len, kv_len, row_start)
    if block_tables.dim() != 2:
        raise ValueError("block_tables must be [S, max_blocks]")
    S = block_tables.shape[0]
    for t in (block_tables, *meta):
        if t.dtype != torch.int32:
            raise TypeError("block tables and span metadata must be int32")
    for t in meta:
        if t.shape != (S,):
            raise ValueError(f"span metadata must be [S={S}]")
    tensors = (q, k_cache, v_cache, block_tables, *meta)
    if any(t.device != q.device for t in tensors):
        raise ValueError("all operands must lie on one device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("all operands must be contiguous")
    if k_cache.data_ptr() % 16 or v_cache.data_ptr() % 16:
        raise ValueError("the caches must be 16-byte aligned (vector loads)")


def ragged_paged_attention_cuda(
    q: torch.Tensor,             # [T, H, D] flat token batch (budget-padded)
    k_cache: torch.Tensor,       # [num_slots, kvH, D]
    v_cache: torch.Tensor,
    block_tables: torch.Tensor,  # [S, max_blocks] int32
    q_start: torch.Tensor,       # [S] int32 — prefix length per span
    q_len: torch.Tensor,         # [S] int32 — span rows (0 = idle)
    kv_len: torch.Tensor,        # [S] int32 — context incl. this step
    row_start: torch.Tensor,     # [S] int32 — span's first flat row
    block_size: int,
    window: int = 0,
) -> torch.Tensor:
    """Mixed prefill+decode attention over one flat ragged batch; returns
    ``[T, H, D]`` with rows no span owns zeroed."""
    if q.device.type == "cpu":
        token_seq, token_pos = span_tokens(q_start, q_len, row_start, q.shape[0])
        return ragged_paged_attention(
            q, k_cache, v_cache, block_tables, token_seq, token_pos,
            block_size, window,
        )
    if q.device.type != "cuda":
        raise ValueError(f"no ragged attention for device {q.device}")
    check_kernel_args(
        q, k_cache, v_cache, block_tables, q_start, q_len, kv_len,
        row_start, block_size, window,
    )
    lib = _lib()
    T, H, D = q.shape
    kvH = k_cache.shape[1]
    out = torch.empty_like(q)
    err = lib.ragged_paged_attention(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), out.data_ptr(),
        block_tables.data_ptr(), q_start.data_ptr(), q_len.data_ptr(),
        kv_len.data_ptr(), row_start.data_ptr(),
        T, H, kvH, D, block_tables.shape[0], block_tables.shape[1],
        block_size, window, SUPPORTED_DTYPES[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if err:
        msg = lib.ragged_paged_attention_error(err).decode()
        raise RuntimeError(f"ragged attention kernel launch failed: {msg}")
    ragged_paged_attention_cuda.launches += 1
    return out


ragged_paged_attention_cuda.launches = 0
