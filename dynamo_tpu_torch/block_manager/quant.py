"""Host-side quantized block rows for the KVBM tiers (port of
dynamo_tpu/block_manager/quant.py).

The per-tier precision policy (docs/architecture/kv_quant.md): G1 serves
hot KV in the engine's compute dtype OR int8 (EngineConfig.kv_quant); the
G2 host and G3 disk tiers store int8 whenever their layout says
``quant="int8"`` — half the bytes per block, which doubles tier capacity
and halves every G1↔G2↔G3 transfer.

A quantized block travels as ONE packed byte row so the pool/offload/
remote machinery stays a layout-agnostic byte mover:

    [ int8 data  (layout.block_elems bytes, [L, 2, bs, H, D] order) |
      f32 scales (layout.scale_elems * 4 bytes, [L, 2, H] order)    ]

Quantize-on-offload vs passthrough is the DEVICE policy's call
(block_manager/manager.py): an int8 G1 hands its native (int8, scales)
pair straight into ``pack_block`` (bit-exact down-tier); a bf16 G1's
offered bytes quantize here on the pump's worker thread. Onboarding is
the mirror image: dequant for a bf16 G1, passthrough for int8.

numpy-only (these run on pump/offload worker threads, never on device).
The host block law (``quantize_kv_block_host`` /
``dequantize_kv_block_host``) is this module's own copy of the
reference's ops/quant.py host functions.
"""

from __future__ import annotations

import numpy as np

from dynamo_tpu_torch.block_manager.config import KvLayoutConfig


def quantize_kv_block_host(data, num_kv_heads: int, head_dim: int):
    """One block's values [..., bs, kvH, D] float → (int8, float32 scales
    shaped data.shape[:-3] + (kvH,)): per (leading dims, head) symmetric
    scales, amax over (block_size, head_dim)."""
    arr = np.asarray(data, np.float32)
    amax = np.abs(arr).max(axis=(-3, -1))
    s = amax / 127.0
    with np.errstate(divide="ignore", invalid="ignore"):
        q = np.where(
            s[..., None, :, None] > 0,
            np.clip(
                np.round(arr / np.maximum(s[..., None, :, None], 1e-30)),
                -127, 127,
            ),
            0.0,
        )
    return q.astype(np.int8), s.astype(np.float32)


def dequantize_kv_block_host(q, scales) -> np.ndarray:
    """int8 [..., bs, kvH, D] * scales [..., kvH] → float32 values."""
    return np.asarray(q, np.float32) * np.asarray(scales, np.float32)[
        ..., None, :, None
    ]


def _bf16_bits_to_f32(u16: np.ndarray) -> np.ndarray:
    return (u16.astype(np.uint32) << 16).view(np.float32)


def _f32_to_bf16_bits(f32: np.ndarray) -> np.ndarray:
    """Round-to-nearest-even f32 -> bf16 bit pattern (uint16)."""
    bits = np.asarray(f32, np.float32).view(np.uint32)
    rounded = bits + (((bits >> 16) & 1) + 0x7FFF)
    return (rounded >> 16).astype(np.uint16)


def decode_values(data, layout: KvLayoutConfig) -> np.ndarray:
    """One block's raw value bytes (any of the host representations:
    uint16 bf16 views, f16/f32) -> float32
    [L, 2, bs, H, D]."""
    shape = (
        layout.num_layers, 2, layout.page_size, layout.num_kv_heads,
        layout.head_dim,
    )
    arr = np.asarray(data)
    if arr.dtype == np.uint16 and layout.dtype == "bfloat16":
        arr = _bf16_bits_to_f32(arr.reshape(-1))
    return np.asarray(arr, np.float32).reshape(shape)


def encode_values(vals: np.ndarray, layout: KvLayoutConfig) -> np.ndarray:
    """float32 values -> the layout's host byte representation (uint16
    bf16 bits / f16 / f32), flat."""
    flat = np.asarray(vals, np.float32).reshape(-1)
    if layout.dtype == "bfloat16":
        return _f32_to_bf16_bits(flat)
    return flat.astype({"float16": np.float16, "float32": np.float32}[
        layout.dtype
    ])


def pack_block(
    q: np.ndarray, scales: np.ndarray, layout: KvLayoutConfig
) -> np.ndarray:
    """(int8 data [L, 2, bs, H, D], f32 scales [L, 2, H]) -> packed
    uint8 row of layout.block_bytes."""
    row = np.empty(layout.block_bytes, np.uint8)
    row[: layout.data_bytes] = (
        np.ascontiguousarray(q, np.int8).reshape(-1).view(np.uint8)
    )
    row[layout.data_bytes:] = (
        np.ascontiguousarray(scales, np.float32).reshape(-1).view(np.uint8)
    )
    return row


def unpack_block(
    row: np.ndarray, layout: KvLayoutConfig
) -> tuple[np.ndarray, np.ndarray]:
    """Packed uint8 row -> (int8 data [L, 2, bs, H, D], scales [L, 2, H])."""
    raw = np.asarray(row).reshape(-1).view(np.uint8)
    if raw.nbytes != layout.block_bytes:
        raise ValueError(
            f"packed block row is {raw.nbytes}B, expected "
            f"{layout.block_bytes}B for this layout"
        )
    q = raw[: layout.data_bytes].view(np.int8).reshape(
        layout.num_layers, 2, layout.page_size, layout.num_kv_heads,
        layout.head_dim,
    )
    scales = raw[layout.data_bytes:].view(np.float32).reshape(
        layout.num_layers, 2, layout.num_kv_heads
    )
    return q, scales


def quantize_block(data, layout: KvLayoutConfig) -> np.ndarray:
    """Quantize one block's full-precision bytes into a packed row
    (the quantize-on-offload path for a bf16-hot G1)."""
    vals = decode_values(data, layout)
    q, s = quantize_kv_block_host(
        vals, layout.num_kv_heads, layout.head_dim
    )
    return pack_block(q, s, layout)


def dequantize_block(row, layout: KvLayoutConfig) -> np.ndarray:
    """Packed row -> flat host bytes in the layout's compute dtype (the
    dequant-on-onboard path for a bf16-hot G1)."""
    q, s = unpack_block(row, layout)
    return encode_values(dequantize_kv_block_host(q, s), layout)


def is_packed_row(data, layout: KvLayoutConfig) -> bool:
    """Heuristic-free size check: quantized layouts move blocks ONLY as
    packed rows, whose byte length (data + sidecar) differs from every
    raw representation."""
    if layout.quant != "int8":
        return False
    return np.asarray(data).nbytes == layout.block_bytes
