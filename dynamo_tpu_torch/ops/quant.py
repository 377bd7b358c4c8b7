"""Weight access sites and the int8 KV write law (port of
dynamo_tpu/ops/quant.py: the unquantized arms of
``qdot``/``qeinsum``/``embed_lookup``/``tied_head_mm``, the stacked
experts' products of dynamo_tpu/models/moe.py, and ``quantize_kv_write``).

Every matmul on the unified path goes through these functions, as
in the reference, so the weight-quantization slice (ROADMAP queue A7)
changes only this module. Until then a quantized ``{"q", "s"}`` weight
raises ``NotImplementedError``.
"""

from __future__ import annotations

import torch


def _plain(w):
    if isinstance(w, dict):
        raise NotImplementedError(
            "quantized {'q','s'} weights arrive with the weight-quant "
            "slice of the port (ROADMAP queue A7)"
        )
    return w


def qdot(x: torch.Tensor, w) -> torch.Tensor:
    """``x @ w`` with ``w`` in the reference's ``[in, out]`` layout."""
    return x @ _plain(w)


def qeinsum(pattern: str, x: torch.Tensor, w) -> torch.Tensor:
    """Einsum against a per-head weight (MLA's absorbed ``w_uk`` and
    ``w_uv``), in the weight's dtype."""
    return torch.einsum(pattern, x, _plain(w))


def _bmm_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` with operands of one dtype, float32 sums and output: on
    the card one cuBLAS batched product, so the stacked weights are never
    copied to float32; on the CPU the operands are widened first (the
    same products and sums)."""
    if w.dtype == torch.float32:
        return torch.bmm(x, w)
    if x.is_cuda:
        return torch.bmm(x, w, out_dtype=torch.float32)
    return torch.bmm(x.float(), w.float())


def expert_mm(x: torch.Tensor, w) -> torch.Tensor:
    """Stacked experts' products ``[E, N, in] @ [E, in, out]`` with a
    float32 output and the operands in ``w``'s dtype."""
    w = _plain(w)
    return _bmm_f32(x.to(w.dtype), w)


def expert_mm_f32(h: torch.Tensor, w) -> torch.Tensor:
    """Stacked experts' products with a float32 input kept in float32, as
    the reference's ``_expert_einsum`` widens the weights: on the CPU the
    weights are widened; on the card ``split_bmm``."""
    w = _plain(w)
    h = h.float()
    if w.dtype == torch.float32 or not h.is_cuda:
        return torch.bmm(h, w.float())
    return split_bmm(h, w)


def split_bmm(h: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """float32 ``h [E, N, in]`` against a low-precision ``w`` without
    widening ``w``: ``h`` splits into two terms of ``w``'s dtype, ``hi =
    h`` rounded and ``lo = h - hi`` rounded, stacked along the rows as
    ``[E, 2N, in]``, and one product with float32 sums gives both halves,
    which are added. The stacked weights are read once (a widened copy
    would cost 1.1 GB a deepseek-v2-lite layer); the rows' arithmetic
    doubles. ``hi + lo`` carries ``h`` to about 16 bits of mantissa."""
    hi = h.to(w.dtype)
    lo = (h - hi.float()).to(w.dtype)
    n = h.shape[1]
    out = _bmm_f32(torch.cat([hi, lo], dim=1), w)
    return out[:, :n] + out[:, n:]


def embed_lookup(embed, token_ids: torch.Tensor) -> torch.Tensor:
    """Embedding-table row gather."""
    return _plain(embed)[token_ids]


def tied_head_mm(h: torch.Tensor, embed) -> torch.Tensor:
    """``h @ embed.T`` (tied lm_head), float32 out (``head_mm``)."""
    return head_mm(h, _plain(embed).T)


def head_mm(h: torch.Tensor, w) -> torch.Tensor:
    """The LM head ``h @ w`` with its sums and its output in float32 and
    the operands in ``w``'s dtype. A bf16 output would round the logits
    to steps of 1/32 at magnitudes of 4–8, coarser than the differences
    greedy sampling and the no-cache reference check look at. On the card
    one cuBLAS product with a float32 output; on the CPU the operands
    are widened first (the same products and sums)."""
    w = _plain(w)
    lead = h.shape[:-1]
    h = h.reshape(-1, h.shape[-1]).to(w.dtype)
    if w.dtype == torch.float32:
        out = h @ w
    elif h.is_cuda:
        out = torch.mm(h, w, out_dtype=torch.float32)
    else:
        out = h.float() @ w.float()
    return out.reshape(*lead, -1)


# ---------------------------------------------------------------------------
# KV-cache block quantization (port of dynamo_tpu/ops/quant.py
# ``quantize_kv_write``). The cache keeps its [num_slots, kvH, D] layout
# but stores int8; a per-(block, kv head) float32 scale rides beside it
# (``kv_scales: [num_layers, 2, num_blocks, kvH]``). Reads dequantize
# ``int8 * scale`` — in the CUDA kernel's registers and in the plain
# version's gathered page, with the same arithmetic.
#
# Write law:
#   - a step's new K/V values scatter-max a per-(block, head) amax;
#   - a block whose FIRST slot is written this step is fresh: its stale
#     scale (from a previous tenant of the physical block) resets;
#   - within an occupancy the scale only grows,
#     new_scale = max(old_scale, amax / 127); where it grows, the block's
#     existing int8 entries requantize by round(q * old / new), touched
#     blocks only;
#   - new values quantize at the new scale: clip(round(v / s), -127, 127).
# ---------------------------------------------------------------------------


def quantize_kv_write(
    cache: torch.Tensor,    # [num_slots, kvH, D] int8, written IN PLACE
    scales: torch.Tensor,   # [num_blocks, kvH] float32
    slots: torch.Tensor,    # [T] target slot per new token
    vals: torch.Tensor,     # [T, kvH, D] new K or V values
    block_size: int,
) -> torch.Tensor:
    """Scatter new K/V values into an int8 cache under per-block scales;
    returns the new scales. Padding rows aimed at trash block 0 churn
    only block 0, which no attention reads. Duplicate touched blocks
    write identical requantized rows, so their order cannot matter; the
    padding rows' values at block 0 may land in any order on the card."""
    num_blocks, kvH = scales.shape
    bs = block_size
    dev = cache.device
    vf = vals.float()
    slots = slots.long()
    blk = slots // bs                                        # [T]

    amax = torch.zeros((num_blocks, kvH), dtype=torch.float32, device=dev)
    amax.scatter_reduce_(
        0, blk[:, None].expand(-1, kvH), vf.abs().amax(dim=-1), "amax",
        include_self=True,
    )
    fresh = torch.zeros(num_blocks, dtype=torch.int32, device=dev)
    fresh.scatter_reduce_(
        0, blk, (slots % bs == 0).to(torch.int32), "amax", include_self=True
    )
    old = torch.where(fresh[:, None] > 0, 0.0, scales)
    new_scales = torch.maximum(old, amax / 127.0)

    ratio = torch.where(
        new_scales > 0, old / torch.clamp(new_scales, min=1e-30), 1.0
    )
    tslots = (blk[:, None] * bs + torch.arange(bs, device=dev)).reshape(-1)
    rows = cache[tslots].float()                             # [T*bs, kvH, D]
    cache[tslots] = torch.clamp(
        torch.round(rows * ratio[blk].repeat_interleave(bs, dim=0)[:, :, None]),
        -127, 127,
    ).to(torch.int8)

    s_at = new_scales[blk]                                   # [T, kvH]
    q = torch.clamp(
        torch.round(vf / torch.clamp(s_at, min=1e-30)[:, :, None]), -127, 127
    ).to(torch.int8)
    cache[slots] = torch.where((s_at > 0)[:, :, None], q, 0).to(torch.int8)
    return new_scales
