"""Attention over a paged KV cache — plain PyTorch versions (port of
dynamo_tpu/ops/attention.py) and the ragged dispatch.

The cache layout is the reference's contract: per layer,
``k_cache/v_cache: [num_slots, n_kv_heads, head_dim]`` with
``num_slots = num_blocks * block_size``; block ``b`` owns slots
``[b*block_size, (b+1)*block_size)``; block 0 is the trash block that
padding rows write to. Unlike the TPU package the port keeps the TRUE
head dim in the cache (no 128-lane padding), so the softmax scale is
``1/sqrt(head_dim)`` everywhere.

These functions are the plain versions the CUDA kernel
(ops/kernels/ragged_attention.py) is held against: the CPU runs them, and
``chip_smoke.py`` compares the kernel with them on the card.
"""

from __future__ import annotations

import torch

NEG_INF = -1e30


def _safe_div(acc: torch.Tensor, l: torch.Tensor) -> torch.Tensor:
    """acc / l, returning 0 where nothing was attended (fully masked)."""
    l = l[..., None]
    return torch.where(l > 0, acc / torch.clamp(l, min=1e-30), 0.0)


def _decode_partials(
    q, k_cache, v_cache, block_tables, context_lens, block_size: int,
    window: int = 0,
):
    """Online-softmax scan over each lane's pages (one query token per
    lane); returns the un-normalized (m, l, acc). With a sliding window
    each lane starts at its first in-window page and the trip count
    shrinks to ceil(window/bs)+1."""
    B, H, D = q.shape
    kvH = k_cache.shape[1]
    G = H // kvH
    scale = 1.0 / (D**0.5)
    qr = (q.float() * scale).reshape(B, kvH, G, D)
    max_blocks = block_tables.shape[1]
    if window:
        span = -(-window // block_size) + 1
        start = torch.clamp(context_lens - window, min=0) // block_size
    else:
        span = max_blocks
        start = torch.zeros_like(context_lens)
    nsteps = min(max_blocks, span)
    offs = torch.arange(block_size, device=q.device)

    m = torch.full((B, kvH, G), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, kvH, G), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, kvH, G, D), dtype=torch.float32, device=q.device)
    for j in range(nsteps):
        blk = start + j                                          # [B]
        entry = torch.gather(
            block_tables, 1, torch.clamp(blk, max=max_blocks - 1)[:, None]
        )[:, 0]
        slots = entry[:, None] * block_size + offs               # [B, bs]
        k = k_cache[slots].float()                               # [B, bs, kvH, D]
        v = v_cache[slots].float()
        scores = torch.einsum("bkgd,bskd->bkgs", qr, k)          # [B, kvH, G, bs]
        # Positions from the UNCLAMPED page index: a clamped over-the-end
        # gather lands at key_pos >= ctx and is masked.
        key_pos = blk[:, None] * block_size + offs
        mask = key_pos < context_lens[:, None]
        if window:
            mask = mask & (key_pos >= context_lens[:, None] - window)
        mask4 = mask[:, None, None, :]
        scores = torch.where(mask4, scores, NEG_INF)
        m_new = torch.maximum(m, scores.amax(dim=-1))
        corr = torch.exp(m - m_new)
        p = torch.where(mask4, torch.exp(scores - m_new[..., None]), 0.0)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bkgs,bskd->bkgd", p, v)
        m = m_new
    return m, l, acc


def paged_decode_attention(
    q: torch.Tensor,             # [B, n_heads, head_dim]
    k_cache: torch.Tensor,       # [num_slots, n_kv_heads, head_dim]
    v_cache: torch.Tensor,
    block_tables: torch.Tensor,  # [B, max_blocks] int32
    context_lens: torch.Tensor,  # [B] int32 — includes the current token
    block_size: int,
    window: int = 0,             # sliding-window size (0 = full causal)
) -> torch.Tensor:
    """One-token-per-sequence attention over each sequence's paged KV.
    Inactive batch slots (context_len == 0) return zeros."""
    B, H, D = q.shape
    _, l, acc = _decode_partials(
        q, k_cache, v_cache, block_tables.long(), context_lens.long(),
        block_size, window,
    )
    return _safe_div(acc, l).reshape(B, H, D).to(q.dtype)


def ragged_paged_attention(
    q: torch.Tensor,             # [T, H, D] — flat mixed prefill+decode batch
    k_cache: torch.Tensor,       # [num_slots, n_kv_heads, head_dim]
    v_cache: torch.Tensor,
    block_tables: torch.Tensor,  # [S, max_blocks] int32 — per-sequence rows
    token_seq: torch.Tensor,     # [T] int32 — owning sequence row per token
    token_pos: torch.Tensor,     # [T] int32 — global position (-1 = padding)
    block_size: int,
    window: int = 0,
) -> torch.Tensor:
    """Plain version of the ragged unified kernel. Every row is one token
    of some sequence; causality makes each token's visible context
    exactly ``token_pos + 1`` keys of its own sequence, so the mixed
    batch reduces to batched decode attention with per-token block
    tables. Padding rows carry ``token_pos = -1`` (context 0) and return
    zeros."""
    rows = torch.clamp(token_seq.long(), 0, block_tables.shape[0] - 1)
    tables = block_tables[rows]                                  # [T, max_blocks]
    ctx = torch.clamp(token_pos.long() + 1, min=0)
    return paged_decode_attention(
        q, k_cache, v_cache, tables, ctx, block_size, window
    )


def span_tokens(
    q_start: torch.Tensor, q_len: torch.Tensor, row_start: torch.Tensor,
    T: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Token-level view (token_seq, token_pos) of span-level metadata:
    row r belongs to the span s with ``row_start[s] <= r < row_start[s] +
    q_len[s]`` and sits at position ``q_start[s] + r - row_start[s]``;
    rows no span owns get position -1."""
    r = torch.arange(T, device=q_len.device)
    own = (
        (r[:, None] >= row_start[None, :])
        & (r[:, None] < (row_start + q_len)[None, :])
        & (q_len[None, :] > 0)
    )                                                            # [T, S]
    has = own.any(dim=1)
    seq = torch.argmax(own.to(torch.int32), dim=1)               # first owner
    pos = q_start[seq] + (r - row_start[seq])
    token_pos = torch.where(has, pos, -1).to(torch.int32)
    token_seq = torch.where(has, seq, 0).to(torch.int32)
    return token_seq, token_pos


def ragged_attention(
    q, k_cache, v_cache, block_tables, token_seq, token_pos, q_start,
    q_len, kv_len, row_start, block_size: int, window: int = 0,
):
    """The unified step's attention (the dispatch modelled on the
    reference's ``AttnDispatch.ragged``): the CUDA kernel for CUDA
    tensors, the plain version for CPU tensors. Span-level metadata
    drives the kernel, token-level metadata the plain version; the
    runner builds both views of the same batch together."""
    if q.is_cuda:
        from dynamo_tpu_torch.ops.kernels.ragged_attention import (
            ragged_paged_attention_cuda,
        )

        return ragged_paged_attention_cuda(
            q, k_cache, v_cache, block_tables, q_start, q_len, kv_len,
            row_start, block_size, window=window,
        )
    return ragged_paged_attention(
        q, k_cache, v_cache, block_tables, token_seq, token_pos,
        block_size, window,
    )


def full_causal_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, window: int = 0
) -> torch.Tensor:
    """Plain causal attention [T, H, D] x [T, kvH, D] — the no-cache
    reference path used to validate the paged implementations."""
    T, H, D = q.shape
    kvH = k.shape[1]
    G = H // kvH
    scale = 1.0 / (D**0.5)
    qr = (q.float() * scale).reshape(T, kvH, G, D)
    scores = torch.einsum("tkgd,skd->tkgs", qr, k.float())
    ar = torch.arange(T, device=q.device)
    mask = ar[None, :] <= ar[:, None]                            # [Tq, Tk]
    if window:
        mask = mask & (ar[None, :] > ar[:, None] - window)
    scores = torch.where(mask[:, None, None, :], scores, NEG_INF)
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("tkgs,skd->tkgd", p, v.float())
    return out.reshape(T, H, D).to(q.dtype)
