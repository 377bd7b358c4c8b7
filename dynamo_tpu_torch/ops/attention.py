"""Attention over a paged KV cache — plain PyTorch versions (port of
dynamo_tpu/ops/attention.py) and the unified step's dispatch to the
ragged CUDA kernel. The model calls the decode and prefill kernels'
wrappers (ops/kernels/) directly: each runs this module's plain version
for CPU tensors.

The cache layout is the reference's contract: per layer,
``k_cache/v_cache: [num_slots, n_kv_heads, head_dim]`` with
``num_slots = num_blocks * block_size``; block ``b`` owns slots
``[b*block_size, (b+1)*block_size)``; block 0 is the trash block that
padding rows write to. Unlike the TPU package the port keeps the TRUE
head dim in the cache (no 128-lane padding), so the softmax scale is
``1/sqrt(head_dim)`` everywhere. An int8 cache comes with per-(block,
kv head) float32 scales ``[num_blocks, kvH]`` and dequantizes as
``int8 * scale`` (ops/quant.py holds the write law).

These functions are the plain versions the CUDA kernels
(ops/kernels/) are held against: the CPU runs them, and
``chip_smoke.py`` compares each kernel with them on the card. The
decode and prefill versions take the signatures of the TPU kernels
(``paged_decode_attention_pallas`` / ``paged_prefill_attention_pallas``),
striped kv_sp scan and ``with_stats`` included.

Striped scan: with ``page_stride = sp > 1`` the block table is shard
r's LOCAL compacted stripe (``stripe_tables``): column j holds the local
page id of logical page ``page_offset + j * page_stride``, and key
positions come from that logical index. ``with_stats`` returns the
output in float32 with the online-softmax ``(m, l)`` per head, which
``merge_stats`` combines across shards.
"""

from __future__ import annotations

import torch

NEG_INF = -1e30


def _safe_div(acc: torch.Tensor, l: torch.Tensor) -> torch.Tensor:
    """acc / l, returning 0 where nothing was attended (fully masked)."""
    l = l[..., None]
    return torch.where(l > 0, acc / torch.clamp(l, min=1e-30), 0.0)


def _dequant_rows(vals, entry, scales):
    """Per-block dequant of gathered pages: ``vals`` [B, bs, kvH, D]
    float32 (cast from int8), ``entry`` [B] physical block ids,
    ``scales`` [num_blocks, kvH]: int8 * scale, nothing else."""
    return vals * scales[entry][:, None, :, None]


def _first_local_page(start, page_offset, page_stride: int):
    """First local stripe column at or after logical page ``start``:
    ceil((start - offset) / stride), at least 0."""
    return torch.clamp(
        (start - page_offset + page_stride - 1) // page_stride, min=0
    )


def _scan_steps(cols: int, span: int, page_stride: int) -> int:
    """Pages a scan visits: a window's ``span`` logical pages cover at
    most ceil(span / stride) (+1 for the stripe's alignment) columns."""
    return min(cols, -(-span // page_stride) + (1 if page_stride > 1 else 0))


def _offset(page_offset):
    """page_offset as the kernels take it ([1] int32 tensor) or an int."""
    if page_offset is None:
        return 0
    if isinstance(page_offset, torch.Tensor):
        return page_offset.reshape(()).long()
    return int(page_offset)


def _decode_partials(
    q, k_cache, v_cache, block_tables, context_lens, block_size: int,
    window: int = 0, page_offset=0, page_stride: int = 1,
    k_scales=None, v_scales=None,
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
    cols = block_tables.shape[1]
    if window:
        span = -(-window // block_size) + 1
        start = torch.clamp(context_lens - window, min=0) // block_size
    else:
        span = cols * page_stride
        start = torch.zeros_like(context_lens)
    first = _first_local_page(start, page_offset, page_stride)
    offs = torch.arange(block_size, device=q.device)

    m = torch.full((B, kvH, G), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, kvH, G), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, kvH, G, D), dtype=torch.float32, device=q.device)
    for j in range(_scan_steps(cols, span, page_stride)):
        col = first + j                                          # [B]
        entry = torch.gather(
            block_tables, 1, torch.clamp(col, max=cols - 1)[:, None]
        )[:, 0]
        slots = entry[:, None] * block_size + offs               # [B, bs]
        k = k_cache[slots].float()                               # [B, bs, kvH, D]
        v = v_cache[slots].float()
        if k_scales is not None:
            k = _dequant_rows(k, entry, k_scales)
            v = _dequant_rows(v, entry, v_scales)
        scores = torch.einsum("bkgd,bskd->bkgs", qr, k)          # [B, kvH, G, bs]
        # Positions from the UNCLAMPED logical page; a clamped
        # over-the-end gather is masked, so a slice of the table's
        # columns (a split of the CUDA kernel) sees only its own pages.
        key_pos = (page_offset + col * page_stride)[:, None] * block_size + offs
        mask = (key_pos < context_lens[:, None]) & (col < cols)[:, None]
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


def _finish(m, l, acc, shape, dtype, with_stats: bool):
    """Normalize partials to the kernels' outputs: ``shape`` in q's
    dtype, or (float32 out, m, l) with stats."""
    out = _safe_div(acc, l).reshape(shape)
    if with_stats:
        return out, m.reshape(shape[:-1]), l.reshape(shape[:-1])
    return out.to(dtype)


def paged_decode_attention(
    q: torch.Tensor,             # [B, n_heads, head_dim]
    k_cache: torch.Tensor,       # [num_slots, n_kv_heads, head_dim]
    v_cache: torch.Tensor,
    block_tables: torch.Tensor,  # [B, max_blocks] int32 (LOCAL stripe when strided)
    context_lens: torch.Tensor,  # [B] int32 — includes the current token
    block_size: int,
    window: int = 0,             # sliding-window size (0 = full causal)
    page_offset=None,            # [1] int32 (or int) — shard's page residue
    page_stride: int = 1,
    with_stats: bool = False,
    k_scales: torch.Tensor | None = None,  # [num_blocks, kvH] (int8 cache)
    v_scales: torch.Tensor | None = None,
):
    """One-token-per-sequence attention over each sequence's paged KV.
    Inactive batch slots (context_len == 0) return zeros (and m = NEG_INF,
    l = 0 with stats). Returns ``[B, H, D]`` in q's dtype, or with
    ``with_stats`` (out float32, m [B, H], l [B, H])."""
    m, l, acc = _decode_partials(
        q, k_cache, v_cache, block_tables.long(), context_lens.long(),
        block_size, window, _offset(page_offset), page_stride,
        k_scales, v_scales,
    )
    return _finish(m, l, acc, q.shape, q.dtype, with_stats)


def _prefill_partials(
    q, k_cache, v_cache, block_tables, q_start, total_len, block_size: int,
    window: int = 0, page_offset=0, page_stride: int = 1,
):
    """Online-softmax scan core of batched prefill attention, all lanes
    at once (the reference vmaps it per lane): q [N, T, H, D], row t of
    lane n at position q_start[n] + t attends to keys at positions
    <= its own and < total_len[n]. A padded row (position >=
    total_len) therefore sees every key of its lane, as in the kernel;
    an idle lane (total_len 0) sees none. Returns un-normalized
    (m, l, acc)."""
    N, T, H, D = q.shape
    kvH = k_cache.shape[1]
    G = H // kvH
    scale = 1.0 / (D**0.5)
    dev = q.device
    qr = (q.float() * scale).reshape(N, T, kvH, G, D)
    q_pos = q_start[:, None] + torch.arange(T, device=dev)      # [N, T]
    cols = block_tables.shape[1]
    if window:
        # Pages wholly before the earliest key any row can see are skipped.
        start = torch.clamp(q_start - window + 1, min=0) // block_size
        span = -(-(T + window) // block_size) + 1
    else:
        start = torch.zeros_like(q_start)
        span = cols * page_stride
    first = _first_local_page(start, page_offset, page_stride)
    offs = torch.arange(block_size, device=dev)

    m = torch.full((N, T, kvH, G), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((N, T, kvH, G), dtype=torch.float32, device=dev)
    acc = torch.zeros((N, T, kvH, G, D), dtype=torch.float32, device=dev)
    for j in range(_scan_steps(cols, span, page_stride)):
        col = first + j                                          # [N]
        entry = torch.gather(
            block_tables, 1, torch.clamp(col, max=cols - 1)[:, None]
        )[:, 0]
        slots = entry[:, None] * block_size + offs               # [N, bs]
        k = k_cache[slots].float()                               # [N, bs, kvH, D]
        v = v_cache[slots].float()
        scores = torch.einsum("ntkgd,nskd->ntkgs", qr, k)        # [N, T, kvH, G, bs]
        key_pos = (page_offset + col * page_stride)[:, None] * block_size + offs
        kp = key_pos[:, None, :]                                 # [N, 1, bs]
        mask = (kp <= q_pos[:, :, None]) & (kp < total_len[:, None, None])
        if window:
            mask = mask & (kp > q_pos[:, :, None] - window)
        mask5 = mask[:, :, None, None, :]
        scores = torch.where(mask5, scores, NEG_INF)
        m_new = torch.maximum(m, scores.amax(dim=-1))
        corr = torch.exp(m - m_new)
        p = torch.where(mask5, torch.exp(scores - m_new[..., None]), 0.0)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum("ntkgs,nskd->ntkgd", p, v)
        m = m_new
    return m, l, acc


def paged_prefill_attention(
    q: torch.Tensor,             # [N, T, H, D] — new tokens' queries per lane
    k_cache: torch.Tensor,       # [num_slots, kvH, D]
    v_cache: torch.Tensor,
    block_tables: torch.Tensor,  # [N, max_blocks] int32 (LOCAL stripe when strided)
    q_start: torch.Tensor,       # [N] — prefix length per lane
    total_len: torch.Tensor,     # [N] — prefix + real new tokens (0 = idle)
    block_size: int,
    q_tile: int = 64,
    window: int = 0,
    page_offset=None,            # [1] int32 (or int) — shard's page residue
    page_stride: int = 1,
    with_stats: bool = False,
):
    """Causal attention of N lanes' new tokens over their prefix and
    themselves, ``q_tile`` rows at a time (the tile bounds the scan's
    memory; it does not change the result). Assumes the new tokens' K/V
    are already in the cache. Returns ``[N, T, H, D]`` in q's dtype, or
    with ``with_stats`` (out float32, m [N, T, H], l [N, T, H])."""
    if q_tile < 1:
        raise ValueError("q_tile must be >= 1")
    off = _offset(page_offset)
    tables, q_start, total_len = (
        block_tables.long(), q_start.long(), total_len.long()
    )
    parts = [
        _prefill_partials(
            q[:, t0:t0 + q_tile], k_cache, v_cache, tables, q_start + t0,
            total_len, block_size, window, off, page_stride,
        )
        for t0 in range(0, q.shape[1], q_tile)
    ]
    m, l, acc = (torch.cat(x, dim=1) for x in zip(*parts))
    return _finish(m, l, acc, q.shape, q.dtype, with_stats)


def stripe_tables(
    block_tables: torch.Tensor, shard: int, num_shards: int, local_blocks: int
) -> torch.Tensor:
    """Shard ``shard``'s stripe of the block tables, localized (the math
    of the reference's ``AttnDispatch._stripe_tables`` for one shard):
    column j holds the LOCAL page id of logical page shard + j·num_shards.
    The striped allocator places logical block i on shard i % num_shards,
    whose blocks are [shard·local_blocks, (shard+1)·local_blocks); entries
    outside the shard (table padding) clip into range and their key
    positions mask out."""
    max_blocks = block_tables.shape[-1]
    cols = torch.clamp(
        shard + torch.arange(-(-max_blocks // num_shards),
                             device=block_tables.device) * num_shards,
        max=max_blocks - 1,
    )
    local = block_tables[..., cols] - shard * local_blocks
    return torch.clamp(local, 0, local_blocks - 1).to(block_tables.dtype)


def merge_stats(parts) -> torch.Tensor:
    """Merge per-shard NORMALIZED outputs with their logsumexp stats
    [(out, m, l), ...] (the math of the reference's
    ``AttnDispatch._stats_merge``): out_r = acc_r / l_r, so
    acc = Σ out_r·l_r·e^(m_r−m) and l = Σ l_r·e^(m_r−m). Empty shards
    (l = 0) weigh 0. Returns float32."""
    m_g = torch.stack([m for _, m, _ in parts]).amax(dim=0)
    o = l_g = 0.0
    for out, m, l in parts:
        w = torch.exp(m - m_g) * l
        l_g = l_g + w
        o = o + out.float() * w[..., None]
    return _safe_div(o, l_g)


def ragged_paged_attention(
    q: torch.Tensor,             # [T, H, D] — flat mixed prefill+decode batch
    k_cache: torch.Tensor,       # [num_slots, n_kv_heads, head_dim]
    v_cache: torch.Tensor,
    block_tables: torch.Tensor,  # [S, max_blocks] int32 — per-sequence rows
    token_seq: torch.Tensor,     # [T] int32 — owning sequence row per token
    token_pos: torch.Tensor,     # [T] int32 — global position (-1 = padding)
    block_size: int,
    window: int = 0,
    k_scales: torch.Tensor | None = None,  # [num_blocks, kvH] (int8 cache)
    v_scales: torch.Tensor | None = None,
) -> torch.Tensor:
    """Plain version of the ragged unified kernel. Every row is one token
    of some sequence; causality makes each token's visible context
    exactly ``token_pos + 1`` keys of its own sequence, so the mixed
    batch reduces to batched decode attention with per-token block
    tables. Padding rows carry ``token_pos = -1`` (context 0) and return
    zeros. With ``k_scales``/``v_scales`` the caches are int8."""
    rows = torch.clamp(token_seq.long(), 0, block_tables.shape[0] - 1)
    tables = block_tables[rows]                                  # [T, max_blocks]
    ctx = torch.clamp(token_pos.long() + 1, min=0)
    return paged_decode_attention(
        q, k_cache, v_cache, tables, ctx, block_size, window,
        k_scales=k_scales, v_scales=v_scales,
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


# -- dispatch (the reference's AttnDispatch, without a mesh) -----------------
def ragged_attention(
    q, k_cache, v_cache, block_tables, token_seq, token_pos, q_start,
    q_len, kv_len, row_start, block_size: int, window: int = 0,
    k_scales=None, v_scales=None,
):
    """The unified step's attention (``AttnDispatch.ragged``): the CUDA
    kernel for CUDA tensors, the plain version for CPU tensors. Span-level
    metadata drives the kernel, token-level metadata the plain version;
    the runner builds both views of the same batch together."""
    if q.is_cuda:
        from dynamo_tpu_torch.ops.kernels.ragged_attention import (
            ragged_paged_attention_cuda,
        )

        return ragged_paged_attention_cuda(
            q, k_cache, v_cache, block_tables, q_start, q_len, kv_len,
            row_start, block_size, window=window, k_scales=k_scales,
            v_scales=v_scales,
        )
    return ragged_paged_attention(
        q, k_cache, v_cache, block_tables, token_seq, token_pos,
        block_size, window, k_scales=k_scales, v_scales=v_scales,
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
