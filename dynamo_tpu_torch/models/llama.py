"""Llama-family transformer over a paged KV cache (port of
dynamo_tpu/models/llama.py, dense GQA trunk).

Plain functions over a params dictionary with the reference's keys and
``[in, out]`` weight layout, so a JAX params tree carries over unchanged
through ``params_from_jax``. Every entry point (``unified``, ``prefill``,
``prefill_batch``, ``decode``) writes K/V into the caches IN PLACE —
PyTorch's counterpart of the reference's donated jit buffers — so it
returns only the logits (and, for an int8 cache, the new scales).
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from dynamo_tpu_torch import resolve_device
from dynamo_tpu_torch.models.config import ModelConfig
from dynamo_tpu_torch.ops.attention import full_causal_attention, ragged_attention
from dynamo_tpu_torch.ops.kernels.paged_decode_attention import (
    paged_decode_attention_cuda,
)
from dynamo_tpu_torch.ops.kernels.paged_prefill_attention import (
    paged_prefill_attention_cuda,
)
from dynamo_tpu_torch.ops.norms import rms_norm
from dynamo_tpu_torch.ops.quant import (
    embed_lookup,
    qdot,
    quantize_kv_write,
    tied_head_mm,
)
from dynamo_tpu_torch.ops.rope import rope_angles, rotate

Params = dict[str, Any]

LAYER_KEYS = (
    "wq", "wk", "wv", "wo", "ln_attn", "ln_mlp", "w_gate", "w_up", "w_down",
)


def check_supported(cfg: ModelConfig) -> None:
    missing = cfg.unsupported_features()
    if missing:
        raise NotImplementedError(
            f"{cfg.name}: {', '.join(missing)} not served by this slice of "
            "the port (dense GQA Llama trunk only)"
        )


def _dense_init(g: torch.Generator, shape, dtype, device) -> torch.Tensor:
    return (
        torch.randn(shape, generator=g, dtype=torch.float32, device=device)
        / (shape[0] ** 0.5)
    ).to(dtype)


def init_params(
    cfg: ModelConfig,
    generator: torch.Generator,
    dtype: torch.dtype = torch.bfloat16,
    device: torch.device | str | None = None,
) -> Params:
    """Random-init params with 1/sqrt(fan_in) scaling (the reference's
    law; the draws come from ``generator``, which must live on the
    target device, and differ from JAX's). ``device`` defaults to the
    card (``resolve_device``)."""
    check_supported(cfg)
    device = resolve_device(device)
    D, H, kvH, hd = cfg.hidden_size, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    I = cfg.intermediate_size
    g = generator

    def dense(shape):
        return _dense_init(g, shape, dtype, device)

    def ones(n):
        return torch.ones((n,), dtype=dtype, device=device)

    params: Params = {
        "embed": dense((cfg.vocab_size, D)),
        "layers": [
            {
                "wq": dense((D, H * hd)),
                "wk": dense((D, kvH * hd)),
                "wv": dense((D, kvH * hd)),
                "wo": dense((H * hd, D)),
                "ln_attn": ones(D),
                "ln_mlp": ones(D),
                "w_gate": dense((D, I)),
                "w_up": dense((D, I)),
                "w_down": dense((I, D)),
            }
            for _ in range(cfg.num_layers)
        ],
        "ln_f": ones(D),
    }
    if not cfg.tie_word_embeddings:
        params["lm_head"] = dense((D, cfg.vocab_size))
    return params


def _to_torch(arr, dtype, device) -> torch.Tensor:
    if isinstance(arr, dict):
        raise NotImplementedError(
            "quantized {'q','s'} weights arrive with the weight-quant "
            "slice of the port (ROADMAP queue A7)"
        )
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":
        # numpy has no native bfloat16: reinterpret the 16-bit payload.
        t = torch.from_numpy(np.array(arr).view(np.uint16))
        t = t.view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr))
    return t.to(device=device, dtype=dtype if dtype is not None else t.dtype)


def params_from_jax(
    tree: Params,
    dtype: torch.dtype | None = None,
    device: torch.device | str | None = None,
) -> Params:
    """The weight bridge: a reference params tree whose leaves are numpy
    arrays (``jax.tree.map(np.asarray, params)``) → the port's params, in
    ``dtype`` (default: each leaf's own) on ``device`` (default: the
    card, ``resolve_device``). The layout is shared, so this is a copy,
    not a re-layout."""
    device = resolve_device(device)
    out: Params = {
        "embed": _to_torch(tree["embed"], dtype, device),
        "ln_f": _to_torch(tree["ln_f"], dtype, device),
        "layers": [],
    }
    for layer in tree["layers"]:
        extra = set(layer) - set(LAYER_KEYS)
        if extra:
            raise NotImplementedError(
                f"layer weights {sorted(extra)} belong to model families "
                "this slice of the port does not serve"
            )
        out["layers"].append(
            {k: _to_torch(layer[k], dtype, device) for k in LAYER_KEYS}
        )
    if "lm_head" in tree:
        out["lm_head"] = _to_torch(tree["lm_head"], dtype, device)
    return out


def _embed(params: Params, token_ids: torch.Tensor) -> torch.Tensor:
    return embed_lookup(params["embed"], token_ids)


def _qkv(layer: Params, x: torch.Tensor, cfg: ModelConfig):
    T = x.shape[0]
    q = qdot(x, layer["wq"]).reshape(T, cfg.num_heads, cfg.head_dim)
    k = qdot(x, layer["wk"]).reshape(T, cfg.num_kv_heads, cfg.head_dim)
    v = qdot(x, layer["wv"]).reshape(T, cfg.num_kv_heads, cfg.head_dim)
    return q, k, v


def _swiglu(layer: Params, x: torch.Tensor) -> torch.Tensor:
    gate = F.silu(qdot(x, layer["w_gate"]))
    return qdot(gate * qdot(x, layer["w_up"]), layer["w_down"])


def _logits(params: Params, cfg: ModelConfig, h: torch.Tensor) -> torch.Tensor:
    h = rms_norm(h, params["ln_f"], cfg.rms_eps)
    if cfg.tie_word_embeddings:
        return tied_head_mm(h, params["embed"]).float()
    return qdot(h, params["lm_head"]).float()


def _layers(
    cfg: ModelConfig, params: Params, token_ids: torch.Tensor,
    positions: torch.Tensor, attend,
) -> torch.Tensor:
    """The decoder stack over flat rows: embed, then per layer RMSNorm,
    q/k/v, RoPE at ``positions``, ``attend(li, q, k, v) -> [rows, H, D]``
    (which writes the layer's cache first where there is one), ``wo``,
    SwiGLU. Returns the pre-final-norm hidden states [rows, D]."""
    check_supported(cfg)
    rows = token_ids.shape[0]
    cos, sin = rope_angles(positions, cfg.head_dim, cfg.rope_theta, cfg.rope_scaling)
    x = _embed(params, token_ids.long())
    for li, layer in enumerate(params["layers"]):
        h = rms_norm(x, layer["ln_attn"], cfg.rms_eps)
        q, k, v = _qkv(layer, h, cfg)
        q, k = rotate(q, cos, sin), rotate(k, cos, sin)
        attn = attend(li, q, k, v)
        x = x + qdot(attn.reshape(rows, -1), layer["wo"])
        x = x + _swiglu(layer, rms_norm(x, layer["ln_mlp"], cfg.rms_eps))
    return x


def _write_kv(cache: tuple[torch.Tensor, torch.Tensor], slots, k, v) -> None:
    """The plain K/V scatter, in place (the JAX package donates the
    cache buffers to its jitted programs instead)."""
    k_cache, v_cache = cache
    k_cache[slots] = k.to(k_cache.dtype)
    v_cache[slots] = v.to(v_cache.dtype)


def unified(
    cfg: ModelConfig,
    params: Params,
    kv_caches: list[tuple[torch.Tensor, torch.Tensor]],
    token_ids: torch.Tensor,     # [T] flat mixed batch (budget-padded)
    token_pos: torch.Tensor,     # [T] global position per token (-1 = pad)
    slot_mapping: torch.Tensor,  # [T] cache slots (trash slots for padding)
    token_seq: torch.Tensor,     # [T] owning metadata row per token
    block_tables: torch.Tensor,  # [S, max_blocks]
    q_start: torch.Tensor,       # [S] span prefix length
    q_len: torch.Tensor,         # [S] span rows (0 = idle row)
    kv_len: torch.Tensor,        # [S] context after this step
    row_start: torch.Tensor,     # [S] span's first flat row
    block_size: int,
    kv_scales: torch.Tensor | None = None,  # [L, 2, num_blocks, kvH] f32
    draft_len: torch.Tensor | None = None,  # [S] draft rows in each span tail
    verify_rows: int = 1,                   # logit rows per span (static)
):
    """ONE forward for a mixed prefill+decode token batch (the unified
    step): embed, RoPE at ``token_pos``, K/V scatter at ``slot_mapping``,
    ragged paged attention, MLP. Decode lanes are spans of length 1,
    prefill quanta their chunk's rows, a speculative draft-verify span
    ``q_len = draft_len + 1`` rows (the fed token plus its drafts).

    Returns per-span logits: ``verify_rows == 1`` gives ``[S, V]`` from
    each span's LAST row (mid-prompt quanta's samples are discarded by
    the engine). ``verify_rows = R > 1`` gives ``[S, R, V]``: row ``j``
    of span ``s`` is the logits at span row ``q_len - 1 - draft_len + j``
    clamped into the span — for a draft-verify span row 0 scores the
    first draft and row ``draft_len`` is the bonus position; shorter
    spans repeat their last row, and idle spans (``q_len = 0``) read row
    0 of the batch, both masked by the caller.

    With ``kv_scales`` (int8 caches) the K/V scatter goes through the
    write law (ops/quant.py ``quantize_kv_write``), attention dequantizes
    in the kernel or the plain version, and the return is
    ``(logits, new_scales [L, 2, num_blocks, kvH])``."""
    T = token_ids.shape[0]
    slots = slot_mapping.long()
    new_scales = []

    def attend(li, q, k, v):
        k_cache, v_cache = kv_caches[li]
        scale_kw = {}
        if kv_scales is None:
            _write_kv(kv_caches[li], slots, k, v)
        else:
            k_sc = quantize_kv_write(k_cache, kv_scales[li, 0], slots, k, block_size)
            v_sc = quantize_kv_write(v_cache, kv_scales[li, 1], slots, v, block_size)
            new_scales.append(torch.stack([k_sc, v_sc]))
            scale_kw = {"k_scales": k_sc, "v_scales": v_sc}
        return ragged_attention(
            q, k_cache, v_cache, block_tables, token_seq, token_pos,
            q_start, q_len, kv_len, row_start, block_size,
            window=cfg.layer_window(li), **scale_kw,
        )

    x = _layers(cfg, params, token_ids, torch.clamp(token_pos, min=0), attend)
    if verify_rows == 1:
        last = torch.clamp(row_start + q_len - 1, 0, T - 1).long()
        logits = _logits(params, cfg, x[last])
    else:
        dl = draft_len if draft_len is not None else torch.zeros_like(q_len)
        offs = torch.arange(verify_rows, device=q_len.device)
        span_row = torch.minimum(
            torch.clamp((q_len - 1 - dl)[:, None] + offs[None, :], min=0),
            torch.clamp(q_len - 1, min=0)[:, None],
        )                                                       # [S, R]
        rows = torch.clamp(row_start[:, None] + span_row, 0, T - 1).long()
        logits = _logits(params, cfg, x[rows])                  # [S, R, V]
    if kv_scales is not None:
        return logits, torch.stack(new_scales)
    return logits


def prefill_batch(
    cfg: ModelConfig,
    params: Params,
    kv_caches: list[tuple[torch.Tensor, torch.Tensor]],
    token_ids: torch.Tensor,     # [N, T] padded new tokens per lane
    block_tables: torch.Tensor,  # [N, max_blocks]
    slot_mapping: torch.Tensor,  # [N, T] (trash slots for padding/idle lanes)
    prefix_len: torch.Tensor,    # [N]
    total_len: torch.Tensor,     # [N] (0 = idle lane)
    block_size: int,
) -> torch.Tensor:
    """N sequences' prefills fused into one call: the projections and
    MLP run over all N*T rows, K/V scatter once, and the prefill kernel
    reads the shared cache through per-lane block tables. Returns
    last-token logits [N, V]."""
    N, T = token_ids.shape
    positions = prefix_len[:, None] + torch.arange(T, device=token_ids.device)
    slots = slot_mapping.reshape(N * T).long()

    def attend(li, q, k, v):
        _write_kv(kv_caches[li], slots, k, v)
        k_cache, v_cache = kv_caches[li]
        out = paged_prefill_attention_cuda(
            q.reshape(N, T, *q.shape[1:]), k_cache, v_cache, block_tables,
            prefix_len, total_len, block_size, window=cfg.layer_window(li),
        )
        return out.reshape(N * T, *q.shape[1:])

    x = _layers(cfg, params, token_ids.reshape(N * T), positions.reshape(N * T), attend)
    last = torch.clamp(total_len - prefix_len - 1, 0, T - 1).long()
    hs = x.reshape(N, T, -1)[torch.arange(N, device=x.device), last]
    return _logits(params, cfg, hs)


def prefill(
    cfg: ModelConfig,
    params: Params,
    kv_caches: list[tuple[torch.Tensor, torch.Tensor]],
    token_ids: torch.Tensor,     # [T] padded new tokens
    block_table: torch.Tensor,   # [max_blocks]
    slot_mapping: torch.Tensor,  # [T] cache slots (trash slots for padding)
    prefix_len: torch.Tensor,    # scalar — prefix-cache hit length
    total_len: torch.Tensor,     # scalar — prefix + real new tokens
    block_size: int,
) -> torch.Tensor:
    """Prefill one sequence's new tokens (the suffix after any
    prefix-cache hit); returns the last real token's logits [V]."""
    return prefill_batch(
        cfg, params, kv_caches, token_ids[None], block_table[None],
        slot_mapping[None], prefix_len.reshape(1), total_len.reshape(1),
        block_size,
    )[0]


def decode(
    cfg: ModelConfig,
    params: Params,
    kv_caches: list[tuple[torch.Tensor, torch.Tensor]],
    token_ids: torch.Tensor,     # [B]
    positions: torch.Tensor,     # [B] — context_len - 1 for active slots
    block_tables: torch.Tensor,  # [B, max_blocks]
    context_lens: torch.Tensor,  # [B] — 0 marks an inactive slot
    slot_mapping: torch.Tensor,  # [B] cache slots for the new token
    block_size: int,
) -> torch.Tensor:
    """One decode step for the whole running batch; returns logits
    [B, V]."""
    slots = slot_mapping.long()

    def attend(li, q, k, v):
        _write_kv(kv_caches[li], slots, k, v)
        k_cache, v_cache = kv_caches[li]
        return paged_decode_attention_cuda(
            q, k_cache, v_cache, block_tables, context_lens, block_size,
            window=cfg.layer_window(li),
        )

    return _logits(params, cfg, _layers(cfg, params, token_ids, positions, attend))


def hidden_states(
    cfg: ModelConfig, params: Params, token_ids: torch.Tensor
) -> torch.Tensor:
    """Full no-cache trunk [T] -> pre-final-norm hidden states [T, D]."""
    positions = torch.arange(token_ids.shape[0], device=token_ids.device)
    return _layers(
        cfg, params, token_ids, positions,
        lambda li, q, k, v: full_causal_attention(
            q, k, v, window=cfg.layer_window(li)
        ),
    )


def reference_forward(
    cfg: ModelConfig, params: Params, token_ids: torch.Tensor
) -> torch.Tensor:
    """Full no-cache forward [T] -> logits [T, V]; the correctness oracle
    the paged paths are tested against."""
    return _logits(params, cfg, hidden_states(cfg, params, token_ids))
