"""Llama-family transformer over a paged KV cache (port of
dynamo_tpu/models/llama.py, dense GQA trunk).

Plain functions over a params dictionary with the reference's keys and
``[in, out]`` weight layout, so a JAX params tree carries over unchanged
through ``params_from_jax``. The unified step writes K/V into the caches
IN PLACE — PyTorch's counterpart of the reference's donated jit buffers —
so ``unified`` returns only the logits.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from dynamo_tpu_torch.models.config import ModelConfig
from dynamo_tpu_torch.ops.attention import full_causal_attention, ragged_attention
from dynamo_tpu_torch.ops.norms import rms_norm
from dynamo_tpu_torch.ops.quant import embed_lookup, qdot, tied_head_mm
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
    device: torch.device | str = "cpu",
) -> Params:
    """Random-init params with 1/sqrt(fan_in) scaling (the reference's
    law; the draws come from ``generator`` and differ from JAX's)."""
    check_supported(cfg)
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
    device: torch.device | str = "cpu",
) -> Params:
    """The weight bridge: a reference params tree whose leaves are numpy
    arrays (``jax.tree.map(np.asarray, params)``) → the port's params, in
    ``dtype`` (default: each leaf's own) on ``device``. The layout is
    shared, so this is a copy, not a re-layout."""
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
) -> torch.Tensor:
    """ONE forward for a mixed prefill+decode token batch (the unified
    step): embed, RoPE at ``token_pos``, K/V scatter at ``slot_mapping``,
    ragged paged attention, MLP. Decode lanes are spans of length 1,
    prefill quanta their chunk's rows. Writes K/V into ``kv_caches`` in
    place and returns per-span logits ``[S, V]`` from each span's LAST
    row (mid-prompt quanta's samples are discarded by the engine)."""
    check_supported(cfg)
    T = token_ids.shape[0]
    positions = torch.clamp(token_pos, min=0)
    slots = slot_mapping.long()
    cos, sin = rope_angles(positions, cfg.head_dim, cfg.rope_theta, cfg.rope_scaling)
    x = _embed(params, token_ids.long())
    for li, (layer, (k_cache, v_cache)) in enumerate(
        zip(params["layers"], kv_caches)
    ):
        h = rms_norm(x, layer["ln_attn"], cfg.rms_eps)
        q, k, v = _qkv(layer, h, cfg)
        q, k = rotate(q, cos, sin), rotate(k, cos, sin)
        # In place: the cache buffers are the engine's state (the JAX
        # package donates them to the jitted step instead).
        k_cache[slots] = k.to(k_cache.dtype)
        v_cache[slots] = v.to(v_cache.dtype)
        attn = ragged_attention(
            q, k_cache, v_cache, block_tables, token_seq, token_pos,
            q_start, q_len, kv_len, row_start, block_size,
            window=cfg.layer_window(li),
        )
        x = x + qdot(attn.reshape(T, -1), layer["wo"])
        x = x + _swiglu(layer, rms_norm(x, layer["ln_mlp"], cfg.rms_eps))
    last = torch.clamp(row_start + q_len - 1, 0, T - 1).long()
    return _logits(params, cfg, x[last])


def hidden_states(
    cfg: ModelConfig, params: Params, token_ids: torch.Tensor
) -> torch.Tensor:
    """Full no-cache trunk [T] -> pre-final-norm hidden states [T, D]."""
    check_supported(cfg)
    T = token_ids.shape[0]
    positions = torch.arange(T, device=token_ids.device)
    cos, sin = rope_angles(positions, cfg.head_dim, cfg.rope_theta, cfg.rope_scaling)
    x = _embed(params, token_ids.long())
    for li, layer in enumerate(params["layers"]):
        h = rms_norm(x, layer["ln_attn"], cfg.rms_eps)
        q, k, v = _qkv(layer, h, cfg)
        q, k = rotate(q, cos, sin), rotate(k, cos, sin)
        attn = full_causal_attention(q, k, v, window=cfg.layer_window(li))
        x = x + qdot(attn.reshape(T, -1), layer["wo"])
        x = x + _swiglu(layer, rms_norm(x, layer["ln_mlp"], cfg.rms_eps))
    return x


def reference_forward(
    cfg: ModelConfig, params: Params, token_ids: torch.Tensor
) -> torch.Tensor:
    """Full no-cache forward [T] -> logits [T, V]; the correctness oracle
    the paged unified path is tested against."""
    return _logits(params, cfg, hidden_states(cfg, params, token_ids))
