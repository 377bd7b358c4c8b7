"""Llama-family transformer over a paged KV cache (port of
dynamo_tpu/models/llama.py: Llama, Qwen2's qkv bias, Qwen3's QK-norm,
Mistral's sliding window, Gemma-3's GeGLU, (1+w) and sandwich norms,
scaled embeddings, local/global windows with a local rope base and the
query scale fold; DeepSeek's MLA with the absorbed latent attention and
yarn rope; routed experts (Mixtral, DeepSeekMoE with shared experts and
dense leading layers, models/moe.py)).

Plain functions over a params dictionary with the reference's keys and
``[in, out]`` weight layout, so a JAX params tree carries over unchanged
through ``params_from_jax``. Every entry point (``unified``, ``prefill``,
``prefill_batch``, ``decode``) writes K/V into the caches IN PLACE —
PyTorch's counterpart of the reference's donated jit buffers — so it
returns only the logits (and, for an int8 cache, the new scales).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from dynamo_tpu_torch import resolve_device
from dynamo_tpu_torch.models.config import ModelConfig
from dynamo_tpu_torch.models.moe import MoeConfig, moe_mlp
from dynamo_tpu_torch.ops.attention import full_causal_attention, ragged_attention
from dynamo_tpu_torch.ops.kernels.paged_decode_attention import (
    paged_decode_attention_cuda,
)
from dynamo_tpu_torch.ops.kernels.paged_prefill_attention import (
    paged_prefill_attention_cuda,
)
from dynamo_tpu_torch.ops.norms import rms_norm
from dynamo_tpu_torch.ops.quant import (
    WEIGHT_FORMATS,
    embed_lookup,
    head_mm,
    policy_layer_fmts,
    policy_top_fmts,
    qdot,
    qeinsum,
    quantize_kv_write,
    quantize_layer,
    quantize_weight,
    tied_head_mm,
    weight_dtype,
)
from dynamo_tpu_torch.ops.rope import rope_tables, rotate

Params = dict[str, Any]


@dataclasses.dataclass(frozen=True)
class WeightQuantPolicy:
    """Per-matmul weight-quantization policy (docs/architecture/
    weight_quant.md): each site — the embedding gather, the attention
    projections (q/k/v/o and MLA's ladder), the gated MLP's and the
    experts' matrices, and the unembed head — selects None (the model's
    dtype) or a storage format of ops/quant.py WEIGHT_FORMATS.

    The policy is value-level: quantized sites hold ``{"q", "s"}`` dicts
    in the params tree and every matmul dispatches on the value
    (ops/quant.py), so the step body, and the CUDA graphs captured from
    it, are the same set with or without a policy."""

    embedding: str | None = None
    attn: str | None = None
    mlp: str | None = None
    unembed: str | None = None

    SITES = ("embedding", "attn", "mlp", "unembed")

    @classmethod
    def from_string(cls, spec: str | None) -> "WeightQuantPolicy":
        """Parse an EngineConfig.weight_quant / ``--weight-quant`` spec: a
        bare format ("int8", "fp8") selects every site; a comma list of
        ``site=fmt`` pairs ("attn=int8,mlp=fp8") selects per site.
        None/"" is the all-off policy."""
        if not spec:
            return cls()
        spec = spec.strip()
        if "=" not in spec:
            if spec not in WEIGHT_FORMATS:
                raise ValueError(
                    f"weight_quant format {spec!r} not in {WEIGHT_FORMATS}"
                )
            return cls(embedding=spec, attn=spec, mlp=spec, unembed=spec)
        kw: dict[str, str] = {}
        for part in spec.split(","):
            part = part.strip()
            if not part:
                continue
            site, _, fmt = part.partition("=")
            site, fmt = site.strip(), fmt.strip()
            if site not in cls.SITES:
                raise ValueError(
                    f"weight_quant site {site!r} not in {cls.SITES}"
                )
            if fmt not in WEIGHT_FORMATS:
                raise ValueError(
                    f"weight_quant format {fmt!r} not in {WEIGHT_FORMATS}"
                )
            kw[site] = fmt
        return cls(**kw)

    @property
    def active(self) -> bool:
        return any(getattr(self, s) for s in self.SITES)

    def describe(self) -> str:
        """Canonical spec string (compile-cache fingerprint, gauges)."""
        if not self.active:
            return "off"
        return ",".join(
            f"{s}={getattr(self, s)}" for s in self.SITES if getattr(self, s)
        )


# The legacy whole-model ``--quant int8`` as a policy: every matmul site,
# the table per row only when tied (it is the head's operand); the
# reference's init_params_int8 / quantize_params.
LEGACY_INT8 = WeightQuantPolicy(attn="int8", mlp="int8", unembed="int8")

LAYER_KEYS = (
    "wq", "wk", "wv", "wo", "ln_attn", "ln_mlp", "w_gate", "w_up", "w_down",
)
# The families' optional layer weights: Gemma's sandwich norms, Qwen2's
# qkv bias, the per-head QK-norm gains.
OPTIONAL_LAYER_KEYS = (
    "ln_post_attn", "ln_post_mlp", "bq", "bk", "bv", "ln_q_head", "ln_k_head",
)
# MLA's projections and norms (its layers have no wk/wv, and wq only
# without q-lora); a MoE layer's router, the sigmoid router's selection
# bias and the shared experts (its w_gate/w_up/w_down are stacked).
MLA_KEYS = ("w_dkv", "ln_kv", "w_uk", "w_uv", "w_dq", "ln_q", "w_uq")
MOE_KEYS = ("w_router", "router_bias", "w_shared_gate", "w_shared_up", "w_shared_down")
ALL_LAYER_KEYS = LAYER_KEYS + OPTIONAL_LAYER_KEYS + MLA_KEYS + MOE_KEYS
# Kept in float32 whatever the weights' dtype, as the reference keeps it.
FLOAT32_KEYS = ("router_bias",)


def _dense_init(g: torch.Generator, shape, dtype, device, fan_in=None) -> torch.Tensor:
    # Scaled in place: one float32 copy of the weight at a time.
    t = torch.randn(shape, generator=g, dtype=torch.float32, device=device)
    t /= (fan_in or shape[0]) ** 0.5
    return t.to(dtype)


def init_params(
    cfg: ModelConfig,
    generator: torch.Generator,
    dtype: torch.dtype = torch.bfloat16,
    device: torch.device | str | None = None,
    policy: WeightQuantPolicy | None = None,
) -> Params:
    """Random-init params with 1/sqrt(fan_in) scaling (the reference's
    law, ``init_layer_params`` layer by layer, with its key set: norms
    start at identity, zeros for Gemma's (1+w) norms, qkv biases and the
    sigmoid router's bias at zero; the draws come from ``generator``,
    which must live on the target device, and differ from JAX's). Each
    tensor is drawn on the device in float32 and cast there, so a model
    near the card's size never has a float32 copy of more than one
    weight. ``device`` defaults to the card (``resolve_device``).

    With a ``policy`` each selected weight quantizes as soon as it is
    drawn (the table and head) or its layer is (the layers), so the
    full-precision transient never exceeds a layer or the table: the
    counterpart of the reference's ``init_params_policy``. The draws are
    the same, so the result equals ``quantize_params_policy`` of the
    unquantized init."""
    # The meta device gives the tree's shapes and dtypes with no storage
    # (EngineConfig's one-card check of a quantized tree).
    device = torch.device("meta") if str(device) == "meta" else resolve_device(device)
    fmts = policy_layer_fmts(policy) if policy is not None else {}
    embed_fmt, unembed_fmt = (
        policy_top_fmts(policy, cfg.tie_word_embeddings) if policy is not None else (None, None)
    )
    D, H, kvH, hd = cfg.hidden_size, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    I = cfg.intermediate_size
    g = generator

    def dense(shape, fan_in=None):
        return _dense_init(g, shape, dtype, device, fan_in)

    def norm(n):
        fill = torch.zeros if cfg.norm_offset else torch.ones
        return fill((n,), dtype=dtype, device=device)

    def zeros(n, dt=dtype):
        return torch.zeros((n,), dtype=dt, device=device)

    def attention():
        if not cfg.is_mla:
            return {"wq": dense((D, H * hd)), "wk": dense((D, kvH * hd)),
                    "wv": dense((D, kvH * hd)), "wo": dense((H * hd, D))}
        # MLA: the latent KV down-projection with the decoupled rope
        # dims, the per-head up-projections absorbed at run time.
        dn, dr, dc = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.kv_lora_rank
        p = {
            "w_dkv": dense((D, dc + dr)),
            "ln_kv": torch.ones((dc,), dtype=dtype, device=device),
            "w_uk": dense((H, dn, dc), dn),
            "w_uv": dense((H, cfg.v_head_dim, dc), dc),
            "wo": dense((H * cfg.v_head_dim, D)),
        }
        if cfg.q_lora_rank:
            p["w_dq"] = dense((D, cfg.q_lora_rank))
            p["ln_q"] = torch.ones((cfg.q_lora_rank,), dtype=dtype, device=device)
            p["w_uq"] = dense((cfg.q_lora_rank, H * (dn + dr)))
        else:
            p["wq"] = dense((D, H * (dn + dr)))
        return p

    def mlp(li):
        if not cfg.moe_layer(li):
            return {"w_gate": dense((D, I)), "w_up": dense((D, I)),
                    "w_down": dense((I, D))}
        E, Im = cfg.num_experts, cfg.moe_intermediate_size or I
        p = {"w_router": dense((D, E))}
        if cfg.gating == "sigmoid":
            p["router_bias"] = zeros(E, torch.float32)
        p["w_gate"] = dense((E, D, Im), D)
        p["w_up"] = dense((E, D, Im), D)
        p["w_down"] = dense((E, Im, D), Im)
        if cfg.n_shared_experts:
            Is = Im * cfg.n_shared_experts
            p.update(w_shared_gate=dense((D, Is)), w_shared_up=dense((D, Is)),
                     w_shared_down=dense((Is, D)))
        return p

    def layer(li):
        p = {**attention(), "ln_attn": norm(D), "ln_mlp": norm(D)}
        if cfg.post_norms:
            p["ln_post_attn"] = norm(D)
            p["ln_post_mlp"] = norm(D)
        p.update(mlp(li))
        if cfg.qkv_bias:
            p.update(bq=zeros(H * hd), bk=zeros(kvH * hd), bv=zeros(kvH * hd))
        if cfg.qk_norm:
            p.update(ln_q_head=norm(hd), ln_k_head=norm(hd))
        return p

    embed = dense((cfg.vocab_size, D))
    if embed_fmt:
        embed = quantize_weight(embed, axis=-1, fmt=embed_fmt)
    params: Params = {
        "embed": embed,
        "layers": [quantize_layer(layer(li), fmts) for li in range(cfg.num_layers)],
        "ln_f": norm(D),
    }
    if not cfg.tie_word_embeddings:
        head = dense((D, cfg.vocab_size))
        params["lm_head"] = quantize_weight(head, fmt=unembed_fmt) if unembed_fmt else head
    return params


def _to_torch(arr, dtype, device):
    """One leaf: an array in ``dtype`` (None: its own), or a quantized
    ``{"q", "s"}`` dict whose ``q`` keeps its storage dtype and whose
    scales take ``dtype``."""
    if isinstance(arr, dict):
        if set(arr) != {"q", "s"}:
            raise ValueError(f"a quantized leaf has keys q and s, not {sorted(arr)}")
        return {"q": _to_torch(arr["q"], None, device), "s": _to_torch(arr["s"], dtype, device)}
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":
        # numpy has no native bfloat16: reinterpret the 16-bit payload.
        t = torch.from_numpy(np.array(arr).view(np.uint16))
        t = t.view(torch.bfloat16)
    elif arr.dtype.name == "float8_e4m3fn":
        # ml_dtypes' e4m3 through its byte payload.
        t = torch.from_numpy(np.array(arr).view(np.uint8)).view(torch.float8_e4m3fn)
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
        extra = set(layer) - set(ALL_LAYER_KEYS)
        if extra:
            raise NotImplementedError(
                f"layer weights {sorted(extra)} are not part of any model "
                "family the port serves"
            )
        out["layers"].append({
            k: _to_torch(layer[k], torch.float32 if k in FLOAT32_KEYS else dtype, device)
            for k in ALL_LAYER_KEYS if k in layer
        })
    if "lm_head" in tree:
        out["lm_head"] = _to_torch(tree["lm_head"], dtype, device)
    return out


def load_hf_weights(
    cfg: ModelConfig,
    model_dir: str,
    dtype: torch.dtype | str = torch.bfloat16,
    device: torch.device | str | None = None,
    policy=None,
) -> Params:
    """The params of an HF checkout's safetensors shards (read by
    utils/safetensors.py), in the layout ``params_from_jax`` gives: torch
    ``[out, in]`` weights transposed to ``[in, out]``. Each tensor moves
    to ``device`` (default: the card) as it is read and is transposed and
    cast there, so the host holds one tensor at a time. MLA's
    ``kv_b_proj`` splits into the absorbed ``w_uk``/``w_uv``, with the
    checkpoint's pair-interleaved rope dims permuted to halves in the
    ``q_pe`` columns and ``k_pe`` rows; routed experts (Mixtral's
    ``block_sparse_moe`` or DeepSeek's ``mlp.experts``) stack over the
    expert axis.

    With a ``policy`` (WeightQuantPolicy) each selected weight quantizes
    as its layer loads, so the full-precision tree never sits whole on
    the device (the reference's ``load_hf_weights(policy=)``)."""
    from dynamo_tpu_torch.utils.safetensors import Checkpoint

    device = resolve_device(device)
    if isinstance(dtype, str):
        dtype = getattr(torch, dtype)
    with Checkpoint(model_dir) as ckpt:
        return _load_hf(cfg, ckpt, dtype, device, policy)


def _load_hf(cfg: ModelConfig, ckpt, dtype: torch.dtype, device: torch.device,
             policy=None) -> Params:
    fmts = policy_layer_fmts(policy) if policy is not None else {}
    embed_fmt, unembed_fmt = (
        policy_top_fmts(policy, cfg.tie_word_embeddings) if policy is not None else (None, None)
    )

    def raw(name: str) -> torch.Tensor:
        return ckpt.get(name, device)

    def w(name: str, transpose: bool = True, dt: torch.dtype | None = None) -> torch.Tensor:
        t = raw(name)
        if transpose and t.ndim == 2:
            t = t.t()
        return t.to(dt or dtype).contiguous()

    layers = []
    for i in range(cfg.num_layers):
        p = f"model.layers.{i}"
        if cfg.is_mla:
            dn, dr, dc = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.kv_lora_rank
            H, dv = cfg.num_heads, cfg.v_head_dim
            # Interleaved rope pairs -> [evens ‖ odds] (the NeoX halves
            # ops/rope.py rotates).
            perm = torch.cat([torch.arange(0, dr, 2), torch.arange(1, dr, 2)]).to(device)

            def permute_q(t):  # [in, H*(dn+dr)], already transposed
                qr = t.reshape(t.shape[0], H, dn + dr)
                pe = qr[..., dn:].index_select(-1, perm)
                return torch.cat([qr[..., :dn], pe], dim=-1).reshape(t.shape[0], -1)

            kvb = raw(f"{p}.self_attn.kv_b_proj.weight").reshape(H, dn + dv, dc)
            dkv = raw(f"{p}.self_attn.kv_a_proj_with_mqa.weight").t()
            dkv = torch.cat([dkv[:, :dc], dkv[:, dc:].index_select(1, perm)], dim=1)
            layer = {
                "w_dkv": dkv.to(dtype).contiguous(),
                "ln_kv": w(f"{p}.self_attn.kv_a_layernorm.weight", transpose=False),
                "w_uk": kvb[:, :dn, :].to(dtype).contiguous(),
                "w_uv": kvb[:, dn:, :].to(dtype).contiguous(),
                "wo": w(f"{p}.self_attn.o_proj.weight"),
                "ln_attn": w(f"{p}.input_layernorm.weight", transpose=False),
                "ln_mlp": w(f"{p}.post_attention_layernorm.weight", transpose=False),
            }
            del kvb, dkv
            if cfg.q_lora_rank:
                layer["w_dq"] = w(f"{p}.self_attn.q_a_proj.weight")
                layer["ln_q"] = w(f"{p}.self_attn.q_a_layernorm.weight", transpose=False)
                layer["w_uq"] = permute_q(w(f"{p}.self_attn.q_b_proj.weight")).contiguous()
            else:
                layer["wq"] = permute_q(w(f"{p}.self_attn.q_proj.weight")).contiguous()
        else:
            layer = {
                "wq": w(f"{p}.self_attn.q_proj.weight"),
                "wk": w(f"{p}.self_attn.k_proj.weight"),
                "wv": w(f"{p}.self_attn.v_proj.weight"),
                "wo": w(f"{p}.self_attn.o_proj.weight"),
                "ln_attn": w(f"{p}.input_layernorm.weight", transpose=False),
            }
            if cfg.post_norms:
                # Gemma-3's sandwich norms: HF's post_attention_layernorm
                # is the post-attention branch norm, the MLP's pre-norm is
                # pre_feedforward_layernorm.
                layer["ln_post_attn"] = w(f"{p}.post_attention_layernorm.weight",
                                          transpose=False)
                layer["ln_mlp"] = w(f"{p}.pre_feedforward_layernorm.weight", transpose=False)
                layer["ln_post_mlp"] = w(f"{p}.post_feedforward_layernorm.weight",
                                         transpose=False)
            else:
                layer["ln_mlp"] = w(f"{p}.post_attention_layernorm.weight", transpose=False)
        if cfg.moe_layer(i):
            if f"{p}.block_sparse_moe.gate.weight" in ckpt:
                m = f"{p}.block_sparse_moe"
                enames = ("w1.weight", "w3.weight", "w2.weight")
            else:
                m = f"{p}.mlp"
                enames = ("gate_proj.weight", "up_proj.weight", "down_proj.weight")
            layer["w_router"] = w(f"{m}.gate.weight")
            if cfg.gating == "sigmoid":
                bias = f"{m}.gate.e_score_correction_bias"
                layer["router_bias"] = (
                    w(bias, transpose=False, dt=torch.float32) if bias in ckpt
                    else torch.zeros((cfg.num_experts,), dtype=torch.float32, device=device)
                )
            for key, ename in zip(("w_gate", "w_up", "w_down"), enames):
                layer[key] = torch.stack(
                    [w(f"{m}.experts.{e}.{ename}") for e in range(cfg.num_experts)]
                )
            if cfg.n_shared_experts:
                layer["w_shared_gate"] = w(f"{m}.shared_experts.gate_proj.weight")
                layer["w_shared_up"] = w(f"{m}.shared_experts.up_proj.weight")
                layer["w_shared_down"] = w(f"{m}.shared_experts.down_proj.weight")
        else:
            layer["w_gate"] = w(f"{p}.mlp.gate_proj.weight")
            layer["w_up"] = w(f"{p}.mlp.up_proj.weight")
            layer["w_down"] = w(f"{p}.mlp.down_proj.weight")
        if cfg.qkv_bias:
            layer["bq"] = w(f"{p}.self_attn.q_proj.bias", transpose=False)
            layer["bk"] = w(f"{p}.self_attn.k_proj.bias", transpose=False)
            layer["bv"] = w(f"{p}.self_attn.v_proj.bias", transpose=False)
        if cfg.qk_norm:
            layer["ln_q_head"] = w(f"{p}.self_attn.q_norm.weight", transpose=False)
            layer["ln_k_head"] = w(f"{p}.self_attn.k_norm.weight", transpose=False)
        layers.append(quantize_layer(layer, fmts))
        del layer
    embed = w("model.embed_tokens.weight", transpose=False)
    if embed_fmt:
        embed = quantize_weight(embed, axis=-1, fmt=embed_fmt)
    params: Params = {
        "embed": embed,
        "layers": layers,
        "ln_f": w("model.norm.weight", transpose=False),
    }
    if not cfg.tie_word_embeddings:
        head = w("lm_head.weight")
        params["lm_head"] = quantize_weight(head, fmt=unembed_fmt) if unembed_fmt else head
    return params


def hf_tensors(cfg: ModelConfig, params: Params) -> dict[str, torch.Tensor]:
    """The inverse of ``load_hf_weights``: the port's params as an HF
    checkout's named tensors (``[out, in]`` views, MLA's rope dims
    re-interleaved, experts unstacked in DeepSeek's layout), on the
    params' device in their dtype — what a checkout written for the
    tests or the chip check holds."""
    out: dict[str, torch.Tensor] = {"model.embed_tokens.weight": params["embed"],
                                    "model.norm.weight": params["ln_f"]}
    if "lm_head" in params:
        out["lm_head.weight"] = params["lm_head"].t()
    dn, dr, dc = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.kv_lora_rank
    H = cfg.num_heads

    def unperm(t, axis):  # [evens ‖ odds] -> interleaved pairs
        inv = torch.empty(dr, dtype=torch.long)
        inv[torch.cat([torch.arange(0, dr, 2), torch.arange(1, dr, 2)])] = torch.arange(dr)
        return t.index_select(axis, inv.to(t.device))

    for i, layer in enumerate(params["layers"]):
        p = f"model.layers.{i}"
        names = {
            "wq": "self_attn.q_proj.weight", "wk": "self_attn.k_proj.weight",
            "wv": "self_attn.v_proj.weight", "wo": "self_attn.o_proj.weight",
            "ln_attn": "input_layernorm.weight", "bq": "self_attn.q_proj.bias",
            "bk": "self_attn.k_proj.bias", "bv": "self_attn.v_proj.bias",
            "ln_q_head": "self_attn.q_norm.weight", "ln_k_head": "self_attn.k_norm.weight",
            "ln_kv": "self_attn.kv_a_layernorm.weight", "w_dq": "self_attn.q_a_proj.weight",
            "ln_q": "self_attn.q_a_layernorm.weight",
        }
        if cfg.post_norms:
            names.update(ln_post_attn="post_attention_layernorm.weight",
                         ln_mlp="pre_feedforward_layernorm.weight",
                         ln_post_mlp="post_feedforward_layernorm.weight")
        else:
            names["ln_mlp"] = "post_attention_layernorm.weight"
        moe = cfg.moe_layer(i)
        if not moe:
            names.update(w_gate="mlp.gate_proj.weight", w_up="mlp.up_proj.weight",
                         w_down="mlp.down_proj.weight")
        for key, name in names.items():
            if key not in layer or (cfg.is_mla and key == "wq"):
                continue
            t = layer[key]
            out[f"{p}.{name}"] = t.t() if t.ndim == 2 else t
        if cfg.is_mla:
            def perm_q(t):  # our [in, H*(dn+dr)] -> HF [H*(dn+dr), in]
                qr = t.reshape(t.shape[0], H, dn + dr)
                qr = torch.cat([qr[..., :dn], unperm(qr[..., dn:], -1)], dim=-1)
                return qr.reshape(t.shape[0], -1).t()

            if "w_uq" in layer:
                out[f"{p}.self_attn.q_b_proj.weight"] = perm_q(layer["w_uq"])
            else:
                out[f"{p}.self_attn.q_proj.weight"] = perm_q(layer["wq"])
            dkv = layer["w_dkv"]
            out[f"{p}.self_attn.kv_a_proj_with_mqa.weight"] = torch.cat(
                [dkv[:, :dc], unperm(dkv[:, dc:], 1)], dim=1).t()
            out[f"{p}.self_attn.kv_b_proj.weight"] = torch.cat(
                [layer["w_uk"], layer["w_uv"]], dim=1).reshape(-1, dc)
        if moe:
            m = f"{p}.mlp"
            out[f"{m}.gate.weight"] = layer["w_router"].t()
            if "router_bias" in layer:
                out[f"{m}.gate.e_score_correction_bias"] = layer["router_bias"]
            for key, ename in (("w_gate", "gate_proj"), ("w_up", "up_proj"),
                               ("w_down", "down_proj")):
                for e in range(cfg.num_experts):
                    out[f"{m}.experts.{e}.{ename}.weight"] = layer[key][e].t()
            for key, ename in (("w_shared_gate", "gate_proj"), ("w_shared_up", "up_proj"),
                               ("w_shared_down", "down_proj")):
                if key in layer:
                    out[f"{m}.shared_experts.{ename}.weight"] = layer[key].t()
    return out


def _ln(x: torch.Tensor, w: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """RMSNorm with the family's scale: Gemma checkpoints store w and
    scale by (1 + w), computed in float32 before the norm."""
    if cfg.norm_offset:
        w = 1.0 + w.float()
    return rms_norm(x, w, cfg.rms_eps)


def _in_dtype(value: float, dtype: torch.dtype) -> float:
    """``value`` rounded to ``dtype`` on the host, so that multiplying by
    it matches the reference's multiply by a scalar of the activation
    dtype without making a tensor on the card."""
    return torch.tensor(value, dtype=dtype).item()


def _layer_rope(cfg: ModelConfig, li: int) -> tuple:
    """(theta, scaling) of layer li: Gemma-3's windowed (local) layers run
    on rope_local_theta with no position scaling; the others keep
    rope_theta and rope_scaling."""
    if cfg.rope_local_theta and cfg.layer_window(li):
        return cfg.rope_local_theta, None
    return cfg.rope_theta, cfg.rope_scaling


def _embed(params: Params, cfg: ModelConfig, token_ids: torch.Tensor) -> torch.Tensor:
    x = embed_lookup(params["embed"], token_ids)
    if cfg.embed_scale:
        # The normalizer in the activation dtype before the multiply: the
        # bf16 rounding of sqrt(hidden) is part of Gemma's numerics.
        x = x * _in_dtype(cfg.hidden_size ** 0.5, x.dtype)
    return x


def _qkv(layer: Params, x: torch.Tensor, cfg: ModelConfig):
    T = x.shape[0]
    q = qdot(x, layer["wq"])
    k = qdot(x, layer["wk"])
    v = qdot(x, layer["wv"])
    if cfg.qkv_bias:
        q, k, v = q + layer["bq"], k + layer["bk"], v + layer["bv"]
    q = q.reshape(T, cfg.num_heads, cfg.head_dim)
    k = k.reshape(T, cfg.num_kv_heads, cfg.head_dim)
    if cfg.qk_norm:
        # Per-head RMSNorm over head_dim, before rope.
        q = _ln(q, layer["ln_q_head"], cfg)
        k = _ln(k, layer["ln_k_head"], cfg)
    if cfg.query_pre_attn_scalar:
        # The kernels scale scores by 1/sqrt(head_dim): fold the family's
        # 1/sqrt(query_pre_attn_scalar) into q.
        q = q * _in_dtype(
            (cfg.head_dim / cfg.query_pre_attn_scalar) ** 0.5, q.dtype
        )
    return q, k, v.reshape(T, cfg.num_kv_heads, cfg.head_dim)


def _qkv_mla(layer: Params, x: torch.Tensor, cfg: ModelConfig, cos, sin):
    """DeepSeek MLA projections with the absorbed-matrix trick: queries
    are projected INTO the latent space (q_nope·(W_uk c) ≡ (W_uk^T
    q_nope)·c), so the paged cache holds one shared entry [latent ‖ roped
    k_pe] per token and attention runs as MQA over kv_lora_rank +
    qk_rope_head_dim dims (576 at DeepSeek's widths) through the same
    kernels. Returns q [T, H, dc+dr], k_entry [T, 1, dc+dr] and v_entry
    [T, 1, dc+dr], the latent zero-padded to the key width (its tail
    reads nothing; ``_mla_out`` up-projects). The kernels scale scores by
    1/sqrt(dc+dr); MLA's scale is 1/sqrt(dn+dr) times yarn's mscale²,
    folded into q."""
    H = cfg.num_heads
    dn, dr, dc = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.kv_lora_rank
    T = x.shape[0]
    if cfg.q_lora_rank:
        cq = rms_norm(qdot(x, layer["w_dq"]), layer["ln_q"], cfg.rms_eps)
        q = qdot(cq, layer["w_uq"])
    else:
        q = qdot(x, layer["wq"])
    q = q.reshape(T, H, dn + dr)
    q_pe = rotate(q[..., dn:], cos, sin)
    q_lat = qeinsum("thn,hnc->thc", q[..., :dn], layer["w_uk"])
    ckr = qdot(x, layer["w_dkv"])                                 # [T, dc + dr]
    c = rms_norm(ckr[:, :dc], layer["ln_kv"], cfg.rms_eps)
    k_pe = rotate(ckr[:, None, dc:], cos, sin)[:, 0]              # one shared head
    corr = ((dc + dr) / (dn + dr)) ** 0.5
    if cfg.rope_scaling is not None:
        corr *= cfg.rope_scaling.attn_mscale() ** 2
    q_full = torch.cat([q_lat, q_pe], dim=-1) * corr
    k_entry = torch.cat([c, k_pe], dim=-1)[:, None, :]
    v_entry = F.pad(c, (0, dr))[:, None, :]
    return q_full.to(x.dtype), k_entry, v_entry


def _mla_out(layer: Params, attn: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Attention output [T, H, dc+dr] → the latent part up-projected per
    head (the absorbed W_uv), then the output projection."""
    o = qeinsum("thc,hvc->thv", attn[..., : cfg.kv_lora_rank], layer["w_uv"])
    return qdot(o.reshape(o.shape[0], -1).to(attn.dtype), layer["wo"])


def _swiglu(
    layer: Params, x: torch.Tensor, act: str = "silu", prefix: str = "w_"
) -> torch.Tensor:
    # "silu": Llama's SwiGLU; "gelu_tanh": Gemma's GeGLU.
    gate = qdot(x, layer[f"{prefix}gate"])
    gate = F.silu(gate) if act == "silu" else F.gelu(gate, approximate="tanh")
    return qdot(gate * qdot(x, layer[f"{prefix}up"]), layer[f"{prefix}down"])


def moe_config(cfg: ModelConfig) -> MoeConfig:
    """The routed experts' settings of a MoE model."""
    return MoeConfig(
        hidden_size=cfg.hidden_size,
        intermediate_size=cfg.moe_intermediate_size or cfg.intermediate_size,
        num_experts=cfg.num_experts,
        num_experts_per_tok=cfg.num_experts_per_tok,
        gating=cfg.gating,
        norm_topk_prob=cfg.norm_topk_prob,
        routed_scaling_factor=cfg.routed_scaling_factor,
        n_group=cfg.n_group,
        topk_group=cfg.topk_group,
        dispatch=cfg.moe_dispatch,
        capacity_factor=cfg.moe_capacity_factor,
    )


def _mlp(layer: Params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """The family's gated MLP, or, in a layer with a router, the routed
    experts (float32 out) plus DeepSeekMoE's always-on shared experts."""
    if "w_router" not in layer:
        return _swiglu(layer, x, cfg.hidden_act)
    out = moe_mlp(layer, x, moe_config(cfg))
    if "w_shared_gate" in layer:
        out = out + _swiglu(layer, x, prefix="w_shared_")
    return out


def _residual_attn(x, layer: Params, attn_out, cfg: ModelConfig):
    """Attention residual add; Gemma's post-attention norm sits on the
    branch."""
    if cfg.post_norms:
        attn_out = _ln(attn_out, layer["ln_post_attn"], cfg)
    return x + attn_out


def _residual_mlp(x, layer: Params, cfg: ModelConfig):
    """Pre-norm, gated MLP, Gemma's post-norm, residual add (the norm's
    output in the weights' dtype, whatever the residual stream's)."""
    h = _ln(x, layer["ln_mlp"], cfg).to(weight_dtype(layer["w_up"]))
    m = _mlp(layer, h, cfg)
    if cfg.post_norms:
        m = _ln(m, layer["ln_post_mlp"], cfg)
    return x + m


def _logits(params: Params, cfg: ModelConfig, h: torch.Tensor) -> torch.Tensor:
    """Final norm, then the head in float32 (``head_mm``)."""
    h = _ln(h, params["ln_f"], cfg)
    if cfg.tie_word_embeddings:
        return tied_head_mm(h, params["embed"])
    return head_mm(h, params["lm_head"])


def _layers(
    cfg: ModelConfig, params: Params, token_ids: torch.Tensor,
    positions: torch.Tensor, attend, on_layer=None, embeds=None, embed_mask=None,
) -> torch.Tensor:
    """The decoder stack over flat rows: embed, then per layer the
    family's norm, q/k/v, RoPE at ``positions`` with the layer's
    ``(theta, scaling)``, ``attend(li, q, k, v) -> [rows, H, D]`` (which
    writes the layer's cache first where there is one), ``wo``, the
    residuals and the gated MLP. The residual stream is float32 whatever
    the weights' dtype: each norm's output and every matmul stay in the
    weights' dtype. (Rounded to bf16 at each of 2 adds per layer, the
    stream of a cached serve and of the no-cache reference drift apart:
    on mistral-7b's 32 layers, 0.03–0.09 nats at the top logits.)
    Returns the pre-final-norm hidden states [rows, D], float32.
    MLA layers (``_qkv_mla``) rotate inside their projections, over
    qk_rope_head_dim, and attend over the shared latent entry.
    ``on_layer(li, x_attn, x_out)``, where given, sees each layer's
    residual after its attention and after its MLP (a divergence probe,
    tools/layer_divergence.py). ``embeds`` [rows, D] and ``embed_mask``
    [rows] (bool), where given, replace the masked rows' token
    embeddings (``_splice``)."""
    rows = token_ids.shape[0]
    tables = rope_tables(
        positions, cfg.qk_rope_head_dim if cfg.is_mla else cfg.head_dim,
        [_layer_rope(cfg, li) for li in range(len(params["layers"]))],
    )
    x = _embed(params, cfg, token_ids.long())
    if embeds is not None:
        x = _splice(x, embeds, embed_mask)
    x = x.float()
    for li, layer in enumerate(params["layers"]):
        h = _ln(x, layer["ln_attn"], cfg).to(weight_dtype(layer["wo"]))
        cos, sin = tables[li]
        if cfg.is_mla:
            x = x + _mla_out(layer, attend(li, *_qkv_mla(layer, h, cfg, cos, sin)), cfg)
        else:
            q, k, v = _qkv(layer, h, cfg)
            attn = attend(li, rotate(q, cos, sin), rotate(k, cos, sin), v)
            x = _residual_attn(x, layer, qdot(attn.reshape(rows, -1), layer["wo"]), cfg)
        x_attn = x
        x = _residual_mlp(x, layer, cfg)
        if on_layer is not None:
            on_layer(li, x_attn, x)
    return x


def _splice(x: torch.Tensor, embeds: torch.Tensor, embed_mask: torch.Tensor) -> torch.Tensor:
    """The multimodal soft prompt: rows under ``embed_mask`` take
    ``embeds`` (float32 patch embeddings from the encode worker) in place
    of their placeholder tokens' embeddings, rounded to the embeddings'
    dtype as the reference's ``jnp.where(embed_mask, embeds.astype(x.dtype),
    x)`` rounds them; the residual stream then widens both alike."""
    return torch.where(embed_mask[:, None], embeds.to(x.dtype), x)


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
    embeds: torch.Tensor | None = None,     # [T, D] soft-prompt rows (f32)
    embed_mask: torch.Tensor | None = None,  # [T] bool: rows taken from embeds
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
    ``(logits, new_scales [L, 2, num_blocks, kvH])``.

    ``embeds``/``embed_mask`` substitute multimodal soft-prompt rows into
    the flat batch (the ``unified_mm`` program)."""
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

    x = _layers(cfg, params, token_ids, torch.clamp(token_pos, min=0), attend,
                embeds=embeds, embed_mask=embed_mask)
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
    embeds: torch.Tensor | None = None,      # [N, T, D] soft-prompt rows (f32)
    embed_mask: torch.Tensor | None = None,  # [N, T] bool
) -> torch.Tensor:
    """N sequences' prefills fused into one call: the projections and
    MLP run over all N*T rows, K/V scatter once, and the prefill kernel
    reads the shared cache through per-lane block tables. Returns
    last-token logits [N, V]. ``embeds``/``embed_mask`` as in ``unified``."""
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

    if embeds is not None:
        embeds, embed_mask = embeds.reshape(N * T, -1), embed_mask.reshape(N * T)
    x = _layers(cfg, params, token_ids.reshape(N * T), positions.reshape(N * T), attend,
                embeds=embeds, embed_mask=embed_mask)
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
    embeds: torch.Tensor | None = None,      # [T, D] soft-prompt rows (f32)
    embed_mask: torch.Tensor | None = None,  # [T] bool
) -> torch.Tensor:
    """Prefill one sequence's new tokens (the suffix after any
    prefix-cache hit); returns the last real token's logits [V]."""
    return prefill_batch(
        cfg, params, kv_caches, token_ids[None], block_table[None],
        slot_mapping[None], prefix_len.reshape(1), total_len.reshape(1),
        block_size,
        embeds=None if embeds is None else embeds[None],
        embed_mask=None if embed_mask is None else embed_mask[None],
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
    cfg: ModelConfig, params: Params, token_ids: torch.Tensor,
    embeds: torch.Tensor | None = None, embed_mask: torch.Tensor | None = None,
) -> torch.Tensor:
    """Full no-cache trunk [T] -> pre-final-norm hidden states [T, D]
    (float32, the residual stream's dtype); ``embeds``/``embed_mask`` as
    in ``unified``."""
    positions = torch.arange(token_ids.shape[0], device=token_ids.device)
    return _layers(
        cfg, params, token_ids, positions,
        lambda li, q, k, v: full_causal_attention(
            q, k, v, window=cfg.layer_window(li)
        ),
        embeds=embeds, embed_mask=embed_mask,
    )


def reference_forward(
    cfg: ModelConfig, params: Params, token_ids: torch.Tensor,
    embeds: torch.Tensor | None = None, embed_mask: torch.Tensor | None = None,
) -> torch.Tensor:
    """Full no-cache forward [T] -> logits [T, V]; the correctness oracle
    the paged paths are tested against, the multimodal ones included."""
    return _logits(params, cfg, hidden_states(cfg, params, token_ids, embeds, embed_mask))
