"""Vision encoder: a ViT-style patch encoder producing text-space soft
prompts (port of dynamo_tpu/models/vision.py).

The model of the multimodal encode worker (llm/multimodal.py): a compact
pre-LN ViT — patchify is a reshape (no convolution), attention and MLP
are plain matrix products, and the final projection lands in the
language model's hidden space, so the engine's soft-prompt prefill
(models/llama.py ``embeds``) splices the patches in place of placeholder
tokens. The reference runs it as plain XLA, not Pallas; here it stays
plain torch ops (einsum and softmax), with no kernel of its own.

The arithmetic is the reference's: patchify ``reshape(n, P, n, P, 3)
.transpose(0, 2, 1, 3, 4)``, a LayerNorm of biased variance times
``rsqrt(var + eps)`` times the gain (no bias), scores divided by
``sqrt(hd)`` and softmaxed over keys, ``jax.nn.gelu``'s default tanh
approximation. The activations run in the weights' dtype; norms, scores
and the softmax in float32. The soft prompt comes back in float32.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from dynamo_tpu_torch import resolve_device

Params = dict[str, Any]

LAYER_KEYS = ("ln_attn", "wq", "wk", "wv", "wo", "ln_mlp", "w_up", "w_down")


@dataclass(frozen=True)
class VisionConfig:
    image_size: int = 32
    patch_size: int = 8
    hidden_size: int = 64
    num_layers: int = 2
    num_heads: int = 2
    mlp_ratio: int = 4
    out_dim: int = 64          # language-model hidden size
    ln_eps: float = 1e-5

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @property
    def patch_dim(self) -> int:
        return self.patch_size * self.patch_size * 3

    @staticmethod
    def tiny_test(out_dim: int = 64) -> "VisionConfig":
        return VisionConfig(out_dim=out_dim)

    def param_count(self) -> int:
        D, M = self.hidden_size, self.mlp_ratio * self.hidden_size
        layer = 2 * D + 4 * D * D + 2 * D * M
        return (self.patch_dim * D + self.num_patches * D + D + D * self.out_dim
                + self.num_layers * layer)


def init_vision_params(
    generator: torch.Generator,
    cfg: VisionConfig,
    dtype: torch.dtype = torch.float32,
    device: torch.device | str | None = None,
) -> Params:
    """Random-init params with the reference's law (``fan_in ** -0.5``
    scaling, 0.02 for the position table, unit norm gains); the draws
    come from ``generator``, which must live on the target device, in
    float32 cast to ``dtype``, and differ from JAX's."""
    device = resolve_device(device)

    def dense(shape, scale=None):
        scale = scale if scale is not None else shape[0] ** -0.5
        w = torch.randn(shape, generator=generator, dtype=torch.float32, device=device)
        return (w * scale).to(dtype)

    def ones(n):
        return torch.ones(n, dtype=dtype, device=device)

    D, M = cfg.hidden_size, cfg.mlp_ratio * cfg.hidden_size
    params: Params = {
        "patch_proj": dense((cfg.patch_dim, D)),
        "pos_embed": dense((cfg.num_patches, D), scale=0.02),
        "ln_f": ones(D),
        "out_proj": dense((D, cfg.out_dim)),
        "layers": [],
    }
    for _ in range(cfg.num_layers):
        params["layers"].append({
            "ln_attn": ones(D), "wq": dense((D, D)), "wk": dense((D, D)),
            "wv": dense((D, D)), "wo": dense((D, D)), "ln_mlp": ones(D),
            "w_up": dense((D, M)), "w_down": dense((M, D)),
        })
    return params


def vision_params_from_jax(
    tree: Params,
    dtype: torch.dtype | None = None,
    device: torch.device | str | None = None,
) -> Params:
    """A reference vision params tree with numpy leaves
    (``jax.tree.map(np.asarray, params)``) → the port's params in
    ``dtype`` (default: each leaf's own) on ``device`` (default: the
    card). The layout is shared."""
    device = resolve_device(device)

    def conv(a):
        t = torch.from_numpy(np.array(a, copy=True))
        return t.to(device=device, dtype=dtype or t.dtype)

    out: Params = {k: conv(tree[k]) for k in ("patch_proj", "pos_embed", "ln_f", "out_proj")}
    out["layers"] = [{k: conv(layer[k]) for k in LAYER_KEYS} for layer in tree["layers"]]
    return out


def _ln(x: torch.Tensor, g: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(-1, keepdim=True)
    return ((xf - mu) * torch.rsqrt(var + eps) * g.float()).to(x.dtype)


def encode_image(params: Params, cfg: VisionConfig, image) -> torch.Tensor:
    """[image_size, image_size, 3] floats in [0, 1] (a tensor or numpy
    array) → [num_patches, out_dim] float32 soft-prompt embeddings
    (bidirectional attention over the patches)."""
    w = params["patch_proj"]
    if not isinstance(image, torch.Tensor):
        image = torch.from_numpy(np.ascontiguousarray(image, np.float32))
    image = image.to(device=w.device, dtype=w.dtype)
    S, P = cfg.image_size, cfg.patch_size
    n = S // P
    patches = (
        image.reshape(n, P, n, P, 3)
        .permute(0, 2, 1, 3, 4)
        .reshape(cfg.num_patches, cfg.patch_dim)
    )
    x = patches @ w + params["pos_embed"]
    D, H = cfg.hidden_size, cfg.num_heads
    hd = D // H
    for layer in params["layers"]:
        h = _ln(x, layer["ln_attn"], cfg.ln_eps)
        q = (h @ layer["wq"]).reshape(-1, H, hd)
        k = (h @ layer["wk"]).reshape(-1, H, hd)
        v = (h @ layer["wv"]).reshape(-1, H, hd)
        scores = torch.einsum("qhd,khd->hqk", q.float(), k.float()) / hd ** 0.5
        probs = torch.softmax(scores, dim=-1).to(v.dtype)
        attn = torch.einsum("hqk,khd->qhd", probs, v).reshape(-1, D)
        x = x + attn @ layer["wo"]
        h = _ln(x, layer["ln_mlp"], cfg.ln_eps)
        x = x + F.gelu(h @ layer["w_up"], approximate="tanh") @ layer["w_down"]
    return (_ln(x, params["ln_f"], cfg.ln_eps) @ params["out_proj"]).float()
