"""Rotary position embeddings (port of dynamo_tpu/ops/rope.py).

Llama-style half-rotation layout computed on the fly from positions.
Llama-3.1+ checkpoints apply the ``llama3`` frequency-band scaling;
Gemma-3 global layers use ``linear`` position interpolation. The ``yarn``
recipe belongs to the MLA models, which arrive with a later slice: a
``yarn`` config parses, and rotating with it raises.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class RopeScaling:
    """HF ``rope_scaling`` block: ``llama3`` frequency bands, ``linear``
    interpolation, or ``yarn`` (parsed only; see module docstring)."""

    kind: str = "llama3"
    factor: float = 8.0
    original_max_position: int = 8192
    # llama3 band parameters
    low_freq_factor: float = 1.0
    high_freq_factor: float = 4.0
    # yarn parameters
    beta_fast: float = 32.0
    beta_slow: float = 1.0
    mscale: float = 1.0
    mscale_all_dim: float = 0.0

    @staticmethod
    def from_hf(d: dict | None) -> "RopeScaling | None":
        if not d:
            return None
        kind = d.get("rope_type", d.get("type", "llama3"))
        if kind == "default":
            return None  # HF semantics: explicitly no scaling
        if kind == "llama3":
            return RopeScaling(
                kind="llama3",
                factor=float(d.get("factor", 8.0)),
                low_freq_factor=float(d.get("low_freq_factor", 1.0)),
                high_freq_factor=float(d.get("high_freq_factor", 4.0)),
                original_max_position=int(
                    d.get("original_max_position_embeddings", 8192)
                ),
            )
        if kind == "linear":
            return RopeScaling(kind="linear", factor=float(d.get("factor", 1.0)))
        if kind == "yarn":
            return RopeScaling(
                kind="yarn",
                factor=float(d.get("factor", 1.0)),
                original_max_position=int(
                    d.get("original_max_position_embeddings", 4096)
                ),
                beta_fast=float(d.get("beta_fast", 32.0)),
                beta_slow=float(d.get("beta_slow", 1.0)),
                mscale=float(d.get("mscale", 1.0)),
                mscale_all_dim=float(d.get("mscale_all_dim", 0.0)),
            )
        raise ValueError(f"unsupported rope_scaling {d!r}")


def _scaled_freqs(freqs: torch.Tensor, s: RopeScaling) -> torch.Tensor:
    if s.kind == "yarn":
        raise NotImplementedError(
            "yarn rope scaling arrives with the MLA model slice"
        )
    if s.kind == "linear":
        return freqs / s.factor
    # Frequency-dependent stretch (the Llama-3.1 formula): wavelengths
    # shorter than the high-freq band keep their frequency, longer than the
    # low-freq band divide by `factor`, and the band between ramps smoothly.
    wavelen = 2.0 * math.pi / freqs
    low_wl = s.original_max_position / s.low_freq_factor
    high_wl = s.original_max_position / s.high_freq_factor
    smooth = (s.original_max_position / wavelen - s.low_freq_factor) / (
        s.high_freq_factor - s.low_freq_factor
    )
    mid = (1.0 - smooth) * freqs / s.factor + smooth * freqs
    return torch.where(
        wavelen < high_wl,
        freqs,
        torch.where(wavelen > low_wl, freqs / s.factor, mid),
    )


def rope_angles(
    positions: torch.Tensor,
    head_dim: int,
    theta: float,
    scaling: RopeScaling | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """positions [...]: returns cos/sin of shape [..., head_dim//2]."""
    half = head_dim // 2
    dev = positions.device
    # log(theta) in float32 as the reference computes it, on the host: a
    # device scalar here would cost a synchronous copy per call.
    log_theta = torch.log(torch.tensor(theta, dtype=torch.float32)).item()
    freqs = torch.exp(
        -log_theta * (torch.arange(half, dtype=torch.float32, device=dev) / half)
    )
    if scaling is not None:
        freqs = _scaled_freqs(freqs, scaling)
    ang = positions.float()[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def rotate(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Rotate q or k [..., n_heads, head_dim] by precomputed ``rope_angles``
    tables (the model computes them once per forward for all layers)."""
    cos = cos[..., None, :]  # broadcast over heads
    sin = sin[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def apply_rope(
    x: torch.Tensor,
    positions: torch.Tensor,
    theta: float = 10000.0,
    scaling: RopeScaling | None = None,
) -> torch.Tensor:
    """Rotate q or k. x: [..., n_heads, head_dim]; positions broadcastable
    to x.shape[:-2]."""
    return rotate(x, *rope_angles(positions, x.shape[-1], theta, scaling))
