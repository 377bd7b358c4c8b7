"""Rotary position embeddings (port of dynamo_tpu/ops/rope.py).

Llama-style half-rotation layout computed on the fly from positions.
Llama-3.1+ checkpoints apply the ``llama3`` frequency-band scaling;
Gemma-3 global layers use ``linear`` position interpolation; the
DeepSeek MLA models ``yarn`` (NTK-by-parts interpolation with its
attention-temperature correction, ``mscale``).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class RopeScaling:
    """HF ``rope_scaling`` block: ``llama3`` frequency bands, ``linear``
    interpolation, or ``yarn`` (DeepSeek-V2/V3/R1 long context)."""

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

    def attn_mscale(self) -> float:
        """Score-scale multiplier DeepSeek folds into the softmax scale
        under yarn (the model applies it to q, models/llama.py
        ``_qkv_mla``): yarn_get_mscale(factor, mscale_all_dim)."""
        if self.kind != "yarn":
            return 1.0
        return _yarn_mscale(self.factor, self.mscale_all_dim)

    def embed_mscale(self) -> float:
        """cos/sin magnitude correction of the rotary embedding (HF
        DeepseekV2YarnRotaryEmbedding: the mscale / mscale_all_dim ratio,
        1.0 on the shipped DeepSeek configs, where the two are equal)."""
        if self.kind != "yarn":
            return 1.0
        return _yarn_mscale(self.factor, self.mscale) / _yarn_mscale(
            self.factor, self.mscale_all_dim
        )


def _yarn_mscale(scale: float, mscale: float) -> float:
    if scale <= 1.0 or mscale <= 0.0:
        return 1.0
    return 0.1 * mscale * math.log(scale) + 1.0


def _log_f32(x: float) -> float:
    """log(x) in float32, as the reference computes it, on the host (a
    device scalar would cost a synchronous copy per call)."""
    return torch.log(torch.tensor(x, dtype=torch.float32)).item()


def _yarn_freqs(freqs: torch.Tensor, s: RopeScaling) -> torch.Tensor:
    """YaRN NTK-by-parts: high-frequency dims (below the beta_fast
    correction point) keep their frequency, low-frequency dims (above
    beta_slow) interpolate by 1/factor, with a linear ramp between (HF
    DeepseekV2YarnRotaryEmbedding). Device tensor ops throughout, in the
    reference's order, so nothing is read back to the host."""
    half = freqs.shape[0]
    dim = 2 * half
    # theta recovered from the frequency ladder: freqs[i] = theta^(-i/half).
    log_theta = -torch.log(freqs[1]) * half if half > 1 else freqs.new_zeros(())

    def correction_dim(num_rotations: float) -> torch.Tensor:
        ratio = s.original_max_position / (num_rotations * 2 * math.pi)
        return dim * _log_f32(ratio) / (2 * log_theta)

    # HF clamps low to [0, half-1] (it indexes the ramp start) and high
    # to [0, dim-1] only.
    low = torch.clamp(torch.floor(correction_dim(s.beta_fast)), 0, half - 1)
    high = torch.clamp(torch.ceil(correction_dim(s.beta_slow)), 0, dim - 1)
    ramp = torch.clamp(
        (torch.arange(half, dtype=torch.float32, device=freqs.device) - low)
        / torch.clamp(high - low, min=1e-3),
        0.0,
        1.0,
    )
    extrapolation_mask = 1.0 - ramp
    return freqs / s.factor * (1.0 - extrapolation_mask) + freqs * extrapolation_mask


def _scaled_freqs(freqs: torch.Tensor, s: RopeScaling) -> torch.Tensor:
    if s.kind == "yarn":
        return _yarn_freqs(freqs, s)
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
    """positions [...]: returns cos/sin of shape [..., head_dim//2] (yarn
    multiplies both by its ``embed_mscale``)."""
    half = head_dim // 2
    dev = positions.device
    log_theta = _log_f32(theta)
    freqs = torch.exp(
        -log_theta * (torch.arange(half, dtype=torch.float32, device=dev) / half)
    )
    if scaling is not None:
        freqs = _scaled_freqs(freqs, scaling)
    ang = positions.float()[..., None] * freqs
    m = scaling.embed_mscale() if scaling is not None else 1.0
    if m != 1.0:
        return torch.cos(ang) * m, torch.sin(ang) * m
    return torch.cos(ang), torch.sin(ang)


def rope_tables(
    positions: torch.Tensor,
    head_dim: int,
    pairs: list[tuple[float, RopeScaling | None]],
) -> list[tuple[torch.Tensor, torch.Tensor]]:
    """``rope_angles`` for each layer's ``(theta, scaling)``, one table
    per distinct pair (Gemma-3's local layers share theirs, its global
    layers theirs); returns one (cos, sin) per entry of ``pairs``."""
    made: dict = {}
    for pair in pairs:
        if pair not in made:
            made[pair] = rope_angles(positions, head_dim, *pair)
    return [made[pair] for pair in pairs]


def rotate(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Rotate q or k [..., n_heads, head_dim] by precomputed ``rope_angles``
    tables (the model computes them once per forward: ``rope_tables``)."""
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
