"""Token sampling inside the step (port of dynamo_tpu/ops/sampling.py):
greedy / temperature / top-k / top-p, vectorized per batch slot.

Greedy is ``argmax`` (first maximum on ties, as ``jnp.argmax``). Sampled
lanes mask against the same static top-``MAX_TOP_K`` candidate window with
the reference's top-k and top-p laws, then draw by Gumbel-max with
uniforms from a counter-based hash. The reference's threefry streams
cannot be reproduced in PyTorch, so what carries over is the contract of
``lane_keys``: a seeded lane's draw depends only on ``(seed,
sample_pos)``, whatever else shares the batch.

The engine stream's key is device data: the unified step reads it from
its metadata block, written on the host before each dispatch, so a
captured CUDA graph draws a new stream on every replay. The phase-split
entry points pass it as a host pair.
"""

from __future__ import annotations

import torch

from dynamo_tpu_torch.llm.protocols.common import MAX_LOGPROBS

MAX_TOP_K = 64

_M32 = 0xFFFFFFFF


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """``(x * c) mod 2**32`` for int64 ``x`` in [0, 2**32) without int64
    overflow: the multiplier splits into 16-bit halves."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + ((x * hi) & 0xFFFF) * 65536) & _M32


def _fmix32(x: torch.Tensor) -> torch.Tensor:
    """MurmurHash3's 32-bit finalizer: a bijective avalanche mix."""
    x = x & _M32
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    return x ^ (x >> 16)


def _mix(a: torch.Tensor, b: torch.Tensor | int) -> torch.Tensor:
    """Counter-based combine of two 32-bit words into one."""
    return _fmix32(a ^ _fmix32((b + 0x9E3779B9) & _M32))


Key = tuple[int, int] | torch.Tensor


def lane_keys(
    key: Key,                    # (engine seed, step) — the engine stream
    seed: torch.Tensor,          # [B] int; < 0 means unseeded
    sample_pos: torch.Tensor,    # [B] int — index of the token being sampled
) -> torch.Tensor:
    """Per-lane 32-bit sampling keys [B] (int64 holding uint32).

    ``key`` is the engine stream's (seed, step) pair: host integers, or a
    device tensor of two int32/int64 words (the unified step's metadata
    row, read as uint32); both give the same keys. A seeded lane's key
    depends ONLY on (seed, token index), so a request with ``seed`` set
    reproduces its samples regardless of what other traffic it was
    batched with or which engine step picked it up. Unseeded lanes draw
    from the engine's step stream, decorrelated per lane."""
    B = seed.shape[0]
    dev = seed.device
    seed = seed.long()
    seeded = _mix(_mix(torch.clamp(seed, min=0), 0x5EED), sample_pos.long())
    if isinstance(key, torch.Tensor):
        words = key.long() & _M32
        stream = _mix(words[0].expand(B), words[1])
    else:
        k0 = torch.full((B,), key[0] & _M32, dtype=torch.long, device=dev)
        stream = _mix(k0, key[1] & _M32)
    unseeded = _mix(stream, torch.arange(B, device=dev))
    return torch.where(seed >= 0, seeded, unseeded)


def _uniform(keys: torch.Tensor, n: int) -> torch.Tensor:
    """[B, n] float32 uniforms in (0, 1), candidate j of lane b drawn from
    hash(keys[b], j)."""
    c = torch.arange(n, device=keys.device)
    bits = _mix(keys[:, None], c[None, :]) >> 8          # 24 random bits
    return (bits.float() + 0.5) * (1.0 / (1 << 24))


def apply_penalties(
    logits: torch.Tensor,             # [B, V]
    counts: torch.Tensor,             # [B, V] int — output-token counts
    frequency_penalty: torch.Tensor,  # [B] float32
    presence_penalty: torch.Tensor,   # [B] float32
) -> torch.Tensor:
    """OpenAI-style penalties over the generated-token counts:
    ``logit[t] -= freq * count[t] + pres * (count[t] > 0)``."""
    c = counts.to(logits.dtype)
    return (
        logits
        - frequency_penalty[:, None] * c
        - presence_penalty[:, None] * (c > 0)
    )


def token_logprobs(
    logits: torch.Tensor,        # [B, V]
    chosen: torch.Tensor,        # [B] int — the sampled token ids
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(chosen_logprob [B], top_ids [B, MAX_LOGPROBS] int32, top_logprobs
    [B, MAX_LOGPROBS]) — log-softmax of the distribution sampled from, at
    temperature-1 scale, like the reference's engines report."""
    lp = torch.log_softmax(logits.float(), dim=-1)
    chosen_lp = torch.gather(lp, 1, chosen.long()[:, None])[:, 0]
    top_lps, top_ids = torch.topk(lp, min(MAX_LOGPROBS, lp.shape[-1]), dim=-1)
    return chosen_lp, top_ids.to(torch.int32), top_lps


def sample_tokens(
    logits: torch.Tensor,        # [B, V] float32
    key: Key,                    # engine stream key (see lane_keys)
    temperature: torch.Tensor,   # [B] float32; <=0 means greedy
    top_k: torch.Tensor,         # [B] int32; 0 means disabled
    top_p: torch.Tensor,         # [B] float32; >=1 means disabled
    seed: torch.Tensor | None = None,        # [B]; < 0 means unseeded
    sample_pos: torch.Tensor | None = None,  # [B] token index being sampled
    all_greedy: bool | None = None,
) -> torch.Tensor:
    """Sampled token ids [B] int32. ``all_greedy`` (known on the host to
    the caller) skips the candidate window without a device sync; None
    decides on the device values."""
    B, V = logits.shape
    greedy_ids = torch.argmax(logits, dim=-1).to(torch.int32)
    if seed is not None and sample_pos is None:
        # One key for every step of a seeded lane would repeat its draws.
        raise ValueError("sample_pos is required when seed is given")
    if all_greedy is None:
        all_greedy = bool((temperature <= 0.0).all())
    if all_greedy:
        return greedy_ids

    cap = min(MAX_TOP_K, V)
    top_vals, top_idx = torch.topk(logits, cap, dim=-1)   # sorted descending
    temp = torch.clamp(temperature, min=1e-6)[:, None]
    scaled = top_vals / temp

    # top-k mask within the candidate window
    k_eff = torch.where(top_k <= 0, cap, torch.clamp(top_k, max=cap))[:, None]
    rank = torch.arange(cap, device=logits.device)[None, :]
    mask = rank < k_eff

    # top-p (nucleus) mask over the sorted candidates: keep tokens whose
    # cumulative mass *before* them is < p (always keep #1)
    probs = torch.softmax(torch.where(mask, scaled, -1e30), dim=-1)
    cumulative = torch.cumsum(probs, dim=-1)
    p_eff = torch.where(
        top_p <= 0, 1.0, torch.clamp(top_p, max=1.0)
    )[:, None]
    before = cumulative - probs
    mask2 = mask & (before < p_eff)
    masked = torch.where(mask2, scaled, -1e30)

    if seed is None:
        seed = torch.full((B,), -1, dtype=torch.long, device=logits.device)
        sample_pos = torch.zeros((B,), dtype=torch.long, device=logits.device)
    u = _uniform(lane_keys(key, seed, sample_pos), cap)
    gumbel = -torch.log(-torch.log(u))
    choice = torch.argmax(masked + gumbel, dim=-1)
    sampled = torch.gather(top_idx, 1, choice[:, None])[:, 0].to(torch.int32)
    return torch.where(temperature <= 0.0, greedy_ids, sampled)
