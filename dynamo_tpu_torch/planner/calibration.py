"""Mocker cost-model calibration: a law over a recorded chip run (port of
dynamo_tpu/planner/calibration.py).

The mocker (mocker/engine.py) prices a dispatch as
``f(decode_lanes, prefill_tokens)``; the fleet simulator
(planner/simulate.py) replays that price list. This module derives the
prices from an artifact that a chip run recorded, with the JAX
package's formulas, and publishes them as module constants:

- **decode dispatch**: two unified decode dispatches at ``lanes`` (32,
  64) give one line: per-lane = Δms·1000 / Δlanes, base = ms(32)·1000 −
  32·per-lane (the per-step weight pass);
- **effective HBM GB/s**: the bytes the wider dispatch streams (weights
  and its lanes' KV) over its device time;
- **weight bytes per step** = base · rate (the bytes the base streams at
  the effective rate), and the standalone prefill's dispatch base is the
  same pass priced back: bytes / rate;
- **prefill**: prefill-only dispatches at three prompt lengths ``n``,
  each the engine's full prefill dispatch of that length (``k`` prompts:
  as many as it admits at once and its token budget holds);
  ``t − base = k·(a·n + b·n²)`` fitted by least squares with ``b ≥ 0``
  gives the per-token ``a`` and quadratic ``b`` µs;
- **host overhead per dispatch**: the headline serve's wall per dispatch
  minus its device time per dispatch (what the device-side step time
  does not see: the engine loop's host work not hidden by the pipeline),
  over the whole serve, and apart for its prefill dispatches (the wall
  up to the last first token minus those dispatches' device time,
  replayed): the port's engine keeps two dispatches in flight, so a
  device-bound prefill dispatch hides most of its host work while a
  host-bound decode step shows it all;
- **handoff**: pinned host→device copies of 1 and 64 KV blocks: rate =
  Δbytes / Δt, fixed cost = t(1) − bytes(1) / rate. ``HANDOFF_GBPS`` is
  the one source of the fleet's default link rate: the router's
  network-aware term (llm/kv_router/scheduler.py) imports it.

The artifact is ``calibration_h100.json`` beside this module: the record
``chip_smoke.py``'s ``planner`` phase prints and writes
(``chip_smoke_out/calibration_h100.json``) on an H100, with the card's
name and power limit. The constants are read from it at first use; a missing or
malformed artifact raises then: no default stands in for a measurement. ``KV_BYTES_PER_TOKEN`` and the int8 ratios
come from the llama3.2-1b layout, not from a run.

``record_from_bench(path)`` reads the JAX package's bench artifact
(``BENCH_r04.json``: two decode step times, the effective HBM rate, the
headline) into the decode half of the same record, so the law can be
held against the JAX package's constants on that package's own run.
"""

from __future__ import annotations

import functools
import json
import math
from dataclasses import dataclass, field
from pathlib import Path

#: The committed H100 artifact.
ARTIFACT = Path(__file__).with_name("calibration_h100.json")
SCHEMA = "dynamo_tpu_torch.calibration/1"

# llama3.2-1b KV bytes per token: 2 (K, V) × 16 layers × 8 kv heads ×
# 64 head dims × 2 B (bf16).
KV_BYTES_PER_TOKEN = 2 * 16 * 8 * 64 * 2


@dataclass(frozen=True)
class Calibration:
    """The derived price list of one recorded run."""

    card: str
    decode_time_per_step_us: float
    decode_time_per_lane_us: float
    decode_hbm_gbps: float
    weight_bytes_per_step: float
    prefill_dispatch_base_us: float
    prefill_time_per_token_us: float = float("nan")
    prefill_quadratic_us: float = float("nan")
    # The unconstrained quadratic of the prefill fit, kept to show how
    # far the b >= 0 bound moved it (0 where it did not bind).
    prefill_quadratic_free_us: float = float("nan")
    host_overhead_us: float = float("nan")
    prefill_host_overhead_us: float = float("nan")
    handoff_gbps: float = float("nan")
    handoff_fixed_us: float = float("nan")
    headline: dict = field(default_factory=dict)
    engine: dict = field(default_factory=dict)

    def price_list(self) -> dict[str, float]:
        return {
            "decode_time_per_step_us": self.decode_time_per_step_us,
            "decode_time_per_lane_us": self.decode_time_per_lane_us,
            "decode_hbm_gbps": self.decode_hbm_gbps,
            "weight_bytes_per_step": self.weight_bytes_per_step,
            "prefill_dispatch_base_us": self.prefill_dispatch_base_us,
            "prefill_time_per_token_us": self.prefill_time_per_token_us,
            "prefill_quadratic_us": self.prefill_quadratic_us,
            "host_overhead_us": self.host_overhead_us,
            "prefill_host_overhead_us": self.prefill_host_overhead_us,
            "handoff_gbps": self.handoff_gbps,
            "handoff_fixed_us": self.handoff_fixed_us,
        }


def _section(record: dict, name: str) -> dict:
    sec = record.get(name)
    if not isinstance(sec, dict):
        raise ValueError(f"calibration record has no {name!r} section")
    return sec


def _floats(sec: dict, key: str, n: int, where: str) -> list[float]:
    vals = sec.get(key)
    if not isinstance(vals, list) or len(vals) != n:
        raise ValueError(f"calibration {where}.{key}: need a list of {n} numbers")
    out = [float(v) for v in vals]
    if not all(math.isfinite(v) and v > 0 for v in out):
        raise ValueError(f"calibration {where}.{key}: {out} not finite and positive")
    return out


def _positive(x: float, what: str) -> float:
    if not (math.isfinite(x) and x > 0):
        raise ValueError(f"calibration: {what} = {x} is not finite and positive")
    return x


def derive_decode(record: dict) -> Calibration:
    """The decode half of the law: dispatch base and per-lane µs, the
    effective HBM rate, the weight bytes per step and the standalone
    prefill's dispatch base."""
    dec = _section(record, "decode")
    lo, hi = (int(x) for x in _floats(dec, "lanes", 2, "decode"))
    if hi <= lo:
        raise ValueError(f"calibration decode.lanes {lo}, {hi}: need two rising counts")
    ms_lo, ms_hi = _floats(dec, "device_ms", 2, "decode")
    per_lane = (ms_hi - ms_lo) * 1000.0 / (hi - lo)
    base = ms_lo * 1000.0 - lo * per_lane
    streamed = _positive(float(dec.get("streamed_bytes", float("nan"))),
                         "decode.streamed_bytes")
    hbm = streamed / (ms_hi * 1e-3) / 1e9
    weight_bytes = base * 1e-6 * hbm * 1e9
    return Calibration(
        card=str(record.get("card", "")),
        decode_time_per_step_us=_positive(base, "decode base µs"),
        decode_time_per_lane_us=_positive(per_lane, "decode per-lane µs"),
        decode_hbm_gbps=hbm,
        weight_bytes_per_step=weight_bytes,
        prefill_dispatch_base_us=weight_bytes / (hbm * 1e9) * 1e6,
        headline=dict(record.get("headline") or {}),
        engine=dict(record.get("engine") or {}),
    )


def _fit_prefill(
    tokens: list[float], prompts: list[float], excess_us: list[float],
) -> tuple[float, float, float]:
    """Least squares of ``excess = k·(a·n + b·n²)`` (``k`` prompts of
    ``n`` tokens) with ``b >= 0``; returns (a, b, the unconstrained b)."""
    x1 = [k * n for n, k in zip(tokens, prompts)]
    x2 = [k * n * n for n, k in zip(tokens, prompts)]
    s11 = sum(x * x for x in x1)
    s12 = sum(x * y for x, y in zip(x1, x2))
    s22 = sum(y * y for y in x2)
    r1 = sum(x * e for x, e in zip(x1, excess_us))
    r2 = sum(y * e for y, e in zip(x2, excess_us))
    det = s11 * s22 - s12 * s12
    a = (r1 * s22 - r2 * s12) / det
    b = (s11 * r2 - s12 * r1) / det
    if b >= 0:
        return a, b, b
    return r1 / s11, 0.0, b


def derive(record: dict) -> Calibration:
    """The whole law over one recorded chip run (the artifact's layout;
    see ``chip_smoke.py``'s calibration leg). Raises ``ValueError`` on a
    record that lacks a section or holds a non-positive measurement."""
    if record.get("schema") != SCHEMA:
        raise ValueError(f"calibration record schema {record.get('schema')!r} != {SCHEMA!r}")
    if not str(record.get("card", "")).strip():
        raise ValueError("calibration record names no card")
    d = derive_decode(record)
    pre = _section(record, "prefill")
    tokens = _floats(pre, "tokens", 3, "prefill")
    prompts = _floats(pre, "prompts", 3, "prefill")
    ms = _floats(pre, "device_ms", 3, "prefill")
    a, b, b_free = _fit_prefill(
        tokens, prompts, [m * 1000.0 - d.prefill_dispatch_base_us for m in ms])
    host = _section(record, "host")
    wall, dev, pre_wall, pre_dev, pre_n = (
        _positive(float(host.get(k, float("nan"))), f"host.{k}")
        for k in ("wall_ms_per_dispatch", "device_ms_per_dispatch", "prefill_wall_ms",
                  "prefill_device_ms", "prefill_dispatches"))
    pre_host = (pre_wall - pre_dev) * 1000.0 / pre_n
    if not (math.isfinite(pre_host) and pre_host >= 0):
        raise ValueError(f"calibration: prefill host overhead {pre_host} µs is negative")
    ho = _section(record, "handoff")
    blocks = _floats(ho, "blocks", 2, "handoff")
    ho_ms = _floats(ho, "ms", 2, "handoff")
    block_bytes = _positive(float(ho.get("block_bytes", float("nan"))), "handoff.block_bytes")
    rate_bps = (blocks[1] - blocks[0]) * block_bytes / ((ho_ms[1] - ho_ms[0]) * 1e-3)
    fixed_us = ho_ms[0] * 1000.0 - blocks[0] * block_bytes / rate_bps * 1e6
    head = _section(record, "headline")
    for k in ("num_requests", "isl", "osl", "tok_s", "p50_ttft_ms"):
        _positive(float(head.get(k, float("nan"))), f"headline.{k}")
    return Calibration(
        card=d.card,
        decode_time_per_step_us=d.decode_time_per_step_us,
        decode_time_per_lane_us=d.decode_time_per_lane_us,
        decode_hbm_gbps=d.decode_hbm_gbps,
        weight_bytes_per_step=d.weight_bytes_per_step,
        prefill_dispatch_base_us=d.prefill_dispatch_base_us,
        prefill_time_per_token_us=_positive(a, "prefill per-token µs"),
        prefill_quadratic_us=b,
        prefill_quadratic_free_us=b_free,
        host_overhead_us=_positive((wall - dev) * 1000.0, "host overhead µs"),
        prefill_host_overhead_us=pre_host,
        handoff_gbps=_positive(rate_bps / 1e9, "handoff GB/s"),
        handoff_fixed_us=_positive(fixed_us, "handoff fixed µs"),
        headline=dict(head),
        engine=dict(record.get("engine") or {}),
    )


def load(path: str | Path = ARTIFACT) -> Calibration:
    """The law over the artifact at ``path`` (the committed H100 record
    by default). A missing file raises ``FileNotFoundError``; a
    malformed one ``ValueError``."""
    try:
        record = json.loads(Path(path).read_text())
    except json.JSONDecodeError as exc:
        raise ValueError(f"calibration artifact {path} is not JSON: {exc}") from None
    if not isinstance(record, dict):
        raise ValueError(f"calibration artifact {path} is not a JSON object")
    return derive(record)


def record_from_bench(path: str | Path) -> dict:
    """The decode half of a calibration record from a bench artifact of
    the JAX package's layout (``parsed.extras``: ``decode_step_ms`` at 64
    lanes, ``decode_step_ms_b32c16`` at 32, ``effective_hbm_gbps`` of
    the 64-lane step, and the headline)."""
    d = json.loads(Path(path).read_text())
    parsed = d.get("parsed") or {}
    ex = parsed.get("extras") or {}
    ms64 = float(ex["decode_step_ms"])
    return {
        "schema": SCHEMA,
        "card": f"bench artifact {Path(path).name}",
        "decode": {
            "lanes": [32, 64],
            "device_ms": [float(ex["decode_step_ms_b32c16"]), ms64],
            "streamed_bytes": float(ex["effective_hbm_gbps"]) * 1e9 * ms64 * 1e-3,
        },
        "headline": {
            "tok_s": float(parsed["value"]),
            "p50_ttft_ms": float(ex["p50_ttft_ms"]),
            "num_requests": int(ex["num_requests"]),
            "isl": int(ex["isl"]),
            "osl": int(ex["osl"]),
        },
    }


# -- the published constants: the law over the committed H100 artifact -----
# Read at first use, not at import: ``calibration.DECODE_TIME_PER_STEP_US``
# and the rest resolve through the module's ``__getattr__``.
_CONSTANTS = {
    "CALIBRATION": None,
    "CARD": "card",
    "DECODE_TIME_PER_STEP_US": "decode_time_per_step_us",
    "DECODE_TIME_PER_LANE_US": "decode_time_per_lane_us",
    "DECODE_HBM_GBPS": "decode_hbm_gbps",
    "WEIGHT_BYTES_PER_STEP": "weight_bytes_per_step",
    "PREFILL_TIME_PER_TOKEN_US": "prefill_time_per_token_us",
    "PREFILL_QUADRATIC_US": "prefill_quadratic_us",
    "PREFILL_DISPATCH_BASE_US": "prefill_dispatch_base_us",
    "HOST_OVERHEAD_US": "host_overhead_us",
    "PREFILL_HOST_OVERHEAD_US": "prefill_host_overhead_us",
    "HANDOFF_GBPS": "handoff_gbps",
    "HANDOFF_FIXED_US": "handoff_fixed_us",
    "HEADLINE": "headline",
}


@functools.lru_cache(maxsize=1)
def committed() -> Calibration:
    """The law over the committed artifact, read once."""
    return load()


def __getattr__(name: str):
    if name not in _CONSTANTS:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    field_name = _CONSTANTS[name]
    c = committed()
    return c if field_name is None else getattr(c, field_name)


def kv_quant_bytes_ratio(
    block_size: int = 16,
    num_layers: int = 16,
    num_kv_heads: int = 8,
    head_dim: int = 64,
    dtype_bytes: int = 2,
) -> float:
    """Stored-KV bytes of an int8 block (data and its f32 per-(layer,
    K/V, head) scales) over the bf16 layout's (defaults: llama3.2-1b;
    ~0.502)."""
    data = num_layers * 2 * block_size * num_kv_heads * head_dim
    scales = num_layers * 2 * num_kv_heads * 4
    return (data + scales) / (data * dtype_bytes)


def kv_bytes_per_token(quant: str | None = None) -> float:
    """Handoff / HBM bytes per token of the llama3.2-1b layout at the
    given KV precision (None = bf16)."""
    if quant == "int8":
        return KV_BYTES_PER_TOKEN * kv_quant_bytes_ratio()
    return float(KV_BYTES_PER_TOKEN)


def weight_quant_bytes_ratio(in_dim: int = 2048, dtype_bytes: int = 2) -> float:
    """Bytes of an int8 weight matrix (int8 data and one f32 scale per
    output channel) over the bf16 layout's: ``(in + 4) / (in · 2)`` per
    output column (default: llama3.2-1b's 2048 hidden dims, ~0.501)."""
    return (in_dim * 1 + 4) / (in_dim * dtype_bytes)


def weight_bytes_per_step(weight_quant: str | None = None) -> float:
    """Weight bytes one dispatch streams at the given weight precision
    (None = bf16, the recorded pass)."""
    base = committed().weight_bytes_per_step
    if weight_quant:
        return base * weight_quant_bytes_ratio()
    return base


def calibrated_mocker_config(calibration: Calibration | None = None, **overrides):
    """A MockerConfig priced by a calibration (the committed one by
    default): what the fleet simulator replays, and a live mocker that
    approximates the card's pacing. ``MockerConfig``'s own defaults keep
    these terms off."""
    # Deferred: the router's scheduler imports this module for
    # HANDOFF_GBPS, and the mocker pulls in the engine.
    from dynamo_tpu_torch.mocker.engine import MockerConfig

    c = calibration or committed()
    kw = dict(
        prefill_time_per_token_us=c.prefill_time_per_token_us,
        prefill_quadratic_us=c.prefill_quadratic_us,
        decode_time_per_step_us=c.decode_time_per_step_us,
        decode_time_per_lane_us=c.decode_time_per_lane_us,
        prefill_dispatch_base_us=c.prefill_dispatch_base_us,
        # Bytes-priced weight pass: inert until decode_hbm_gbps is also
        # set (bytes / rate then round-trips to the flat base).
        weight_bytes_per_step=c.weight_bytes_per_step,
    )
    kw.update(overrides)
    return MockerConfig(**kw)


def handoff_seconds(
    isl_tokens: int,
    link_gbps: float | None = None,
    kv_quant: str | None = None,
) -> float:
    """Prefill→decode KV handoff time of one prompt over a link of
    ``link_gbps`` (the calibrated rate by default): the fixed cost plus
    bytes / rate, the bytes at the given KV precision."""
    c = committed()
    rate = c.handoff_gbps if link_gbps is None else link_gbps
    bytes_ = isl_tokens * kv_bytes_per_token(kv_quant)
    return c.handoff_fixed_us / 1e6 + bytes_ / (rate * 1e9)
