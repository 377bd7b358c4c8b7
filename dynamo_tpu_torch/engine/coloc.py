"""SLO-aware prefill/decode co-location controller (port of
dynamo_tpu/engine/coloc.py: the same law, constants and counters).

The unified step mixes decode lanes with chunked-prefill quanta in one
ragged dispatch. This module is the policy for the prefill quantum: the
two phases become separately-managed SLO populations on one card.

The control loop, once per retired unified dispatch that carried decode
lanes:

- **Measure**: the interval the decode lanes just experienced becomes an
  ITL sample — EMA for the control law, a bounded window for the p95 the
  SLO is stated in. The engine takes the sample at retire, when the
  dispatch's completion event is ready, so it is device time as the
  lanes saw it, never the host's issue time.
- **Adapt (AIMD)**: while the EMA sits below
  ``itl_slo_ms * headroom_frac`` (and the dispatch carried prefill
  evidence), the quantum grows additively (+``grow_tokens``); when the
  EMA exceeds the target it shrinks multiplicatively (x``shrink``).
  Between the two thresholds is a deadband: no change.
- **Floor**: the quantum never drops below ``coloc_min_quantum``, so
  prefill never fully starves.
- **Per-phase admission**: NEW prompts join the prefilling population
  only while the headroom permits (``admit_prefill``), bounded by an
  anti-starvation streak.

The quantum is pure batch COMPOSITION: every total still snaps onto the
budget ladder, and a CUDA graph is keyed by (variant, rung, greedy |
sampled) only, so moving the quantum replays graphs captured at warmup
and captures none.

``coloc="static"`` keeps the hand-tuned quantum (the A/B control);
``itl_slo_ms`` alone still measures EMA/p95/violations.
"""

from __future__ import annotations

from collections import deque
from typing import TYPE_CHECKING

if TYPE_CHECKING:  # pragma: no cover
    from dynamo_tpu_torch.engine.config import EngineConfig

# EMA weight for the ITL estimate: ~last 10 dispatches dominate, so the
# loop reacts within a handful of steps without chasing single spikes
# (the p95 window catches sustained tails instead).
EMA_ALPHA = 0.2


class ColocController:
    """Feedback loop from measured decode ITL to the prefill quantum.

    Driven from the engine thread only (observe / quantum /
    admit_prefill); ``snapshot()`` reads plain ints/floats and is safe
    to call from the asyncio thread (same contract as
    ``Scheduler.metrics``).
    """

    def __init__(
        self,
        cfg: "EngineConfig",
        *,
        grow_tokens: int = 16,
        shrink: float = 0.7,
        headroom_frac: float = 0.8,
        window: int = 64,
        max_defer_steps: int = 256,
    ) -> None:
        self.slo_ms = float(cfg.itl_slo_ms)
        self.adaptive = cfg.coloc == "adaptive"
        self.floor = max(1, int(cfg.coloc_min_quantum))
        self.cap = int(cfg.unified_token_budget)
        q = int(cfg.unified_prefill_quantum)
        self.quantum = min(max(q, self.floor), self.cap) if self.adaptive else q
        self.grow_tokens = grow_tokens
        self.shrink = shrink
        self.headroom_frac = headroom_frac
        self.max_defer_steps = max_defer_steps
        self.itl_ema_ms = 0.0
        self._window: deque[float] = deque(maxlen=max(8, window))
        self.itl_slo_violations_total = 0
        self.prefill_deferrals_total = 0
        self._defer_streak = 0
        self.steps_observed = 0

    # -- measurement --------------------------------------------------------
    def observe(
        self, sample_ms: float, decode_lanes: int, prefill_tokens: int
    ) -> None:
        """One retired unified dispatch's timing. Only dispatches that
        carried decode lanes are ITL evidence — a prefill-only dispatch
        has no lane waiting on it (and compose already lifts the quantum
        cap there)."""
        if decode_lanes <= 0 or sample_ms <= 0.0:
            return
        self.steps_observed += 1
        self.itl_ema_ms = (
            sample_ms
            if self.steps_observed == 1
            else EMA_ALPHA * sample_ms + (1.0 - EMA_ALPHA) * self.itl_ema_ms
        )
        self._window.append(sample_ms)
        if self.slo_ms > 0.0 and sample_ms > self.slo_ms:
            self.itl_slo_violations_total += 1
        self._adapt(prefill_tokens)

    def _adapt(self, prefill_tokens: int) -> None:
        if not self.adaptive or self.slo_ms <= 0.0:
            return
        if self.itl_ema_ms > self.slo_ms:
            # Multiplicative decrease on SUSTAINED pressure (the EMA is
            # its own damper: one noise spike can't trigger it, a few
            # consecutive over-SLO dispatches do), floored at the
            # TTFT-progress minimum. The windowed p95 stays out of the
            # control law deliberately — a single oversized sample
            # would otherwise pin shrinking for a whole window (a
            # collapse-to-floor transient); it is the OBSERVED tail the
            # SLO is stated in, reported not steered by.
            self.quantum = max(self.floor, int(self.quantum * self.shrink))
        elif (
            prefill_tokens > 0
            and self.itl_ema_ms < self.slo_ms * self.headroom_frac
        ):
            # Additive increase while headroom exists — but only on
            # EVIDENCE (a dispatch that actually carried prefill at the
            # current quantum): decode-only idle steps say nothing
            # about what a bigger quantum would cost, and growing on
            # them would park the quantum at the cap so the next
            # burst's first dispatch overshoots the SLO in one jump.
            # Each evidence step adds a bounded slice, so overshoot
            # past the deadband is at most one grow step's worth.
            self.quantum = min(self.cap, self.quantum + self.grow_tokens)
        # else: inside the deadband [headroom_frac * slo, slo] — hold.

    # -- derived estimates --------------------------------------------------
    @property
    def itl_p95_ms(self) -> float:
        if not self._window:
            return 0.0
        ordered = sorted(self._window)
        return ordered[min(len(ordered) - 1, int(0.95 * len(ordered)))]

    @property
    def headroom_ms(self) -> float:
        """Estimated ITL slack against the SLO (negative = in
        violation). Meaningless (0.0) when no SLO is configured."""
        if self.slo_ms <= 0.0:
            return 0.0
        return self.slo_ms - self.itl_ema_ms

    @property
    def under_pressure(self) -> bool:
        return (
            self.slo_ms > 0.0
            and self.steps_observed > 0
            and self.itl_ema_ms > self.slo_ms
        )

    # -- per-phase admission ------------------------------------------------
    def admit_prefill(self) -> bool:
        """May a NEW prompt join the co-located prefilling population
        this step? Deferrals are bounded (``max_defer_steps``
        consecutive) so sustained SLO pressure throttles — never
        starves — TTFT progress. Static mode always admits (legacy
        behavior, the A/B control)."""
        if not self.adaptive or not self.under_pressure:
            self._defer_streak = 0
            return True
        if self._defer_streak >= self.max_defer_steps:
            # Anti-starvation valve: the chip can't hold the SLO at all
            # — admit anyway so prompts still progress; upstream
            # admission (prefill_backlog_tokens watermark) sheds.
            self._defer_streak = 0
            return True
        self._defer_streak += 1
        self.prefill_deferrals_total += 1
        return False

    # -- observability -------------------------------------------------------
    def snapshot(self) -> dict:
        """The co-location metric surface (readiness, /metrics)."""
        return {
            "coloc_quantum": self.quantum,
            "itl_ema_ms": round(self.itl_ema_ms, 3),
            "itl_p95_ms": round(self.itl_p95_ms, 3),
            "itl_headroom_ms": round(self.headroom_ms, 3),
            "itl_slo_violations_total": self.itl_slo_violations_total,
            "coloc_prefill_deferrals_total": self.prefill_deferrals_total,
            "coloc_adaptive": int(self.adaptive),
        }
