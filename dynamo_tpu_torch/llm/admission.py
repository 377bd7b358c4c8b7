"""Ingress admission control (port of dynamo_tpu/llm/admission.py):
refuse excess load at the HTTP boundary.

- a hard cap on concurrently admitted requests (``max_inflight``);
- watermarks fed by the engine's live readiness snapshot: the waiting
  list's depth (``max_engine_waiting``) and the un-prefilled prompt
  tokens (``max_prefill_backlog_tokens``);
- a ``draining`` latch flipped by graceful shutdown: new work is refused
  with 503 while admitted requests finish.

Rejections raise ``AdmissionRejected`` carrying a ``Retry-After`` hint
that grows with the overload on the axis that tripped, clamped to
``[retry_after_s, retry_after_max_s]``; the HTTP service maps capacity
rejections to 429 and draining to 503. Every rejection is noted in
``OVERLOAD``.

Not in this slice: SLO request classes and their watermark scales, the
KV-usage watermark and default deadlines (ROADMAP queue A).
"""

from __future__ import annotations

import logging
from dataclasses import dataclass

from dynamo_tpu_torch.utils.overload import OVERLOAD

logger = logging.getLogger(__name__)


class AdmissionRejected(RuntimeError):
    """Refused at the admission gate. ``draining`` distinguishes the
    going-away rejection (HTTP 503) from capacity rejection (HTTP 429)."""

    def __init__(
        self, reason: str, retry_after_s: float, draining: bool = False
    ) -> None:
        super().__init__(reason)
        self.reason = reason
        self.retry_after_s = retry_after_s
        self.draining = draining


@dataclass
class AdmissionConfig:
    max_inflight: int = 256
    # Reject while the engine has this many requests queued (0 = off).
    max_engine_waiting: int = 0
    # Reject while the engine's un-prefilled backlog exceeds this many
    # prompt tokens (0 = off).
    max_prefill_backlog_tokens: int = 0
    retry_after_s: float = 1.0
    retry_after_max_s: float = 30.0


class _Permit:
    """Admission slot: released on exit, exactly once."""

    def __init__(self, controller: "AdmissionController") -> None:
        self._c = controller
        self._released = False

    def __enter__(self) -> "_Permit":
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    def release(self) -> None:
        if not self._released:
            self._released = True
            self._c._inflight -= 1


class AdmissionController:
    def __init__(self, cfg: AdmissionConfig | None = None, engine_stats=None) -> None:
        """``engine_stats``: zero-arg callable returning the engine's
        readiness snapshot (TorchEngine.readiness) or None — the
        watermarks' feed."""
        self.cfg = cfg or AdmissionConfig()
        self._engine_stats = engine_stats
        self._inflight = 0
        self._draining = False
        self.admitted_total = 0
        self.rejected: dict[str, int] = {}
        self.retry_after_by_reason: dict[str, float] = {}

    @property
    def draining(self) -> bool:
        return self._draining

    def begin_drain(self) -> None:
        if not self._draining:
            self._draining = True
            logger.info("admission gate draining: refusing new requests")

    @property
    def inflight(self) -> int:
        return self._inflight

    def _retry_hint(self, reason: str, stats: dict) -> float:
        """base * (live value / watermark) on the axis that tripped,
        clamped to [base, max]."""
        cfg = self.cfg
        pressure = 1.0
        if reason == "engine_waiting":
            pressure = stats.get("num_requests_waiting", 0) / max(
                cfg.max_engine_waiting, 1.0
            )
        elif reason == "prefill_backlog":
            pressure = stats.get("prefill_backlog_tokens", 0) / max(
                cfg.max_prefill_backlog_tokens, 1.0
            )
        elif reason == "inflight_cap":
            pressure = self._inflight / max(cfg.max_inflight, 1.0)
        hint = min(cfg.retry_after_max_s, cfg.retry_after_s * max(1.0, pressure))
        self.retry_after_by_reason[reason] = round(hint, 2)
        return hint

    def _reject(self, reason: str, stats: dict | None = None,
                draining: bool = False) -> None:
        self.rejected[reason] = self.rejected.get(reason, 0) + 1
        OVERLOAD.note_shed(f"admission.{reason}")
        hint = (
            self._retry_hint(reason, stats)
            if stats is not None
            else self.cfg.retry_after_s
        )
        raise AdmissionRejected(reason, hint, draining=draining)

    def admit(self) -> _Permit:
        """One admission decision; raises AdmissionRejected or returns a
        permit the caller must release (a context manager)."""
        if self._draining:
            self._reject("draining", draining=True)
        cfg = self.cfg
        if self._inflight >= cfg.max_inflight:
            self._reject("inflight_cap", {})
        if (cfg.max_engine_waiting or cfg.max_prefill_backlog_tokens) and self._engine_stats:
            stats = self._probe()
            if (
                cfg.max_engine_waiting
                and stats.get("num_requests_waiting", 0) >= cfg.max_engine_waiting
            ):
                self._reject("engine_waiting", stats)
            if (
                cfg.max_prefill_backlog_tokens
                and stats.get("prefill_backlog_tokens", 0)
                >= cfg.max_prefill_backlog_tokens
            ):
                self._reject("prefill_backlog", stats)
        self._inflight += 1
        self.admitted_total += 1
        return _Permit(self)

    def _probe(self) -> dict:
        try:
            return self._engine_stats() or {}
        except Exception:  # noqa: BLE001 — a broken probe must not 500 admission
            logger.exception("admission engine-stats probe failed")
            return {}

    def snapshot(self) -> dict:
        return {
            "inflight": self._inflight,
            "admitted_total": self.admitted_total,
            "rejected": dict(self.rejected),
            "rejected_total": sum(self.rejected.values()),
            "retry_after_by_reason": dict(self.retry_after_by_reason),
            "draining": self._draining,
        }
