"""Ingress admission control (port of dynamo_tpu/llm/admission.py):
refuse excess load at the HTTP boundary.

- a hard cap on concurrently admitted requests (``max_inflight``);
- watermarks fed by the engine's live readiness snapshot: the waiting
  list's depth (``max_engine_waiting``), the KV blocks in use
  (``max_kv_usage``) and the un-prefilled prompt tokens
  (``max_prefill_backlog_tokens``);
- a ``draining`` latch flipped by graceful shutdown: new work is refused
  with 503 while admitted requests finish.

SLO-class-weighted watermarks (llm/slo.py): each request carries a
class (interactive | batch, from the ``X-Request-Class`` header with a
configured default), and a class's effective cap and watermarks are the
configured ones scaled by ``class_watermark_scale`` — batch trips at
(by default) half the pressure interactive does, so degradation is
cheapest-first. ``default_deadline_s`` is the deadline the HTTP service
applies when a client sends no ``X-Request-Timeout-Ms``.

Rejections raise ``AdmissionRejected`` carrying a ``Retry-After`` hint
that grows with the overload on the axis that tripped, clamped to
``[retry_after_s, retry_after_max_s]``; the HTTP service maps capacity
rejections to 429 and draining to 503. Every rejection is noted in
``OVERLOAD`` with its class.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass, field

from dynamo_tpu_torch.llm import slo
from dynamo_tpu_torch.utils.deadline import OVERLOAD

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
    # Reject while the engine's KV block arena is this full, in [0, 1]
    # (0 = off): admitted work would only evict or preempt.
    max_kv_usage: float = 0.0
    # Deadline applied when the client sends none (0 = no default).
    default_deadline_s: float = 0.0
    retry_after_s: float = 1.0
    retry_after_max_s: float = 30.0
    # The class assumed without an X-Request-Class header, and each
    # class's watermark scale (effective = configured * scale; scales
    # above 1.0 are clamped: no class outranks the configured watermark).
    default_request_class: str = slo.INTERACTIVE
    class_watermark_scale: dict = field(
        default_factory=lambda: {slo.INTERACTIVE: 1.0, slo.BATCH: 0.5}
    )

    def scale_for(self, request_class: str) -> float:
        return min(1.0, float(self.class_watermark_scale.get(request_class, 1.0)))


class _Permit:
    """Admission slot: released on exit, exactly once."""

    def __init__(self, controller: "AdmissionController", request_class: str) -> None:
        self._c = controller
        self.request_class = request_class
        self._released = False

    def __enter__(self) -> "_Permit":
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    def release(self) -> None:
        if not self._released:
            self._released = True
            self._c._inflight -= 1
            by_class = self._c._inflight_by_class
            by_class[self.request_class] = max(0, by_class.get(self.request_class, 0) - 1)


class AdmissionController:
    def __init__(self, cfg: AdmissionConfig | None = None, engine_stats=None) -> None:
        """``engine_stats``: zero-arg callable returning the engine's
        readiness snapshot (TorchEngine.readiness) or None — the
        watermarks' feed."""
        self.cfg = cfg or AdmissionConfig()
        self._engine_stats = engine_stats
        self._inflight = 0
        self._inflight_by_class: dict[str, int] = {}
        self._draining = False
        self.admitted_total = 0
        self.admitted_by_class: dict[str, int] = {}
        self.rejected: dict[str, int] = {}
        self.rejected_by_class: dict[str, int] = {}
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

    def _retry_hint(self, reason: str, stats: dict, scale: float) -> float:
        """base * (live value / effective watermark) on the axis that
        tripped, clamped to [base, max]."""
        cfg = self.cfg
        pressure = 1.0
        if reason == "engine_waiting" and cfg.max_engine_waiting:
            pressure = stats.get("num_requests_waiting", 0) / max(
                cfg.max_engine_waiting * scale, 1.0
            )
        elif reason == "prefill_backlog" and cfg.max_prefill_backlog_tokens:
            pressure = stats.get("prefill_backlog_tokens", 0) / max(
                cfg.max_prefill_backlog_tokens * scale, 1.0
            )
        elif reason == "kv_watermark" and cfg.max_kv_usage:
            pressure = stats.get("gpu_cache_usage_perc", 0.0) / max(
                cfg.max_kv_usage * scale, 1e-6
            )
        elif reason == "inflight_cap":
            pressure = self._inflight / max(cfg.max_inflight * scale, 1.0)
        hint = min(cfg.retry_after_max_s, cfg.retry_after_s * max(1.0, pressure))
        self.retry_after_by_reason[reason] = round(hint, 2)
        return hint

    def _reject(self, reason: str, request_class: str, stats: dict | None = None,
                scale: float = 1.0, draining: bool = False) -> None:
        self.rejected[reason] = self.rejected.get(reason, 0) + 1
        self.rejected_by_class[request_class] = (
            self.rejected_by_class.get(request_class, 0) + 1
        )
        OVERLOAD.note_shed(f"admission.{reason}", request_class=request_class)
        hint = (
            self._retry_hint(reason, stats, scale)
            if stats is not None
            else self.cfg.retry_after_s
        )
        raise AdmissionRejected(reason, hint, draining=draining)

    def admit(self, request_class: str | None = None) -> _Permit:
        """One admission decision; raises AdmissionRejected or returns a
        permit the caller must release (a context manager). The class
        scales the cap and every watermark: batch refuses at lower
        pressure so interactive keeps the headroom."""
        cls = slo.normalize_class(request_class, self.cfg.default_request_class)
        if self._draining:
            self._reject("draining", cls, draining=True)
        cfg = self.cfg
        scale = cfg.scale_for(cls)
        if self._inflight >= cfg.max_inflight * scale:
            self._reject("inflight_cap", cls, {}, scale)
        if (
            cfg.max_engine_waiting or cfg.max_kv_usage or cfg.max_prefill_backlog_tokens
        ) and self._engine_stats:
            stats = self._probe()
            if (
                cfg.max_engine_waiting
                and stats.get("num_requests_waiting", 0)
                >= cfg.max_engine_waiting * scale
            ):
                self._reject("engine_waiting", cls, stats, scale)
            if (
                cfg.max_kv_usage
                and stats.get("gpu_cache_usage_perc", 0.0) >= cfg.max_kv_usage * scale
            ):
                self._reject("kv_watermark", cls, stats, scale)
            if (
                cfg.max_prefill_backlog_tokens
                and stats.get("prefill_backlog_tokens", 0)
                >= cfg.max_prefill_backlog_tokens * scale
            ):
                self._reject("prefill_backlog", cls, stats, scale)
        self._inflight += 1
        self._inflight_by_class[cls] = self._inflight_by_class.get(cls, 0) + 1
        self.admitted_total += 1
        self.admitted_by_class[cls] = self.admitted_by_class.get(cls, 0) + 1
        return _Permit(self, cls)

    def _probe(self) -> dict:
        try:
            return self._engine_stats() or {}
        except Exception:  # noqa: BLE001 — a broken probe must not 500 admission
            logger.exception("admission engine-stats probe failed")
            return {}

    def snapshot(self) -> dict:
        return {
            "inflight": self._inflight,
            "inflight_by_class": dict(self._inflight_by_class),
            "admitted_total": self.admitted_total,
            "admitted_by_class": dict(self.admitted_by_class),
            "rejected": dict(self.rejected),
            "rejected_by_class": dict(self.rejected_by_class),
            "rejected_total": sum(self.rejected.values()),
            "retry_after_by_reason": dict(self.retry_after_by_reason),
            "draining": self._draining,
        }
