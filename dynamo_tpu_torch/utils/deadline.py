"""Request deadlines + process-wide overload accounting (port of
dynamo_tpu/utils/deadline.py).

Every request may carry an absolute deadline. In-process the deadline is a
``time.monotonic`` instant (immune to wall-clock steps); on the wire it
travels as REMAINING budget milliseconds and re-anchors on receipt, so a
hop's transit time is the only slack it gains (conservative by
milliseconds, never early).

``OVERLOAD`` is the process-wide shed/deadline counter registry (the
pattern of ``utils/faults.FAULTS`` and ``utils/retry.RETRIES``): every
point that sheds load or cancels expired work notes it here, and both
Prometheus surfaces (the HTTP service's and the worker's) export
``shed_requests_total`` / ``deadline_exceeded_total`` from it. Silent
load shedding is indistinguishable from loss — these counters are the
difference.

Shed/expiry points (labels in the snapshot):
- ``admission.*``        HTTP-boundary admission gate (llm/admission.py)
- ``engine.waiting``     scheduler waiting-list depth/age bound
- ``engine.arrival``     request already expired when the engine saw it
- ``engine.queued``      expired while waiting for a batch slot
- ``engine.decode``      expired mid-generation
- ``engine.draining``    a draining engine refusing new work
- ``failover``           expired before a failover replay
"""

from __future__ import annotations

import threading
import time
from typing import Any


class Deadline:
    """An absolute request deadline (monotonic-anchored)."""

    __slots__ = ("at",)

    def __init__(self, at: float) -> None:
        self.at = at  # time.monotonic() instant

    # -- constructors -------------------------------------------------------
    @staticmethod
    def after(budget_s: float) -> "Deadline":
        return Deadline(time.monotonic() + max(0.0, budget_s))

    @staticmethod
    def after_ms(budget_ms: float) -> "Deadline":
        return Deadline.after(budget_ms / 1000.0)

    @staticmethod
    def from_wire(value: Any) -> "Deadline | None":
        """Re-anchor a wire ``deadline_ms`` (remaining budget) locally."""
        if value is None:
            return None
        return Deadline.after_ms(float(value))

    # -- queries ------------------------------------------------------------
    def remaining_s(self) -> float:
        return self.at - time.monotonic()

    def remaining_ms(self) -> float:
        return self.remaining_s() * 1000.0

    @property
    def expired(self) -> bool:
        return time.monotonic() >= self.at

    # -- wire ---------------------------------------------------------------
    def to_wire(self) -> float:
        """Remaining budget in ms (clamped at 0 so an expired deadline
        stays expired after the hop re-anchors it)."""
        return max(0.0, self.remaining_ms())

    def __repr__(self) -> str:  # debugging / log lines
        return f"Deadline(+{self.remaining_s():.3f}s)"


def parse_timeout_ms(value: str | None) -> float | None:
    """Parse the ``X-Request-Timeout-Ms`` header: a positive millisecond
    budget, or None when absent/unparseable (the caller applies its
    configured default)."""
    if not value:
        return None
    try:
        ms = float(value)
    except (TypeError, ValueError):
        return None
    return ms if ms > 0 else None


class OverloadCounters:
    """Thread-safe process-wide shed / deadline-expiry accounting.

    Sheds are additionally split by SLO class (llm/slo.py) when the
    shedding point knows the victim's class — the cheapest-first
    degradation contract (batch absorbs load shedding before
    interactive) is only auditable if the counters carry the split
    (``shed_interactive_total`` / ``shed_batch_total`` on the metric
    surfaces)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.shed: dict[str, int] = {}
        self.deadline: dict[str, int] = {}
        self.shed_class: dict[str, int] = {}

    def note_shed(
        self, point: str, n: int = 1, request_class: str | None = None
    ) -> None:
        with self._lock:
            self.shed[point] = self.shed.get(point, 0) + n
            if request_class:
                self.shed_class[request_class] = (
                    self.shed_class.get(request_class, 0) + n
                )

    def note_deadline(self, point: str, n: int = 1) -> None:
        with self._lock:
            self.deadline[point] = self.deadline.get(point, 0) + n

    @property
    def shed_total(self) -> int:
        with self._lock:
            return sum(self.shed.values())

    def shed_class_total(self, request_class: str) -> int:
        with self._lock:
            return self.shed_class.get(request_class, 0)

    @property
    def deadline_total(self) -> int:
        with self._lock:
            return sum(self.deadline.values())

    def snapshot(self) -> dict[str, dict[str, int]]:
        with self._lock:
            return {
                "shed": dict(self.shed),
                "deadline": dict(self.deadline),
                "shed_by_class": dict(self.shed_class),
            }


OVERLOAD = OverloadCounters()
