"""The process-wide shed counter (port of ``OVERLOAD`` in
dynamo_tpu/utils/deadline.py, without the deadline and per-class
counts, which arrive with their slices): every point that refuses a
request to protect the system notes it here, and ``/metrics`` and the
engine's readiness report the total as ``shed_requests_total``."""

from __future__ import annotations

import threading


class OverloadCounters:
    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.shed: dict[str, int] = {}

    def note_shed(self, point: str, n: int = 1) -> None:
        with self._lock:
            self.shed[point] = self.shed.get(point, 0) + n

    @property
    def shed_total(self) -> int:
        with self._lock:
            return sum(self.shed.values())


OVERLOAD = OverloadCounters()
