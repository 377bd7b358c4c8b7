"""Planner observability (port of dynamo_tpu/planner/obs.py).

Every scaling decision lands in three sinks:

- the process-wide ``PLANNER_OBS`` below: scale counters (in total and
  per pool), pool size and draining gauges, crash replacements and the
  age of the last decision, merged into the ``/metrics`` of the
  frontend (llm/http_service.py ``HttpService``), of the worker health
  server (``HealthServer``) and of the exporter
  (llm/metrics_exporter.py), as the router's ``ROUTE_OBS`` is;
- the ``DYNTPU_TRACE`` capture, as ``kind="planner"`` records through
  ``tracer().export``, so tools/trace_merge.py and tools/route_audit.py
  can line decisions up against the requests and routes they caused;
- the planner's own decision JSONL (``decision_log_path``).

Its lock comes from the concurrency checker (``planner_obs``).
"""

from __future__ import annotations

import logging
import time
from collections import deque
from typing import Any

from dynamo_tpu_torch.utils.concurrency import make_lock

logger = logging.getLogger(__name__)


class PlannerObservatory:
    """Process-wide planner decision counters + pool gauges."""

    def __init__(self, capacity: int = 512) -> None:
        self._lock = make_lock("planner_obs")
        self._ring: deque[dict] = deque(maxlen=capacity)
        self.scale_up_total = 0
        self.scale_down_total = 0
        self.replaced_dead_total = 0
        # pool name -> per-pool state
        self._pool_sizes: dict[str, int] = {}
        self._pool_draining: dict[str, int] = {}
        self._pool_up: dict[str, int] = {}
        self._pool_down: dict[str, int] = {}
        self._pool_dead: dict[str, int] = {}
        self._last_decision_unix: float | None = None

    def note_replaced_dead(self, pool: str, n: int = 1) -> dict:
        """A crashed worker was reaped and immediately replaced at
        target size (pools.py ``reap_dead`` — crash, not drain: no
        drain accounting, no grace period). Returns the capture-ready
        ``kind="planner"`` record for the trace stream."""
        now = time.time()
        with self._lock:
            self.replaced_dead_total += n
            self._pool_dead[pool] = self._pool_dead.get(pool, 0) + n
            self._last_decision_unix = now
            rec = {
                "kind": "planner",
                "pool": pool,
                "decision": "replace_dead",
                "replaced": int(n),
                "unix": round(now, 6),
            }
            self._ring.append(rec)
        return rec

    def note_size(self, pool: str, size: int, draining: int = 0) -> None:
        """Live pool-size gauge (set on every spawn/drain, not just on
        adjustment ticks, so the gauge can't lag a mid-window change)."""
        with self._lock:
            self._pool_sizes[pool] = int(size)
            self._pool_draining[pool] = int(draining)

    def note_decision(
        self,
        pool: str,
        decision: str,
        size: int,
        signals: dict[str, Any] | None = None,
        draining: int = 0,
    ) -> dict:
        """Record one adjustment-tick decision. Returns the capture-ready
        ``kind="planner"`` record (the caller streams it through
        ``tracer().export`` — this module stays import-light so the
        exporter can pull gauges without the tracing stack)."""
        now = time.time()
        with self._lock:
            self._pool_sizes[pool] = int(size)
            self._pool_draining[pool] = int(draining)
            if decision == "up":
                self.scale_up_total += 1
                self._pool_up[pool] = self._pool_up.get(pool, 0) + 1
            elif decision == "down":
                self.scale_down_total += 1
                self._pool_down[pool] = self._pool_down.get(pool, 0) + 1
            self._last_decision_unix = now
            rec = {
                "kind": "planner",
                "pool": pool,
                "decision": decision,
                "size": int(size),
                "unix": round(now, 6),
            }
            for k, v in (signals or {}).items():
                if isinstance(v, float):
                    rec[k] = round(v, 4)
                elif isinstance(v, (int, str)):
                    rec[k] = v
            self._ring.append(rec)
        return rec

    def snapshot(self, n: int = 64) -> dict[str, Any]:
        """Most recent n decisions + totals (``/debug`` surface and
        tests)."""
        with self._lock:
            recent = list(self._ring)[-n:] if n > 0 else []
            return {
                "scale_up_total": self.scale_up_total,
                "scale_down_total": self.scale_down_total,
                "pools": dict(self._pool_sizes),
                "recent": recent,
            }

    def gauges(self) -> dict[str, float]:
        """Flat gauge dict for the /metrics surfaces. The last-decision
        age is computed at scrape time (a gauge that only moved on
        decisions would read "fresh" forever on a wedged control loop —
        the age growing without bound is exactly the wedge signal)."""
        with self._lock:
            out: dict[str, float] = {
                "planner_scale_up_total": float(self.scale_up_total),
                "planner_scale_down_total": float(self.scale_down_total),
                "planner_replaced_dead_total": float(
                    self.replaced_dead_total
                ),
            }
            for pool, n in self._pool_dead.items():
                out[f"planner_{pool}_replaced_dead_total"] = float(n)
            for pool, size in self._pool_sizes.items():
                out[f"planner_pool_size_{pool}"] = float(size)
            for pool, n in self._pool_draining.items():
                out[f"planner_pool_draining_{pool}"] = float(n)
            for pool, n in self._pool_up.items():
                out[f"planner_{pool}_scale_up_total"] = float(n)
            for pool, n in self._pool_down.items():
                out[f"planner_{pool}_scale_down_total"] = float(n)
            if self._last_decision_unix is not None:
                out["planner_last_decision_age_s"] = round(
                    max(0.0, time.time() - self._last_decision_unix), 3
                )
        return out

    def reset(self) -> None:
        """Test isolation only — serving code never resets counters."""
        with self._lock:
            self._ring.clear()
            self.scale_up_total = 0
            self.scale_down_total = 0
            self.replaced_dead_total = 0
            self._pool_sizes.clear()
            self._pool_draining.clear()
            self._pool_up.clear()
            self._pool_down.clear()
            self._pool_dead.clear()
            self._last_decision_unix = None


PLANNER_OBS = PlannerObservatory()
