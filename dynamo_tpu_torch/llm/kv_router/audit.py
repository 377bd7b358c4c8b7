"""Route-decision audit plane (port of dynamo_tpu/llm/kv_router/audit.py).

Every KV-mode routing decision produces a :class:`RouteAuditRecord`: the
full candidate score field, the predicted overlap, the indexer's event
watermark at score time, the metrics snapshot's age and the decision
latency. Records land in a process-wide bounded ring served at
``/debug/routes`` (llm/http_service.py) and stream into the
``DYNTPU_TRACE`` capture as ``kind="route"`` lines — the predicted half
of the loop ``tools/route_audit.py`` closes against the engine's
``kind="kv_actual"`` records.

``ROUTE_OBS`` is a process-wide singleton, like ``utils.faults.FAULTS``:
routers register a gauge provider on start, so both /metrics surfaces
export router-plane gauges (indexer staleness, scrape failures, route
counts) without threading handles through every constructor.
"""

from __future__ import annotations

import logging
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable

from dynamo_tpu_torch.utils.concurrency import make_lock

logger = logging.getLogger(__name__)


@dataclass
class RouteAuditRecord:
    """One KV-mode routing decision, fully explained."""

    request_id: str
    trace_id: str
    worker_id: int                 # chosen
    overlap_blocks: int            # predicted prefix overlap (blocks)
    isl_blocks: int
    logit: float
    decision_ms: float             # indexer query + selector walk
    candidates: list[dict] = field(default_factory=list)
    # Indexer event watermark at score time: events applied / pending
    # (+ per-shard pending for sharded indexers) — the staleness context
    # a misprediction is judged against.
    indexer: dict = field(default_factory=dict)
    indexer_shards: int = 1
    metrics_age_ms: float = 0.0    # age of the load snapshot scored
    # Which router replica decided: route_audit.py groups the
    # predicted-vs-actual error per replica and bounds each.
    replica_id: int = 0
    unix: float = field(default_factory=time.time)

    def to_wire(self) -> dict[str, Any]:
        return {
            "kind": "route",
            "id": self.request_id,
            "trace": self.trace_id,
            "worker_id": self.worker_id,
            "overlap_blocks": self.overlap_blocks,
            "isl_blocks": self.isl_blocks,
            "logit": round(self.logit, 6),
            "decision_ms": round(self.decision_ms, 3),
            "candidates": self.candidates,
            "indexer": self.indexer,
            "indexer_shards": self.indexer_shards,
            "metrics_age_ms": round(self.metrics_age_ms, 1),
            "replica_id": self.replica_id,
            "unix": round(self.unix, 6),
        }


class RouteObservatory:
    """Process-wide ring of route decisions + router gauge providers."""

    def __init__(self, capacity: int = 2048) -> None:
        self._lock = make_lock("route_obs")
        self._ring: deque[RouteAuditRecord] = deque(maxlen=capacity)
        self.routes_total = 0
        self.predicted_blocks_total = 0
        # Zero-arg callables returning {gauge_name: number}; registered by
        # each live KvRouter (indexer staleness, aggregator failures).
        self._providers: list[Callable[[], dict]] = []

    def record(self, rec: RouteAuditRecord) -> None:
        with self._lock:
            self._ring.append(rec)
            self.routes_total += 1
            self.predicted_blocks_total += max(0, rec.overlap_blocks)

    def snapshot(self, n: int = 64) -> dict[str, Any]:
        """Most recent n decisions + ring totals (/debug/routes)."""
        with self._lock:
            recent = list(self._ring)[-n:] if n > 0 else []
            total = self.routes_total
            predicted = self.predicted_blocks_total
        return {
            "routes_total": total,
            "predicted_blocks_total": predicted,
            "recent": [r.to_wire() for r in recent],
            "gauges": self.gauges(),
        }

    # -- gauge providers ----------------------------------------------------
    def register_provider(self, fn: Callable[[], dict]) -> None:
        with self._lock:
            if fn not in self._providers:
                self._providers.append(fn)

    def unregister_provider(self, fn: Callable[[], dict]) -> None:
        with self._lock:
            if fn in self._providers:
                self._providers.remove(fn)

    def gauges(self) -> dict[str, float]:
        """Merged router-plane gauges for the /metrics surfaces. Provider
        faults are swallowed (a probe must never take down a scrape).
        Colliding names across providers merge by family: ``*_total``
        counters SUM (N routers in one process export their combined
        count); everything else — quantiles (lag p99), 0/1 flags
        (metrics_stale), ages, shard counts — takes the MAX, since
        summing a p99 or a staleness flag across routers is meaningless
        and max preserves the alarm semantics."""
        # Totals read under the lock with the provider list: a scrape
        # racing record() must not see a routes_total newer than the
        # blocks counter it is averaged against.
        with self._lock:
            out: dict[str, float] = {
                "kv_router_routes_total": float(self.routes_total),
                "kv_router_predicted_blocks_total": float(
                    self.predicted_blocks_total
                ),
            }
            providers = list(self._providers)
        for fn in providers:
            try:
                for k, v in (fn() or {}).items():
                    if not isinstance(v, (int, float)):
                        continue
                    v = float(v)
                    if k in out:
                        out[k] = out[k] + v if k.endswith("_total") else max(
                            out[k], v
                        )
                    else:
                        out[k] = v
            except Exception:  # noqa: BLE001 — metrics probe must not 500 a scrape
                logger.exception("route observatory provider failed")
        return out

    def reset(self) -> None:
        """Test isolation only — serving code never resets counters."""
        with self._lock:
            self._ring.clear()
            self.routes_total = 0
            self.predicted_blocks_total = 0
            self._providers.clear()


ROUTE_OBS = RouteObservatory()
