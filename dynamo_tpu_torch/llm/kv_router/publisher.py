"""Worker-side event and metrics publication (port of
dynamo_tpu/llm/kv_router/publisher.py).

``KvEventPublisher`` forwards the engine's KV-cache events onto the bus
events plane under the worker's component, and its actual-reuse records
onto the hit-rate plane; both calls come from the engine thread and hop
onto the event loop. ``WorkerMetricsPublisher`` holds the latest
``ForwardPassMetrics`` and serves it on the component's ``load_metrics``
endpoint for the aggregator to scrape. Payloads go through the port's
MessagePack codec (runtime/transports/wire.py).
"""

from __future__ import annotations

import asyncio
import logging
import time
from typing import AsyncIterator

from dynamo_tpu_torch.llm.kv_router.protocols import (
    KV_EVENT_PLANE,
    KV_HIT_RATE_PLANE,
    KV_METRICS_ENDPOINT,
    ForwardPassMetrics,
    KvCacheEventData,
    RouterEvent,
)
from dynamo_tpu_torch.runtime.component import Component
from dynamo_tpu_torch.runtime.engine import Context
from dynamo_tpu_torch.runtime.transports import wire
from dynamo_tpu_torch.utils.task import spawn_tracked

logger = logging.getLogger(__name__)


class KvEventPublisher:
    def __init__(self, drt, component: Component, worker_id: int) -> None:
        self._drt = drt
        self._subject = component.event_subject(KV_EVENT_PLANE)
        self._hit_rate_subject = component.event_subject(KV_HIT_RATE_PLANE)
        self.worker_id = worker_id
        self._loop = asyncio.get_running_loop()

    def publish(self, ev: KvCacheEventData) -> None:
        """Thread-safe fire-and-forget publish (called from the engine
        thread's side-channel flush). Stamped with the wall clock so the
        indexer can measure the publish→apply lag."""
        payload = wire.packb(
            RouterEvent(
                self.worker_id, ev, published_unix=time.time()
            ).to_wire()
        )
        self._loop.call_soon_threadsafe(
            lambda: spawn_tracked(
                self._drt.bus.broadcast(self._subject, payload),
                name="kv-event-broadcast",
            )
        )

    def publish_hit_actual(self, rec: dict) -> None:
        """Thread-safe broadcast of an engine-side actual-reuse record on
        the hit-rate plane, closing the loop the router's "predicted"
        payload opens. The bus payload's kind is "actual"; the trace
        capture's twin of the record is kind="kv_actual"."""
        payload = wire.packb(
            {**rec, "kind": "actual", "worker_id": self.worker_id}
        )
        self._loop.call_soon_threadsafe(
            lambda: spawn_tracked(
                self._drt.bus.broadcast(self._hit_rate_subject, payload),
                name="kv-hit-actual-broadcast",
            )
        )

    def publish_engine_event(self, ev) -> None:
        """Adapter for engine.kv_cache.KvEvent callbacks."""
        self.publish(
            KvCacheEventData(
                kind=ev.kind,
                block_hashes=list(ev.block_hashes),
                parent_hash=ev.parent_hash,
                token_ids=ev.token_ids,
            )
        )


class WorkerMetricsPublisher:
    """Latest-value metrics endpoint (watch-channel semantics)."""

    def __init__(self) -> None:
        self.latest = ForwardPassMetrics()

    def publish(self, metrics: ForwardPassMetrics | dict) -> None:
        if isinstance(metrics, dict):
            metrics = ForwardPassMetrics.from_wire(metrics)
        self.latest = metrics

    async def create_endpoint(self, component: Component):
        """Serve `load_metrics` on the worker's component."""
        endpoint = component.endpoint(KV_METRICS_ENDPOINT)
        publisher = self

        class _MetricsEngine:
            async def generate(self, request: Context) -> AsyncIterator[dict]:
                yield publisher.latest.to_wire()

        return await endpoint.serve(_MetricsEngine())
