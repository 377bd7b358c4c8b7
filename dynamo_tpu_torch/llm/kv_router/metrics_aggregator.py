"""Periodic scrape of every worker's ``load_metrics`` endpoint (port of
dynamo_tpu/llm/kv_router/metrics_aggregator.py).

Produces a ``ProcessedEndpoints`` snapshot for the selector: each worker
serves ``load_metrics`` (kv_router/publisher.py) and the aggregator asks
every live instance through a direct-mode ``PushRouter``, each under a
timeout. A worker whose scrape fails keeps its last-known snapshot for
``endpoint_ttl_s``, then drops out; ``mark_dead`` drops it at once; a
snapshot older than the TTL is ``stale`` and forces a coalesced scrape.
"""

from __future__ import annotations

import asyncio
import logging
import time
from dataclasses import dataclass, field

from dynamo_tpu_torch.llm.kv_router.protocols import (
    KV_METRICS_ENDPOINT,
    ForwardPassMetrics,
)
from dynamo_tpu_torch.runtime.component import Component
from dynamo_tpu_torch.runtime.egress import Client, PushRouter, RouterMode
from dynamo_tpu_torch.runtime.engine import Context

logger = logging.getLogger(__name__)


@dataclass
class ProcessedEndpoints:
    """Live worker set + their latest load metrics."""

    metrics: dict[int, ForwardPassMetrics] = field(default_factory=dict)
    stamp: float = 0.0

    def age_s(self, now: float | None = None) -> float:
        """Seconds since this snapshot was produced (monotonic). A never-
        scraped snapshot (stamp 0) reports a very large age so staleness
        checks treat it as unusable rather than fresh."""
        now = time.monotonic() if now is None else now
        return now - self.stamp if self.stamp else float("inf")

    @property
    def worker_ids(self) -> list[int]:
        return list(self.metrics)

    @property
    def load_avg(self) -> float:
        if not self.metrics:
            return 0.0
        return sum(m.kv_active_blocks for m in self.metrics.values()) / len(
            self.metrics
        )


class KvMetricsAggregator:
    def __init__(
        self, drt, component: Component, interval_s: float = 0.5,
        scrape_timeout_s: float = 2.0, endpoint_ttl_s: float = 5.0,
    ) -> None:
        self._drt = drt
        self._component = component
        self.interval_s = interval_s
        self.scrape_timeout_s = scrape_timeout_s
        # How long a worker's LAST-KNOWN metrics stay scoreable across
        # failed scrapes. A transient blip (one timed-out scrape) keeps
        # the previous snapshot so routing doesn't flap; past the TTL the
        # entry is dropped — the selector must not keep scoring a dead
        # worker's stale load.
        self.endpoint_ttl_s = endpoint_ttl_s
        self.endpoints = ProcessedEndpoints()
        # Per-endpoint scrape failures and whole-pass failures, counted:
        # a dead metrics plane must not look like an idle one.
        self.scrape_failures_total = 0
        self.stale_endpoint_drops_total = 0
        self._last_seen: dict[int, float] = {}   # wid -> monotonic stamp
        self._router: PushRouter | None = None
        self._task: asyncio.Task | None = None
        self._updated = asyncio.Event()
        # Coalesces caller-forced scrapes (scrape_coalesced): N routing
        # decisions hitting a stale snapshot must produce ONE fleet-wide
        # scrape, not N simultaneous storms against a degraded plane.
        self._scrape_gate = asyncio.Lock()
        # Called after every successful scrape (e.g. the selector's
        # predicted-load reset).
        self.on_update: list = []

    async def start(self) -> "KvMetricsAggregator":
        endpoint = self._component.endpoint(KV_METRICS_ENDPOINT)
        client = await Client.create(self._drt, endpoint.id)
        self._router = PushRouter(self._drt, client, RouterMode.DIRECT)
        self._task = asyncio.ensure_future(self._run())
        self._drt.runtime.token.on_cancel(
            lambda: self._task.cancel() if self._task else None
        )
        return self

    async def _run(self) -> None:
        while True:
            try:
                await self.scrape()
            except asyncio.CancelledError:
                return
            except Exception:
                # Counted, not just logged: a scrape loop that dies every
                # pass leaves `endpoints` frozen at its last snapshot, and
                # the selector would otherwise keep scoring that ghost
                # fleet forever (the `stale` check is the backstop).
                self.scrape_failures_total += 1
                logger.exception("metrics scrape failed")
            await asyncio.sleep(self.interval_s)

    def mark_dead(self, worker_id: int) -> None:
        """Drop a worker's load snapshot NOW (the router's mark-dead
        fast path): a dispatch-time connection error proved the worker
        is a corpse, and its last-known metrics must stop being
        scoreable immediately — not linger until ``endpoint_ttl_s``
        ages them out."""
        if self.endpoints.metrics.pop(worker_id, None) is not None:
            self.stale_endpoint_drops_total += 1
        self._last_seen.pop(worker_id, None)

    @property
    def stale(self) -> bool:
        """True when the snapshot is older than the endpoint TTL — the
        selector must force a scrape (or decline to score) rather than
        rank workers by a dead plane's last-known load."""
        return self.endpoints.age_s() > self.endpoint_ttl_s

    async def scrape_coalesced(self) -> ProcessedEndpoints:
        """Single-flight forced scrape: concurrent callers serialize on
        the gate, and a follower whose wait was satisfied by the leader's
        scrape returns the now-fresh snapshot instead of launching its
        own fleet-wide fan-out (each scrape is a per-endpoint 2 s-timeout
        broadcast — N inflight requests must not multiply it). The
        stamp-advanced check matters when the fleet is UNREACHABLE: the
        leader's scrape then yields a fresh-but-EMPTY snapshot, and
        followers must accept it rather than each re-running the full
        timeout fan-out serialized behind the gate."""
        stamp0 = self.endpoints.stamp
        async with self._scrape_gate:
            refreshed = self.endpoints.stamp > stamp0
            if (refreshed or self.endpoints.metrics) and not self.stale:
                return self.endpoints
            return await self.scrape()

    async def _scrape_one(self, instance_id: int) -> ForwardPassMetrics | None:
        async for item in self._router.direct(Context({}), instance_id):
            return ForwardPassMetrics.from_wire(item)
        return None

    async def scrape(self) -> ProcessedEndpoints:
        """Scrape all live instances concurrently, each under a timeout (a
        hung worker must not stall the whole metrics plane)."""
        assert self._router is not None
        instances = self._router.client.instances()
        results = await asyncio.gather(
            *[
                asyncio.wait_for(
                    self._scrape_one(inst.instance_id), self.scrape_timeout_s
                )
                for inst in instances
            ],
            return_exceptions=True,
        )
        now = time.monotonic()
        metrics: dict[int, ForwardPassMetrics] = {}
        for inst, res in zip(instances, results):
            wid = inst.instance_id
            if isinstance(res, ForwardPassMetrics):
                metrics[wid] = res
                self._last_seen[wid] = now
            else:
                self.scrape_failures_total += 1
                logger.warning("scrape of %#x failed: %r", wid, res)
                # Retain the last-known snapshot through a transient blip;
                # drop it once the worker has been unreachable past the
                # TTL (stale-after-TTL: the selector stops scoring it).
                prev = self.endpoints.metrics.get(wid)
                seen = self._last_seen.get(wid)
                if prev is not None and seen is not None:
                    if now - seen <= self.endpoint_ttl_s:
                        metrics[wid] = prev
                    else:
                        self.stale_endpoint_drops_total += 1
        # Workers no longer in the instance list (lease expiry) age out of
        # _last_seen too, so the stamp map can't grow unboundedly.
        live = {inst.instance_id for inst in instances}
        for wid in list(self._last_seen):
            if wid not in live:
                del self._last_seen[wid]
        self.endpoints = ProcessedEndpoints(metrics=metrics, stamp=now)
        self._updated.set()
        for cb in self.on_update:
            try:
                cb()
            except Exception:
                logger.exception("metrics on_update callback failed")
        return self.endpoints

    async def stop(self) -> None:
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass
            self._task = None

    async def wait_updated(self, timeout_s: float = 2.0) -> ProcessedEndpoints:
        self._updated.clear()
        await asyncio.wait_for(self._updated.wait(), timeout_s)
        return self.endpoints
