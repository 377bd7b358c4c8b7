"""KvRouter: the assembled KV-aware routing plane (port of
dynamo_tpu/llm/kv_router/router.py).

Subscribes the worker component's ``kv_events`` subject into a (possibly
sharded) radix indexer, keeps a metrics aggregator scraping worker load,
and exposes ``find_best_match(token_ids)`` plus ``selector_fn``, the
selector of PushRouter's KV mode. Prompts are hashed with the port's
``TokenBlockSequence`` (BLAKE2b), the hashes the port's block pool
registers. Every decision leaves a route-audit record in ``ROUTE_OBS``
and the ``DYNTPU_TRACE`` capture and a ``predicted`` record on the
hit-rate plane — the predicted half of the loop tools/route_audit.py
closes.
"""

from __future__ import annotations

import asyncio
import logging
import random
import time

from dynamo_tpu_torch.llm.kv_router.audit import ROUTE_OBS, RouteAuditRecord
from dynamo_tpu_torch.llm.kv_router.indexer import KvIndexer, KvIndexerSharded
from dynamo_tpu_torch.llm.kv_router.metrics_aggregator import KvMetricsAggregator
from dynamo_tpu_torch.llm.kv_router.protocols import (
    KV_EVENT_PLANE,
    KV_HIT_RATE_PLANE,
    KvCacheEventData,
    RouterEvent,
)
from dynamo_tpu_torch.llm.kv_router.scheduler import (
    DefaultWorkerSelector,
    KvRouterConfig,
    SchedulingDecision,
)
from dynamo_tpu_torch.llm.tokens import TokenBlockSequence
from dynamo_tpu_torch.runtime.component import INSTANCE_ROOT, Component
from dynamo_tpu_torch.runtime.transports import wire
from dynamo_tpu_torch.runtime.transports.store import EventKind
from dynamo_tpu_torch.utils.task import spawn_tracked
from dynamo_tpu_torch.utils.tracing import tracer

logger = logging.getLogger(__name__)


class KvRouter:
    def __init__(
        self,
        drt,
        component: Component,
        cfg: KvRouterConfig | None = None,
        selector: DefaultWorkerSelector | None = None,
        replica_id: int = 0,
    ) -> None:
        """``replica_id`` labels this router's audit records when N
        replicas share one KV event plane: tools/route_audit.py groups
        the predicted-vs-actual error per replica and bounds each."""
        self._drt = drt
        self._component = component
        self.replica_id = replica_id
        self.cfg = cfg or KvRouterConfig()
        self.indexer = (
            KvIndexerSharded(self.cfg.sharded_indexer_shards)
            if self.cfg.sharded_indexer_shards > 0
            else KvIndexer()
        )
        self.selector = selector or DefaultWorkerSelector(self.cfg)
        self.aggregator = KvMetricsAggregator(drt, component)
        self._event_task: asyncio.Task | None = None
        self._prune_task: asyncio.Task | None = None
        self._instance_watch = None
        self._sub = None

    async def start(self) -> "KvRouter":
        self.indexer.start()
        self.aggregator.on_update.append(self.selector.on_metrics)
        await self.aggregator.start()
        # Router-plane gauges (indexer staleness, scrape failures) onto
        # the process's /metrics surfaces.
        ROUTE_OBS.register_provider(self.observability)
        self._sub = await self._drt.bus.subscribe(
            self._component.event_subject(KV_EVENT_PLANE)
        )
        sub = self._sub

        async def pump() -> None:
            async for raw in sub:
                try:
                    ev = RouterEvent.from_wire(wire.unpackb(raw))
                    if ev.event.kind == "worker_dead":
                        # Mark-dead propagation: a SIBLING replica
                        # observed this worker die. Drop its load
                        # snapshot here too — the radix prune rides the
                        # normal apply below — and never re-broadcast
                        # (only the observing replica publishes, so the
                        # plane can't loop).
                        self.aggregator.mark_dead(ev.worker_id)
                    self.indexer.apply(ev)
                except Exception:
                    logger.exception("bad kv event")

        self._event_task = asyncio.ensure_future(pump())

        # Prune dead workers from the radix index on instance-key DELETE
        # (lease expiry / deregistration).
        prefix = (
            f"{INSTANCE_ROOT}{self._component.namespace.name}/"
            f"{self._component.name}/"
        )
        self._instance_watch = await self._drt.store.watch_prefix(prefix)
        watch = self._instance_watch

        async def prune() -> None:
            async for ev in watch:
                if ev.kind is not EventKind.DELETE:
                    continue
                try:
                    wid = int(ev.key.rsplit(":", 1)[-1], 16)
                except ValueError:
                    continue
                logger.info("kv router: dropping dead worker %#x", wid)
                self.indexer.remove_worker(wid)

        self._prune_task = asyncio.ensure_future(prune())
        event_task = self._event_task
        # Bound to this start's objects: a stop() before the runtime's
        # shutdown has already cleared the attributes.
        self._drt.runtime.token.on_cancel(
            lambda: (sub.close(), event_task.cancel(), watch.cancel())
        )
        return self

    def remove_worker(self, worker_id: int) -> None:
        self.indexer.remove_worker(worker_id)

    def note_worker_dead(self, worker_id: int) -> None:
        """PushRouter mark-dead hook (auto-wired through
        ``selector_fn.__self__`` — runtime/egress.py): one dispatch-time
        connection error drops the corpse from both scoring inputs in
        the same step — its load snapshot leaves the metrics aggregator
        and its cached blocks leave the radix index — so the very next
        decision can neither route to it nor credit it with overlap.

        The death is also broadcast over the KV event plane as a
        ``worker_dead`` event, so every sibling router replica stops
        scoring the corpse within one apply instead of waiting out the
        lease TTL or ``endpoint_ttl_s``."""
        self.aggregator.mark_dead(worker_id)
        self.indexer.remove_worker(worker_id)
        payload = wire.packb(
            RouterEvent(
                worker_id,
                KvCacheEventData(kind="worker_dead"),
                published_unix=time.time(),
            ).to_wire()
        )
        spawn_tracked(
            self._drt.bus.broadcast(
                self._component.event_subject(KV_EVENT_PLANE), payload
            ),
            name="kv-worker-dead-broadcast",
        )

    def observability(self) -> dict:
        """Router-plane gauges for the metrics surfaces (registered with
        ROUTE_OBS on start): indexer staleness/size and the aggregator's
        previously-silent failure counters."""
        g = dict(self.indexer.stats())
        age = self.aggregator.endpoints.age_s()
        g.update(
            {
                "aggregator_scrape_failures_total": (
                    self.aggregator.scrape_failures_total
                ),
                "aggregator_stale_endpoint_drops_total": (
                    self.aggregator.stale_endpoint_drops_total
                ),
                "kv_router_metrics_stale": int(self.aggregator.stale),
                "kv_router_metrics_age_ms": (
                    round(1000.0 * age, 1) if age != float("inf") else -1.0
                ),
            }
        )
        return g

    async def find_best_match(
        self, token_ids: list[int], request_id: str | None = None
    ) -> SchedulingDecision | None:
        """Pick the best worker for this prompt; None if no metrics yet
        (or none fresh enough to score). Emits a route-audit record for
        every decision; `request_id` binds it to the request's trace."""
        t0 = time.monotonic()
        hashes = TokenBlockSequence.from_tokens(
            token_ids, block_size=self.cfg.block_size
        ).sequence_hashes()
        # Watermark BEFORE the query: find_matches drains the event queue,
        # so sampling after it would always report pending=0 — hiding
        # exactly the backlog the staleness axis exists to measure.
        watermark = self.indexer.watermark()
        overlaps = await self.indexer.find_matches(hashes)
        endpoints = self.aggregator.endpoints
        if not endpoints.metrics or self.aggregator.stale:
            # First requests race the first scrape — force one. A stale
            # snapshot forces one too: scoring a dead metrics plane's
            # last-known load would keep routing to ghosts. Coalesced:
            # concurrent deciders share one fleet scrape.
            try:
                endpoints = await self.aggregator.scrape_coalesced()
            except Exception:
                self.aggregator.scrape_failures_total += 1
                logger.exception("forced metrics scrape failed")
                return None
        decision = self.selector.select(endpoints, overlaps, len(token_ids))
        if decision is not None:
            decision_ms = 1000.0 * (time.monotonic() - t0)
            self._audit(decision, len(token_ids), decision_ms,
                        watermark, endpoints, request_id)
            self._publish_hit_rate(decision, len(token_ids), request_id)
        return decision

    def _audit(
        self, decision: SchedulingDecision, isl: int, decision_ms: float,
        watermark: dict, endpoints, request_id: str | None,
    ) -> None:
        """Ring + capture + histogram for one decision (never raises —
        the audit plane must not fail a route)."""
        try:
            # if_active: a caller outside PushRouter's route span (direct
            # API use) must not make the audit path OPEN a trace nobody
            # finishes — it would leak until the TTL sweep and inflate
            # abandoned_traces_total, the gauge this plane exports.
            trace_id = (
                tracer().trace_id_if_active(request_id) or ""
                if request_id else ""
            )
            rec = RouteAuditRecord(
                request_id=request_id or "",
                trace_id=trace_id,
                replica_id=self.replica_id,
                worker_id=decision.worker_id,
                overlap_blocks=decision.overlap_blocks,
                isl_blocks=(
                    (isl + self.cfg.block_size - 1) // self.cfg.block_size
                ),
                logit=decision.logit,
                decision_ms=decision_ms,
                candidates=decision.candidates,
                indexer=watermark,
                indexer_shards=(
                    len(self.indexer.shards)
                    if isinstance(self.indexer, KvIndexerSharded)
                    else 1
                ),
                metrics_age_ms=1000.0 * min(endpoints.age_s(), 1e6),
            )
            ROUTE_OBS.record(rec)
            tracer().export(rec.to_wire())
            tracer().observe("route_score", decision_ms)
        except Exception:  # noqa: BLE001 — observability must not fail routing
            logger.exception("route audit record failed")

    def _publish_hit_rate(
        self, decision: SchedulingDecision, isl: int,
        request_id: str | None = None,
    ) -> None:
        """The ``predicted`` record on the hit-rate plane, fire and forget:
        over a control plane a broadcast is a round trip, and awaiting it
        on the request's route (as the JAX package does) holds every
        decision behind the plane's queue of KV events."""
        payload = wire.packb(
            {
                "kind": "predicted",
                "id": request_id or "",
                "trace": (
                    tracer().trace_id_if_active(request_id) or ""
                    if request_id else ""
                ),
                "worker_id": decision.worker_id,
                "isl_blocks": (isl + self.cfg.block_size - 1) // self.cfg.block_size,
                "overlap_blocks": decision.overlap_blocks,
            }
        )
        spawn_tracked(
            self._drt.bus.broadcast(
                self._component.event_subject(KV_HIT_RATE_PLANE), payload
            ),
            name="kv-hit-rate-broadcast",
        )

    async def selector_fn(
        self, payload, instances, request_id: str | None = None
    ) -> int | None:
        """PushRouter KV-mode selector: payload is the preprocessed request
        wire dict; returns the chosen instance id. `request_id` (passed by
        PushRouter when the selector accepts it) binds the route-audit
        record to the request's trace."""
        token_ids = (
            payload.get("token_ids") if isinstance(payload, dict) else None
        ) or []
        live = {inst.instance_id for inst in instances}
        decision = await self.find_best_match(
            list(token_ids), request_id=request_id
        )
        if decision is not None and decision.worker_id in live:
            return decision.worker_id
        if not live:
            raise RuntimeError("no live instances")
        # Metrics unavailable — spread, don't stampede one worker.
        return random.choice(sorted(live))

    async def stop(self) -> None:
        if self._event_task is not None:
            self._sub.close()
            self._event_task.cancel()
            try:
                await self._event_task
            except asyncio.CancelledError:
                pass
            self._event_task = None
        if self._prune_task is not None:
            self._instance_watch.cancel()
            self._prune_task.cancel()
            try:
                await self._prune_task
            except asyncio.CancelledError:
                pass
            self._prune_task = None
        ROUTE_OBS.unregister_provider(self.observability)
        await self.aggregator.stop()
        await self.indexer.stop()


def kv_selector_factory(drt, cfg: KvRouterConfig | None = None):
    """ModelWatcher plug-in: one KvRouter per worker component, created on
    demand, returning its selector for PushRouter's KV mode."""
    routers: dict[tuple[str, str], KvRouter] = {}
    lock = asyncio.Lock()

    async def factory(card, endpoint_id):
        key = (endpoint_id.namespace, endpoint_id.component)
        async with lock:  # concurrent models on one component: build once
            if key not in routers:
                comp = drt.namespace(endpoint_id.namespace).component(
                    endpoint_id.component
                )
                routers[key] = await KvRouter(drt, comp, cfg).start()
        return routers[key].selector_fn

    return factory
