"""Router replica set: N RouterServices on one component, managed (port
of dynamo_tpu/llm/kv_router/replicas.py).

The horizontal scaling unit of the routing plane. Each replica is a full
:class:`~dynamo_tpu_torch.llm.router_service.RouterService` — its own
radix view and metrics aggregator, both fed by the shared KV event
plane — served as one more instance of the router endpoint (its
discovery record carries ``routes_to`` and ``replica_id``), so a
frontend needs nothing replica-aware: a plain ``PushRouter`` spreads
requests over the replicas and its ``FailoverEngine`` replays a stream
whose replica died onto a survivor.

This module manages the set where one process hosts it (the ingress
tool, tests, single-host deployments): spawn, kill, rejoin, and the
measured staleness of a rejoined replica. A replica that rejoins after
a death subscribes afresh to the event plane: every KV event published
while it was down is gone, so its radix view undercounts until the
workers' store/remove traffic rebuilds it — or until the re-announce
that ``rejoin`` asks for (block_manager/peer.py ``Reannouncer``)
republishes every worker's resident blocks.
:meth:`RouterReplicaSet.staleness` reports each replica's
applied-event watermark against the set's maximum, and its
publish→apply lag p99; the rejoined replica's route records carry its
``replica_id`` so tools/route_audit.py can bound its error apart from
its warm siblings'.

Production replicas are separate processes (``python -m
dynamo_tpu_torch router --replica-id N`` each); there the set is the
discovery store, and the staleness instruments are each replica's
``kv_events_applied_total`` and lag gauges.
"""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass

from dynamo_tpu_torch.llm.kv_router.scheduler import KvRouterConfig
from dynamo_tpu_torch.llm.router_service import (
    DEFAULT_ROUTER_COMPONENT,
    RouterService,
)

logger = logging.getLogger(__name__)


@dataclass
class ReplicaHandle:
    """One live (or killed) router replica."""

    replica_id: int
    service: RouterService
    drt: object                  # the replica's own runtime (own lease)
    alive: bool = True
    started_unix: float = 0.0
    rejoined_unix: float | None = None

    @property
    def instance_id(self) -> int:
        return self.drt.primary_lease_id


class RouterReplicaSet:
    """Spawn/kill/rejoin a router replica fleet in one process.

    ``drt_factory`` is an async zero-arg callable returning a runtime
    handle that SHARES the fleet's store/bus but owns a fresh lease
    (``DistributedRuntime.in_process(store=..., bus=..., runtime=...)``)
    — each replica must be its own instance of the router endpoint or
    kills would take the whole plane down with one lease."""

    def __init__(
        self,
        drt_factory,
        target,
        cfg: KvRouterConfig | None = None,
        component_name: str = DEFAULT_ROUTER_COMPONENT,
    ) -> None:
        self._drt_factory = drt_factory
        self._target = target
        self._cfg = cfg
        self._component_name = component_name
        self.replicas: list[ReplicaHandle] = []
        self._next_id = 0

    async def start(self, n: int) -> "RouterReplicaSet":
        for _ in range(n):
            await self.spawn()
        return self

    async def spawn(self) -> ReplicaHandle:
        rid = self._next_id
        self._next_id += 1
        drt = await self._drt_factory()
        svc = await RouterService(
            drt, self._target, component_name=self._component_name,
            cfg=self._cfg_copy(), replica_id=rid,
        ).start()
        handle = ReplicaHandle(
            replica_id=rid, service=svc, drt=drt,
            started_unix=time.time(),
        )
        self.replicas.append(handle)
        logger.info("router replica %d up (lease %#x)",
                    rid, handle.instance_id)
        return handle

    def _cfg_copy(self) -> KvRouterConfig | None:
        # Each replica owns its config instance: the selector keeps
        # per-replica predicted-load state keyed off it.
        if self._cfg is None:
            return None
        from dataclasses import replace

        return replace(self._cfg)

    @property
    def alive(self) -> list[ReplicaHandle]:
        return [r for r in self.replicas if r.alive]

    async def kill(self, handle: ReplicaHandle) -> None:
        """Abrupt replica death: the served pump and every in-flight
        relay die, response sockets abort frame-less, discovery is NOT
        cleaned up — callers fail over via the frontend's mark-dead
        fast path (the worker-death story, one level up)."""
        if not handle.alive:
            return
        handle.alive = False
        logger.warning("CHAOS: killing router replica %d",
                       handle.replica_id)
        await handle.service.kill()

    async def rejoin(self, handle: ReplicaHandle) -> ReplicaHandle:
        """Restart a killed replica UNDER ITS replica id, with a fresh
        lease and a fresh (EMPTY) radix view — the events published
        while it was down are lost, which is exactly the staleness
        :meth:`staleness` then measures instead of assuming away; then it
        asks the workers to re-announce their blocks."""
        if handle.alive:
            return handle
        drt = await self._drt_factory()
        svc = await RouterService(
            drt, self._target, component_name=self._component_name,
            cfg=self._cfg_copy(), replica_id=handle.replica_id,
        ).start()
        fresh = ReplicaHandle(
            replica_id=handle.replica_id, service=svc, drt=drt,
            started_unix=handle.started_unix,
            rejoined_unix=time.time(),
        )
        self.replicas[self.replicas.index(handle)] = fresh
        logger.info("router replica %d rejoined (lease %#x)",
                    fresh.replica_id, fresh.instance_id)
        # Staleness repair: ask the worker fleet to republish its
        # registered blocks on the KV event plane (block_manager/peer.py
        # Reannouncer), so the fresh radix view converges in one announce
        # round instead of waiting for live traffic to re-cover the lost
        # prefixes. Best-effort: a worker without a Reannouncer never
        # answers, and the measured staleness above still holds.
        try:
            from dynamo_tpu_torch.block_manager.peer import request_reannounce

            target = svc.target
            comp = drt.namespace(target.namespace).component(target.component)
            await request_reannounce(drt, comp)
        except Exception:  # noqa: BLE001 — the repair is opportunistic
            logger.debug("re-announce request failed", exc_info=True)
        return fresh

    # -- staleness ----------------------------------------------------------
    def staleness(self) -> dict:
        """Per-replica event-watermark staleness vs the fleet maximum.

        ``applied_lag`` is how many KV events the freshest replica has
        consumed that this one has not — a rejoined replica starts with
        the full lag of its downtime window and converges only as fast
        as live traffic re-covers the lost prefixes. ``lag_p99_ms`` is
        the replica's own publish→apply latency.
        Dead replicas report ``alive: false`` with their last state."""
        per: dict[int, dict] = {}
        applied_max = 0
        for r in self.replicas:
            kvr = r.service.kv_router
            wm = kvr.indexer.watermark() if kvr is not None else {}
            applied = int(wm.get("applied", 0))
            applied_max = max(applied_max, applied)
            per[r.replica_id] = {
                "alive": r.alive,
                "applied": applied,
                "pending": int(wm.get("pending", 0)),
                "lag_p99_ms": float(wm.get("lag_p99_ms", 0.0)),
                "rejoined": r.rejoined_unix is not None,
            }
        for rec in per.values():
            rec["applied_lag"] = applied_max - rec["applied"]
        return {
            "replicas": per,
            "applied_max": applied_max,
            "max_applied_lag": max(
                (rec["applied_lag"] for rec in per.values() if rec["alive"]),
                default=0,
            ),
        }

    async def stop(self) -> None:
        for r in self.replicas:
            try:
                if r.alive:
                    await r.service.stop()
            except Exception:  # noqa: BLE001 — teardown
                logger.debug("replica stop failed", exc_info=True)
        self.replicas.clear()
