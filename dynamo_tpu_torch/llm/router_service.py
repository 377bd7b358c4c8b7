"""Standalone KV router service (port of dynamo_tpu/llm/router_service.py).

A process that builds a KvRouter over a target worker endpoint and
serves its own ``generate`` endpoint on a router component: clients
address the router instead of picking workers, each request goes to the
KV-best worker instance, and the response stream is relayed back. A
custom ``selector`` can replace the default cost function.

Replicated: N RouterServices on one router component — each with its own
radix view and metrics aggregator, all fed by the shared KV event plane
— are N instances of one endpoint, so a frontend's PushRouter spreads
over them and its FailoverEngine replays a stream whose replica died.
Each replica wraps its own worker egress in a FailoverEngine too, so a
worker dying mid-stream is absorbed at the replica, where the KV view
lives.

Launch: ``python -m dynamo_tpu_torch router --control-plane ADDR
--endpoint dyn://ns.component.generate [--replica-id N]``, one process
per replica.
"""

from __future__ import annotations

import logging
from typing import Any, AsyncIterator

from dynamo_tpu_torch.llm.kv_router.router import KvRouter
from dynamo_tpu_torch.llm.kv_router.scheduler import (
    DefaultWorkerSelector,
    KvRouterConfig,
)
from dynamo_tpu_torch.runtime.component import EndpointId
from dynamo_tpu_torch.runtime.egress import PushRouter, RouterMode
from dynamo_tpu_torch.runtime.engine import Context
from dynamo_tpu_torch.runtime.failover import FailoverEngine

logger = logging.getLogger(__name__)

DEFAULT_ROUTER_COMPONENT = "router"


class RouterService:
    """A routed ingress: serves ``generate`` on its own component, forwarding
    to the KV-best instance of the target endpoint. Itself an AsyncEngine, so
    it can also be linked into pipelines or registered as a model backend."""

    def __init__(
        self,
        drt,
        target: EndpointId | str,
        component_name: str = DEFAULT_ROUTER_COMPONENT,
        cfg: KvRouterConfig | None = None,
        selector: DefaultWorkerSelector | None = None,
        replica_id: int = 0,
    ) -> None:
        if isinstance(target, str):
            target = EndpointId.parse(target)
        self._drt = drt
        self.target = target
        self.component_name = component_name
        self.replica_id = replica_id
        self._cfg = cfg
        self._selector = selector
        self.kv_router: KvRouter | None = None
        self._push: PushRouter | None = None
        self._engine: FailoverEngine | None = None
        self._instance = None

    @property
    def endpoint_path(self) -> str:
        return (
            f"dyn://{self.target.namespace}.{self.component_name}"
            f".{self.target.name}"
        )

    async def start(self) -> "RouterService":
        worker_comp = self._drt.namespace(self.target.namespace).component(
            self.target.component
        )
        self.kv_router = await KvRouter(
            self._drt, worker_comp, self._cfg, selector=self._selector,
            replica_id=self.replica_id,
        ).start()
        self._push = await PushRouter.create(
            self._drt,
            self.target,
            mode=RouterMode.KV,
            selector=self.kv_router.selector_fn,
        )
        # Worker-death failover happens at the replica: the KV view that
        # can re-route the replay lives here, and the mark-dead fast
        # path (and its worker_dead broadcast to sibling replicas) has
        # evicted the corpse by the time the replay re-picks.
        self._engine = FailoverEngine(self._push)
        ep = self._drt.namespace(self.target.namespace).component(
            self.component_name
        ).endpoint(self.target.name)
        # Discovery says what this instance is: a replica routing to
        # ``target``, under its replica id.
        self._instance = await ep.serve(
            self, metadata={
                "routes_to": str(self.target),
                "replica_id": self.replica_id,
            }
        )
        logger.info(
            "router service %s (replica %d) -> %s",
            self.endpoint_path, self.replica_id, self.target,
        )
        return self

    async def generate(self, request: Context) -> AsyncIterator[Any]:
        async for item in self._engine.generate(request):
            yield item

    async def stop(self) -> None:
        # Deregister + halt the pump FIRST so no request arrives routed by
        # a stopped KvRouter (frozen metrics, stale radix index).
        if self._instance is not None:
            await self._instance.stop()
            self._instance = None
        if self.kv_router is not None:
            await self.kv_router.stop()
            self.kv_router = None

    async def kill(self) -> None:
        """Abrupt replica death: the served instance's pump and every
        in-flight relay are cancelled, response sockets abort with no
        terminal frame (callers see WorkerDiedError and fail over to a
        sibling replica), and the discovery key is not deregistered — a
        crashed process never cleans up; the frontend's mark-dead fast
        path or the lease TTL evicts it (runtime/ingress.py
        ServedInstance.kill)."""
        if self._instance is not None:
            await self._instance.kill()
            self._instance = None
        if self.kv_router is not None:
            await self.kv_router.stop()
            self.kv_router = None

    async def run(self, token) -> None:
        """Start (if not already started) and serve until the cancellation
        token fires."""
        if self._instance is None:
            await self.start()
        try:
            await token.cancelled()
        finally:
            await self.stop()
