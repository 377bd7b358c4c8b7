"""Client-side request routing (port of dynamo_tpu/runtime/egress.py).

``Client`` keeps a live instance list for an endpoint through a
discovery-store watch. ``PushRouter`` picks an instance per request
(round robin, random or direct), publishes the request envelope to the
instance's bus subject with the caller's TCP connection info, and yields
the response stream. A dispatch that finds a dead worker, or a stream
whose socket dies, evicts the instance at once (the mark-dead fast path)
instead of waiting out its lease.

``RouterMode.KV`` is parsed and refused: the KV-aware router arrives with
ROADMAP A5, and so do the route span and the ``fleet.worker_kill`` trace
record (the fault point itself is here).
"""

from __future__ import annotations

import asyncio
import enum
import logging
import random
import uuid
from typing import Any, AsyncIterator

from dynamo_tpu_torch.llm.protocols.common import ShedError, WorkerDiedError
from dynamo_tpu_torch.runtime.component import EndpointId, Instance
from dynamo_tpu_torch.runtime.engine import Context
from dynamo_tpu_torch.runtime.failover import FAILOVER
from dynamo_tpu_torch.runtime.transports import wire
from dynamo_tpu_torch.runtime.transports.store import EventKind
from dynamo_tpu_torch.utils.faults import FAULTS
from dynamo_tpu_torch.utils.task import spawn_tracked

logger = logging.getLogger(__name__)

#: How long a dispatched worker gets to open its response connection
#: before the dispatch counts as dead. The connect-back happens before
#: any engine work, so this bounds only the handshake, never prefill.
DEFAULT_CONNECT_TIMEOUT_S = 5.0

#: Distinct instances one generate() call tries before giving up on
#: dispatch (each failure marks that instance dead first).
MAX_DISPATCH_ATTEMPTS = 8


class RouterMode(enum.Enum):
    RANDOM = "random"
    ROUND_ROBIN = "round_robin"
    DIRECT = "direct"
    KV = "kv"


KV_REFUSAL = (
    "--router-mode kv: the KV-aware router is not served by the port yet "
    "(ROADMAP A5)"
)


class Client:
    """Instance source for one endpoint, kept live by a store watch."""

    def __init__(self, drt, endpoint_id: EndpointId) -> None:
        self._drt = drt
        self.endpoint_id = endpoint_id
        self._instances: dict[int, Instance] = {}
        self._watch_task: asyncio.Task | None = None
        self._event = asyncio.Event()
        # Evictions since the last store re-read: a falsely marked-dead
        # worker has no watch event to bring it back (keepalive touches
        # the lease, not the key), so the next pick re-reads the store.
        self._evicted_since_refresh = False
        self._refreshing = False
        # Watch-DELETE tombstones (id -> loop time): a refresh's snapshot
        # is read before its await completes, so a worker deregistered
        # meanwhile must not be resurrected from the stale bytes.
        self._deleted: dict[int, float] = {}

    @staticmethod
    async def create(drt, endpoint_id: EndpointId) -> "Client":
        client = Client(drt, endpoint_id)
        watch = await drt.store.watch_prefix(endpoint_id.etcd_prefix)
        for raw in watch.initial.values():
            inst = Instance.from_json(raw)
            client._instances[inst.instance_id] = inst
        if client._instances:
            client._event.set()
        client._watch_task = asyncio.ensure_future(client._pump(watch))
        drt.runtime.token.on_cancel(watch.cancel)
        return client

    async def _pump(self, watch) -> None:
        async for ev in watch:
            if ev.kind is EventKind.PUT and ev.value:
                inst = Instance.from_json(ev.value)
                self._instances[inst.instance_id] = inst
                self._deleted.pop(inst.instance_id, None)
                self._event.set()
            elif ev.kind is EventKind.DELETE:
                try:
                    wid = int(ev.key.rsplit(":", 1)[-1], 16)
                except ValueError:
                    continue
                self._instances.pop(wid, None)
                self._deleted[wid] = asyncio.get_running_loop().time()

    def instances(self) -> list[Instance]:
        return list(self._instances.values())

    def instance_ids(self) -> list[int]:
        return list(self._instances.keys())

    def evict(self, instance_id: int) -> bool:
        """Remove an instance from the live view now (the mark-dead fast
        path); the store is untouched — lease expiry or a deregister
        stays the authoritative cleanup."""
        self._evicted_since_refresh = True
        return self._instances.pop(instance_id, None) is not None

    async def refresh(self) -> list[Instance]:
        """Re-read the instance set from the store (the recovery path for
        a false mark-dead)."""
        t0 = asyncio.get_running_loop().time()
        self._evicted_since_refresh = False
        raw = await self._drt.store.get_prefix(self.endpoint_id.etcd_prefix)
        fresh: dict[int, Instance] = {}
        for value in raw.values():
            try:
                inst = Instance.from_json(value)
            except (ValueError, KeyError):
                logger.warning("skipping malformed instance entry")
                continue
            if self._deleted.get(inst.instance_id, -1.0) >= t0:
                continue
            fresh[inst.instance_id] = inst
        self._instances = fresh
        for wid in [w for w, ts in self._deleted.items() if ts < t0]:
            del self._deleted[wid]
        if fresh:
            self._event.set()
        return list(fresh.values())

    async def _refresh_background(self) -> None:
        """Single-flight re-read after an eviction, off the pick path."""
        if self._refreshing:
            return
        self._refreshing = True
        try:
            await self.refresh()
        except (ConnectionError, OSError, RuntimeError):
            logger.debug("background instance refresh failed", exc_info=True)
        finally:
            self._refreshing = False

    async def wait_for_instances(self, timeout_s: float = 5.0) -> list[Instance]:
        if not self._instances:
            # Mark-dead may have evicted everything: re-read the store
            # before concluding the endpoint has no capacity.
            try:
                await self.refresh()
            except (ConnectionError, OSError, RuntimeError):
                logger.debug("instance refresh failed", exc_info=True)
        elif self._evicted_since_refresh:
            spawn_tracked(self._refresh_background(), name="client-refresh")
        if not self._instances:
            self._event.clear()
            await asyncio.wait_for(self._event.wait(), timeout_s)
        return self.instances()


class PushRouter:
    """Routes requests to instances; itself an AsyncEngine."""

    def __init__(
        self,
        drt,
        client: Client,
        mode: RouterMode = RouterMode.ROUND_ROBIN,
        connect_timeout_s: float = DEFAULT_CONNECT_TIMEOUT_S,
    ) -> None:
        if mode is RouterMode.KV:
            raise SystemExit(KV_REFUSAL)
        self._drt = drt
        self.client = client
        self.mode = mode
        self.connect_timeout_s = connect_timeout_s
        self._rr = 0

    @staticmethod
    async def create(
        drt,
        endpoint_id: EndpointId | str,
        mode: RouterMode = RouterMode.ROUND_ROBIN,
        connect_timeout_s: float = DEFAULT_CONNECT_TIMEOUT_S,
    ) -> "PushRouter":
        if mode is RouterMode.KV:
            raise SystemExit(KV_REFUSAL)
        if isinstance(endpoint_id, str):
            endpoint_id = EndpointId.parse(endpoint_id)
        client = await Client.create(drt, endpoint_id)
        return PushRouter(drt, client, mode, connect_timeout_s=connect_timeout_s)

    async def _pick(self, instance_id: int | None, exclude: set[int]) -> Instance:
        try:
            instances = await self.client.wait_for_instances()
        except asyncio.TimeoutError:
            # Every instance gone (rolling restart, drain, lease expiry):
            # a typed retryable rejection (HTTP 503 + Retry-After).
            raise ShedError(
                f"no live instances for {self.client.endpoint_id}", retry_after_s=2.0
            ) from None
        if exclude:
            instances = [i for i in instances if i.instance_id not in exclude]
            if not instances:
                raise ShedError(
                    f"every live instance of {self.client.endpoint_id} "
                    f"already failed this request",
                    retry_after_s=2.0,
                )
        if instance_id is not None:
            for inst in instances:
                if inst.instance_id == instance_id:
                    return inst
            raise LookupError(
                f"instance {instance_id:#x} not found for {self.client.endpoint_id}"
            )
        if self.mode is RouterMode.RANDOM:
            return random.choice(instances)
        if self.mode is RouterMode.ROUND_ROBIN:
            inst = instances[self._rr % len(instances)]
            self._rr += 1
            return inst
        raise RuntimeError("direct mode requires instance_id")

    def mark_dead(self, instance_id: int, reason: str) -> None:
        """The mark-dead fast path: a typed transport failure against a
        worker evicts it from the live routing view at once."""
        if self.client.evict(instance_id):
            FAILOVER.note_marked_dead(reason)
            logger.warning(
                "marked worker %#x dead (%s) — evicted from the live "
                "instance view", instance_id, reason,
            )

    async def generate(
        self, request: Context, instance_id: int | None = None
    ) -> AsyncIterator[Any]:
        tried: set[int] = set()
        while True:
            instance = await self._pick(instance_id, tried)
            try:
                receiver = await self._dispatch(instance, request)
            except (ConnectionError, OSError, asyncio.TimeoutError) as exc:
                # Dead at dispatch (connection-refused class): mark it,
                # and since nothing has streamed yet, re-pick.
                self.mark_dead(instance.instance_id, f"dispatch:{type(exc).__name__}")
                tried.add(instance.instance_id)
                if instance_id is not None or len(tried) >= MAX_DISPATCH_ATTEMPTS:
                    raise WorkerDiedError(
                        f"dispatch to {instance.instance_id:#x} failed: {exc}"
                    ) from exc
                continue
            request.annotations["worker_id"] = instance.instance_id
            async for item in self._relay(instance, receiver, request):
                yield item
            return

    async def direct(self, request: Context, instance_id: int) -> AsyncIterator[Any]:
        async for item in self.generate(request, instance_id=instance_id):
            yield item

    async def _dispatch(self, instance: Instance, request: Context):
        """Publish the envelope and wait for the worker's response
        connection (the dispatch ack). Raises the typed transport error
        on a dead subject (NoSubscriberError), an injected
        ``fleet.worker_kill`` fault, or a connect-back that never comes."""
        server = await self._drt.tcp_server()
        stream_id = uuid.uuid4().hex
        receiver = server.register(stream_id)
        envelope = {
            "id": request.id,
            "payload": request.payload,
            "resp": server.connection_info(stream_id).to_wire(),
            "trace": None,
        }
        try:
            if FAULTS.active:
                await FAULTS.maybe_fail_async("fleet.worker_kill")
            await self._drt.bus.publish(
                instance.subject, wire.packb(envelope), require_subscriber=True
            )
            await asyncio.wait_for(receiver.connected.wait(), self.connect_timeout_s)
        except BaseException:
            server.unregister(stream_id)
            raise
        return receiver

    async def _relay(self, instance: Instance, receiver, request: Context):
        try:
            async for payload in receiver:
                if request.is_killed:
                    break
                yield wire.unpackb(payload)
        except WorkerDiedError as exc:
            # Mid-stream death, on transport evidence only: evict now so
            # the failover re-dispatch stops routing here. A
            # WorkerDiedError that crossed as an error frame came from a
            # live worker: it fails over without eviction.
            if exc.transport_dead:
                self.mark_dead(instance.instance_id, "stream")
            raise
