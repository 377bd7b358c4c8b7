"""Message bus and work queue — the request/messaging plane (port of
dynamo_tpu/runtime/transports/bus.py).

Plays NATS's role: pub/sub carrying request envelopes to worker-endpoint
subjects (queue-group delivery) and events to every subscriber
(broadcast), leased work queues with ack and redelivery, and an object
store for model cards. ``InProcBus`` is the in-process implementation;
the control-plane server (transports/control_plane.py) exposes one over
TCP.
"""

from __future__ import annotations

import asyncio
from collections import defaultdict, deque
from typing import AsyncIterator, Protocol

from dynamo_tpu_torch.utils.faults import FAULTS


class NoSubscriberError(ConnectionError):
    """A request-plane publish found no live subscriber on the subject —
    the bus-architecture analogue of connection-refused: the worker that
    owned this subject is gone (its subscription closed) but its lease
    has not yet TTL-expired out of discovery. Subclasses ConnectionError
    so the router's mark-dead fast path and every transport-retry filter
    classify it as a dead peer, not a server bug. Only raised when the
    publisher asked for delivery confirmation (``require_subscriber``);
    fire-and-forget event kicks keep their silent-drop semantics."""


class Subscription:
    """A live subscription delivering message payloads."""

    def __init__(self) -> None:
        self._queue: asyncio.Queue[bytes | None] = asyncio.Queue()
        self.closed = False

    def _deliver(self, payload: bytes) -> None:
        if not self.closed:
            self._queue.put_nowait(payload)

    def close(self) -> None:
        self.closed = True
        self._queue.put_nowait(None)

    def __aiter__(self) -> AsyncIterator[bytes]:
        return self

    async def __anext__(self) -> bytes:
        payload = await self._queue.get()
        if payload is None:
            raise StopAsyncIteration
        return payload


class MessageBus(Protocol):
    async def publish(
        self, subject: str, payload: bytes, require_subscriber: bool = False
    ) -> None: ...
    async def subscribe(self, subject: str) -> Subscription: ...
    async def request(self, subject: str, payload: bytes, timeout_s: float = 5.0) -> bytes: ...


class WorkQueue(Protocol):
    """At-least-once work queue (the prefill-queue primitive).

    ``dequeue_leased`` hands an item out under a visibility timeout; the
    consumer must ``ack`` within the lease or the item is redelivered to
    the next consumer (reference: JetStream-backed `NatsQueue` ack/
    redelivery semantics, lib/runtime/src/transports/nats.rs:345-478).
    Plain ``dequeue`` is destructive (auto-ack) for fire-and-forget uses.
    """

    async def enqueue(self, payload: bytes) -> None: ...
    async def dequeue(self, timeout_s: float | None = None) -> bytes | None: ...
    async def dequeue_leased(
        self, timeout_s: float | None = None, lease_s: float = 30.0
    ) -> tuple[int, bytes] | None: ...
    async def ack(self, item_id: int) -> bool: ...
    async def nack(self, item_id: int) -> bool: ...
    async def depth(self) -> int: ...
    async def oldest_age_s(self) -> float: ...
    async def stats(self) -> tuple[int, float]: ...  # (depth, oldest age)


class ObjectStore(Protocol):
    async def put_object(self, bucket: str, key: str, data: bytes) -> None: ...
    async def get_object(self, bucket: str, key: str) -> bytes | None: ...
    async def list_objects(self, bucket: str, prefix: str = "") -> list[str]: ...
    async def delete_object(self, bucket: str, key: str) -> bool: ...


class InProcBus:
    """In-process MessageBus + WorkQueue factory + ObjectStore."""

    def __init__(self) -> None:
        self._subs: dict[str, list[Subscription]] = defaultdict(list)
        self._rr: dict[str, int] = defaultdict(int)
        self._queues: dict[str, "InProcQueue"] = {}
        self._objects: dict[tuple[str, str], bytes] = {}

    # -- MessageBus ---------------------------------------------------------
    async def publish(
        self, subject: str, payload: bytes, require_subscriber: bool = False
    ) -> None:
        if FAULTS.active and not await FAULTS.maybe_fail_async(
            "bus.publish", can_drop=True
        ):
            return  # injected message loss
        subs = [s for s in self._subs.get(subject, []) if not s.closed]
        self._subs[subject] = subs
        if not subs:
            if require_subscriber:
                # Request-plane contract (runtime/egress.py): the caller
                # needs to KNOW the worker is gone NOW — a silent drop
                # here turns worker death into a caller that hangs until
                # its own timeout, exactly the failure-detection gap the
                # mark-dead fast path closes.
                raise NoSubscriberError(
                    f"no live subscriber on subject {subject!r}"
                )
            return
        # Endpoint subjects have one subscriber (the worker); if several
        # share a subject they form a queue group — deliver to one.
        idx = self._rr[subject] % len(subs)
        self._rr[subject] += 1
        subs[idx]._deliver(payload)

    async def broadcast(self, subject: str, payload: bytes) -> None:
        """Fan-out delivery (events plane: KV events, metrics). Prunes
        closed subscriptions like publish() — a broadcast-only subject
        would otherwise accumulate dead Subscription objects forever."""
        if FAULTS.active and not await FAULTS.maybe_fail_async(
            "bus.broadcast", can_drop=True
        ):
            return  # injected message loss
        subs = [s for s in self._subs.get(subject, []) if not s.closed]
        self._subs[subject] = subs
        for sub in subs:
            sub._deliver(payload)

    async def subscribe(self, subject: str) -> Subscription:
        sub = Subscription()
        self._subs[subject].append(sub)
        return sub

    async def request(
        self, subject: str, payload: bytes, timeout_s: float = 5.0
    ) -> bytes:
        raise NotImplementedError("use PushRouter for request/stream")

    # -- queues / objects ---------------------------------------------------
    def work_queue(self, name: str) -> "InProcQueue":
        if name not in self._queues:
            self._queues[name] = InProcQueue()
        return self._queues[name]

    async def put_object(self, bucket: str, key: str, data: bytes) -> None:
        self._objects[(bucket, key)] = data

    async def get_object(self, bucket: str, key: str) -> bytes | None:
        return self._objects.get((bucket, key))

    async def list_objects(self, bucket: str, prefix: str = "") -> list[str]:
        return sorted(
            k for b, k in self._objects if b == bucket and k.startswith(prefix)
        )

    async def delete_object(self, bucket: str, key: str) -> bool:
        return self._objects.pop((bucket, key), None) is not None


class InProcQueue:
    """In-process WorkQueue with visibility-timeout redelivery.

    Items carry a queue-unique id. A leased dequeue moves the item to the
    in-flight table with a deadline; ``ack`` completes it, ``nack`` (or
    lease expiry, driven by an asyncio timer) requeues it at the FRONT so
    redelivered work doesn't lose its place behind newer arrivals.
    """

    def __init__(self) -> None:
        # (item_id, payload, enqueued_at) — enqueued_at survives redelivery
        # so age reflects how long the WORK has waited, not the last lease.
        self._items: deque[tuple[int, bytes, float]] = deque()
        # item_id -> (payload, deadline monotonic, enqueued_at)
        self._inflight: dict[int, tuple[bytes, float, float]] = {}
        # waiter futures resolve to an (item_id, payload) pair; each waiter
        # carries the lease it asked for (None = destructive dequeue).
        self._waiters: deque[tuple[asyncio.Future, float | None]] = deque()
        self._next_id = 0
        self._timer: asyncio.TimerHandle | None = None
        self.delivered = 0
        self.redelivered = 0

    # -- internals ------------------------------------------------------------
    def _lease_out(
        self, item_id: int, payload: bytes, lease_s: float | None, ts: float
    ):
        self.delivered += 1
        if lease_s is None:
            return
        deadline = asyncio.get_running_loop().time() + lease_s
        self._inflight[item_id] = (payload, deadline, ts)
        self._arm_timer()

    def _arm_timer(self) -> None:
        if self._timer is not None:
            self._timer.cancel()
            self._timer = None
        if not self._inflight:
            return
        loop = asyncio.get_running_loop()
        nxt = min(dl for _, dl, _ts in self._inflight.values())
        self._timer = loop.call_later(
            max(0.0, nxt - loop.time()), self._expire_sweep
        )

    def _expire_sweep(self) -> None:
        self._timer = None
        now = asyncio.get_running_loop().time()
        expired = [
            iid for iid, (_, dl, _ts) in self._inflight.items() if dl <= now
        ]
        # Oldest first at the front keeps redelivery order stable.
        for iid in sorted(expired, reverse=True):
            payload, _, ts = self._inflight.pop(iid)
            self.redelivered += 1
            self._push_front(payload, ts)
        self._arm_timer()

    def _push_front(self, payload: bytes, ts: float) -> None:
        """Redeliver under a FRESH id (each delivery gets its own id, so a
        stale ack/nack from the previous holder can't touch the new lease),
        to a parked waiter if any, else back at the front of the queue."""
        self._next_id += 1
        item_id = self._next_id
        while self._waiters:
            fut, lease_s = self._waiters.popleft()
            if not fut.done():
                self._lease_out(item_id, payload, lease_s, ts)
                fut.set_result((item_id, payload))
                return
        self._items.appendleft((item_id, payload, ts))

    # -- WorkQueue -------------------------------------------------------------
    async def enqueue(self, payload: bytes) -> None:
        self._next_id += 1
        item_id = self._next_id
        ts = asyncio.get_running_loop().time()
        while self._waiters:
            fut, lease_s = self._waiters.popleft()
            if not fut.done():
                self._lease_out(item_id, payload, lease_s, ts)
                fut.set_result((item_id, payload))
                return
        self._items.append((item_id, payload, ts))

    async def dequeue_leased(
        self, timeout_s: float | None = None, lease_s: float | None = 30.0
    ) -> tuple[int, bytes] | None:
        if self._items:
            item_id, payload, ts = self._items.popleft()
            self._lease_out(item_id, payload, lease_s, ts)
            return item_id, payload
        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        entry = (fut, lease_s)
        self._waiters.append(entry)
        try:
            if timeout_s is None:
                return await fut
            return await asyncio.wait_for(fut, timeout_s)
        except asyncio.TimeoutError:
            return None
        finally:
            if not fut.done() or fut.cancelled():
                # Timed out / cancelled before delivery: a polling consumer
                # must not leave a dead waiter behind per poll.
                try:
                    self._waiters.remove(entry)
                except ValueError:
                    pass

    async def dequeue(self, timeout_s: float | None = None) -> bytes | None:
        got = await self.dequeue_leased(timeout_s, lease_s=None)
        return got[1] if got is not None else None

    async def ack(self, item_id: int) -> bool:
        done = self._inflight.pop(item_id, None) is not None
        if done:
            self._arm_timer()
        return done

    async def nack(self, item_id: int) -> bool:
        entry = self._inflight.pop(item_id, None)
        if entry is None:
            return False
        self.redelivered += 1
        self._push_front(entry[0], entry[2])
        self._arm_timer()
        return True

    async def depth(self) -> int:
        return len(self._items)

    async def oldest_age_s(self) -> float:
        """Seconds the oldest live item (queued OR leased in-flight) has
        waited — the per-item SLA signal depth alone can't give. In-flight
        items count because a stuck consumer holding the only item is
        exactly the stall this signal exists to expose."""
        ages = [ts for _, _, ts in self._items]
        ages.extend(ts for _, _, ts in self._inflight.values())
        if not ages:
            return 0.0
        return max(0.0, asyncio.get_running_loop().time() - min(ages))

    async def stats(self) -> tuple[int, float]:
        return len(self._items), await self.oldest_age_s()

    @property
    def inflight(self) -> int:
        return len(self._inflight)
