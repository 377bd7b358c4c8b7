"""Control-plane client: RemoteStore + RemoteBus over one TCP connection
(port of dynamo_tpu/runtime/transports/control_client.py).

The worker-process side of transports/control_plane.py. One
`ControlPlaneClient` implements BOTH the KeyValueStore protocol
(transports/store.py) and the MessageBus / WorkQueue-factory / ObjectStore
surface (transports/bus.py), so `DistributedRuntime.connect(addr)` passes
it as the runtime's `store` and `bus` (reference: the etcd+NATS client
pair held by DistributedRuntime, lib/runtime/src/distributed.rs:34-77).

All traffic multiplexes over a single connection: request/response pairs
matched by "id", server-pushed stream frames (watch events, subscription
messages) routed by "sid". Connection loss fails every pending call and
ends every stream — the runtime's lease-keepalive CriticalTask then
escalates to process shutdown, which is exactly the reference's
lease-death ⇒ shutdown coupling.
"""

from __future__ import annotations

import asyncio
import itertools
import logging

from dynamo_tpu_torch.runtime.transports import wire
from dynamo_tpu_torch.runtime.transports.bus import NoSubscriberError, Subscription
from dynamo_tpu_torch.runtime.transports.codec import encode_frame, read_frame
from dynamo_tpu_torch.runtime.transports.store import EventKind, Watch, WatchEvent
from dynamo_tpu_torch.utils.faults import FAULTS
from dynamo_tpu_torch.utils.task import spawn_tracked

logger = logging.getLogger(__name__)

RPC_TIMEOUT_S = 10.0


class ControlPlaneClient:
    def __init__(self, reader, writer) -> None:
        self._reader = reader
        self._writer = writer
        self._wlock = asyncio.Lock()
        self._ids = itertools.count(1)
        self._pending: dict[int, asyncio.Future] = {}
        self._watches: dict[int, Watch] = {}
        self._subs: dict[int, Subscription] = {}
        # Stream frames that raced ahead of their sid's registration: the
        # server starts pumping immediately after the watch/subscribe
        # response, and _read_loop can process buffered frames before the
        # _call() continuation installs the sid. Held here and
        # replayed by _register_stream.
        self._orphans: dict[int, list[tuple[dict, bytes]]] = {}
        # Sids cancelled locally: in-flight frames the server wrote before
        # processing the cancel are dropped, not buffered (they would sit in
        # _orphans forever — no future _register_stream for a dead sid).
        # Insertion-ordered + bounded: tail frames arrive promptly after the
        # cancel, so only recent sids matter.
        self._dead_sids: dict[int, None] = {}
        self._pump = asyncio.ensure_future(self._read_loop())
        self.closed = False

    _MAX_ORPHANS = 1024  # frames; a sid that never registers gets dropped

    @staticmethod
    async def connect(addr: str, token: str | None = None) -> "ControlPlaneClient":
        host, port = addr.rsplit(":", 1)
        reader, writer = await asyncio.open_connection(host, int(port))
        client = ControlPlaneClient(reader, writer)
        if token is not None:
            await client._call({"op": "auth", "token": token})
        return client

    # -- wire ---------------------------------------------------------------
    async def _call(
        self, header: dict, payload: bytes = b"", timeout_s: float | None = RPC_TIMEOUT_S
    ) -> tuple[dict, bytes]:
        # A dropped control RPC behaves like a lost connection: the caller
        # sees the injected ConnectionError, never a silent half-call.
        if FAULTS.active:
            await FAULTS.maybe_fail_async("control.call")
        if self.closed:
            raise ConnectionError("control plane connection closed")
        rid = next(self._ids)
        header["id"] = rid
        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        self._pending[rid] = fut
        try:
            async with self._wlock:
                self._writer.write(
                    encode_frame(wire.packb(header), payload)
                )
                await self._writer.drain()
            resp, data = await asyncio.wait_for(fut, timeout_s)
        finally:
            self._pending.pop(rid, None)
        if not resp.get("ok"):
            if resp.get("err_type") == "NoSubscriberError":
                # Re-typify: the server-side bus found the worker's
                # subject dead — the remote publisher must see the same
                # ConnectionError-class failure the in-proc bus raises.
                raise NoSubscriberError(str(resp.get("err")))
            raise RuntimeError(
                f"control plane {header.get('op')} failed: {resp.get('err')}"
            )
        return resp, data

    async def _read_loop(self) -> None:
        try:
            while True:
                raw_header, payload = await read_frame(self._reader)
                h = wire.unpackb(raw_header)
                if "sid" in h and "id" not in h:
                    self._on_stream(h, payload)
                    continue
                fut = self._pending.get(h.get("id"))
                if fut is not None and not fut.done():
                    fut.set_result((h, payload))
        except (
            asyncio.IncompleteReadError,
            ConnectionResetError,
            asyncio.CancelledError,
            OSError,
        ):
            pass
        finally:
            self._teardown()

    def _on_stream(self, h: dict, payload: bytes) -> None:
        sid = h["sid"]
        if sid in self._dead_sids:
            return  # cancelled stream's tail frames
        if sid not in self._subs and sid not in self._watches:
            # Raced ahead of registration — buffer for _register_stream.
            if sum(len(v) for v in self._orphans.values()) < self._MAX_ORPHANS:
                self._orphans.setdefault(sid, []).append((h, payload))
            else:
                logger.warning("dropping orphan stream frame for sid %s", sid)
            return
        self._dispatch_stream(h, payload)

    def _dispatch_stream(self, h: dict, payload: bytes) -> None:
        sid = h["sid"]
        if h["ev"] == "msg":
            sub = self._subs.get(sid)
            if sub is not None:
                sub._deliver(payload)
            return
        watch = self._watches.get(sid)
        if watch is not None:
            watch._emit(
                WatchEvent(EventKind(h["ev"]), h["key"], payload or None)
            )

    def _register_stream(self, sid: int) -> None:
        """Replay frames that arrived before the sid was installed."""
        for h, payload in self._orphans.pop(sid, []):
            self._dispatch_stream(h, payload)

    def _teardown(self) -> None:
        self.closed = True
        for fut in self._pending.values():
            if not fut.done():
                fut.set_exception(ConnectionError("control plane lost"))
        self._pending.clear()
        # cancel()/close() re-enter _cancel_stream, which pops from these
        # dicts — iterate over snapshots.
        for watch in list(self._watches.values()):
            watch.cancel()
        self._watches.clear()
        for sub in list(self._subs.values()):
            sub.close()
        self._subs.clear()

    async def close(self) -> None:
        self._pump.cancel()
        try:
            self._writer.close()
        except Exception:
            pass
        self._teardown()

    # -- KeyValueStore -------------------------------------------------------
    async def put(self, key: str, value: bytes, lease_id: int | None = None) -> None:
        await self._call({"op": "put", "key": key, "lease": lease_id}, value)

    async def create(self, key: str, value: bytes, lease_id: int | None = None) -> bool:
        resp, _ = await self._call(
            {"op": "create", "key": key, "lease": lease_id}, value
        )
        return bool(resp["created"])

    async def get(self, key: str) -> bytes | None:
        resp, data = await self._call({"op": "get", "key": key})
        return data if resp["found"] else None

    async def get_prefix(self, prefix: str) -> dict[str, bytes]:
        _, data = await self._call({"op": "get_prefix", "prefix": prefix})
        return wire.unpackb(data)

    async def delete(self, key: str) -> None:
        await self._call({"op": "delete", "key": key})

    async def delete_prefix(self, prefix: str) -> None:
        await self._call({"op": "delete_prefix", "prefix": prefix})

    async def grant_lease(self, ttl_s: float) -> int:
        resp, _ = await self._call({"op": "lease_grant", "ttl": ttl_s})
        return resp["lease"]

    async def keep_alive(self, lease_id: int) -> bool:
        # Keepalive gets its own fault point: lease death ⇒ deregister ⇒
        # drain is THE recovery path the reference encodes (disagg_serving
        # failure semantics) and the chaos suite must drive it alone.
        await FAULTS.maybe_fail_async("control.keepalive")
        resp, _ = await self._call({"op": "lease_keepalive", "lease": lease_id})
        return bool(resp["alive"])

    async def revoke_lease(self, lease_id: int) -> None:
        if self.closed:
            return  # connection gone ⇒ lease will TTL-expire server-side
        await self._call({"op": "lease_revoke", "lease": lease_id})

    async def watch_prefix(self, prefix: str) -> Watch:
        resp, data = await self._call({"op": "watch", "prefix": prefix})
        initial = wire.unpackb(data)
        watch = _RemoteWatch(initial, self, resp["sid"])
        self._watches[resp["sid"]] = watch
        self._register_stream(resp["sid"])
        return watch

    # -- MessageBus / queues / objects ---------------------------------------
    async def publish(
        self, subject: str, payload: bytes, require_subscriber: bool = False
    ) -> None:
        await self._call(
            {
                "op": "publish",
                "subject": subject,
                "require": require_subscriber,
            },
            payload,
        )

    async def broadcast(self, subject: str, payload: bytes) -> None:
        await self._call({"op": "broadcast", "subject": subject}, payload)

    async def subscribe(self, subject: str) -> Subscription:
        resp, _ = await self._call({"op": "subscribe", "subject": subject})
        sub = _RemoteSubscription(self, resp["sid"])
        self._subs[resp["sid"]] = sub
        self._register_stream(resp["sid"])
        return sub

    async def request(
        self, subject: str, payload: bytes, timeout_s: float = 5.0
    ) -> bytes:
        raise NotImplementedError("use PushRouter for request/stream")

    def work_queue(self, name: str) -> "RemoteQueue":
        return RemoteQueue(self, name)

    async def put_object(self, bucket: str, key: str, data: bytes) -> None:
        await self._call({"op": "obj_put", "bucket": bucket, "key": key}, data)

    async def get_object(self, bucket: str, key: str) -> bytes | None:
        resp, data = await self._call(
            {"op": "obj_get", "bucket": bucket, "key": key}
        )
        return data if resp["found"] else None

    async def list_objects(self, bucket: str, prefix: str = "") -> list[str]:
        resp, _ = await self._call(
            {"op": "obj_list", "bucket": bucket, "prefix": prefix}
        )
        return list(resp["keys"])

    async def delete_object(self, bucket: str, key: str) -> bool:
        resp, _ = await self._call(
            {"op": "obj_del", "bucket": bucket, "key": key}
        )
        return bool(resp["deleted"])

    def _cancel_stream(self, sid: int) -> None:
        self._watches.pop(sid, None)
        self._subs.pop(sid, None)
        self._orphans.pop(sid, None)
        self._dead_sids[sid] = None
        while len(self._dead_sids) > 4096:
            self._dead_sids.pop(next(iter(self._dead_sids)))
        if not self.closed:
            spawn_tracked(self._try_cancel(sid), name="control-cancel")

    async def _try_cancel(self, sid: int) -> None:
        try:
            await self._call({"op": "cancel", "sid": sid})
        except Exception:
            pass


class _RemoteWatch(Watch):
    def __init__(self, initial, client: ControlPlaneClient, sid: int) -> None:
        super().__init__(initial)
        self._client = client
        self._sid = sid

    def cancel(self) -> None:
        if not self.cancelled:
            super().cancel()
            self._client._cancel_stream(self._sid)


class _RemoteSubscription(Subscription):
    def __init__(self, client: ControlPlaneClient, sid: int) -> None:
        super().__init__()
        self._client = client
        self._sid = sid

    def close(self) -> None:
        if not self.closed:
            super().close()
            self._client._cancel_stream(self._sid)


class RemoteQueue:
    """WorkQueue over the control plane (the prefill-queue primitive)."""

    def __init__(self, client: ControlPlaneClient, name: str) -> None:
        self._client = client
        self.name = name

    async def enqueue(self, payload: bytes) -> None:
        await self._client._call(
            {"op": "q_enqueue", "name": self.name}, payload
        )

    async def dequeue(self, timeout_s: float | None = None) -> bytes | None:
        rpc_timeout = None if timeout_s is None else timeout_s + RPC_TIMEOUT_S
        resp, data = await self._client._call(
            {"op": "q_dequeue", "name": self.name, "timeout": timeout_s},
            timeout_s=rpc_timeout,
        )
        return data if resp["found"] else None

    async def dequeue_leased(
        self, timeout_s: float | None = None, lease_s: float = 30.0
    ) -> tuple[int, bytes] | None:
        """Visibility-timeout dequeue: the item redelivers unless ``ack``ed
        within ``lease_s`` (or immediately if this connection dies)."""
        rpc_timeout = None if timeout_s is None else timeout_s + RPC_TIMEOUT_S
        resp, data = await self._client._call(
            {
                "op": "q_dequeue", "name": self.name, "timeout": timeout_s,
                "lease": lease_s,
            },
            timeout_s=rpc_timeout,
        )
        return (resp["item"], data) if resp["found"] else None

    async def ack(self, item_id: int) -> bool:
        resp, _ = await self._client._call(
            {"op": "q_ack", "name": self.name, "item": item_id}
        )
        return bool(resp["acked"])

    async def nack(self, item_id: int) -> bool:
        resp, _ = await self._client._call(
            {"op": "q_nack", "name": self.name, "item": item_id}
        )
        return bool(resp["nacked"])

    async def depth(self) -> int:
        resp, _ = await self._client._call(
            {"op": "q_depth", "name": self.name}
        )
        return resp["depth"]

    async def oldest_age_s(self) -> float:
        return (await self.stats())[1]

    async def stats(self) -> tuple[int, float]:
        """(depth, oldest item age) in ONE round trip — the disagg hot
        path reads both per request."""
        resp, _ = await self._client._call(
            {"op": "q_depth", "name": self.name}
        )
        return resp["depth"], float(resp.get("oldest_age", 0.0))
