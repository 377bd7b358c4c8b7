"""Control-plane server: the framework's own etcd+NATS-role service
(port of dynamo_tpu/runtime/transports/control_plane.py: the same ops
over the same frames, so either package's client talks to either
package's server).

One process runs a `ControlPlaneServer`; every worker process connects with
`transports/control_client.ControlPlaneClient` and gets the full discovery
plane (KV store with leases + prefix watches — reference:
lib/runtime/src/transports/etcd.rs:100-131,309), messaging plane (pub/sub
subjects with queue-group and broadcast delivery — reference:
transports/nats.rs:50-120), work queues (the prefill-queue primitive —
reference: transports/nats.rs:345-478 NatsQueue) and object store
(model-card/tokenizer blobs — reference: transports/nats.rs:123-196).

The authoritative state is simply a MemoryStore + InProcBus owned by the
server process; this module is the wire layer exposing them. Protocol: the
two-part codec (transports/codec.py) over TCP, header = MessagePack
control map (transports/wire.py), payload = opaque value bytes.

Request ops (header fields; V marks ops whose value rides the payload):
  auth(token)                       — must be first when the server has a token
  put(key, lease)V create(key, lease)V get(key) get_prefix(prefix)
  delete(key) delete_prefix(prefix)
  lease_grant(ttl) lease_keepalive(lease) lease_revoke(lease)
  watch(prefix) -> {sid, initial}; events stream as {sid, ev, key}V
  publish(subject)V broadcast(subject)V
  subscribe(subject) -> {sid}; messages stream as {sid, ev:"msg"}V
  cancel(sid)                       — stop a watch/subscription stream
  q_enqueue(name)V q_dequeue(name, timeout[, lease]) q_depth(name)
  q_ack(name, item) q_nack(name, item)
  obj_put(bucket, key)V obj_get(bucket, key)

Queue durability (reference: JetStream ack/redelivery semantics,
lib/runtime/src/transports/nats.rs:345-478): a q_dequeue with "lease"
returns {item} and holds the item in-flight until q_ack; lease expiry or
consumer-connection death nacks it back to the FRONT of the queue. A
legacy no-lease dequeue is served under a short internal lease that is
acked only after the response frame is written, so a connection dying
between dequeue and send never loses the item.

Responses echo the request "id": {"id", "ok", ...} (+payload for values).
A blocking q_dequeue is served by a per-request task so one long poll
never stalls the connection's other traffic.
"""

from __future__ import annotations

import asyncio
import hmac
import logging
from typing import Optional

from dynamo_tpu_torch.runtime.transports import wire
from dynamo_tpu_torch.runtime.transports.bus import InProcBus, NoSubscriberError
from dynamo_tpu_torch.runtime.transports.codec import encode_frame, read_frame
from dynamo_tpu_torch.runtime.transports.store import MemoryStore

logger = logging.getLogger(__name__)


class ControlPlaneServer:
    def __init__(
        self,
        host: str = "127.0.0.1",
        port: int = 0,
        token: Optional[str] = None,
        store: MemoryStore | None = None,
        bus: InProcBus | None = None,
    ) -> None:
        self.store = store if store is not None else MemoryStore()
        self.bus = bus if bus is not None else InProcBus()
        self._host = host
        self._port = port
        self._token = token
        self._server: asyncio.AbstractServer | None = None
        self._conns: set["_Conn"] = set()
        self.port: int = 0

    async def start(self) -> "ControlPlaneServer":
        self._server = await asyncio.start_server(
            self._on_conn, self._host, self._port
        )
        self.port = self._server.sockets[0].getsockname()[1]
        logger.info("control plane listening on %s:%d", self._host, self.port)
        return self

    @property
    def address(self) -> str:
        return f"{self._host}:{self.port}"

    async def stop(self) -> None:
        if self._server is not None:
            self._server.close()
            # Force-close live connections: wait_closed() (3.12+) waits for
            # their handlers, which otherwise block in read_frame forever.
            for conn in list(self._conns):
                await conn.close()
            await self._server.wait_closed()

    # -- per-connection ------------------------------------------------------
    async def _on_conn(self, reader, writer) -> None:
        conn = _Conn(self, reader, writer)
        self._conns.add(conn)
        try:
            await conn.run()
        except (asyncio.IncompleteReadError, ConnectionResetError):
            pass
        except Exception:
            logger.exception("control plane connection failed")
        finally:
            self._conns.discard(conn)
            await conn.close()


class _Conn:
    """One client connection: request dispatch + stream pumps."""

    def __init__(self, server: ControlPlaneServer, reader, writer) -> None:
        self.server = server
        self.reader = reader
        self.writer = writer
        self._wlock = asyncio.Lock()
        self._streams: dict[int, object] = {}  # sid -> Watch | Subscription
        self._pumps: list[asyncio.Task] = []
        self._sid = 0
        self._authed = server._token is None
        # Items this connection holds under lease; nacked back to the
        # queue if the consumer dies without acking.
        self._leased: set[tuple[str, int]] = set()

    async def _send(self, header: dict, payload: bytes = b"") -> None:
        async with self._wlock:
            self.writer.write(encode_frame(wire.packb(header), payload))
            await self.writer.drain()

    async def run(self) -> None:
        while True:
            header, payload = await read_frame(self.reader)
            h = wire.unpackb(header)
            op = h.get("op")
            if not self._authed:
                if op != "auth" or not hmac.compare_digest(
                    str(h.get("token", "")), self.server._token
                ):
                    logger.warning("control plane: rejected unauthed peer")
                    return
                self._authed = True
                await self._send({"id": h.get("id"), "ok": True})
                continue
            if op == "q_dequeue":
                # Long poll: serve concurrently, don't stall the connection.
                # Self-pruning — a worker polls this op for its whole
                # lifetime, so completed tasks must not accumulate.
                task = asyncio.ensure_future(self._q_dequeue(h))
                self._pumps.append(task)
                task.add_done_callback(
                    lambda t: t in self._pumps and self._pumps.remove(t)
                )
                continue
            try:
                await self._dispatch(op, h, payload)
            except Exception as exc:  # noqa: BLE001 — report, keep serving
                await self._send(
                    {"id": h.get("id"), "ok": False, "err": f"{exc}"}
                )

    async def _dispatch(self, op: str, h: dict, payload: bytes) -> None:
        store, bus = self.server.store, self.server.bus
        rid = h.get("id")
        if op == "put":
            await store.put(h["key"], payload, lease_id=h.get("lease"))
            await self._send({"id": rid, "ok": True})
        elif op == "create":
            created = await store.create(h["key"], payload, lease_id=h.get("lease"))
            await self._send({"id": rid, "ok": True, "created": created})
        elif op == "get":
            value = await store.get(h["key"])
            await self._send(
                {"id": rid, "ok": True, "found": value is not None},
                value or b"",
            )
        elif op == "get_prefix":
            d = await store.get_prefix(h["prefix"])
            await self._send({"id": rid, "ok": True}, wire.packb(d))
        elif op == "delete":
            await store.delete(h["key"])
            await self._send({"id": rid, "ok": True})
        elif op == "delete_prefix":
            await store.delete_prefix(h["prefix"])
            await self._send({"id": rid, "ok": True})
        elif op == "lease_grant":
            lease = await store.grant_lease(h["ttl"])
            await self._send({"id": rid, "ok": True, "lease": lease})
        elif op == "lease_keepalive":
            alive = await store.keep_alive(h["lease"])
            await self._send({"id": rid, "ok": True, "alive": alive})
        elif op == "lease_revoke":
            await store.revoke_lease(h["lease"])
            await self._send({"id": rid, "ok": True})
        elif op == "watch":
            watch = await store.watch_prefix(h["prefix"])
            sid = self._new_sid()
            self._streams[sid] = watch
            await self._send(
                {"id": rid, "ok": True, "sid": sid},
                wire.packb(watch.initial),
            )
            self._pumps.append(
                asyncio.ensure_future(self._pump_watch(sid, watch))
            )
        elif op == "publish":
            try:
                await bus.publish(
                    h["subject"], payload,
                    require_subscriber=bool(h.get("require")),
                )
            except NoSubscriberError as exc:
                # Typed so the remote publisher's mark-dead fast path
                # fires exactly as it would on the in-proc bus.
                await self._send({
                    "id": rid, "ok": False, "err": str(exc),
                    "err_type": "NoSubscriberError",
                })
                return
            await self._send({"id": rid, "ok": True})
        elif op == "broadcast":
            await bus.broadcast(h["subject"], payload)
            await self._send({"id": rid, "ok": True})
        elif op == "subscribe":
            sub = await bus.subscribe(h["subject"])
            sid = self._new_sid()
            self._streams[sid] = sub
            await self._send({"id": rid, "ok": True, "sid": sid})
            self._pumps.append(asyncio.ensure_future(self._pump_sub(sid, sub)))
        elif op == "cancel":
            stream = self._streams.pop(h["sid"], None)
            if stream is not None:
                _close_stream(stream)
            await self._send({"id": rid, "ok": True})
        elif op == "q_enqueue":
            await bus.work_queue(h["name"]).enqueue(payload)
            await self._send({"id": rid, "ok": True})
        elif op == "q_ack":
            done = await bus.work_queue(h["name"]).ack(h["item"])
            self._leased.discard((h["name"], h["item"]))
            await self._send({"id": rid, "ok": True, "acked": done})
        elif op == "q_nack":
            done = await bus.work_queue(h["name"]).nack(h["item"])
            self._leased.discard((h["name"], h["item"]))
            await self._send({"id": rid, "ok": True, "nacked": done})
        elif op == "q_depth":
            queue = bus.work_queue(h["name"])
            depth = await queue.depth()
            age = await queue.oldest_age_s()
            await self._send(
                {"id": rid, "ok": True, "depth": depth, "oldest_age": age}
            )
        elif op == "obj_put":
            await bus.put_object(h["bucket"], h["key"], payload)
            await self._send({"id": rid, "ok": True})
        elif op == "obj_get":
            data = await bus.get_object(h["bucket"], h["key"])
            await self._send(
                {"id": rid, "ok": True, "found": data is not None}, data or b""
            )
        elif op == "obj_list":
            keys = await bus.list_objects(h["bucket"], h.get("prefix", ""))
            await self._send({"id": rid, "ok": True, "keys": keys})
        elif op == "obj_del":
            deleted = await bus.delete_object(h["bucket"], h["key"])
            await self._send({"id": rid, "ok": True, "deleted": deleted})
        else:
            await self._send({"id": rid, "ok": False, "err": f"bad op {op!r}"})

    # Internal lease covering a legacy (no-lease) dequeue between queue pop
    # and a successful send — so a dying connection can't lose the item.
    SEND_GRACE_S = 30.0

    async def _q_dequeue(self, h: dict) -> None:
        name = h["name"]
        queue = self.server.bus.work_queue(name)
        lease = h.get("lease")
        got = None
        try:
            got = await queue.dequeue_leased(
                timeout_s=h.get("timeout"),
                lease_s=lease if lease is not None else self.SEND_GRACE_S,
            )
            if got is None:
                await self._send({"id": h.get("id"), "ok": True, "found": False})
                return
            item_id, payload = got
            if lease is not None:
                self._leased.add((name, item_id))
            await self._send(
                {"id": h.get("id"), "ok": True, "found": True, "item": item_id},
                payload,
            )
            if lease is None:
                await queue.ack(item_id)  # delivered — retire the grace lease
            got = None  # delivery complete; no rollback below
        except asyncio.CancelledError:
            pass
        except Exception as exc:  # noqa: BLE001
            try:
                await self._send(
                    {"id": h.get("id"), "ok": False, "err": f"{exc}"}
                )
            except Exception:
                pass
        finally:
            if got is not None:
                # Dequeued but never delivered (send failed / cancelled):
                # put it straight back at the front.
                item_id, _ = got
                self._leased.discard((name, item_id))
                await queue.nack(item_id)

    def _new_sid(self) -> int:
        self._sid += 1
        return self._sid

    async def _pump_watch(self, sid: int, watch) -> None:
        try:
            async for ev in watch:
                await self._send(
                    {"sid": sid, "ev": ev.kind.value, "key": ev.key},
                    ev.value or b"",
                )
        except (ConnectionResetError, asyncio.CancelledError):
            pass

    async def _pump_sub(self, sid: int, sub) -> None:
        try:
            async for payload in sub:
                await self._send({"sid": sid, "ev": "msg"}, payload)
        except (ConnectionResetError, asyncio.CancelledError):
            pass

    async def close(self) -> None:
        for stream in self._streams.values():
            _close_stream(stream)
        self._streams.clear()
        for task in self._pumps:
            task.cancel()
        # Consumer died holding leases — redeliver its items immediately
        # rather than waiting for the visibility timeout.
        for name, item_id in list(self._leased):
            try:
                await self.server.bus.work_queue(name).nack(item_id)
            except Exception:
                logger.exception("nack of %s/%s on close failed", name, item_id)
        self._leased.clear()
        try:
            self.writer.close()
        except Exception:
            pass


def _close_stream(stream) -> None:
    cancel = getattr(stream, "cancel", None) or getattr(stream, "close", None)
    if cancel is not None:
        cancel()
