"""Server-side request handling (port of dynamo_tpu/runtime/ingress.py).

Wraps an AsyncEngine as a served endpoint: subscribe the endpoint's bus
subject, and for each request envelope spawn a handler that runs the
engine and streams its items back over the TCP response plane.

Request envelope (MessagePack, transports/wire.py): ``{"id": str,
"payload": <obj>, "resp": {host, port, stream_id}, "trace": {trace_id,
parent_span, sent_unix}}``. The handler adopts the caller's trace id
before any work, so every span it records (and any error frame it sends)
joins the caller's timeline, and finishes the capture when the stream
ends, however it ends. A request's ``deadline_ms`` rides inside its
payload. Response frames carry MessagePack items; the last frame is an
end or err control frame (transports/tcp.py).
"""

from __future__ import annotations

import asyncio
import logging
from typing import Any

from dynamo_tpu_torch.llm.protocols.common import ShedError
from dynamo_tpu_torch.runtime.component import Endpoint, Instance
from dynamo_tpu_torch.runtime.engine import AsyncEngine, Context
from dynamo_tpu_torch.runtime.transports import wire
from dynamo_tpu_torch.runtime.transports.tcp import ConnectionInfo, TcpResponseSender
from dynamo_tpu_torch.utils.logging import request_scope
from dynamo_tpu_torch.utils.task import spawn_tracked
from dynamo_tpu_torch.utils.tracing import TraceContext, tracer

logger = logging.getLogger(__name__)


class ServedInstance:
    """A live served endpoint plus its teardown. Proxies the registered
    ``Instance``'s attributes. ``stop()`` deregisters and halts the
    request pump; ``drain()`` is the loss-free variant (stop accepting,
    finish the in-flight handlers, deregister first); ``kill()`` is
    abrupt death."""

    def __init__(self, drt, instance: Instance, sub, task, inflight: set) -> None:
        self.instance = instance
        self._drt = drt
        self._sub = sub
        self._task = task
        self._inflight = inflight
        #: Requests this endpoint has taken (the worker's /metrics).
        self.requests_total = 0

    def __getattr__(self, name):
        return getattr(self.instance, name)

    @property
    def inflight(self) -> int:
        """Requests currently being handled by this endpoint."""
        return len(self._inflight)

    async def _deregister(self) -> None:
        try:
            await self._drt.store.delete(self.instance.store_key)
        except Exception:  # noqa: BLE001 — the store may be gone at teardown
            logger.debug("instance deregister failed", exc_info=True)

    async def _stop_pump(self) -> None:
        self._sub.close()
        self._task.cancel()
        try:
            await self._task
        except asyncio.CancelledError:
            pass

    async def drain(self, grace_s: float = 30.0) -> bool:
        """Graceful retirement: deregister first (routers stop picking
        this instance), stop the request pump, then wait up to
        ``grace_s`` for in-flight handlers to finish streaming (the
        response plane is direct TCP, independent of discovery). True
        when nothing was abandoned."""
        await self._deregister()
        await self._stop_pump()
        pending = {t for t in self._inflight if not t.done()}
        if pending:
            _done, still = await asyncio.wait(pending, timeout=grace_s)
            if still:
                logger.warning(
                    "drain grace expired with %d request(s) in flight", len(still)
                )
                return False
        return True

    async def stop(self) -> None:
        await self._stop_pump()
        await self._deregister()

    async def kill(self) -> None:
        """Abrupt worker death: the subscription closes and every
        in-flight handler is cancelled, its response socket aborted with
        no terminal frame, so each caller sees ``WorkerDiedError`` and
        fails over. Does not deregister: a crashed process never cleans
        up discovery — the lease TTL or the router's mark-dead fast path
        evicts the corpse."""
        self._sub.close()
        self._task.cancel()
        doomed = [self._task, *self._inflight]
        for t in doomed[1:]:
            t.cancel()
        for t in doomed:
            try:
                await t
            except (asyncio.CancelledError, Exception):  # noqa: BLE001 — dying
                pass


async def serve_endpoint(
    drt, endpoint: Endpoint, engine: AsyncEngine
) -> ServedInstance:
    """Register ``engine`` as a live instance of ``endpoint`` and start
    the request pump."""
    lease_id = drt.primary_lease_id
    subject = endpoint.subject_for(lease_id)
    instance = Instance(endpoint=endpoint.id, lease_id=lease_id, subject=subject)

    sub = await drt.bus.subscribe(subject)
    await drt.store.put(instance.store_key, instance.to_json(), lease_id=lease_id)
    # Live handler tasks of this endpoint, awaited by drain().
    inflight: set[asyncio.Future] = set()
    served: ServedInstance | None = None

    async def pump() -> None:
        try:
            async for raw in sub:
                served.requests_total += 1
                t = spawn_tracked(_handle_request(engine, raw), name="ingress-request")
                inflight.add(t)
                t.add_done_callback(inflight.discard)
        except asyncio.CancelledError:
            pass

    task = asyncio.ensure_future(pump())
    served = ServedInstance(drt, instance, sub, task, inflight)
    drt.runtime.token.on_cancel(lambda: (sub.close(), task.cancel()))
    logger.info("serving %s on %s (lease %#x)", endpoint.id, subject, lease_id)
    return served


async def _handle_request(engine: AsyncEngine, raw: bytes) -> None:
    envelope = wire.unpackb(raw)
    sender: TcpResponseSender | None = None
    rid = envelope.get("id", "")
    ctx_trace = TraceContext.from_wire(envelope.get("trace"))
    tracer().adopt(rid, ctx_trace)
    trace_id = ctx_trace.trace_id if ctx_trace is not None else None
    with request_scope(rid, trace_id):
        try:
            info = ConnectionInfo.from_wire(envelope["resp"])
            sender = await TcpResponseSender.connect(info)
            ctx: Context[Any] = Context(envelope["payload"], id=rid)
            async for item in engine.generate(ctx):
                await sender.send(wire.packb(item, default=_default))
            await sender.end()
            # The engine finishes the requests it runs; a payload that
            # bypassed it only opened a capture through adopt() above.
            tracer().finish(rid)
        except asyncio.CancelledError:
            # Abrupt worker death (ServedInstance.kill, process teardown):
            # abort with NO terminal frame, so the caller fails over.
            tracer().mark_if_active(rid, "error")
            tracer().finish(rid)
            if sender is not None:
                sender.abort()
            raise
        except Exception as exc:  # noqa: BLE001 — report to the caller, keep serving
            logger.exception("request %s failed", rid)
            # Mark and finish under the trace id the caller finishes its
            # half with: the error plane orphans nothing.
            tracer().mark_if_active(rid, "error")
            tracer().finish(rid)
            if sender is not None:
                try:
                    await sender.error(_wire_error(exc))
                except (ConnectionError, OSError):
                    pass


def _wire_error(exc: Exception) -> str:
    """Error-frame text for the response plane. ShedError carries its
    retry/draining hints in a parseable prefix (transports/tcp.py
    ``_typed_stream_error`` decodes it); every ConnectionError (engine
    death, a lost transport under the handler) crosses as the one name
    the decoder re-types as failover-eligible."""
    if isinstance(exc, ShedError):
        return f"ShedError[{exc.retry_after_s:g},{int(exc.draining)}]: {exc}"
    if isinstance(exc, ConnectionError):
        return f"WorkerDiedError: {exc}"
    return f"{type(exc).__name__}: {exc}"


def _default(obj):
    """Wire fallback for dataclass-like payloads."""
    if hasattr(obj, "to_wire"):
        return obj.to_wire()
    if hasattr(obj, "__dict__"):
        return obj.__dict__
    raise TypeError(f"cannot serialize {type(obj).__name__}")
