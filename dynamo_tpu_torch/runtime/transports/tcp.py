"""TCP response plane (port of dynamo_tpu/runtime/transports/tcp.py).

Requests ride the message bus to a worker; the response stream comes
straight back over a TCP connection from the worker to the caller.
Protocol: the worker connects and sends a prologue frame whose header is
``{"stream_id": ...}``, then data frames with headers ``{"t": "data"}``,
and ends with ``{"t": "err"}`` (message in the payload) or
``{"t": "end"}``. Headers are MessagePack maps (transports/wire.py), so
either package's worker can answer either package's caller.
"""

from __future__ import annotations

import asyncio
import logging
import re
from dataclasses import dataclass
from typing import Any, AsyncIterator

from dynamo_tpu_torch.llm.protocols.common import (
    DeadlineError,
    RequestError,
    ShedError,
    WorkerDiedError,
)
from dynamo_tpu_torch.runtime.transports import wire
from dynamo_tpu_torch.runtime.transports.codec import encode_frame, read_frame
from dynamo_tpu_torch.utils.faults import FAULTS

logger = logging.getLogger(__name__)

_DATA = wire.packb({"t": "data"})
_ERR = wire.packb({"t": "err"})
_END = wire.packb({"t": "end"})


@dataclass(frozen=True)
class ConnectionInfo:
    """Where the worker connects to stream responses back."""

    host: str
    port: int
    stream_id: str

    def to_wire(self) -> dict[str, Any]:
        return {"host": self.host, "port": self.port, "stream_id": self.stream_id}

    @staticmethod
    def from_wire(d: dict[str, Any]) -> "ConnectionInfo":
        return ConnectionInfo(d["host"], d["port"], d["stream_id"])


class ResponseStreamReceiver:
    """Caller-side handle: an async iterator of response payload bytes.

    A stream ends cleanly on its terminal frame (``end``, or ``err``
    raised as its typed error); a connection that closes with no terminal
    frame is worker death, raised as ``WorkerDiedError`` with
    ``transport_dead`` set — the failover plane's trigger."""

    def __init__(self) -> None:
        self._queue: asyncio.Queue[tuple[str, bytes] | None] = asyncio.Queue()
        #: Set when the worker's connection presents this stream id: the
        #: dispatch ack the router's connect timeout waits for.
        self.connected = asyncio.Event()
        self._terminal = False

    def _push(self, kind: str, payload: bytes) -> None:
        if kind in ("end", "err"):
            self._terminal = True
        self._queue.put_nowait((kind, payload))

    def _close(self) -> None:
        self._queue.put_nowait(None)

    def __aiter__(self) -> AsyncIterator[bytes]:
        return self

    async def __anext__(self) -> bytes:
        item = await self._queue.get()
        if item is None:
            if not self._terminal:
                err = WorkerDiedError(
                    "response stream closed without a terminal frame — "
                    "worker died mid-stream"
                )
                err.transport_dead = True
                raise err
            raise StopAsyncIteration
        kind, payload = item
        if kind == "end":
            raise StopAsyncIteration
        if kind == "err":
            raise _typed_stream_error(payload.decode("utf-8", "replace"))
        return payload


def _typed_stream_error(message: str) -> Exception:
    """Re-type a worker-side error that crossed the wire as a
    ``"TypeName: message"`` frame (runtime/ingress.py ``_wire_error``), so
    a remote frontend maps it as a local one would (429/503/504/400, 502
    with failover). ShedError frames carry their hints as
    ``ShedError[<retry_after_s>,<0|1>]: msg``; an unknown name becomes a
    RuntimeError."""
    m = re.match(r"^ShedError\[([0-9.eE+-]+),([01])\]: (.*)$", message, re.S)
    if m:
        return ShedError(
            m.group(3), retry_after_s=float(m.group(1)), draining=m.group(2) == "1"
        )
    name, sep, rest = message.partition(": ")
    typed = {
        "ShedError": ShedError,
        "DeadlineError": DeadlineError,
        "RequestError": RequestError,
        "WorkerDiedError": WorkerDiedError,
    }.get(name)
    if sep and typed is not None:
        return typed(rest)
    return RuntimeError(message)


class TcpStreamServer:
    """Caller-side server accepting response streams from workers."""

    def __init__(self, host: str = "127.0.0.1") -> None:
        self._host = host
        self._server: asyncio.base_events.Server | None = None
        self._pending: dict[str, ResponseStreamReceiver] = {}
        self.port: int = 0

    async def start(self) -> None:
        self._server = await asyncio.start_server(self._on_conn, self._host, 0)
        self.port = self._server.sockets[0].getsockname()[1]

    async def stop(self) -> None:
        if self._server:
            self._server.close()
            await self._server.wait_closed()

    def register(self, stream_id: str) -> ResponseStreamReceiver:
        receiver = ResponseStreamReceiver()
        self._pending[stream_id] = receiver
        return receiver

    def unregister(self, stream_id: str) -> None:
        """Forget a stream whose worker never connected: a late
        connection is then logged and dropped."""
        self._pending.pop(stream_id, None)

    def connection_info(self, stream_id: str) -> ConnectionInfo:
        return ConnectionInfo(self._host, self.port, stream_id)

    async def _on_conn(
        self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter
    ) -> None:
        receiver: ResponseStreamReceiver | None = None
        try:
            header, _ = await read_frame(reader)
            prologue = wire.unpackb(header)
            receiver = self._pending.pop(prologue["stream_id"], None)
            if receiver is None:
                logger.warning("unknown stream id %s", prologue.get("stream_id"))
                return
            receiver.connected.set()
            while True:
                header, payload = await read_frame(reader)
                kind = wire.unpackb(header)["t"]
                receiver._push(kind, payload)
                if kind in ("end", "err"):
                    break
        except (asyncio.IncompleteReadError, ConnectionError):
            pass
        finally:
            if receiver is not None:
                receiver._close()
            writer.close()


class TcpResponseSender:
    """Worker-side handle: connect back to the caller and stream frames."""

    def __init__(self, writer: asyncio.StreamWriter) -> None:
        self._writer = writer

    @staticmethod
    async def connect(info: ConnectionInfo) -> "TcpResponseSender":
        _, writer = await asyncio.open_connection(info.host, info.port)
        writer.write(encode_frame(wire.packb({"stream_id": info.stream_id})))
        await writer.drain()
        return TcpResponseSender(writer)

    async def send(self, payload: bytes) -> None:
        # A raise here is the caller vanishing mid-stream; the worker's
        # handler treats a failed send as the request's cancellation.
        if FAULTS.active:
            await FAULTS.maybe_fail_async("tcp.respond")
        self._writer.write(encode_frame(_DATA, payload))
        await self._writer.drain()

    async def error(self, message: str) -> None:
        self._writer.write(encode_frame(_ERR, message.encode()))
        await self._writer.drain()

    async def end(self) -> None:
        try:
            self._writer.write(encode_frame(_END))
            await self._writer.drain()
        finally:
            self._writer.close()

    def abort(self) -> None:
        """Close with no terminal frame — worker death as the caller sees
        it (``WorkerDiedError``, failover-eligible)."""
        self._writer.transport.abort()
