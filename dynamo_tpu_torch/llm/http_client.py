"""A small HTTP/1.1 client on asyncio streams, standard library only: one
request per connection, ``Content-Length`` and chunked responses, each
chunk handed to a callback as it arrives (what a streaming client needs
to time SSE events). The port's tests and chip_smoke.py drive the OpenAI
service with it."""

from __future__ import annotations

import asyncio
import json
from dataclasses import dataclass
from typing import Any, Callable

from dynamo_tpu_torch.llm.protocols.sse import SseEvent, decode_stream


@dataclass
class HttpResponse:
    status: int
    headers: dict[str, str]
    body: bytes

    def json(self) -> Any:
        return json.loads(self.body)

    def events(self) -> list[SseEvent]:
        return list(decode_stream(self.body.decode()))


async def fetch(
    host: str,
    port: int,
    method: str,
    path: str,
    body: Any = None,
    headers: dict[str, str] | None = None,
    on_chunk: Callable[[bytes], None] | None = None,
    timeout: float = 300.0,
) -> HttpResponse:
    """One request; ``body`` (if not None) is sent as JSON. ``on_chunk``
    sees each piece of the response body as it is read."""
    reader, writer = await asyncio.open_connection(host, port)
    try:
        return await asyncio.wait_for(
            _exchange(reader, writer, host, method, path, body, headers or {},
                      on_chunk),
            timeout,
        )
    finally:
        writer.close()
        try:
            await writer.wait_closed()
        except ConnectionError:
            pass


async def _exchange(reader, writer, host, method, path, body, headers, on_chunk):
    data = b"" if body is None else json.dumps(body).encode()
    lines = [f"{method} {path} HTTP/1.1", f"Host: {host}", "Connection: close",
             f"Content-Length: {len(data)}"]
    if body is not None:
        lines.append("Content-Type: application/json")
    lines += [f"{k}: {v}" for k, v in headers.items()]
    writer.write(("\r\n".join(lines) + "\r\n\r\n").encode("latin-1") + data)
    await writer.drain()

    status_line = await reader.readline()
    status = int(status_line.split()[1])
    resp_headers: dict[str, str] = {}
    while True:
        line = await reader.readline()
        if line in (b"\r\n", b"\n", b""):
            break
        name, _, value = line.decode("latin-1").partition(":")
        resp_headers[name.strip().lower()] = value.strip()
    parts: list[bytes] = []

    def got(piece: bytes) -> None:
        parts.append(piece)
        if on_chunk is not None:
            on_chunk(piece)

    if resp_headers.get("transfer-encoding", "").lower() == "chunked":
        while True:
            size = int((await reader.readline()).split(b";")[0], 16)
            if size == 0:
                await reader.readline()
                break
            got(await reader.readexactly(size))
            await reader.readexactly(2)
    elif "content-length" in resp_headers:
        got(await reader.readexactly(int(resp_headers["content-length"])))
    else:
        got(await reader.read())
    return HttpResponse(status, resp_headers, b"".join(parts))
