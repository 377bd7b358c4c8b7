"""Two-part frame codec for response streams and the control plane (port
of dynamo_tpu/runtime/transports/codec.py).

Frame layout: ``[u32 header_len][u32 payload_len][header][payload]`` with
little-endian lengths. Headers are small MessagePack control maps
(transports/wire.py); payloads are opaque bytes.
"""

from __future__ import annotations

import asyncio
import struct

_LEN = struct.Struct("<II")
MAX_FRAME = 64 * 1024 * 1024


def encode_frame(header: bytes, payload: bytes = b"") -> bytes:
    return _LEN.pack(len(header), len(payload)) + header + payload


async def read_frame(reader: asyncio.StreamReader) -> tuple[bytes, bytes]:
    raw = await reader.readexactly(_LEN.size)
    hlen, plen = _LEN.unpack(raw)
    if hlen > MAX_FRAME or plen > MAX_FRAME:
        raise ValueError(f"frame too large: header={hlen} payload={plen}")
    header = await reader.readexactly(hlen) if hlen else b""
    payload = await reader.readexactly(plen) if plen else b""
    return header, payload
