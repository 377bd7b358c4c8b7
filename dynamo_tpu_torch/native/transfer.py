"""ctypes bindings for the C++ transfer agent (port of
dynamo_tpu/native/transfer.py; the agent's source is the port's own copy,
csrc/transfer_agent/agent.cpp).

`TransferServer` owns registered numpy arenas; remote peers write into them
with zero Python in the data path (the C++ thread memcpys straight into the
arena). `TransferClient` is the sender side. Completion notifications carry
opaque bytes (MessagePack at our call sites) drained via `poll()`.
"""

from __future__ import annotations

import ctypes
import logging

import numpy as np

from dynamo_tpu_torch.native.build import load_library

logger = logging.getLogger(__name__)

_SOURCES = ["csrc/transfer_agent/agent.cpp"]


def _lib():
    lib = load_library("transfer_agent", _SOURCES)
    if lib is None:
        return None
    lib.ta_create.restype = ctypes.c_void_p
    lib.ta_create.argtypes = [ctypes.c_char_p, ctypes.c_uint16, ctypes.c_char_p]
    lib.ta_port.restype = ctypes.c_uint16
    lib.ta_port.argtypes = [ctypes.c_void_p]
    lib.ta_register.restype = ctypes.c_int
    lib.ta_register.argtypes = [
        ctypes.c_void_p, ctypes.c_uint64, ctypes.c_void_p, ctypes.c_uint64,
    ]
    lib.ta_unregister.restype = ctypes.c_int
    lib.ta_unregister.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
    lib.ta_poll.restype = ctypes.c_int64
    lib.ta_poll.argtypes = [
        ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_uint64),
        ctypes.c_char_p,
        ctypes.c_uint32,
    ]
    lib.ta_destroy.argtypes = [ctypes.c_void_p]
    lib.ta_connect.restype = ctypes.c_void_p
    lib.ta_connect.argtypes = [
        ctypes.c_char_p, ctypes.c_uint16, ctypes.c_char_p,
    ]
    lib.ta_write.restype = ctypes.c_int
    lib.ta_write.argtypes = [
        ctypes.c_void_p, ctypes.c_uint64, ctypes.c_uint64,
        ctypes.c_void_p, ctypes.c_uint64,
    ]
    lib.ta_notify.restype = ctypes.c_int
    lib.ta_notify.argtypes = [
        ctypes.c_void_p, ctypes.c_uint64, ctypes.c_void_p, ctypes.c_uint32,
    ]
    lib.ta_read.restype = ctypes.c_int64
    lib.ta_read.argtypes = [
        ctypes.c_void_p, ctypes.c_uint64, ctypes.c_uint64,
        ctypes.c_void_p, ctypes.c_uint64,
    ]
    lib.ta_close.argtypes = [ctypes.c_void_p]
    return lib


def available() -> bool:
    return _lib() is not None


class TransferServer:
    def __init__(self, port: int = 0, bind_host: str = "127.0.0.1") -> None:
        """bind_host="0.0.0.0" accepts cross-host peers (the reference's
        NIXL plane is multi-node); the default stays loopback-only. Every
        server requires peers to AUTH with `self.token` (distribute it via
        the trusted control plane) — the wire protocol is otherwise
        unauthenticated raw memory writes."""
        self._lib = _lib()
        if self._lib is None:
            raise RuntimeError("native transfer agent unavailable")
        import secrets

        self.token: bytes = secrets.token_bytes(16)
        self._h = self._lib.ta_create(bind_host.encode(), port, self.token)
        if not self._h:
            raise RuntimeError("ta_create failed")
        self.port = self._lib.ta_port(self._h)
        self._meta_buf = ctypes.create_string_buffer(1 << 20)
        # Keep registered arrays alive — the C++ side holds raw pointers.
        self._pinned: dict[int, np.ndarray] = {}

    def register(self, region_id: int, arena: np.ndarray) -> None:
        arena = np.ascontiguousarray(arena)
        rc = self._lib.ta_register(
            self._h, region_id, arena.ctypes.data_as(ctypes.c_void_p),
            arena.nbytes,
        )
        if rc != 0:
            raise RuntimeError(f"ta_register({region_id}) failed")
        self._pinned[region_id] = arena

    def unregister(self, region_id: int) -> None:
        self._lib.ta_unregister(self._h, region_id)
        self._pinned.pop(region_id, None)

    def poll(self) -> tuple[int, bytes] | None:
        """Drain one completion: (tag, meta) or None."""
        tag = ctypes.c_uint64()
        n = self._lib.ta_poll(
            self._h, ctypes.byref(tag), self._meta_buf,
            len(self._meta_buf),
        )
        if n < 0:
            return None
        return tag.value, self._meta_buf.raw[:n]

    def close(self) -> None:
        if self._h:
            self._lib.ta_destroy(self._h)
            self._h = None


class TransferClient:
    def __init__(self, host: str, port: int, token: bytes | None = None) -> None:
        self._lib = _lib()
        if self._lib is None:
            raise RuntimeError("native transfer agent unavailable")
        if token is not None and len(token) != 16:
            raise ValueError("auth token must be 16 bytes")
        # ta_connect takes a dotted quad (inet_pton, no DNS) — resolve
        # hostnames here so advertise addresses like "decode-0.svc" work.
        import socket

        host = socket.gethostbyname(host)
        self._c = self._lib.ta_connect(host.encode(), port, token)
        if not self._c:
            raise ConnectionError(f"ta_connect {host}:{port} failed")

    def write(self, region_id: int, offset: int, data: np.ndarray) -> None:
        data = np.ascontiguousarray(data)
        rc = self._lib.ta_write(
            self._c, region_id, offset,
            data.ctypes.data_as(ctypes.c_void_p), data.nbytes,
        )
        if rc != 0:
            raise ConnectionError("ta_write failed")

    def notify(self, tag: int, meta: bytes = b"") -> None:
        rc = self._lib.ta_notify(self._c, tag, meta, len(meta))
        if rc != 0:
            raise ConnectionError("ta_notify failed")

    def read(self, region_id: int, offset: int, nbytes: int) -> bytes:
        buf = ctypes.create_string_buffer(nbytes)
        n = self._lib.ta_read(self._c, region_id, offset, buf, nbytes)
        if n < 0:
            raise ConnectionError(f"ta_read failed ({n})")
        return buf.raw[:n]

    def close(self) -> None:
        if self._c:
            self._lib.ta_close(self._c)
            self._c = None
