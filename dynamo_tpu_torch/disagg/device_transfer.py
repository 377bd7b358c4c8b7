"""Device-path KV transfer: same-process prefill→decode block moves on
the card (port of dynamo_tpu/disagg/device_transfer.py).

When the prefill and decode engines share one process, block bytes never
touch host memory: the prefill side snapshots its blocks as one device
tensor (``ModelRunner.gather_many_device``) and the decode side scatters
it straight into its cache (``scatter_many_device``). A decode operator
advertises this channel beside its wire receiver in the queue entry; the
prefill worker picks it only if the address resolves in its own process
registry.

The channel crosses two engine threads, and a torch stream is current
per thread: the producer records an event after its gather, the consumer
makes its own stream wait on that event before the scatter, and, where
the two streams differ, marks the snapshot as used on its stream
(``record_stream``) so the producer's allocator cannot hand the memory
out before the scatter ran. The snapshot is a tensor of its own, so the
prefill side releases its blocks at once.
"""

from __future__ import annotations

import logging
import secrets
import threading
from typing import Callable

logger = logging.getLogger(__name__)

_REGISTRY: dict[str, "DeviceKvReceiver"] = {}
_REGISTRY_LOCK = threading.Lock()

SCHEME = "device://"


class BlockBatch:
    """A device snapshot [N, ...] shipped as ONE unit — one gather on the
    prefill side, one scatter on the decode side. ``scales`` ([N, L, 2,
    kvH]) rides along for int8 pairs. On the card the constructor records
    an event on the producer's current stream; ``consume()`` (on the
    consumer's thread) orders the consumer's stream after it. Host arrays
    (the mocker's) need neither."""

    def __init__(self, data, scales=None) -> None:
        self.data = data
        self.scales = scales
        self.event = None
        self.stream = None
        if getattr(data, "is_cuda", False):
            import torch

            self.stream = torch.cuda.current_stream(data.device)
            self.event = torch.cuda.Event()
            self.event.record(self.stream)

    def __len__(self) -> int:
        return int(self.data.shape[0])

    def __getitem__(self, key):
        if isinstance(key, slice):
            out = BlockBatch.__new__(BlockBatch)
            out.data = self.data[key]
            out.scales = self.scales[key] if self.scales is not None else None
            out.event, out.stream = self.event, self.stream
            return out
        return self.data[key]

    def consume(self):
        """(data, scales), ready to read on the caller's current stream."""
        if self.event is not None:
            import torch

            current = torch.cuda.current_stream(self.data.device)
            current.wait_event(self.event)
            if current != self.stream:
                self.data.record_stream(current)
                if self.scales is not None:
                    self.scales.record_stream(current)
        return self.data, self.scales


def resolve(address: str) -> "DeviceKvReceiver | None":
    """Look the address up in THIS process's registry (None ⇒ the sender
    lives in another process and must use the wire path)."""
    with _REGISTRY_LOCK:
        return _REGISTRY.get(address)


class DeviceKvReceiver:
    """Decode-side registration for in-process device transfers. The same
    callback contract as the wire receivers (engine submit-queue targets),
    but ``data`` is a device snapshot the engine scatters without host
    staging."""

    def __init__(
        self,
        on_block: Callable[[str, int, object], None],
        on_finish: Callable[[str, int], None],
        on_blocks: Callable[[str, int, object], None] | None = None,
    ) -> None:
        self._on_block = on_block
        self._on_finish = on_finish
        self._on_blocks = on_blocks  # batched form: (req, start_idx, [N,...])
        self.address = SCHEME + secrets.token_hex(8)
        self.auth = secrets.token_hex(16)
        self.blocks_received = 0
        self.bytes_received = 0

    async def start(self) -> "DeviceKvReceiver":
        with _REGISTRY_LOCK:
            _REGISTRY[self.address] = self
        return self

    async def stop(self) -> None:
        with _REGISTRY_LOCK:
            _REGISTRY.pop(self.address, None)

    # Called by DeviceKvSender (same process, possibly another task/thread).
    def deliver_block(self, request_id: str, idx: int, data) -> None:
        self.blocks_received += 1
        self._on_block(request_id, idx, data)

    def deliver_batch(self, request_id: str, start_idx: int, data) -> None:
        """One [N, ...] device snapshot (a BlockBatch). Falls back to
        per-block delivery when the receiver has no batched callback."""
        n = len(data)
        self.blocks_received += n
        self.bytes_received += int(data.data.nbytes)
        if self._on_blocks is not None:
            self._on_blocks(request_id, start_idx, data)
        else:
            for i in range(n):
                self._on_block(request_id, start_idx + i, data[i])

    def deliver_finish(self, request_id: str, first_token: int) -> None:
        self._on_finish(request_id, first_token)


class DeviceKvSender:
    """Prefill-side: hand device-resident block snapshots to the in-process
    receiver. `send_blocks` mirrors the wire senders' signature."""

    async def send_blocks(
        self,
        address: str,
        request_id: str,
        blocks: list,
        first_token: int,
        start_idx: int = 0,
        auth: str | None = None,
        **_ignored,
    ) -> None:
        receiver = resolve(address)
        if receiver is None:
            raise ConnectionError(f"{address} not registered in this process")
        if auth != receiver.auth:
            raise PermissionError("bad device-channel auth token")
        if isinstance(blocks, BlockBatch):
            if len(blocks):
                receiver.deliver_batch(request_id, start_idx, blocks)
        else:
            for i, block in enumerate(blocks):
                receiver.deliver_block(request_id, start_idx + i, block)
        receiver.deliver_finish(request_id, first_token)

    async def close(self) -> None:
        pass
