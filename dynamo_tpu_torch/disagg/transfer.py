"""KV-block transfer plane: prefill worker → decode worker device cache
(port of dynamo_tpu/disagg/transfer.py).

The role NIXL plays in the reference (reference: docs/architecture/
disagg_serving.md:78-109 — RDMA write of computed KV into the decode
worker's pre-allocated blocks + completion notification). Here: TCP into
the decode host's memory, then a host→device scatter on the decode
engine's thread. Framing is the runtime's two-part codec; payloads are raw
block bytes (dtype/shape from the header), so a future C++ agent can speak
the identical protocol (native/transfer_agent).

Wire: header MessagePack (runtime/transports/wire.py) {"req": id, "kind": "block"|"finish", "idx": n,
"dtype": str, "shape": [..], "crc": n} + payload bytes.

Every receiver counts what it landed (``blocks_received``,
``bytes_received``), so a caller can tell which transport carried a
request's blocks.
"""

from __future__ import annotations

import asyncio
import logging
from typing import Callable

import numpy as np

from dynamo_tpu_torch.block_manager.integrity import INTEGRITY, block_checksum
from dynamo_tpu_torch.runtime.transports import wire
from dynamo_tpu_torch.runtime.transports.codec import encode_frame, read_frame
from dynamo_tpu_torch.utils.faults import FAULTS
from dynamo_tpu_torch.utils.retry import TRANSFER, retry_async

logger = logging.getLogger(__name__)


class KvReceiver:
    """Decode-side landing server. `on_block(req, idx, data)` and
    `on_finish(req, first_token)` are called as frames land (thread-safe
    targets: the engine's submit queue)."""

    def __init__(
        self,
        on_block: Callable[[str, int, np.ndarray], None],
        on_finish: Callable[[str, int], None],
        host: str = "127.0.0.1",
    ) -> None:
        import secrets

        self._on_block = on_block
        self._on_finish = on_finish
        self._host = host
        self._server: asyncio.AbstractServer | None = None
        self.port: int = 0
        # Hex token peers must present in their first frame (distributed
        # via the trusted control plane — the queue entry).
        self.auth: str = secrets.token_hex(16)
        self.blocks_received = 0
        self.bytes_received = 0
        self._writers: set = set()  # open peer connections (closed by stop)

    async def start(self) -> "KvReceiver":
        # `host` is the ADVERTISE address; a non-loopback one implies
        # remote peers, so bind all interfaces (shared policy).
        from dynamo_tpu_torch.disagg.net import bind_for_advertise

        # A read buffer of a few frames: at the default 64 KiB the stream
        # pauses and resumes the socket several times per 512 KiB block.
        self._server = await asyncio.start_server(
            self._on_conn, bind_for_advertise(self._host), 0, limit=1 << 22
        )
        self.port = self._server.sockets[0].getsockname()[1]
        return self

    @property
    def address(self) -> str:
        return f"{self._host}:{self.port}"

    async def _on_conn(self, reader, writer) -> None:
        import hmac

        self._writers.add(writer)
        try:
            # Auth-first: the connection's first frame must carry the token.
            header, _ = await read_frame(reader)
            h = wire.unpackb(header)
            if h.get("kind") != "auth" or not hmac.compare_digest(
                str(h.get("token", "")), self.auth
            ):
                logger.warning("kv receiver: rejected unauthenticated peer")
                return
            while True:
                header, payload = await read_frame(reader)
                # Injected receive failure: raise/partition kills the
                # connection mid-transfer (the sender's retry/requeue
                # path takes over); drop silently loses ONE frame — the
                # decode side's remote_kv_timeout then degrades the
                # request to local recompute.
                if FAULTS.active and not await FAULTS.maybe_fail_async(
                    "disagg.recv", can_drop=True
                ):
                    continue
                h = wire.unpackb(header)
                if h["kind"] == "block":
                    crc = h.get("crc")
                    if crc is not None and block_checksum(payload) != crc:
                        # Corrupt KV frame: treated EXACTLY like a
                        # dropped one (checked before frombuffer — a
                        # truncated payload must not raise) — the hole
                        # in the completeness ledger degrades the
                        # request to local recompute, byte-identical.
                        INTEGRITY.note_failure("frame")
                        logger.warning(
                            "kv receiver: frame %s/%s failed checksum; "
                            "dropped", h.get("req"), h.get("idx"),
                        )
                        continue
                    data = np.frombuffer(payload, dtype=h["dtype"]).reshape(
                        h["shape"]
                    )
                    self.blocks_received += 1
                    self.bytes_received += len(payload)
                    self._on_block(h["req"], h["idx"], data)
                elif h["kind"] == "finish":
                    # Correlate the landing with the request's trace —
                    # mark ONLY an already-open trace: a late finish
                    # frame for a cancelled request must not re-open one
                    # that would then leak until the TTL sweep.
                    from dynamo_tpu_torch.utils.tracing import tracer

                    tracer().mark_if_active(h["req"], "kv_landed")
                    self._on_finish(h["req"], h["first_token"])
                    # ack so the sender can sequence completion
                    writer.write(encode_frame(wire.packb({"ok": True})))
                    await writer.drain()
        except (asyncio.IncompleteReadError, ConnectionResetError):
            pass
        except Exception:
            logger.exception("kv receiver connection failed")
        finally:
            self._writers.discard(writer)
            writer.close()

    async def stop(self) -> None:
        if self._server is not None:
            self._server.close()
            # A peer (a prefill worker's cached sender) may keep its
            # connection open: close it, or wait_closed waits for it.
            for writer in list(self._writers):
                writer.close()
            await self._server.wait_closed()


class KvSender:
    """Prefill-side pusher. One connection per destination worker, reused
    across requests."""

    # Bound on the completion-ack wait: a receiver that accepted every
    # frame but never acks (wedged process, lost finish frame) must fail
    # the attempt — retryable TimeoutError — not hang the prefill worker.
    # Sized so the WHOLE retried send (3 ack waits + backoff, capped by
    # TRANSFER.deadline_s) finishes inside the decode side's
    # remote_kv_timeout_s (default 30 s): retrying past the moment the
    # decode engine degrades the request to local recompute only holds
    # the per-destination lock against other requests' sends.
    ACK_TIMEOUT_S = 8.0

    def __init__(self) -> None:
        self._conns: dict[str, tuple] = {}
        self._locks: dict[str, asyncio.Lock] = {}

    def _lock(self, address: str) -> asyncio.Lock:
        if address not in self._locks:
            self._locks[address] = asyncio.Lock()
        return self._locks[address]

    async def _conn(self, address: str, auth: str | None = None):
        if address not in self._conns:
            host, port = address.rsplit(":", 1)
            reader, writer = await asyncio.open_connection(host, int(port))
            # Auth-first frame (see KvReceiver._on_conn).
            writer.write(
                encode_frame(
                    wire.packb({"kind": "auth", "token": auth or ""})
                )
            )
            await writer.drain()
            self._conns[address] = (reader, writer)
        return self._conns[address]

    async def send_blocks(
        self,
        address: str,
        request_id: str,
        blocks: list[np.ndarray],
        first_token: int,
        start_idx: int = 0,
        auth: str | None = None,
        trace_id: str | None = None,
    ) -> None:
        """Push all blocks then the completion notification; awaits the
        receiver's ack (the reference's NIXL completion semantics). The
        per-destination lock keeps concurrent requests' ack reads ordered.
        Transport loss retries on a FRESH connection under the shared
        backoff policy (utils/retry.py TRANSFER — the reference's NIXL
        transfer-retry role); resends are safe because the receiver
        scatters blocks idempotently by (req, idx).

        ``trace_id`` rides the frame headers (docs/architecture/
        observability.md): a transfer captured on the wire — or logged by
        the receiver — stays attributable to its request's trace."""
        async with self._lock(address):
            try:
                await retry_async(
                    lambda: self._send_locked(
                        address, request_id, blocks, first_token, start_idx,
                        auth, trace_id,
                    ),
                    TRANSFER,
                    seam="disagg.send",
                    on_retry=lambda _exc, _n: self._drop_conn(address),
                )
            except BaseException:
                # Budget exhausted (or non-retryable): the cached socket
                # may still be live with THIS request's ack pending — a
                # reuse would read that late ack as the NEXT request's
                # completion and desync every send after it.
                self._drop_conn(address)
                raise

    def _drop_conn(self, address: str) -> None:
        conn = self._conns.pop(address, None)
        if conn is not None:
            conn[1].close()

    async def _send_locked(
        self, address, request_id, blocks, first_token, start_idx=0,
        auth=None, trace_id=None,
    ) -> None:
        await FAULTS.maybe_fail_async("disagg.send")
        reader, writer = await self._conn(address, auth)
        for i, data in enumerate(blocks, start=start_idx):
            arr = np.ascontiguousarray(data)
            payload = arr.tobytes()
            header = {
                "req": request_id,
                "kind": "block",
                "idx": i,
                "dtype": arr.dtype.str,
                "shape": list(arr.shape),
                # Integrity envelope over the exact payload bytes: the
                # receiver refuses a frame whose bytes drifted in flight
                # (the layout handshake advertised the algorithm —
                # disagg/worker.py _check_layout).
                "crc": block_checksum(payload),
            }
            if trace_id:
                header["trace"] = trace_id
            if FAULTS.active:
                # Wire corruption after the crc was stamped — exactly
                # what the receiver-side check must catch.
                payload = FAULTS.corrupt("kvbm.corrupt_frame", payload)
            writer.write(encode_frame(wire.packb(header), payload))
            # Drain per frame: with a prompt's whole KV (tens of MB)
            # buffered in the transport, every socket send moves the rest
            # of the buffer.
            await writer.drain()
        fin = {
            "req": request_id, "kind": "finish", "first_token": first_token,
        }
        if trace_id:
            fin["trace"] = trace_id
        writer.write(encode_frame(wire.packb(fin)))
        await writer.drain()
        # Completion ack, bounded (see ACK_TIMEOUT_S). The conn is
        # dropped on every failure path — between retries AND at budget
        # exhaustion (send_blocks) — so a late ack on this socket can
        # never be read as a later request's completion.
        await asyncio.wait_for(read_frame(reader), self.ACK_TIMEOUT_S)

    async def close(self) -> None:
        for _, writer in self._conns.values():
            writer.close()
        self._conns.clear()
