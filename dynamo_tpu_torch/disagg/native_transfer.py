"""Disagg KV transfer over the native C++ agent (port of
dynamo_tpu/disagg/native_transfer.py).

The production data path (reference analogue: NIXL write + notification,
docs/architecture/disagg_serving.md:78-109): the decode worker reserves
staging slots in a registered host arena; the prefill worker's C++ client
writes block bytes straight into those slots (no Python on the receive
path) and posts one notification; the decode side drains completions,
scatters host→device on the engine thread, and frees the slots.

Each reservation registers its slots as their own generation-tagged
regions (region id = generation<<16 | slot) and unregisters them on
release/expiry — a LATE write from a slow prefill whose reservation
expired bounces at the C++ region lookup instead of corrupting whatever
request now owns the physical slot.

Under ``transport="auto"`` the decode operator falls back to
disagg/transfer.py's asyncio implementation when the native library
cannot build; an explicit ``transport="native"`` raises instead.
"""

from __future__ import annotations

import asyncio
import logging
import time

import numpy as np

from dynamo_tpu_torch.block_manager.config import KvLayoutConfig
from dynamo_tpu_torch.block_manager.integrity import INTEGRITY, block_checksum
from dynamo_tpu_torch.native.transfer import TransferClient, TransferServer
from dynamo_tpu_torch.runtime.transports import wire
from dynamo_tpu_torch.utils.faults import FAULTS
from dynamo_tpu_torch.utils.retry import TRANSFER, retry_async

logger = logging.getLogger(__name__)

class NativeKvReceiver:
    """Decode-side: staging arena + completion pump."""

    def __init__(
        self,
        on_block,
        on_finish,
        layout: KvLayoutConfig,
        num_slots: int = 64,
        host: str = "127.0.0.1",
        reservation_timeout_s: float = 30.0,
    ) -> None:
        self._on_block = on_block
        self._on_finish = on_finish
        self.layout = layout
        self._host = host
        self.block_bytes = layout.block_bytes
        self._arena = np.zeros((num_slots, self.block_bytes), np.uint8)
        self._free = list(range(num_slots - 1, -1, -1))
        # request_id -> (region_ids, reserve_time). Region ids are
        # generation-tagged (gen<<16 | slot) and registered/unregistered
        # with the C++ server per reservation.
        self._reserved: dict[str, tuple[list[int], float]] = {}
        self._gen = 1
        self._timeout_s = reservation_timeout_s
        self.server: TransferServer | None = None
        self.auth: str | None = None  # hex token peers must present
        self._pump: asyncio.Task | None = None
        self.blocks_received = 0
        self.bytes_received = 0

    async def start(self) -> "NativeKvReceiver":
        from dynamo_tpu_torch.disagg.net import bind_for_advertise

        self.server = TransferServer(bind_host=bind_for_advertise(self._host))
        self.auth = self.server.token.hex()
        self._pump = asyncio.ensure_future(self._poll_loop())
        return self

    @property
    def address(self) -> str:
        return f"{self._host}:{self.server.port}"

    def reserve(self, request_id: str, n_blocks: int) -> list[int] | None:
        """Claim staging slots for one inbound transfer; None if exhausted.

        Returns generation-tagged REGION ids (not raw slot indices): each
        is registered with the server for exactly this reservation's
        lifetime, so a late write from an expired transfer bounces at the
        region lookup instead of landing in a recycled slot."""
        if len(self._free) < n_blocks:
            self._expire()
            if len(self._free) < n_blocks:
                return None
        gen = self._gen
        self._gen += 1
        regions = []
        for _ in range(n_blocks):
            slot = self._free.pop()
            region = (gen << 16) | slot
            self.server.register(region, self._arena[slot])
            regions.append(region)
        self._reserved[request_id] = (regions, time.monotonic())
        return regions

    def _expire(self) -> None:
        now = time.monotonic()
        for rid, (slots, t0) in list(self._reserved.items()):
            if now - t0 > self._timeout_s:
                logger.warning("expiring staging reservation %s", rid)
                self._release(rid)

    def release(self, request_id: str) -> None:
        """Public release of a reservation whose transfer completed out of
        band (e.g. the sender took the same-process device path)."""
        self._release(request_id)

    def _release(self, request_id: str) -> None:
        regions, _ = self._reserved.pop(request_id, ([], 0.0))
        for region in regions:
            self.server.unregister(region)
            self._free.append(region & 0xFFFF)

    async def _poll_loop(self) -> None:
        while True:
            ev = self.server.poll()
            if ev is None:
                await asyncio.sleep(0.002)
                continue
            try:
                self._handle(ev)
            except Exception:  # noqa: BLE001 — one bad completion event must not kill the poll loop; the request times out and degrades
                logger.exception("bad native transfer completion")

    def _handle(self, ev: tuple[int, bytes]) -> None:
        _, meta = ev
        m = wire.unpackb(meta)
        rid = m["req"]
        if rid not in self._reserved:
            logger.warning("completion for unknown reservation %s", rid)
            return
        # The sender's metadata is untrusted: only regions actually
        # reserved for THIS request may be read, else a buggy or malicious
        # peer could feed another request's staged bytes into this one.
        owned = set(self._reserved[rid][0])
        try:
            shape = tuple(m["shape"])
            dtype = np.dtype(m["dtype"])
            if not shape or any(
                not isinstance(d, int) or d <= 0 for d in shape
            ):
                raise ValueError(f"bad block shape {shape}")
            nbytes = dtype.itemsize * int(np.prod(shape))
            if nbytes > self.block_bytes:
                raise ValueError(f"block payload {nbytes}B > {self.block_bytes}B")
            crcs = m.get("crcs")
            for j, (seq_idx, region) in enumerate(m["blocks"]):
                if region not in owned:
                    raise ValueError(
                        f"region {region} not reserved for request {rid}"
                    )
                staged = self._arena[region & 0xFFFF, :nbytes]
                if crcs is not None and block_checksum(staged) != crcs[j]:
                    # Staged bytes drifted from what the sender hashed
                    # (wire corruption or a torn write into the slot):
                    # skip the block — the hole in the completeness
                    # ledger degrades the request to local recompute,
                    # byte-identical. Checked before the dtype view so a
                    # short write can never surface as garbage KV.
                    INTEGRITY.note_failure("frame")
                    logger.warning(
                        "native kv receiver: staged block %s/%s failed "
                        "checksum; dropped", rid, seq_idx,
                    )
                    continue
                data = (
                    staged
                    .view(dtype)
                    .reshape(shape)
                    .copy()  # slot is about to be freed/reused
                )
                self.blocks_received += 1
                self.bytes_received += nbytes
                self._on_block(rid, seq_idx, data)
            self._on_finish(rid, m["first_token"])
        finally:
            # Always free the reservation — a malformed completion must not
            # leak slots until the expiry sweep.
            self._release(rid)

    async def stop(self) -> None:
        if self._pump is not None:
            self._pump.cancel()
            try:
                await self._pump
            except asyncio.CancelledError:
                pass
        if self.server is not None:
            self.server.close()


class NativeKvSender:
    """Prefill-side: one C++ connection per destination."""

    def __init__(self) -> None:
        self._conns: dict[str, TransferClient] = {}

    def _conn(self, address: str, auth: str | None = None) -> TransferClient:
        if address not in self._conns:
            host, port = address.rsplit(":", 1)
            token = bytes.fromhex(auth) if auth else None
            self._conns[address] = TransferClient(host, int(port), token)
        return self._conns[address]

    async def send_blocks(
        self,
        address: str,
        request_id: str,
        blocks: list[np.ndarray],
        first_token: int,
        start_idx: int = 0,
        staging_slots: list[int] | None = None,
        staging_pitch: int | None = None,
        auth: str | None = None,
    ) -> None:
        assert staging_slots is not None and len(staging_slots) == len(blocks)

        def push(client: TransferClient) -> None:
            entries = []
            crcs = []
            shape, dtype = None, None
            for j, data in enumerate(blocks):
                arr = np.ascontiguousarray(data)
                shape, dtype = list(arr.shape), arr.dtype.str
                pitch = staging_pitch or arr.nbytes
                if arr.nbytes > pitch:
                    raise ValueError(
                        f"block {arr.nbytes}B exceeds staging pitch {pitch}B"
                    )
                # staging_slots carry generation-tagged region ids; each
                # region IS one staging slot, so the write offset is 0.
                region = staging_slots[j]
                # Integrity envelope over the exact bytes handed to the
                # C++ client; the decode side re-hashes the staged slot
                # before trusting it (corruption on the wire or in the
                # staging arena shows up as a mismatch there).
                payload = arr.tobytes()
                crcs.append(block_checksum(payload))
                if FAULTS.active:
                    # Mutate AFTER the crc was stamped — wire corruption
                    # the receiver-side check must catch. A truncating
                    # mutation writes only a prefix of the slot.
                    payload = FAULTS.corrupt("kvbm.corrupt_frame", payload)
                client.write(region, 0, np.frombuffer(payload, np.uint8))
                entries.append([start_idx + j, region])
            client.notify(
                0,
                wire.packb(
                    {
                        "req": request_id,
                        "first_token": first_token,
                        "blocks": entries,
                        "shape": shape,
                        "dtype": dtype,
                        "crcs": crcs,
                    }
                ),
            )

        # Connection construction (incl. DNS resolution) happens inside the
        # worker thread — a slow resolver must not stall the event loop.
        def attempt() -> None:
            FAULTS.maybe_fail("disagg.send")
            push(self._conn(address, auth))

        def drop_stale(_exc, _n) -> None:
            stale = self._conns.pop(address, None)
            if stale is not None:
                stale.close()

        # Shared backoff policy (utils/retry.py), fresh connection per
        # retry. Re-pushing already-landed writes is safe: the receiver's
        # completion handler frees the reservation, so a duplicate notify
        # after success bounces at the region lookup instead of landing.
        try:
            await retry_async(
                lambda: asyncio.to_thread(attempt),
                TRANSFER,
                seam="disagg.native_send",
                on_retry=drop_stale,
            )
        except BaseException:
            # Budget exhausted: a half-written frame may sit on the cached
            # socket — never reuse it for the next request.
            drop_stale(None, 0)
            raise

    async def close(self) -> None:
        for c in self._conns.values():
            c.close()
        self._conns.clear()
