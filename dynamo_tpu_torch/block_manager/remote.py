"""G4 remote tier: blockset export and import between workers (port of
dynamo_tpu/block_manager/remote.py).

Role of the reference's distributed KVBM (reference:
lib/llm/src/block_manager.rs:119-146 export_local_blockset /
import_remote_blockset; block/nixl.rs RemoteBlock reads). Each worker
EXPORTS its host-tier blockset (sequence hashes, lease-bound in the
store, so a dead worker's set vanishes) and serves block bytes on a
``kv_blocks`` endpoint; peers IMPORT by watching the blockset prefix and
fetching bytes over the request plane, landing them in their own host
tier — from where the normal G2→G1 onboard scatters them into the
device cache.

Records ride the port's own MessagePack codec (runtime/transports/
wire.py). A block's ``dtype`` field names the host arena's numpy view:
the port holds bf16 rows as ``uint16`` (block_manager/storage.py), so a
bf16 record says ``uint16`` where the JAX package's says ``bfloat16``.
A mixed fleet shares no hash space anyway (BLAKE2b, llm/tokens.py).

Layout compatibility rides the export record, and a peer whose layout
differs is refused loudly, never reinterpreted.

A port client asks for batched frames (``"frames": True`` beside the
hashes): a peer server (block_manager/peer.py) then packs up to
``peer.FRAME_BYTES`` of block bytes into one response item, field by
field (``block_frame``), instead of one item per block. Each block keeps its
own bytes and CRC. A server that does not know the flag sends per-block
records, which the client reads too.
"""

from __future__ import annotations

import asyncio
import logging
from typing import AsyncIterator, Sequence

import numpy as np

from dynamo_tpu_torch.block_manager.integrity import INTEGRITY, block_checksum
from dynamo_tpu_torch.runtime.engine import Context
from dynamo_tpu_torch.runtime.transports import wire
from dynamo_tpu_torch.utils.faults import FAULTS
from dynamo_tpu_torch.utils.retry import BLOCK_IMPORT, retry_async

logger = logging.getLogger(__name__)

BLOCKSET_ROOT = "blocksets/"
KV_BLOCKS_ENDPOINT = "kv_blocks"
# A host-tier copy this small runs on the event loop: handing it to a
# worker thread and back costs two thread switches, which on a loaded
# host take longer than the copy itself.
INLINE_BYTES = 1 << 20


async def off_loop(nbytes: int | None, fn, *args):
    """``fn(*args)`` on the loop when it copies at most INLINE_BYTES, in a
    worker thread otherwise (or when the size is unknown): a long copy
    must not stall the loop."""
    if nbytes is not None and nbytes <= INLINE_BYTES:
        return fn(*args)
    return await asyncio.to_thread(fn, *args)


def match_bytes(manager, n: int) -> int | None:
    """Bytes a ``match_host`` of n blocks copies at most, when the
    manager says its layout."""
    layout = getattr(getattr(manager, "cfg", None), "layout", None)
    return None if layout is None else n * layout.block_bytes


def _block_bytes(data) -> tuple[np.ndarray, bytes, int]:
    """(array, bytes as sent, CRC of the bytes as serialised) of one
    served block. ``kvbm.corrupt_frame`` mutates the bytes between
    serialising and sending, so the importer's check must refuse them."""
    arr = np.ascontiguousarray(data)
    payload = arr.tobytes()
    crc = block_checksum(payload)
    if FAULTS.active:
        payload = FAULTS.corrupt("kvbm.corrupt_frame", payload)
    return arr, payload, crc


def block_record(h, parent, tokens, data) -> tuple[dict, int]:
    """One served block as its wire record, and its byte count."""
    arr, payload, crc = _block_bytes(data)
    return {
        "hash": h,
        "parent": parent,
        "tokens": list(tokens),
        "dtype": str(arr.dtype),
        "shape": list(arr.shape),
        "data": payload,
        "crc": crc,
    }, arr.nbytes


def block_frame(rows) -> dict:
    """Several served blocks (``match_host`` tuples: rows of one host
    arena, so of one dtype and shape) as ONE response item, field by
    field, the tokens as one int64 buffer: one frame and one codec pass
    per batch instead of per block (per-block items cost the response
    plane ~0.1 ms each on both ends, of the order of recomputing a
    block). Each block keeps its own bytes and CRC."""
    payloads, crcs = [], []
    for *_meta, data in rows:
        arr, payload, crc = _block_bytes(data)
        payloads.append(payload)
        crcs.append(crc)
    return {"blocks": {
        "hash": [r[0] for r in rows],
        "parent": [r[1] for r in rows],
        "ntok": [len(r[2]) for r in rows],
        "tokens": np.asarray(
            [t for r in rows for t in r[2]], np.int64
        ).tobytes(),
        "dtype": str(arr.dtype),
        "shape": list(arr.shape),
        "data": payloads,
        "crc": crcs,
    }}


def frame_records(item: dict):
    """(hash, parent, tokens, dtype, shape, bytes, crc) of each block of
    one response item: a batched frame's in order, or the item itself
    when it is one record."""
    cols = item.get("blocks")
    if cols is None:
        yield (item["hash"], item["parent"], item["tokens"], item["dtype"],
               item["shape"], item["data"], item.get("crc"))
        return
    tokens = np.frombuffer(cols["tokens"], np.int64).tolist()
    at = 0
    for i, n in enumerate(cols["ntok"]):
        yield (cols["hash"][i], cols["parent"][i], tokens[at:at + n],
               cols["dtype"], cols["shape"], cols["data"][i], cols["crc"][i])
        at += n


class RemoteBlockServer:
    """Export side: publish this worker's blockset + serve block bytes."""

    def __init__(
        self,
        drt,
        component,
        manager,
        layout: dict | None = None,
        refresh_s: float = 1.0,
    ) -> None:
        self._drt = drt
        self._component = component
        self._manager = manager
        self._layout = layout or {}
        self.refresh_s = refresh_s
        self._task: asyncio.Task | None = None
        self._published: frozenset[int] = frozenset()

    @property
    def _key(self) -> str:
        ns = self._component.namespace.name
        return (
            f"{BLOCKSET_ROOT}{ns}/{self._component.name}/"
            f"{self._drt.primary_lease_id:x}"
        )

    async def start(self) -> "RemoteBlockServer":
        await self._component.endpoint(KV_BLOCKS_ENDPOINT).serve(self)
        await self._publish()
        self._task = asyncio.ensure_future(self._refresh_loop())
        return self

    async def stop(self) -> None:
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass
        # Unpublish explicitly: the runtime (and its lease) may outlive
        # this exporter, and a frozen blockset would keep attracting
        # imports for blocks the host tier no longer holds.
        try:
            await self._drt.store.delete(self._key)
        except Exception:  # noqa: BLE001 — lease expiry reaps the key anyway
            logger.debug("blockset unpublish failed", exc_info=True)

    def _hashes(self) -> frozenset[int]:
        return self._manager.registered_hashes()

    async def _publish(self) -> None:
        hashes = self._hashes()
        if hashes == self._published:
            return
        await self._drt.store.put(
            self._key,
            wire.packb({"hashes": sorted(hashes), "layout": self._layout}),
            lease_id=self._drt.primary_lease_id,
        )
        # Only after the put succeeds — a transient store failure must
        # leave the set dirty so the refresh loop retries it.
        self._published = hashes

    async def _refresh_loop(self) -> None:
        while True:
            await asyncio.sleep(self.refresh_s)
            try:
                await self._publish()
            except asyncio.CancelledError:
                raise
            except Exception:  # noqa: BLE001 — retried next tick; peers see stale data
                logger.exception("blockset publish failed")

    # AsyncEngine: {"hashes": [...]} → stream of per-block records.
    async def generate(self, request: Context) -> AsyncIterator[dict]:
        hashes = list(request.payload.get("hashes") or [])
        # match_host copies block bytes under the manager lock — off the
        # event loop when it is long, or the fetch stalls this worker's
        # engine thread.
        blocks = await off_loop(match_bytes(self._manager, len(hashes)),
                                self._manager.match_host, hashes)
        for h, parent, tokens, data in blocks:
            yield block_record(h, parent, tokens, data)[0]


class RemoteBlockClient:
    """Import side: track peers' blocksets; fetch prefix blocks."""

    def __init__(self, drt, component, layout: dict | None = None) -> None:
        self._drt = drt
        self._component = component
        self._layout = layout or {}
        # instance hex -> set of hashes
        self._blocksets: dict[str, set[int]] = {}
        self._watch = None
        self._task: asyncio.Task | None = None
        self._router = None

    @property
    def _prefix(self) -> str:
        return (
            f"{BLOCKSET_ROOT}{self._component.namespace.name}/"
            f"{self._component.name}/"
        )

    async def start(self) -> "RemoteBlockClient":
        from dynamo_tpu_torch.runtime.egress import PushRouter, RouterMode

        self._router = await PushRouter.create(
            self._drt,
            self._component.endpoint(KV_BLOCKS_ENDPOINT).id,
            mode=RouterMode.DIRECT,
        )
        # The response-plane server a fetch's stream lands on, bound now:
        # the first pull must not pay for it on a parked request's clock.
        await self._drt.tcp_server()
        self._watch = await self._drt.store.watch_prefix(self._prefix)
        for key, raw in self._watch.initial.items():
            self._apply(key, raw)
        self._task = asyncio.ensure_future(self._pump())
        return self

    async def stop(self) -> None:
        if self._watch is not None:
            self._watch.cancel()
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass

    def _apply(self, key: str, raw: bytes | None) -> None:
        wid = key[len(self._prefix):]
        if raw is None:
            self._blocksets.pop(wid, None)
            return
        d = wire.unpackb(raw)
        if self._layout and d.get("layout") and d["layout"] != self._layout:
            # The refusal is LOUD (the disagg layout check's posture): a
            # quietly skipped peer looks like a cold fleet, and a
            # checksum-algorithm split means a legacy peer offers rows
            # this worker cannot verify.
            theirs = d["layout"] if isinstance(d["layout"], dict) else {}
            ours_algo = self._layout.get("checksum")
            theirs_algo = theirs.get("checksum")
            if theirs_algo != ours_algo:
                logger.warning(
                    "peer %s blockset REFUSED: checksum algorithm %r != "
                    "ours %r — its rows are unverifiable here (legacy "
                    "peer? upgrade it before pooling KV)",
                    wid, theirs_algo, ours_algo,
                )
            else:
                logger.warning(
                    "peer %s blockset REFUSED: incompatible KV layout "
                    "%r != ours %r", wid, d["layout"], self._layout,
                )
            self._blocksets.pop(wid, None)
            return
        self._blocksets[wid] = set(d.get("hashes") or [])

    async def _pump(self) -> None:
        from dynamo_tpu_torch.runtime.transports.store import EventKind

        async for ev in self._watch:
            try:
                self._apply(
                    ev.key, ev.value if ev.kind is EventKind.PUT else None
                )
            except Exception:  # noqa: BLE001 — one malformed event must not kill the pump
                logger.exception("blockset watch apply failed")

    def best_peer(self, hashes: Sequence[int]) -> tuple[str | None, int]:
        """(worker hex id, prefix length) of the peer holding the longest
        prefix of `hashes` (0 ⇒ nobody has even the first block)."""
        own_lease = f"{self._drt.primary_lease_id:x}"
        best, best_n = None, 0
        for wid, have in self._blocksets.items():
            if wid == own_lease:
                continue
            n = 0
            for h in hashes:
                if h not in have:
                    break
                n += 1
            if n > best_n:
                best, best_n = wid, n
        return best, best_n

    async def _fetch_attempt(
        self, wid: str, hashes: Sequence[int]
    ) -> list[tuple[int, int | None, tuple[int, ...], np.ndarray]]:
        """One un-retried fetch of `hashes` from peer `wid` (match_host
        tuples) — the body both this class's fetch and the peer tier's
        fault-instrumented fetch (block_manager/peer.py) wrap."""
        out = []
        ctx = Context({"hashes": list(hashes), "frames": True})
        async for item in self._router.direct(ctx, int(wid, 16)):
            for h, parent, tokens, dtype, shape, data, crc in frame_records(item):
                if crc is not None and block_checksum(data) != crc:
                    # Corrupt block: stop the imported prefix HERE (a
                    # child of a dropped block can never prefix-match) and
                    # let the requester recompute the tail. Checked BEFORE
                    # frombuffer — a truncated payload must not raise.
                    INTEGRITY.note_failure("peer")
                    logger.warning(
                        "peer %s block %x failed checksum in flight; "
                        "dropping the rest of the pull", wid, h,
                    )
                    return out
                arr = np.frombuffer(data, dtype=np.dtype(dtype)).reshape(shape)
                out.append((h, parent, tuple(tokens), arr))
        return out

    async def fetch(
        self, wid: str, hashes: Sequence[int]
    ) -> list[tuple[int, int | None, tuple[int, ...], np.ndarray]]:
        """Fetch blocks for `hashes` from peer `wid` (match_host tuples).
        Transport loss retries under the shared policy — the import is a
        read-only prefix pull, so a clean re-request is always safe."""
        return await retry_async(
            lambda: self._fetch_attempt(wid, hashes),
            BLOCK_IMPORT,
            seam="kvbm.import",
        )

    async def onboard_into(self, manager, hashes: Sequence[int]) -> int:
        """Pull the longest remote prefix into `manager`'s host tier; the
        next match_host (G2→G1 onboard) then hits locally. Returns the
        number of blocks imported."""
        missing = [h for h in hashes if not manager.has_host(h)]
        if not missing:
            return 0
        wid, n = self.best_peer(missing)
        if wid is None or n == 0:
            return 0
        blocks = await self.fetch(wid, missing[:n])
        for h, parent, tokens, data in blocks:
            manager.offer(h, parent, tokens, data)
        return len(blocks)
