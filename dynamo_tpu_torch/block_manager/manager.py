"""KvBlockManager: the multi-tier orchestrator (port of
dynamo_tpu/block_manager/manager.py, without the G4 peer tier).

Wires the tiers (reference: lib/llm/src/block_manager.rs:89-174
KvBlockManager): the engine owns G1 (its paged device cache + allocator); this
manager owns G2 (host DRAM pool) and G3 (disk pool) and the movement
between them. The engine thread hands gathered block bytes in via
`offer()` (G1→G2, batched to an asyncio pump so serving never blocks on
tier writes), the scheduler queries `match_host()` on prefix miss, and
onboarding returns bytes for the engine to scatter back into the device
cache. A device gather reaches ``offer_batch`` as an asynchronous host
copy (ops/kv_copy.py ``HostCopy``): the pump's worker thread waits on
that copy's event, never on the device.

Thread model: BlockPool mutations run under one lock — `offer` is called
from the engine thread, the offload pump and G2→G3 demotion on the asyncio
loop (reference leans on Rust Send/Sync; Python gets a mutex).
"""

from __future__ import annotations

import asyncio
import logging
import time
from collections import deque
from typing import Callable, Sequence

import numpy as np

from dynamo_tpu_torch.block_manager.config import KvbmConfig
from dynamo_tpu_torch.block_manager.integrity import INTEGRITY, block_checksum
from dynamo_tpu_torch.block_manager.offload import OffloadManager, RateEMA
from dynamo_tpu_torch.block_manager.pool import BlockPool, BlockState
from dynamo_tpu_torch.block_manager.storage import DiskStorage, HostStorage
from dynamo_tpu_torch.engine.kv_cache import KvEvent
from dynamo_tpu_torch.utils.concurrency import make_lock
from dynamo_tpu_torch.utils.faults import FAULTS

logger = logging.getLogger(__name__)


def _select_and_materialize(data, rows: list[int], n_keep: int, scales=None):
    """Offload-pump worker-thread step: materialize the dedup-kept rows
    to a host ndarray. Returns (array, scale array or None, row indices
    into the data array).

    HOST batches row-select BEFORE the copy, so dropped rows never pay.
    A device gather arrives as an asynchronous host copy
    (ops/kv_copy.py ``HostCopy``): ``np.asarray`` waits on its event
    here, on the pump's worker thread, then selects on the host. The
    engine pre-filters offers by has_host, so batches with dropped rows
    only arise from races and the full-batch copy waste is bounded.

    ``scales`` is the optional per-block scale batch [N, L, 2, H] an
    int8-G1 engine gathered alongside the data (kv_quant passthrough);
    it is selected by the SAME original row set and returned row-aligned
    with the data."""
    orig = list(rows)
    if isinstance(data, np.ndarray) and len(rows) < data.shape[0]:
        data = data[np.asarray(rows)]
        rows = list(range(n_keep))
    arr = np.asarray(data)
    if arr.ndim > 0 and len(rows) < arr.shape[0]:
        arr = arr[np.asarray(rows)]
        rows = list(range(n_keep))
    sc = None
    if scales is not None:
        sc = np.asarray(scales)
        if sc.ndim > 0 and sc.shape[0] != n_keep:
            sc = sc[np.asarray(orig)]
    return arr, sc, rows


class KvBlockManager:
    def __init__(
        self,
        cfg: KvbmConfig,
        on_event: Callable[[KvEvent], None] | None = None,
    ) -> None:
        assert cfg.layout is not None, "KvbmConfig.layout required"
        self.cfg = cfg
        self._lock = make_lock("kvbm.pool")
        self.host_pool: BlockPool | None = None
        self.disk_pool: BlockPool | None = None
        self._g2_to_g3: OffloadManager | None = None
        if cfg.host_blocks > 0:
            # Intercept host-tier evictions so the disk-origin markers
            # can't outlive their blocks (see _host_event), then forward
            # to the caller's handler.
            self.host_pool = BlockPool(
                HostStorage(cfg.host_blocks, cfg.layout),
                on_event=self._host_event,
            )
        self._external_event = on_event
        if cfg.disk_blocks > 0:
            assert cfg.disk_path, "disk tier needs disk_path"
            disk_storage = DiskStorage(
                cfg.disk_blocks, cfg.layout, cfg.disk_path,
                persist=cfg.disk_persist,
            )
            self.disk_pool = BlockPool(disk_storage)
            # Crash recovery: adopt every sidecar-named block whose bytes
            # verified (storage dropped the torn tail) — the next request
            # over the lost suffix recomputes, byte-identical.
            for idx, h, parent, tokens, crc in (
                disk_storage.recovered_entries()
            ):
                self.disk_pool.adopt(idx, h, parent, tokens, crc)
        if self.host_pool and self.disk_pool:
            self._g2_to_g3 = OffloadManager(
                self.host_pool,
                self.disk_pool,
                cfg.offload_concurrency,
                lock=self._lock,
            )
        # (hash, parent, tokens, bytes) handed over from the engine thread.
        self._offers: deque = deque()
        self._offer_signal: asyncio.Event | None = None
        self._pump_task: asyncio.Task | None = None
        self._offered: set[int] = set()
        self._promotions: set[asyncio.Task] = set()  # in-flight G3→G2
        self._promoting: set[int] = set()  # leading hash per in-flight promo
        # Tier telemetry (KV observatory — docs/architecture/
        # observability.md): per-request host-prefix hit/miss block
        # counts, stores, promotion requests, the G1→G2 store rate, and
        # which host-resident hashes arrived via DISK promotion — so the
        # engine can split actual reuse into G2-native vs G3-origin.
        self._host_hit_blocks = 0
        self._host_miss_blocks = 0
        self._host_stored_blocks = 0
        self._promotions_requested = 0
        self._promoted_blocks = 0
        self._from_disk: set[int] = set()
        self._store_rate = RateEMA()
        # Quantized-tier telemetry (docs/architecture/kv_quant.md):
        # blocks stored quantized into G2 and the cumulative bytes saved
        # vs storing them in the compute dtype (G3's share is derived in
        # stats() from the offload edge's block count — every chained
        # block is already packed).
        self._quant_stored_blocks = 0
        # Integrity envelope (block_manager/integrity.py): hashes whose
        # block failed verification — barred from re-announce
        # (host_entries / registered_hashes) until a FRESH store
        # re-stamps them — plus the G3 scrubber's sweep cursor and its
        # injectable pacing clock (tests substitute a recorded sleep).
        self._barred: set[int] = set()
        self._scrub_cursor = 0
        self._scrub_task: asyncio.Task | None = None
        self._scrub_sleep = asyncio.sleep

    def _host_event(self, ev: KvEvent) -> None:
        """Host-pool event tap. On eviction, drop the block's disk-origin
        marker — without this, a promoted-then-abandoned hash would pin a
        `_from_disk` entry forever (the lazy prune in count_disk_origin
        only fires when that exact hash is queried again, so the set
        would grow without bound under prefix churn). Locking: store-path
        invocations hold self._lock, but evictions triggered from
        OffloadManager._onboard_blocking fire under ITS lock instead —
        keep this handler to GIL-atomic ops (set.discard) only."""
        if ev.kind == "removed":
            for h in ev.block_hashes:
                self._from_disk.discard(h)
        if self._external_event is not None:
            self._external_event(ev)

    # -- lifecycle (asyncio side) ------------------------------------------
    async def start(self) -> "KvBlockManager":
        # A marker whose _go callback never ran (loop stopped between
        # call_soon_threadsafe and execution) would otherwise suppress
        # promotion of that prefix FOREVER in the restarted pump — the
        # promotion tasks it guarded are gone, so the set must be too.
        with self._lock:
            self._promoting.clear()
        self._offer_signal = asyncio.Event()
        self._pump_task = asyncio.ensure_future(self._pump())
        if self.disk_pool is not None and self.cfg.scrub_blocks_per_tick > 0:
            self._scrub_task = asyncio.ensure_future(self._scrub_loop())
        return self

    async def stop(self) -> None:
        for attr in ("_pump_task", "_scrub_task"):
            task = getattr(self, attr)
            if task is not None:
                task.cancel()
                try:
                    await task
                except asyncio.CancelledError:
                    pass
                setattr(self, attr, None)
        with self._lock:
            self._promoting.clear()

    # -- engine-thread API --------------------------------------------------
    def offer(
        self,
        sequence_hash: int,
        parent_hash: int | None,
        tokens: Sequence[int],
        data: np.ndarray,
        scales=None,
    ) -> None:
        """G1 block registered — stage its bytes for host-tier storage.
        Thread-safe, non-blocking; duplicates are dropped."""
        self.offer_batch(
            [(sequence_hash, parent_hash, tuple(tokens))], [data],
            scales=scales if scales is None else scales[None],
        )

    def offer_batch(self, entries, data, scales=None) -> None:
        """Batched offer: `entries` is (hash, parent, tokens) rows; `data`
        is anything np.asarray turns into [N, ...] block bytes — including
        a DEVICE-resident gather, whose host materialization is deferred to
        the pump's worker thread so the engine thread never pays the D2H
        sync on the serving path. The device snapshot is a copy made at
        dispatch (ops/kv_copy.py), so a later G1 rewrite can't race it.

        ``scales`` ([N, L, 2, H], host or device) rides along when the
        offering engine's G1 cache is int8 (kv_quant): the pump then
        packs (data, scales) bit-exactly instead of re-quantizing."""
        if self.host_pool is None:
            return
        keep: list[tuple[int, int | None, tuple]] = []
        rows: list[int] = []
        with self._lock:
            for i, (h, parent, tokens) in enumerate(entries):
                if (
                    h in self._offered
                    or self.host_pool.get_by_hash(h) is not None
                ):
                    continue
                self._offered.add(h)
                keep.append((h, parent, tuple(tokens)))
                rows.append(i)
        if not keep:
            return
        self._offers.append((keep, rows, data, scales))
        if self._offer_signal is not None:
            try:
                loop = self._pump_task.get_loop() if self._pump_task else None
                if loop is not None:
                    loop.call_soon_threadsafe(self._offer_signal.set)
            except RuntimeError:
                pass

    async def drain_offers(self, timeout_s: float = 60.0) -> None:
        """Wait until every queued offer has been stored or dropped —
        deterministic settling for tests/benches (replaces sleep guesses).
        Fails loudly instead of spinning forever when the pump isn't
        running or a wakeup signal was lost."""
        deadline = time.monotonic() + timeout_s
        # Let call_soon_threadsafe-scheduled promotion starts land first.
        await asyncio.sleep(0)
        await asyncio.sleep(0)
        while self._promotions:
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"drain_offers: {len(self._promotions)} disk "
                    f"promotions still in flight after {timeout_s}s"
                )
            done, _pending = await asyncio.wait(
                list(self._promotions),
                timeout=max(0.0, deadline - time.monotonic()),
            )
            for t in done:
                t.exception()  # retrieved by the done callback's logger
        while self._offers or self._offered:
            if self._pump_task is None or self._pump_task.done():
                raise RuntimeError(
                    "offer pump not running (manager not started, or "
                    "stopped with offers pending)"
                )
            if self._offer_signal is not None:
                self._offer_signal.set()  # re-kick in case a set was lost
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"drain_offers: {len(self._offers)} batches / "
                    f"{len(self._offered)} hashes still pending after "
                    f"{timeout_s}s"
                )
            await asyncio.sleep(0.01)

    def has_host(self, sequence_hash: int) -> bool:
        """Quick engine-thread check before paying a device gather."""
        if self.host_pool is None:
            return False
        with self._lock:
            return (
                sequence_hash in self._offered
                or self.host_pool.get_by_hash(sequence_hash) is not None
            )

    def registered_hashes(self) -> frozenset[int]:
        """Snapshot of host-tier registered sequence hashes (the blockset
        a G4 exporter would publish); owns its own locking."""
        if self.host_pool is None:
            return frozenset()
        with self._lock:
            return frozenset(
                h for h in self.host_pool.registered_hashes()
                if h not in self._barred
            )

    def count_host_match(self, hashes: Sequence[int]) -> int:
        """Length of the host-tier prefix match WITHOUT copying any block
        bytes — the adaptive onboard gate's input (deciding to skip must
        not itself pay the prefix-sized memcpy)."""
        if self.host_pool is None:
            return 0
        with self._lock:
            matched = self.host_pool.match_sequence_hashes(hashes)
            n = len(matched)
            for b in matched:
                self.host_pool.release(b)
            self._host_hit_blocks += n
            self._host_miss_blocks += max(0, len(hashes) - n)
        return n

    def count_disk_origin(self, hashes: Sequence[int]) -> int:
        """How many of `hashes` are host-resident blocks that arrived via
        DISK promotion — the G3 share of an actual-reuse report. Entries
        whose host block was since evicted are pruned lazily (the set is
        bounded by the disk tier's block count either way)."""
        if self.host_pool is None:
            return 0
        n = 0
        with self._lock:
            for h in hashes:
                if h not in self._from_disk:
                    continue
                if self.host_pool.get_by_hash(h) is None:
                    self._from_disk.discard(h)
                    continue
                n += 1
        return n

    def host_entries(self) -> list[tuple[int, int | None, tuple]]:
        """(hash, parent, tokens) for every host-resident block that is
        not barred, no byte copies — what a re-announce would publish."""
        if self.host_pool is None:
            return []
        out = []
        with self._lock:
            for h in self.host_pool.registered_hashes():
                if h in self._barred:
                    continue
                b = self.host_pool.get_by_hash(h)
                if b is None or b.sequence_hash is None:
                    continue
                out.append((b.sequence_hash, b.parent_hash, tuple(b.tokens)))
        return out

    def match_host(
        self, hashes: Sequence[int], out: np.ndarray | None = None
    ) -> list[tuple[int, int | None, tuple[int, ...], np.ndarray]]:
        """Longest host-tier prefix for `hashes`; returns
        (hash, parent, tokens, bytes) per block, bytes already copied out —
        the engine scatters them into the device cache. ``out`` ([n,
        row elements] in the arena's dtype, n >= len(hashes)): copy row i
        into ``out[i]`` (the engine's pinned staging) and return views of
        it. Called on the engine thread."""
        if self.host_pool is None:
            return []
        bad = None
        with self._lock:
            matched = self.host_pool.match_sequence_hashes(hashes)
            staging, out = out, []
            try:
                for i, b in enumerate(matched):
                    row = self.host_pool.storage.read_block(b.idx)
                    if staging is None:
                        data = row.copy()
                    else:
                        data = staging[i]
                        data[...] = row
                    if b.checksum is not None and (
                        block_checksum(data) != b.checksum
                    ):
                        # Host-arena rot caught at the G2→G1 trust
                        # boundary: truncate the matched prefix HERE and
                        # quarantine after the refs drop — the engine
                        # recomputes the tail, byte-identical.
                        bad = b
                        break
                    out.append((b.sequence_hash, b.parent_hash, b.tokens, data))
            finally:
                for b in matched:
                    self.host_pool.release(b)
                if bad is not None:
                    h = bad.sequence_hash
                    INTEGRITY.note_failure("host")
                    if h is not None:
                        self._barred.add(h)
                    self.host_pool.quarantine(bad)
                    logger.warning(
                        "host block %x failed checksum at onboard; "
                        "quarantined", h if h is not None else 0,
                    )
        return out

    def request_disk_promotion(self, hashes: Sequence[int]) -> None:
        """Thread-safe, fire-and-forget G3→G2 promotion (two-touch: a host
        miss on a disk-resident prefix promotes it so the NEXT request's
        match_host hits — the engine thread never blocks on disk IO).
        Reference: KVBM's manual onboard path, block_manager/offload.rs."""
        if self.disk_pool is None or self._pump_task is None or not hashes:
            return
        hashes = list(hashes)
        key = hashes[0]
        with self._lock:
            # One in-flight promotion per prefix: concurrent misses on the
            # same prefix would each re-read the blocks from disk and
            # churn the host tier's LRU for bytes register_block dedups.
            if key in self._promoting:
                return
            self._promoting.add(key)
            self._promotions_requested += 1
        loop = self._pump_task.get_loop()

        def _done(task: asyncio.Task) -> None:
            self._promotions.discard(task)
            with self._lock:
                self._promoting.discard(key)
            if not task.cancelled() and task.exception() is not None:
                logger.warning("disk promotion failed: %r", task.exception())

        def _go() -> None:
            task = asyncio.ensure_future(self.onboard_from_disk(hashes))
            self._promotions.add(task)
            task.add_done_callback(_done)

        try:
            loop.call_soon_threadsafe(_go)
        except RuntimeError:
            with self._lock:
                self._promoting.discard(key)

    # -- offload pump (asyncio side) ---------------------------------------
    async def _pump(self) -> None:
        assert self._offer_signal is not None
        while True:
            await self._offer_signal.wait()
            self._offer_signal.clear()
            while self._offers:
                keep, rows, data, scales = self._offers.popleft()
                try:
                    # Async fault call: an armed delay must stall only the
                    # pump, never the event loop. A drop loses this batch
                    # the same way a raise does (un-marked below, so a
                    # later offer can retry).
                    if not await FAULTS.maybe_fail_async(
                        "kvbm.pump", can_drop=True
                    ):
                        with self._lock:
                            for h, _, _ in keep:
                                self._offered.discard(h)
                        continue
                    # Device→host materialization happens HERE, on a worker
                    # thread — the engine thread only dispatched the gather,
                    # and the loop thread must not pay the copy either.
                    # Host batches select the dedup-kept rows BEFORE the
                    # copy; see _select_and_materialize for
                    # the device-batch trade-off.
                    arr, sc, rows = await asyncio.to_thread(
                        _select_and_materialize, data, rows, len(keep),
                        scales,
                    )
                except Exception:
                    with self._lock:
                        for h, _, _ in keep:
                            self._offered.discard(h)
                    logger.exception("offer batch materialization failed")
                    continue
                for (h, parent, tokens), ri in zip(keep, rows):
                    try:
                        row = np.asarray(arr[ri])
                        sc_row = (
                            np.asarray(sc[ri]) if sc is not None else None
                        )
                        if (
                            self._g2_to_g3 is not None
                            and self.cfg.layout.quant != "int8"
                        ):
                            # The disk chain retains its row until the
                            # write drains; a VIEW would pin the whole
                            # [N, ...] batch for every queued row.
                            # (Quantized tiers pack into a fresh array
                            # inside _store_host, so no copy needed.)
                            row = row.copy()
                        stored, crc = await asyncio.to_thread(
                            self._store_host, h, parent, tokens, row, sc_row
                        )
                        if self._g2_to_g3 is not None:
                            # Chain down-tier with the bytes in hand — never
                            # a deferred re-read of an evictable host block.
                            # `stored` is the row as WRITTEN (packed when
                            # the tier quantizes), so G3 holds identical
                            # bytes without a second quantization — and
                            # `crc` is the envelope stamped over exactly
                            # those bytes.
                            self._g2_to_g3.offload_data(
                                h, parent, tokens, stored, crc
                            )
                    except MemoryError:
                        with self._lock:
                            self._offered.discard(h)
                        logger.debug("host tier full; dropped offer %x", h)
                    except Exception:
                        with self._lock:
                            self._offered.discard(h)
                        logger.exception("offer %x failed", h)

    def _store_host(self, h, parent, tokens, data, scales=None):
        """Store one block into G2, applying the tier's precision policy
        (quantize-on-offload): a quantized layout packs the bytes —
        passthrough when the engine handed its int8 G1 data + scales,
        re-pack when the row is already packed (G3 promotion re-store),
        quantize otherwise (bf16-hot G1). Returns (row-as-written,
        checksum), so the caller can chain identical bytes — and the
        envelope stamped over exactly those bytes — down-tier.

        This is the ONE stamp point of the integrity envelope
        (docs/architecture/integrity.md): the CRC covers the packed row
        (data ‖ scales) and every later crossing verifies against it,
        never re-stamps."""
        layout = self.cfg.layout
        if layout.quant == "int8":
            from dynamo_tpu_torch.block_manager import quant as bq

            if scales is not None:
                data = bq.pack_block(
                    np.asarray(data).reshape(-1).view(np.int8),
                    scales, layout,
                )
            elif bq.is_packed_row(data, layout):
                # COPY, not a view: an already-packed row arriving via
                # the pump is a row of the whole [N, ...] offer batch,
                # and the G3 chain retains the returned row until the
                # disk write drains — a view would pin the entire batch
                # (the same pinning the raw path copies for).
                data = np.asarray(data).reshape(-1).view(np.uint8).copy()
            else:
                data = bq.quantize_block(data, layout)
        crc = block_checksum(np.asarray(data))
        with self._lock:
            # Timed INSIDE the lock: the sample must measure the memcpy,
            # not lock-wait — deflated link rates would mislead the
            # network-aware selection they feed.
            t0 = time.monotonic()
            if layout.quant == "int8":
                self._quant_stored_blocks += 1
            block = self.host_pool.allocate_blocks(1)[0]
            self.host_pool.storage.write_block(block.idx, data)
            block = self.host_pool.register_block(
                block, h, parent, tokens, checksum=crc
            )
            self.host_pool.release(block)
            self._offered.discard(h)
            # A fresh store re-stamps the envelope: the quarantine bar
            # lifts (these are new bytes, verified-at-birth).
            self._barred.discard(h)
            # These bytes came from the DEVICE: if an earlier disk
            # promotion of the same hash was since evicted, the origin
            # marker must not survive into this re-store — the tier
            # split would misattribute reuse forever.
            self._from_disk.discard(h)
            self._host_stored_blocks += 1
            # nbytes of the row as WRITTEN: a quantized tier's link EMAs
            # honestly reflect the halved transfer bytes.
            self._store_rate.note(
                int(np.asarray(data).nbytes),
                max(time.monotonic() - t0, 1e-9),
            )
        return data, crc

    # -- onboard from disk --------------------------------------------------
    async def onboard_from_disk(self, hashes: Sequence[int]) -> int:
        """G3→G2 promotion for a prefix (the next match_host sees them)."""
        if self._g2_to_g3 is None:
            return 0
        blocks = await self._g2_to_g3.onboard(hashes)
        with self._lock:
            for b in blocks:
                # Remember the disk origin so a later actual-reuse report
                # can attribute these blocks to G3, not G2.
                if b.sequence_hash is not None:
                    self._from_disk.add(b.sequence_hash)
                self.host_pool.release(b)
            self._promoted_blocks += len(blocks)
        return len(blocks)

    # -- G3 scrubber (block_manager/integrity.py) ---------------------------
    async def _scrub_loop(self) -> None:
        """Background bit-rot sweep: one paced partial slice per tick so
        a request never meets rot the scrubber could have found first.
        Pacing is injectable (tests swap ``_scrub_sleep`` / call
        ``scrub_tick`` directly) and the verify runs on a worker thread —
        the event loop never pays a disk read."""
        while True:
            await self._scrub_sleep(self.cfg.scrub_interval_s)
            try:
                await asyncio.to_thread(self.scrub_tick)
            except Exception:
                logger.exception("disk scrub tick failed")

    def scrub_tick(self, max_blocks: int | None = None) -> tuple[int, int]:
        """Verify one bounded slice of the disk tier against the stored
        envelopes; quarantine + bar anything rotten. Returns
        (scanned, detected). The cursor wraps, so repeated ticks cover
        the whole tier regardless of slice size."""
        pool = self.disk_pool
        if pool is None or not pool.blocks:
            return (0, 0)
        budget = (
            max_blocks if max_blocks is not None
            else (self.cfg.scrub_blocks_per_tick or 16)
        )
        scanned = detected = 0
        with self._lock:
            total = len(pool.blocks)
            for _ in range(min(budget, total)):
                b = pool.blocks[self._scrub_cursor % total]
                self._scrub_cursor = (self._scrub_cursor + 1) % total
                if (
                    b.state is not BlockState.REGISTERED
                    or b.sequence_hash is None
                    or b.checksum is None
                ):
                    continue
                scanned += 1
                arr = np.asarray(pool.storage.read_block(b.idx))
                if block_checksum(arr) == b.checksum:
                    continue
                detected += 1
                h = b.sequence_hash
                INTEGRITY.note_failure("disk")
                self._barred.add(h)
                pool.quarantine(b)
                drop = getattr(pool.storage, "drop_block", None)
                if drop is not None:
                    # In-lock on purpose: sidecar un-naming must precede
                    # any reallocation of the index (same contract as
                    # the promotion-path quarantine).
                    drop(b.idx)
                logger.warning(
                    "scrub: disk block %x failed checksum; quarantined", h
                )
        if scanned or detected:
            INTEGRITY.note_scrub(scanned, detected)
        return (scanned, detected)

    # -- stats --------------------------------------------------------------
    def stats(self) -> dict:
        """Tier telemetry digest (KV observatory). Surfaced — prefixed
        ``kvbm_`` — on engine readiness(), the engine metrics callback
        (→ ForwardPassMetrics), HTTP /metrics, and the standalone
        exporter; previously computed here and shown nowhere.

        Deliberately LOCK-FREE: this runs on every engine step (metrics
        flush) and on the asyncio thread (readiness probes), while
        _store_host holds the lock across a block memcpy — acquiring it
        here would stall the step loop / event loop for the copy. Every
        value is a single int/float/len read (atomic under the GIL);
        metric-scrape tearing across fields is acceptable."""
        host, disk = self.host_pool, self.disk_pool
        edge = self._g2_to_g3.stats() if self._g2_to_g3 is not None else {}
        # Quantized-tier digest (per-tier precision policy): density is
        # the quantized fraction of cumulative stores per tier (1.0 on a
        # quantized layout — every store packs), bytes-saved counts G2
        # stores plus G3 offloads against the compute-dtype baseline.
        layout = self.cfg.layout
        qdelta = (
            layout.unquantized_block_bytes - layout.block_bytes
            if layout.quant == "int8"
            else 0
        )
        offloaded = edge.get("offloaded_blocks_total", 0)
        return {
            "quant_host_density": round(
                self._quant_stored_blocks
                / max(self._host_stored_blocks, 1),
                4,
            ),
            "quant_disk_density": (
                1.0
                if layout.quant == "int8" and disk and offloaded > 0
                else 0.0
            ),
            "quant_bytes_saved_total": qdelta
            * (self._quant_stored_blocks + offloaded),
            # Occupancy (legacy keys kept: offload_bench & tests).
            "host_registered": host.num_registered if host else 0,
            "host_usage": round(host.usage(), 4) if host else 0.0,
            "disk_registered": disk.num_registered if disk else 0,
            "disk_usage": round(disk.usage(), 4) if disk else 0.0,
            # Hit/miss/store/eviction/promotion counters.
            "host_hit_blocks_total": self._host_hit_blocks,
            "host_miss_blocks_total": self._host_miss_blocks,
            "host_stored_blocks_total": self._host_stored_blocks,
            "host_evictions_total": host.evictions_total if host else 0,
            "disk_evictions_total": disk.evictions_total if disk else 0,
            "promotions_requested_total": self._promotions_requested,
            "promoted_blocks_total": self._promoted_blocks,
            "offloaded_blocks_total": edge.get(
                "offloaded_blocks_total", 0
            ),
            # Per-link byte-rate EMAs (g1g2 = device→host store,
            # g2g3 = host→disk offload, g3g2 = disk→host promotion);
            # the engine adds g2g1 (host→HBM onboard) from its own EMA.
            "link_g1g2_bps": self._store_rate.value,
            "link_g2g3_bps": edge.get("offload_bps", 0.0),
            "link_g3g2_bps": edge.get("onboard_bps", 0.0),
            # G4 peer tier: not in the port yet — its keys read 0 so
            # every metric surface keeps the reference's field set.
            "g4_pulls_total": 0,
            "g4_pull_bytes_total": 0,
            "g4_pull_fallbacks_total": 0,
            "link_peer_bps": 0.0,
            # Integrity envelope: process-wide per-tier corruption
            # detections + scrub progress (integrity.py). The ledger's
            # internal lock guards a dict copy only — never held across
            # IO — so the lock-free contract above effectively holds.
            **INTEGRITY.snapshot(),
        }
