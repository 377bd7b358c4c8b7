"""Offload manager: demote registered blocks down-tier, onboard on demand
(port of dynamo_tpu/block_manager/offload.py).

Reference: lib/llm/src/block_manager/offload.rs:16-460 — a priority queue of
offload requests drained by transfer workers (bounded concurrency, batched),
plus a manual `onboard` path pulling blocks back up. Here transfers are
blocking byte moves (device gather / host memcpy / disk write) run in a
thread so the event loop never blocks on PCIe or disk.
"""

from __future__ import annotations

import asyncio
import contextlib
import logging
import threading
import time
from typing import Sequence

import numpy as np

from dynamo_tpu_torch.block_manager.integrity import INTEGRITY, block_checksum
from dynamo_tpu_torch.block_manager.pool import Block, BlockPool
from dynamo_tpu_torch.utils.concurrency import bound

logger = logging.getLogger(__name__)


class RateEMA:
    """Bytes-per-second EMA over wall-clock transfer samples — the
    per-link rate telemetry NetKV-style network-aware selection
    scores against. Same 0.7/0.3 blend as the engine's
    adaptive-gate EMAs. note() takes the sample's own measured duration
    (callers time the transfer themselves), so a slow link yields an
    honest (low) rate rather than starving the estimate — and tests
    drive determinism by passing exact durations."""

    def __init__(self) -> None:
        self.bps: float | None = None
        self.bytes_total = 0

    def note(self, nbytes: int, dt_s: float) -> None:
        if nbytes <= 0 or dt_s <= 0:
            return
        self.bytes_total += nbytes
        bps = nbytes / dt_s
        self.bps = bps if self.bps is None else 0.7 * self.bps + 0.3 * bps

    @property
    def value(self) -> float:
        return round(self.bps, 1) if self.bps is not None else 0.0


class OffloadManager:
    """Moves registered blocks src_pool → dst_pool (one tier edge).

    `lock` (optional threading.Lock) serializes pool mutations with other
    threads touching the same pools (KvBlockManager shares its lock so the
    engine thread's match/offer never interleave with a transfer).
    """

    def __init__(
        self,
        src_pool: BlockPool,
        dst_pool: BlockPool,
        concurrency: int = 4,
        lock: threading.Lock | None = None,
    ) -> None:
        self.src = src_pool
        self.dst = dst_pool
        self._lock = lock if lock is not None else contextlib.nullcontext()
        self._sem = asyncio.Semaphore(concurrency)
        self._pending: set[int] = set()
        self._tasks: set[asyncio.Task] = set()
        # Tier-edge telemetry (KV observatory): blocks/bytes moved each
        # direction and the live byte-rate EMA per link direction.
        self.offloaded_blocks_total = 0     # src → dst (down-tier)
        self.onboarded_blocks_total = 0     # dst → src (promotion)
        self.offload_rate = RateEMA()
        self.onboard_rate = RateEMA()

    def offload(self, block: Block) -> None:
        """Queue one registered src block for copy-down (idempotent). The
        bytes are read NOW, under the lock and before the src block can be
        LRU-evicted and rewritten — a deferred read could capture another
        prefix's bytes."""
        h = block.sequence_hash
        if h is None or h in self._pending or self.dst.get_by_hash(h):
            return
        with self._lock:
            if block.sequence_hash != h:  # evicted+reused since the check
                return
            data = np.asarray(self.src.storage.read_block(block.idx)).copy()
            checksum = block.checksum
        self.offload_data(h, block.parent_hash, block.tokens, data, checksum)

    def offload_data(
        self,
        h: int,
        parent_hash: int | None,
        tokens: tuple[int, ...],
        data: np.ndarray,
        checksum: int | None = None,
    ) -> None:
        """Queue already-captured block bytes for the dst tier.
        ``checksum`` is the integrity envelope stamped at the G1→G2 store
        law — it rides down-tier beside the bytes, never recomputed (a
        recompute here would bless bytes corrupted in flight)."""
        if h in self._pending or self.dst.get_by_hash(h):
            return
        self._pending.add(h)
        task = asyncio.ensure_future(
            self._run(h, parent_hash, tokens, data, checksum)
        )
        self._tasks.add(task)
        task.add_done_callback(self._tasks.discard)

    async def _run(self, h, parent_hash, tokens, data, checksum) -> None:
        async with self._sem:
            try:
                await asyncio.to_thread(
                    self._store, h, parent_hash, tokens, data, checksum
                )
            except MemoryError:
                logger.debug("offload of %x skipped: dst full", h)
            except Exception:  # noqa: BLE001 — offload is opportunistic; the source tier still holds the block
                logger.exception("offload of %x failed", h)
            finally:
                self._pending.discard(h)

    def _store(self, h, parent_hash, tokens, data, checksum=None) -> None:
        # Runs on a to_thread executor: a scoped bind tells this thread
        # apart from the engine and the loop for the affinity checker
        # (executor threads are reused, so the bind does not stick).
        with bound("worker"), self._lock:
            # Timed inside the lock: the rate sample must measure the
            # transfer, not lock-wait (deflated EMAs would mislead the
            # network-aware selection they feed).
            t0 = time.monotonic()
            dst_block = self.dst.allocate_blocks(1)[0]
            idx = dst_block.idx
            self.dst.storage.write_block(idx, data)
            dst_block = self.dst.register_block(
                dst_block, h, parent_hash, tokens, checksum=checksum
            )
            self.dst.release(dst_block)
            if dst_block.idx == idx:  # not deduped away: name it durable
                record = getattr(self.dst.storage, "record_block", None)
                if record is not None:
                    # In-lock on purpose: the sidecar must name the block
                    # while the pool still agrees it exists — flushing
                    # outside the lock could persist an entry for an
                    # already-evicted index.
                    record(idx, h, parent_hash, tokens, checksum)
            self.offloaded_blocks_total += 1
            self.offload_rate.note(
                int(np.asarray(data).nbytes),
                max(time.monotonic() - t0, 1e-9),
            )

    async def onboard(self, hashes: Sequence[int]) -> list[Block]:
        """Inverse direction: copy the longest matched prefix of `hashes`
        from the dst (lower) tier back into src-tier blocks. Returns the
        src-tier blocks (registered, ref-held by the caller)."""
        return await asyncio.to_thread(self._onboard_blocking, hashes)

    def _onboard_blocking(self, hashes: Sequence[int]) -> list[Block]:
        out: list[Block] = []
        nbytes = 0
        bad: Block | None = None
        with bound("worker"), self._lock:
            matched = self.dst.match_sequence_hashes(hashes)
            # Timer starts at the copy loop: the rate sample must cover
            # the byte moves only — neither lock-wait nor the hash-match
            # bookkeeping above may deflate the G3→G2 bandwidth estimate.
            t0 = time.monotonic()
            try:
                for low_block in matched:
                    data = self.dst.storage.read_block(low_block.idx)
                    arr = np.asarray(data)
                    if low_block.checksum is not None and (
                        block_checksum(arr) != low_block.checksum
                    ):
                        # Disk bit-rot caught at the G3→G2 trust boundary:
                        # stop the promoted prefix HERE (children of a
                        # corrupt block are unreachable by prefix match
                        # anyway) and quarantine below, after the match
                        # refs drop. The requester degrades to recompute.
                        bad = low_block
                        break
                    try:
                        up_block = self.src.allocate_blocks(1)[0]
                    except MemoryError:
                        # Up-tier full of ref-held blocks: promote the
                        # prefix that fits; the rest stays down-tier.
                        break
                    self.src.storage.write_block(up_block.idx, arr)
                    nbytes += int(arr.nbytes)
                    out.append(
                        self.src.register_block(
                            up_block,
                            low_block.sequence_hash,
                            low_block.parent_hash,
                            low_block.tokens,
                            checksum=low_block.checksum,
                        )
                    )
            except Exception:
                # A failed promotion must not pin already-promoted blocks
                # forever (ref would stay 1 with no owner to release).
                for b in out:
                    self.src.release(b)
                raise
            finally:
                for b in matched:
                    self.dst.release(b)
                if bad is not None:
                    h = bad.sequence_hash
                    INTEGRITY.note_failure("disk")
                    self.dst.quarantine(bad)
                    drop = getattr(self.dst.storage, "drop_block", None)
                    if drop is not None:
                        # In-lock on purpose: the sidecar un-naming must
                        # land before the index can be reallocated to
                        # fresh bytes — a crash in between must not
                        # resurrect the corrupt block.
                        drop(bad.idx)
                    logger.warning(
                        "disk block %x failed checksum at promotion; "
                        "quarantined", h if h is not None else 0,
                    )
            if out:
                self.onboarded_blocks_total += len(out)
                self.onboard_rate.note(
                    nbytes, max(time.monotonic() - t0, 1e-9)
                )
        return out

    def stats(self) -> dict:
        """Edge telemetry digest (merged into KvBlockManager.stats())."""
        return {
            "offloaded_blocks_total": self.offloaded_blocks_total,
            "onboarded_blocks_total": self.onboarded_blocks_total,
            "offload_bps": self.offload_rate.value,
            "onboard_bps": self.onboard_rate.value,
            "offload_bytes_total": self.offload_rate.bytes_total,
            "onboard_bytes_total": self.onboard_rate.bytes_total,
        }

    async def drain(self, timeout_s: float = 60.0) -> None:
        """Wait until every queued copy-down has run, bounded. A finished
        task leaves the set here, not only through its done callback
        (whose loop may no longer run it: the reference's unbounded drain
        spun on such a set), and a store wedged in its thread raises
        ``TimeoutError`` after ``timeout_s``."""
        deadline = time.monotonic() + timeout_s
        while True:
            self._tasks.difference_update([t for t in self._tasks if t.done()])
            if not self._tasks:
                return
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(
                    f"offload drain: {len(self._tasks)} copies still "
                    f"pending after {timeout_s}s"
                )
            await asyncio.wait(list(self._tasks), timeout=left)
