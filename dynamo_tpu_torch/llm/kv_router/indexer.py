"""Global radix index of cached KV blocks per worker (port of
dynamo_tpu/llm/kv_router/indexer.py).

Nodes are hash-chained token blocks; each node records which workers
hold that block's KV. A request's prompt is hashed into the same chain
(llm/tokens.py), and walking the chain counts, per worker, how many
consecutive prefix blocks are already cached. ``KvIndexer`` applies
events from a queue on one consumer task; ``KvIndexerSharded`` shards
by worker id and merges the answers.

Staleness: every applied event is counted and its publish→apply lag
(``RouterEvent.published_unix`` → apply wall clock) folded into a
bucketed histogram, so a route record can say how far behind the
index was when it scored. The ``indexer.apply`` fault point
(utils/faults.py) delays or drops the consumer.
"""

from __future__ import annotations

import asyncio
import logging
import time
from dataclasses import dataclass, field
from typing import Sequence

from dynamo_tpu_torch.llm.kv_router.protocols import KvCacheEventData, RouterEvent
from dynamo_tpu_torch.utils.faults import FAULTS
from dynamo_tpu_torch.utils.tracing import Histogram, tracer

logger = logging.getLogger(__name__)


@dataclass
class RadixNode:
    parent_hash: int | None
    workers: set[int] = field(default_factory=set)
    children: set[int] = field(default_factory=set)  # child sequence hashes


class RadixTree:
    """Synchronous core."""

    def __init__(self) -> None:
        self._nodes: dict[int, RadixNode] = {}
        self._worker_blocks: dict[int, set[int]] = {}
        # Blocks that left the index (removed events + worker removals) —
        # the eviction axis of the radix-size telemetry.
        self.evicted_blocks_total = 0

    # -- queries ------------------------------------------------------------
    def find_matches(self, sequence_hashes: Sequence[int]) -> dict[int, int]:
        """Per-worker count of consecutive prefix blocks present. A worker
        only accrues overlap while it has held every block so far —
        prefix reuse requires contiguity."""
        overlap: dict[int, int] = {}
        alive: set[int] | None = None
        for depth, h in enumerate(sequence_hashes):
            node = self._nodes.get(h)
            holders = node.workers if node else set()
            alive = set(holders) if alive is None else alive & holders
            if not alive:
                break
            for w in alive:
                overlap[w] = depth + 1
        return overlap

    def workers(self) -> list[int]:
        return list(self._worker_blocks)

    @property
    def num_blocks(self) -> int:
        return len(self._nodes)

    # -- mutations ----------------------------------------------------------
    def apply_event(self, worker_id: int, ev: KvCacheEventData) -> None:
        if ev.kind == "stored":
            parent = ev.parent_hash
            for h in ev.block_hashes:
                node = self._nodes.get(h)
                if node is None:
                    node = self._nodes[h] = RadixNode(parent_hash=parent)
                    if parent is not None and parent in self._nodes:
                        self._nodes[parent].children.add(h)
                node.workers.add(worker_id)
                self._worker_blocks.setdefault(worker_id, set()).add(h)
                parent = h
        elif ev.kind == "removed":
            for h in ev.block_hashes:
                self._remove(worker_id, h)
        elif ev.kind in ("cleared", "worker_dead"):
            # "worker_dead" is the mark-dead broadcast (router.py
            # note_worker_dead): its radix effect is "cleared"'s; the
            # KvRouter pump also drops the corpse's load snapshot.
            self.remove_worker(worker_id)
        else:
            logger.warning("unknown kv event kind %r", ev.kind)

    def _remove(self, worker_id: int, h: int) -> None:
        node = self._nodes.get(h)
        if node is None:
            return
        node.workers.discard(worker_id)
        blocks = self._worker_blocks.get(worker_id)
        if blocks is not None:
            blocks.discard(h)
        self._prune(h)

    def _prune(self, h: int) -> None:
        node = self._nodes.get(h)
        if node is None or node.workers or node.children:
            return
        del self._nodes[h]
        self.evicted_blocks_total += 1
        if node.parent_hash is not None:
            parent = self._nodes.get(node.parent_hash)
            if parent is not None:
                parent.children.discard(h)
                self._prune(node.parent_hash)

    def remove_worker(self, worker_id: int) -> None:
        """Worker left (lease expired) — drop all its blocks."""
        for h in list(self._worker_blocks.pop(worker_id, ())):
            node = self._nodes.get(h)
            if node is not None:
                node.workers.discard(worker_id)
                self._prune(h)


class KvIndexer:
    """Async wrapper: serialized event application + queries."""

    def __init__(self) -> None:
        self.tree = RadixTree()
        self._events: asyncio.Queue[RouterEvent | None] = asyncio.Queue()
        self._task: asyncio.Task | None = None
        # True while the consumer holds a popped-but-unapplied event —
        # the queue reads empty during that window, but a query that
        # returned then would miss the event (_drain waits on BOTH).
        self._applying = False
        # Staleness telemetry (single-threaded: every touch happens on the
        # event loop, so plain counters are race-free).
        self.events_applied_total = 0
        self.events_dropped_total = 0
        self.applied_by_kind: dict[str, int] = {}
        self.lag_hist = Histogram()        # publish→apply lag, ms
        self.last_applied_unix: float = 0.0

    def start(self) -> "KvIndexer":
        self._task = asyncio.ensure_future(self._run())
        return self

    def _apply_now(self, ev: RouterEvent) -> None:
        """Apply one event with staleness accounting — the ONE funnel for
        both the consumer task and the consumer-dead direct path, so
        ``kv_events_applied_total`` and the lag histogram can't diverge
        from what the tree actually saw."""
        try:
            self.tree.apply_event(ev.worker_id, ev.event)
        except Exception:
            self.events_dropped_total += 1
            logger.exception("failed applying kv event")
            return
        self.events_applied_total += 1
        kind = ev.event.kind
        self.applied_by_kind[kind] = self.applied_by_kind.get(kind, 0) + 1
        now = time.time()
        self.last_applied_unix = now
        if ev.published_unix:
            lag_ms = max(0.0, 1000.0 * (now - ev.published_unix))
            self.lag_hist.observe(lag_ms)
            # Also onto the tracer's histograms: /metrics renders it as
            # dyntpu_trace_kv_event_lag_ms_bucket.
            tracer().observe("kv_event_lag", lag_ms)

    async def _run(self) -> None:
        while True:
            ev = await self._events.get()
            if ev is None:
                return
            # No await between the get() resuming and this flag: a query's
            # _drain can never observe empty-queue + not-applying while an
            # event is actually in flight.
            self._applying = True
            try:
                # Chaos seam: a delayed/raising apply keeps events PENDING —
                # the shape of an indexer replica falling behind the bus
                # (staleness the route audit must then attribute).
                if FAULTS.active:
                    if not await FAULTS.maybe_fail_async(
                        "indexer.apply", can_drop=True
                    ):
                        self.events_dropped_total += 1
                        continue
                self._apply_now(ev)
            except Exception:
                self.events_dropped_total += 1
                logger.exception("kv event apply faulted")
            finally:
                self._applying = False

    def apply(self, ev: RouterEvent) -> None:
        self._events.put_nowait(ev)

    def remove_worker(self, worker_id: int) -> None:
        self._events.put_nowait(
            RouterEvent(worker_id, KvCacheEventData(kind="cleared"))
        )

    async def find_matches(self, sequence_hashes: Sequence[int]) -> dict[int, int]:
        await self._drain()
        return self.tree.find_matches(sequence_hashes)

    async def _drain(self) -> None:
        """Let the consumer catch up so queries see all queued events —
        including one the consumer has POPPED but not yet applied (a slow
        apply, e.g. the ``indexer.apply`` delay fault, leaves the queue
        empty mid-flight). If the consumer task isn't running (never
        started, stopped, or died), apply directly instead of spinning on
        a queue nobody drains."""
        while not self._events.empty() or self._applying:
            if self._task is None or self._task.done():
                if self._events.empty():
                    break  # dead consumer can't be mid-apply
                ev = self._events.get_nowait()
                if ev is not None:
                    self._apply_now(ev)
                continue
            await asyncio.sleep(0)

    # -- staleness telemetry ------------------------------------------------
    @property
    def pending_events(self) -> int:
        """Events published but not yet applied — the depth a route
        decision is potentially blind to at score time (queued, plus the
        one the consumer is mid-apply on)."""
        return self._events.qsize() + int(self._applying)

    def watermark(self) -> dict:
        """Cheap snapshot for per-decision audit records: how much event
        history the index had consumed when it scored, and the running
        publish→apply lag p99 (a 14-bucket interpolation, not a scan)."""
        return {
            "applied": self.events_applied_total,
            "pending": self.pending_events,
            "lag_p99_ms": round(self.lag_hist.quantile(0.99), 3),
        }

    def stats(self) -> dict:
        """Full staleness/size digest for the observability surfaces."""
        return {
            "kv_events_applied_total": self.events_applied_total,
            "kv_events_dropped_total": self.events_dropped_total,
            "kv_events_pending": self.pending_events,
            "kv_radix_blocks": self.tree.num_blocks,
            "kv_radix_workers": len(self.tree.workers()),
            "kv_radix_evicted_blocks_total": self.tree.evicted_blocks_total,
            "kv_event_lag_p50_ms": round(self.lag_hist.quantile(0.50), 3),
            "kv_event_lag_p99_ms": round(self.lag_hist.quantile(0.99), 3),
            "kv_event_lag_max_ms": round(self.lag_hist.max_ms, 3),
            "kv_event_lag_count": self.lag_hist.count,
            "kv_indexer_shards": 1,
        }

    async def stop(self) -> None:
        if self._task is not None:
            self._events.put_nowait(None)
            await self._task
            self._task = None


class KvIndexerSharded:
    """N independent indexers, workers assigned by id hash; queries fan out
    and merge. Shard assignment is a pure function of the worker id, so
    two replicas fed the same event stream build identical shard
    states."""

    def __init__(self, num_shards: int = 4) -> None:
        self.shards = [KvIndexer() for _ in range(num_shards)]

    def start(self) -> "KvIndexerSharded":
        for s in self.shards:
            s.start()
        return self

    def _shard(self, worker_id: int) -> KvIndexer:
        return self.shards[hash(worker_id) % len(self.shards)]

    def apply(self, ev: RouterEvent) -> None:
        self._shard(ev.worker_id).apply(ev)

    def remove_worker(self, worker_id: int) -> None:
        self._shard(worker_id).remove_worker(worker_id)

    async def find_matches(self, sequence_hashes: Sequence[int]) -> dict[int, int]:
        results = await asyncio.gather(
            *[s.find_matches(sequence_hashes) for s in self.shards]
        )
        merged: dict[int, int] = {}
        for r in results:
            merged.update(r)
        return merged

    # -- staleness telemetry ------------------------------------------------
    @property
    def pending_events(self) -> int:
        return sum(s.pending_events for s in self.shards)

    def watermark(self) -> dict:
        return {
            "applied": sum(s.events_applied_total for s in self.shards),
            "pending": self.pending_events,
            "per_shard_pending": [s.pending_events for s in self.shards],
            "lag_p99_ms": max(
                (round(s.lag_hist.quantile(0.99), 3) for s in self.shards),
                default=0.0,
            ),
        }

    def stats(self) -> dict:
        """Merged digest: counters sum; the lag histogram merges by
        bucket (bucket counts are additive), so shard quantiles compose
        exactly instead of averaging percentiles."""
        merged_lag = Histogram()
        out = {
            "kv_events_applied_total": 0,
            "kv_events_dropped_total": 0,
            "kv_events_pending": 0,
            "kv_radix_blocks": 0,
            "kv_radix_workers": 0,
            "kv_radix_evicted_blocks_total": 0,
        }
        for s in self.shards:
            st = s.stats()
            for k in out:
                out[k] += st[k]
            for i, c in enumerate(s.lag_hist.counts):
                merged_lag.counts[i] += c
            merged_lag.sum_ms += s.lag_hist.sum_ms
            merged_lag.max_ms = max(merged_lag.max_ms, s.lag_hist.max_ms)
        out.update(
            {
                "kv_event_lag_p50_ms": round(merged_lag.quantile(0.50), 3),
                "kv_event_lag_p99_ms": round(merged_lag.quantile(0.99), 3),
                "kv_event_lag_max_ms": round(merged_lag.max_ms, 3),
                "kv_event_lag_count": merged_lag.count,
                "kv_indexer_shards": len(self.shards),
            }
        )
        return out

    async def stop(self) -> None:
        await asyncio.gather(*[s.stop() for s in self.shards])
