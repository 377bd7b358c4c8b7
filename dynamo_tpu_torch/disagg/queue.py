"""Prefill work queue (port of dynamo_tpu/disagg/queue.py; entries are
encoded with the port's standard-library MessagePack codec,
runtime/transports/wire.py, byte for byte what ``msgpack`` packs).

A named work queue on the bus shared by all prefill workers of a namespace
(reference: lib/runtime/src/transports/nats.rs:345-478 `NatsQueue` over
JetStream; examples/llm/utils/prefill_queue.py). Decode workers enqueue
RemotePrefillRequests; prefill workers compete to dequeue; queue depth
feeds the disagg decision and the planner.

Overload bounds (docs/architecture/overload_and_drain.md): the queue is
BOUNDED — ``try_enqueue`` refuses work when depth or oldest-item age is
over its bound, and the decode side keeps that prefill LOCAL instead (a
graceful fallback, not a client error: the request still completes at
local-prefill cost). Depth alone misses a stalled consumer pool, which is
why the age bound exists. Expired-deadline entries are shed by the
CONSUMER at dequeue (disagg/worker.py) — work nobody can finish on time
must not occupy prefill lanes.
"""

from __future__ import annotations

import logging

from dynamo_tpu_torch.runtime.transports import wire
from dynamo_tpu_torch.utils.deadline import OVERLOAD

logger = logging.getLogger(__name__)


class PrefillQueue:
    # A prefill (chunked, possibly queued behind the engine) should finish
    # well within this; a worker that dies mid-item redelivers at expiry
    # (or immediately on connection death under the control plane).
    LEASE_S = 60.0

    def __init__(
        self,
        drt,
        namespace: str = "default",
        max_depth: int = 256,
        max_age_s: float = 0.0,
    ) -> None:
        """``max_depth``/``max_age_s`` bound ``try_enqueue`` (0 = that
        bound is off). The router's ``max_prefill_queue_size`` is the
        soft, decision-level bound; these are the hard backstop against
        races and multi-decoder bursts."""
        self._queue = drt.bus.work_queue(f"{namespace}.prefill_queue")
        self.max_depth = max_depth
        self.max_age_s = max_age_s

    async def enqueue(self, request: dict) -> None:
        await self._queue.enqueue(wire.packb(request))

    async def try_enqueue(self, request: dict) -> bool:
        """Bounded enqueue: False when the queue is over its depth or age
        bound — the caller keeps the prefill local (shed from the REMOTE
        plane, not from the client)."""
        if self.max_depth or self.max_age_s:
            depth, age = await self.stats()
            # Entries are SLO-class-tagged (disagg/worker.py; llm/slo.py)
            # — the per-class shed split must cover this plane too, or
            # shed_{interactive,batch}_total diverge from
            # shed_requests_total on disagg deployments. Untagged legacy
            # entries normalize to interactive like every other seam.
            from dynamo_tpu_torch.llm import slo

            cls = slo.normalize_class(request.get("request_class"))
            if self.max_depth and depth >= self.max_depth:
                OVERLOAD.note_shed("prefill_queue.depth", request_class=cls)
                logger.warning(
                    "prefill queue at depth bound (%d) — keeping prefill "
                    "local for %s",
                    self.max_depth, request.get("request_id"),
                )
                return False
            if self.max_age_s and age > self.max_age_s:
                OVERLOAD.note_shed("prefill_queue.age", request_class=cls)
                logger.warning(
                    "prefill queue oldest item %.1fs old (bound %.1fs) — "
                    "keeping prefill local for %s",
                    age, self.max_age_s, request.get("request_id"),
                )
                return False
        await self.enqueue(request)
        return True

    async def dequeue(
        self, timeout_s: float | None = None
    ) -> tuple[int, dict] | None:
        """Leased dequeue: returns (item_id, request); the consumer must
        ``ack(item_id)`` after the KV push completes or the item redelivers
        to another worker (at-least-once, reference NatsQueue semantics)."""
        got = await self._queue.dequeue_leased(timeout_s, lease_s=self.LEASE_S)
        if got is None:
            return None
        item_id, raw = got
        return item_id, wire.unpackb(raw)

    async def ack(self, item_id: int) -> bool:
        return await self._queue.ack(item_id)

    async def nack(self, item_id: int) -> bool:
        return await self._queue.nack(item_id)

    async def depth(self) -> int:
        return await self._queue.depth()

    async def oldest_age_s(self) -> float:
        """Wait time of the oldest live item — the per-item SLA signal
        for the disagg decision (depth alone misses a stalled consumer)."""
        return await self._queue.oldest_age_s()

    async def stats(self) -> tuple[int, float]:
        """(depth, oldest age) in one control-plane round trip."""
        return await self._queue.stats()
