"""Disaggregated workers: the decode-side operator and the prefill loop
(port of dynamo_tpu/disagg/worker.py).

DecodeOperator wraps a decode TorchEngine as the served AsyncEngine: per
request it makes the local/remote decision, and for remote ones admits the
sequence (blocks pre-allocated), enqueues a RemotePrefillRequest carrying
this worker's transfer address, and streams tokens that start flowing once
the prefill worker pushes KV + first token back (reference:
examples/llm/components/worker.py:186-235).

PrefillWorker drains the shared queue: prefill on its own engine (its local
prefix cache still applies), push blocks to the decode worker, done
(reference: examples/llm/components/prefill_worker.py:139-211). SIGTERM
semantics: `stop()` finishes the current item then exits (reference:
disagg_serving.md:187-194 graceful drain).
"""

from __future__ import annotations

import asyncio
import logging
import os
import time
from typing import AsyncIterator

from dynamo_tpu_torch.block_manager.integrity import CHECKSUM_ALGO
from dynamo_tpu_torch.disagg.queue import PrefillQueue
from dynamo_tpu_torch.disagg.router import DisaggRouter
from dynamo_tpu_torch.disagg.transfer import KvReceiver, KvSender
from dynamo_tpu_torch.engine.engine import TorchEngine
from dynamo_tpu_torch.llm.protocols.common import (
    PreprocessedRequest,
    SamplingOptions,
)
from dynamo_tpu_torch.runtime.engine import Context
from dynamo_tpu_torch.utils.deadline import OVERLOAD
from dynamo_tpu_torch.utils.logging import request_scope
from dynamo_tpu_torch.utils.retry import QUEUE_REDELIVERY, RETRIES
from dynamo_tpu_torch.utils.tracing import TraceContext, tracer

logger = logging.getLogger(__name__)


class DecodeOperator:
    """AsyncEngine served by a decode worker in a disagg deployment."""

    def __init__(
        self,
        engine: TorchEngine,
        queue: PrefillQueue,
        router: DisaggRouter,
        transport: str = "auto",  # "native" (C++ agent) | "tcp" | "auto"
        staging_slots: int = 64,
        transfer_host: str = "127.0.0.1",
    ) -> None:
        """transfer_host: the address prefill workers reach this worker at,
        advertised in enqueued requests. Anything other than loopback makes
        the receiver bind all interfaces (cross-host disaggregation)."""
        self.engine = engine
        self.queue = queue
        self.router = router
        self.transport = transport
        self._staging_slots = staging_slots
        self._transfer_host = transfer_host
        self.receiver = None
        # Under "auto": a plain TCP receiver kept alongside the native
        # one, so a request the staging arena can't fund degrades to the
        # staging-free tcp wire instead of shedding to LOCAL prefill
        # (at 3000 prompt tokens every request needs ~190 staging blocks —
        # a 64-slot arena would turn "disagg" into silent aggregated
        # serving).
        self.tcp_receiver = None
        self.device_receiver = None
        self.remote_count = 0
        self.local_count = 0

    def _layout(self) -> dict:
        """KV block layout advertised in queue entries, so a prefill worker
        with a different one rejects the pair instead of shipping bytes
        this cache cannot hold. The head dim is the model's own (the
        port's cache is never lane-padded), so a TPU engine's padded
        layout is refused; a JAX engine on the CPU advertises the same
        one. ``tp`` and ``kv_sp`` are 1: the port has no mesh yet."""
        m = self.engine.cfg.model
        return {
            "num_layers": m.num_layers,
            "num_kv_heads": m.num_kv_heads,
            "head_dim": m.head_dim,
            "block_size": self.engine.cfg.block_size,
            "dtype": str(self.engine.cfg.dtype),
            # KV precision (docs/architecture/kv_quant.md): quantized
            # pairs ship PACKED rows (int8 data + scale sidecar) and
            # must match exactly — a mixed-precision pair rejects at
            # _check_layout and the decode side recomputes locally.
            "kv_quant": self.engine.cfg.kv_quant,
            "tp": 1,
            "kv_sp": 1,
            # Integrity-envelope algorithm this receiver verifies KV
            # frames with: a prefill worker speaking a DIFFERENT
            # algorithm must refuse the pair (its crc headers would be
            # unverifiable noise here), while a legacy peer that omits
            # the field is tolerated — its frames arrive unchecksummed
            # and ride the pre-envelope trust path.
            "checksum": CHECKSUM_ALGO,
        }

    async def start(self) -> "DecodeOperator":
        # Under "auto"/"device" the in-process channel (HBM→HBM,
        # disagg/device_transfer.py) is registered and advertised; senders
        # use it only when the address resolves in their own process. Wire
        # receivers below are the cross-process fallback. Explicit
        # "tcp"/"native" pins the wire path (tests, forced staging).
        want_device = self.transport in ("auto", "device")
        if self.transport == "device":
            self.transport = "auto"
        await self._start_wire()
        if want_device:
            from dynamo_tpu_torch.disagg.device_transfer import DeviceKvReceiver

            def on_finish(request_id: str, first_token: int) -> None:
                # The wire receiver may hold a staging reservation made
                # before the sender chose the device path — release it, or
                # the staging arena leaks one slot set per device transfer.
                release = getattr(self.receiver, "release", None)
                if release is not None:
                    release(request_id)
                self.engine.on_remote_finish(request_id, first_token)

            self.device_receiver = await DeviceKvReceiver(
                on_block=self.engine.on_remote_block,
                on_finish=on_finish,
                on_blocks=self.engine.on_remote_blocks,
            ).start()
        return self

    async def _start_wire(self) -> "DecodeOperator":
        pinned = self.transport
        if self.transport in ("auto", "native"):
            try:
                from dynamo_tpu_torch.block_manager.config import KvLayoutConfig
                from dynamo_tpu_torch.disagg.native_transfer import NativeKvReceiver

                # Quantized pairs stage PACKED rows (block_bytes includes
                # the scale sidecar).
                layout = KvLayoutConfig.for_engine(
                    self.engine.cfg, quant=self.engine.cfg.kv_quant)
                self.receiver = await NativeKvReceiver(
                    on_block=self.engine.on_remote_block,
                    on_finish=self.engine.on_remote_finish,
                    layout=layout,
                    num_slots=self._staging_slots,
                    host=self._transfer_host,
                ).start()
                self.transport = "native"
                if pinned == "auto":
                    self.tcp_receiver = await KvReceiver(
                        on_block=self.engine.on_remote_block,
                        on_finish=self.engine.on_remote_finish,
                        host=self._transfer_host,
                    ).start()
                return self
            except Exception:
                if self.transport == "native":
                    raise
                logger.info("native transfer unavailable; using tcp")
        self.transport = "tcp"
        self.receiver = await KvReceiver(
            on_block=self.engine.on_remote_block,
            on_finish=self.engine.on_remote_finish,
            host=self._transfer_host,
        ).start()
        return self

    async def stop(self) -> None:
        if self.receiver is not None:
            await self.receiver.stop()
        if self.tcp_receiver is not None:
            await self.tcp_receiver.stop()
        if self.device_receiver is not None:
            await self.device_receiver.stop()

    async def generate(self, request: Context) -> AsyncIterator[dict]:
        pre = (
            PreprocessedRequest.from_wire(request.payload)
            if isinstance(request.payload, dict)
            else request.payload
        )
        depth, age = await self.queue.stats()
        remote = self.router.prefill_remote(
            len(pre.token_ids),
            self.engine.prefix_overlap(list(pre.token_ids)),
            depth,
            queue_age_s=age,
        )
        if pre.logprobs is not None:
            # The first token samples on the PREFILL worker, which has no
            # channel for its logprob arrays — a remote prefill would drop
            # that token's entry and misalign logprobs vs tokens. Serve
            # logprob requests locally.
            remote = False
        stream = None
        if remote:
            admitted = await self.engine.begin_remote(request, pre)
            if admitted is not None:
                info, stream = admitted
                tracer().adopt(request.id, pre.trace)
                req = {
                    "request_id": request.id,
                    "token_ids": list(pre.token_ids),
                    "sampling": pre.sampling.to_wire(),
                    # SLO class tag (llm/slo.py): the consumer threads
                    # it into its prefill sequences, so class-aware shed
                    # /preempt decisions hold on the PREFILL worker too
                    # — a batch prompt must not displace an interactive
                    # one in a shared prefill pool.
                    "request_class": (pre.annotations or {}).get(
                        "request_class", "interactive"
                    ),
                    "transport": self.transport,
                    "transfer_address": self.receiver.address,
                    # Shared secret for the transfer plane; the queue is
                    # the trusted control plane that carries it.
                    "transfer_auth": self.receiver.auth,
                    "layout": self._layout(),
                    # Decode already holds blocks [0, start_block) from
                    # its prefix cache — ship only the suffix.
                    "start_block": info["start_block"],
                    # Trace identity + enqueue stamp: the consumer adopts
                    # the trace and retro-records the queue wait as a
                    # ``queue_wait`` span (wall clock — the wait itself
                    # crosses processes, same rationale as deadline_unix).
                    "trace": tracer().context_wire(
                        request.id, parent_span="queue_wait"
                    ),
                    "trace_pid": os.getpid(),
                    "enqueued_unix": time.time(),
                }
                if pre.deadline is not None:
                    # Wall-clock absolute: the QUEUE WAIT itself must
                    # count against the budget across processes (a
                    # remaining-ms re-anchor at dequeue would forgive it).
                    req["deadline_unix"] = pre.deadline.to_unix()
                if self.device_receiver is not None:
                    # Same-process fast path: HBM→HBM, no host staging.
                    req["device_address"] = self.device_receiver.address
                    req["device_auth"] = self.device_receiver.auth
                ok = True
                if self.transport == "native":
                    n_transfer = info["num_blocks"] - info["start_block"]
                    slots = self.receiver.reserve(request.id, n_transfer)
                    if slots is not None:
                        req["staging_slots"] = slots
                        req["staging_pitch"] = self.receiver.block_bytes
                    elif self.tcp_receiver is not None:
                        # Staging arena can't fund this transfer — keep it
                        # REMOTE over the staging-free tcp wire (the
                        # device fast path, if the sender resolves it,
                        # still wins and ignores these fields).
                        req["transport"] = "tcp"
                        req["transfer_address"] = self.tcp_receiver.address
                        req["transfer_auth"] = self.tcp_receiver.auth
                    else:
                        ok = False  # pinned native — do it locally
                if ok:
                    # Bounded enqueue: a full/stalled queue keeps this
                    # prefill LOCAL (graceful fallback) rather than
                    # queueing work the pool can't absorb.
                    if await self.queue.try_enqueue(req):
                        self.remote_count += 1
                        # Enqueued for REAL: from here a kv_transfer
                        # span is required for a complete timeline
                        # (trace_merge checks) — marked only after the
                        # bounded queue accepted, so a local fallback
                        # never demands a transfer that won't happen.
                        tracer().mark(request.id, "remote_prefill")
                    else:
                        self.engine.cancel_remote(request.id)
                        stream = None
                else:
                    self.engine.cancel_remote(request.id)
                    stream = None
        if stream is None:
            self.local_count += 1
            stream = self.engine.generate(request)
        async for item in stream:
            yield item


class PrefillWorker:
    """Queue consumer: prefill → push KV → notify."""

    def __init__(self, engine: TorchEngine, queue: PrefillQueue) -> None:
        self.engine = engine
        self.queue = queue
        self.sender = KvSender()
        self._native_sender = None  # lazily built on first native request
        self._task: asyncio.Task | None = None
        self._stopping = asyncio.Event()
        self.served = 0

    def start(self) -> "PrefillWorker":
        self._task = asyncio.ensure_future(self._run())
        return self

    async def _run(self) -> None:
        # Drain in BATCHES up to the engine's prefill width: a serial
        # per-request drain would leave the prefill engine at 1/lanes of
        # its batched prefill throughput.
        width = max(1, getattr(self.engine.cfg, "prefill_batch", 1))
        while not self._stopping.is_set():
            got = await self.queue.dequeue(timeout_s=0.2)
            if got is None:
                continue
            batch = [got]
            while len(batch) < width:
                more = await self.queue.dequeue(timeout_s=0.0)
                if more is None:
                    break
                batch.append(more)
            # Shed expired entries at the dequeue hop: a queued prefill
            # past its deadline is acked away, never executed — the decode
            # side's own deadline sweep cancels the waiting sequence.
            live = []
            for item_id, req in batch:
                du = req.get("deadline_unix")
                if du is not None and time.time() > du:
                    OVERLOAD.note_deadline("prefill_queue")
                    logger.warning(
                        "shedding expired queued prefill %s",
                        req.get("request_id"),
                    )
                    try:
                        await self.queue.ack(item_id)
                    except Exception:  # noqa: BLE001 — unacked expired item just redelivers and re-sheds
                        pass
                else:
                    live.append((item_id, req))
            batch = live
            if not batch:
                continue
            try:
                await self._serve_batch([r for _, r in batch])
            except Exception:  # noqa: BLE001 — batch is re-enqueued below with a bounded attempt count
                logger.exception("prefill batch failed")
                # Retry elsewhere, but BOUNDED: re-enqueue with an
                # attempt count and ack the originals, so a poison
                # request can't nack-to-front spin forever. Worker
                # DEATH (no ack at all) is covered by lease redelivery.
                for item_id, req in batch:
                    try:
                        attempts = req.get("attempts", 0) + 1
                        if attempts >= self.MAX_ATTEMPTS:
                            logger.error(
                                "dropping prefill %s after %d failed "
                                "attempts",
                                req.get("request_id"), attempts,
                            )
                        else:
                            RETRIES.note("prefill.requeue")
                            await self.queue.enqueue(
                                {**req, "attempts": attempts}
                            )
                        await self.queue.ack(item_id)
                    except Exception:  # noqa: BLE001 — requeue/ack failure is covered by lease-expiry redelivery
                        pass
                continue
            self.served += len(batch)
            for item_id, req in batch:
                try:
                    await self.queue.ack(item_id)
                except Exception:
                    # Served but un-acked: at-least-once means a possible
                    # duplicate prefill later; the decode side drops
                    # frames for unknown/finished request ids — safe.
                    logger.warning(
                        "ack of served prefill %s failed "
                        "(duplicate possible)",
                        req.get("request_id"),
                    )

    # One attempt budget for both requeue paths (engine-full and failed
    # batch), shared with the rest of the stack (utils/retry.py).
    MAX_ATTEMPTS = QUEUE_REDELIVERY.attempts

    def _check_layout(self, req: dict) -> bool:
        """Validate the decode side's advertised block layout against this
        engine's: layer and head counts, block size, head dim, dtype and
        KV precision must all match (the port repacks nothing: a
        lane-padded TPU layout is refused), and the integrity algorithm
        must be this worker's. A legacy entry without a layout passes."""
        layout = req.get("layout")
        if layout is None:
            return True
        cfg, m = self.engine.cfg, self.engine.cfg.model
        mine = {
            "num_layers": m.num_layers, "num_kv_heads": m.num_kv_heads,
            "head_dim": m.head_dim, "block_size": cfg.block_size,
            "dtype": cfg.dtype, "kv_quant": cfg.kv_quant,
        }
        hard = all(layout.get(k, v) == v for k, v in mine.items())
        if hard and layout.get("checksum", CHECKSUM_ALGO) != CHECKSUM_ALGO:
            # Mixed-fleet refusal: the decode side verifies frames under
            # an algorithm this worker does not speak. A layout that OMITS
            # the field is a legacy peer and stays accepted.
            logger.error(
                "prefill %s: decode peer verifies KV with %r, this worker "
                "stamps %r — rejecting (mixed integrity fleet; upgrade "
                "the lagging side)",
                req.get("request_id"), layout.get("checksum"), CHECKSUM_ALGO,
            )
            hard = False
        elif not hard:
            logger.error(
                "prefill %s: incompatible KV layout %s vs local %s — rejecting",
                req.get("request_id"), layout, mine,
            )
        return hard

    def _device_addr(self, req: dict) -> str | None:
        """Same-process decode peer ⇒ the device channel — but only for a
        peer whose layout names the same sharding (a layout without the
        fields, an older peer, takes the wire)."""
        from dynamo_tpu_torch.disagg import device_transfer

        layout = req.get("layout") or {}
        if (layout.get("tp", -1), layout.get("kv_sp", -1)) != (1, 1):
            return None
        dev_addr = req.get("device_address")
        if dev_addr and device_transfer.resolve(dev_addr) is not None:
            return dev_addr
        return None

    async def _serve_batch(self, reqs: list[dict]) -> None:
        """Prefill a batch of queue entries through the engine's FUSED
        lanes (prefill_only_batch), then ship each result over its own
        transport (device / native / tcp)."""
        good: list[dict] = []
        devs: list[str | None] = []
        for req in reqs:
            if not self._check_layout(req):
                continue  # decode's remote_kv_timeout reclaims the slot
            rid = req.get("request_id", "")
            # Join the request's trace: spans this worker records land
            # under the decode side's trace id, and the queue wait it
            # just finished is retro-recorded from the enqueue stamp.
            ctx_trace = TraceContext.from_wire(req.get("trace"))
            if ctx_trace is not None:
                # The queue entry's context is serialized at ENQUEUE, so
                # recv - sent here measures queue dwell (already recorded
                # as queue_wait below), not clock offset — a loaded queue
                # would otherwise report seconds of "skew" between
                # NTP-synced hosts. Low-latency seams (bus envelope) keep
                # their hints.
                ctx_trace.sent_unix = None
            tracer().adopt(rid, ctx_trace)
            # Span only entries that CARRY trace context: add_span
            # auto-opens, and a legacy (pre-trace) entry would emit a
            # junk single-process trace under a fresh id no other
            # process shares.
            if ctx_trace is not None and req.get("enqueued_unix"):
                tracer().add_span(
                    rid, "queue_wait", start_unix=float(req["enqueued_unix"])
                )
            good.append(req)
            devs.append(self._device_addr(req))
        if not good:
            return
        items = [
            (
                PreprocessedRequest(
                    token_ids=req["token_ids"],
                    sampling=SamplingOptions.from_wire(
                        req.get("sampling") or {}
                    ),
                    # Class-tagged queue entry (llm/slo.py): rides into
                    # the prefill sequence's slo_class via annotations.
                    annotations=(
                        {"request_class": req["request_class"]}
                        if req.get("request_class") else {}
                    ),
                ),
                req["request_id"],
                dev is not None,
            )
            for req, dev in zip(good, devs)
        ]
        futs = self.engine.prefill_only_batch(items)

        async def ship(req: dict, dev: str | None, fut) -> None:
            # Each item resolves as ITS prompt completes — ship right
            # then, not when the whole batch lands (TTFT would otherwise
            # pay the full batch's prefill time). Failures stay PER-ITEM:
            # one flaky send must not propagate and re-enqueue batch
            # mates that already shipped (they'd be prefilled twice).
            rid = req.get("request_id", "")
            # Trace id from the WIRE, not tracer().trace_id(): the
            # latter auto-opens a capture, and an entry without trace
            # context (pre-upgrade producer in a rolling deploy) would
            # open one nothing ever finishes.
            tid = (req.get("trace") or {}).get("trace_id") or None
            with request_scope(rid, tid):
                requeued = False
                rejoined = False
                try:
                    result = await fut
                    if result is None:
                        requeued = await self._requeue_full(req)
                        return
                    first_token, blocks = result
                    # Record kv_transfer only once the send SUCCEEDS: a
                    # failed attempt is requeued and retried, and a span
                    # per failed try would be summed by trace_merge's
                    # decomposition, overstating kv_transfer for exactly
                    # the retried requests.
                    t0_send = time.monotonic()
                    await self._send_result(
                        req, dev, first_token, blocks, tid
                    )
                    if tid:
                        # Same traceless-legacy guard as queue_wait
                        # above: never auto-open a junk trace.
                        if (
                            req.get("trace_pid") == os.getpid()
                            and tracer().trace_id_if_active(rid) != tid
                        ):
                            # Same process, one shared capture: the last
                            # frame activated the decode side, which can
                            # stream and FINISH the request before this
                            # coroutine resumes. A span added now would
                            # open a fresh trace under a new id (the
                            # request's timeline then lacks kv_transfer
                            # and an orphan appears): rejoin the request's
                            # trace for the span and close it again below.
                            late = TraceContext.from_wire(req.get("trace"))
                            late.sent_unix = None   # no clock-offset hint
                            tracer().adopt(rid, late)
                            rejoined = True
                        tracer().add_span(
                            rid, "kv_transfer", start_mono=t0_send
                        )
                except Exception:
                    logger.exception(
                        "shipping prefill %s failed", req.get("request_id")
                    )
                    requeued = await self._requeue_full(req)
                finally:
                    if rejoined:
                        # The span streamed to the capture as it closed;
                        # the request's finish is the decode side's.
                        tracer().abandon(rid, reason="late kv_transfer span")
                    elif req.get("trace_pid") != os.getpid():
                        # Cross-process item (including trace_pid=None —
                        # an entry from a producer that predates trace
                        # context): this worker's half of the capture
                        # closes here (its spans already streamed out);
                        # the decode/frontend side owns the real finish.
                        # In-process the trace is SHARED — leave it to
                        # the decode side's finish.
                        if not requeued:
                            tracer().finish(rid)
                        else:
                            # A REQUEUED item is still in flight and its
                            # next consumption may land on a DIFFERENT
                            # worker — holding this capture open for a
                            # same-process re-adopt would TTL-reap it as
                            # "abandoned" whenever a peer wins the pop,
                            # inflating abandoned_traces_total on routine
                            # engine-full churn. Close it without stats:
                            # re-consumption (here or elsewhere) adopts a
                            # fresh capture under the same trace id, and
                            # the requeue re-stamps enqueued_unix.
                            tracer().abandon(rid, reason="requeued")

        await asyncio.gather(
            *(ship(r, d, f) for r, d, f in zip(good, devs, futs))
        )

    async def _send_result(
        self,
        req: dict,
        dev_addr: str | None,
        first_token: int,
        blocks,
        trace_id: str | None = None,
    ) -> None:
        from dynamo_tpu_torch.disagg import device_transfer

        start = req.get("start_block", 0)
        if dev_addr is not None:
            await device_transfer.DeviceKvSender().send_blocks(
                dev_addr,
                req["request_id"],
                blocks[start:],
                first_token,
                start_idx=start,
                auth=req.get("device_auth"),
            )
            return
        if req.get("transport") == "native":
            if self._native_sender is None:
                from dynamo_tpu_torch.disagg.native_transfer import NativeKvSender

                self._native_sender = NativeKvSender()
            await self._native_sender.send_blocks(
                req["transfer_address"],
                req["request_id"],
                blocks[start:],
                first_token,
                start_idx=start,
                staging_slots=req["staging_slots"],
                staging_pitch=req.get("staging_pitch"),
                auth=req.get("transfer_auth"),
            )
        else:
            await self.sender.send_blocks(
                req["transfer_address"],
                req["request_id"],
                blocks[start:],
                first_token,
                start_idx=start,
                auth=req.get("transfer_auth"),
                # Wire-derived id from ship(): tracer().trace_id() here
                # would auto-open (and stamp frames with) a meaningless
                # fresh trace for legacy entries without trace context.
                trace_id=trace_id,
            )

    async def _requeue_full(self, req: dict) -> bool:
        """Engine full — requeue for another worker / a quieter moment.
        Bounded by the shared backoff policy: a never-admittable request
        must not cycle forever (the decode side's remote_kv_timeout
        reclaims its slot), and each cycle backs off exponentially so a
        saturated pool isn't hammered. Returns True when the item went
        back on the queue (it is still in flight), False when it was
        dropped for good."""
        attempts = req.get("attempts", 0) + 1
        if attempts >= self.MAX_ATTEMPTS:
            logger.error(
                "dropping prefill %s after %d attempts",
                req.get("request_id"), attempts,
            )
            return False
        RETRIES.note("prefill.requeue")
        # Fresh enqueue stamp: the retro-recorded queue_wait span on the
        # NEXT consumption must cover only that dwell — keeping the
        # original stamp would fold this attempt's prefill + transfer
        # time into queue_wait and corrupt the TTFT decomposition.
        await self.queue.enqueue(
            {**req, "attempts": attempts, "enqueued_unix": time.time()}
        )
        await asyncio.sleep(QUEUE_REDELIVERY.delay_for(attempts - 1))
        return True

    async def stop(self) -> None:
        """Graceful drain: finish the in-flight item, then stop."""
        self._stopping.set()
        if self._task is not None:
            await self._task
        await self.sender.close()
        if self._native_sender is not None:
            await self._native_sender.close()
