"""TorchEngine: the serving engine (port of the unified step of
dynamo_tpu/engine/engine.py's TpuEngine).

Continuous batching over a paged KV cache with prefix caching. Every
engine step is ONE ragged dispatch mixing decode lanes (draft-verify
spans under speculative decoding) with chunked-prefill quanta
(``_step_unified``); dispatches are pipelined ``pipeline_depth`` deep
(1 while speculation is active), each decode lane reading its previous
token on the device (the runner's feed), so the host never waits on a
fetch to issue the next step. On the card every dispatch replays a
captured CUDA graph (engine/runner.py).

Compile lifecycle: ``warmup()`` makes the hot program set on the engine
thread (the shape manifest's observed rungs first) while the engine is
``warming``; the rest of the plan, when a manifest defers it, is made one
program per idle step. ``warmup_gate="hold"`` holds admission until
then; ``"degraded"`` serves at once, flags ``served_unwarmed`` and
captures each program at first use (``mid_traffic_compiles_total``).

Speculative decoding (``speculative_k``): greedy decode lanes draft by
prompt lookup over their host token history and verify the drafts in
the same dispatch; an auto-gate falls back to plain decode below
break-even and re-probes later. Sampling extras (penalties, logprobs)
run through the top-rung extras program, taken only by dispatches that
carry such a request.

Threading model: model dispatch runs on a dedicated engine thread;
asyncio callers talk to it through thread-safe queues. Implements the
AsyncEngine contract: ``generate(Context)`` streams ``EngineOutput``
wire dicts.

Graceful drain: ``begin_drain`` refuses new requests with ``ShedError``
while every submitted sequence runs to completion; ``readiness()`` is
the snapshot ``/health``, ``/metrics`` and the admission gate read.

Observability and SLOs: every request's trace (utils/tracing.py) gets
the ``engine_queued`` mark, the ``queue_wait``, ``prefill``,
``decode_first`` and ``decode`` spans and a per-token ITL observation;
every dispatch leaves one flight record (engine/flight_recorder.py,
``debug_steps``), dumped to disk when the engine loop faults. Requests
may carry a deadline (expired ones finish with ``DEADLINE`` on arrival,
while waiting, or at their next token) and an SLO class (batch is shed
and preempted first). The prefill quantum of each dispatch is the
co-location controller's (engine/coloc.py), fed one ITL sample per
retired dispatch that carried decode lanes.

Side channels (``_flush_side_channels``, on the engine thread once per
loop pass): the block pool's KV events (``on_kv_event``, the KV
router's radix index), each admitted request's actual prefix reuse
(``kind="kv_actual"``: to the trace capture and ``on_kv_actual``, the
router's hit-rate plane) and a ``ForwardPassMetrics`` dict
(``on_metrics``, the worker's ``load_metrics`` endpoint). Without a
hook the flush only clears the buffers.

KVBM (``block_manager=``, block_manager/): at admission the G1 prefix
hit is extended with host-tier (G2) blocks (``_onboard_host_prefix``:
a bytes-free count first, disk promotion of the missing tail, the
adaptive gate that skips an onboard predicted slower than recompute,
then one in-place scatter of the matched rows); a prompt's full blocks
are offered to G2 once it is fed (``_offload_prompt_blocks``: one
device gather copied to pinned host memory, materialized on the KVBM
pump's thread).

Disaggregation (disagg/): the prefill side runs queued prompts through
``prefill_only_batch`` — depth-first waves of ``unified_step`` spans,
the warmed programs, each prompt's blocks gathered and its future
resolved as it completes; the decode side admits a sequence with its
blocks funded (``begin_remote``), lands the KV the transfer plane
delivers (``on_remote_block(s)``, checked against the sequence's
completeness ledger) and activates it at ``on_remote_finish``. A lost,
corrupt or late transfer degrades the request to local recompute.

Not in this port yet: G4 peers and multimodal (ROADMAP queue A).
Requests that ask for them are refused with ``RequestError``.
"""

from __future__ import annotations

import asyncio
import logging
import queue
import threading
import time
from collections import deque
from typing import AsyncIterator, Callable

import numpy as np

from dynamo_tpu_torch import resolve_device
from dynamo_tpu_torch.engine.coloc import ColocController
from dynamo_tpu_torch.engine.compile_cache import (
    ShapeManifest,
    _bucket,
    engine_fingerprint,
    fingerprint_key,
    token_budget,
)
from dynamo_tpu_torch.engine.config import EngineConfig
from dynamo_tpu_torch.engine.flight_recorder import FlightRecorder
from dynamo_tpu_torch.engine.kv_cache import BlockAllocator, KvEvent
from dynamo_tpu_torch.engine.runner import ModelRunner
from dynamo_tpu_torch.engine.scheduler import Scheduler, compose_unified
from dynamo_tpu_torch.engine.sequence import Sequence, SeqStatus
from dynamo_tpu_torch.llm import slo
from dynamo_tpu_torch.llm.tokens import TokenBlockSequence
from dynamo_tpu_torch.llm.protocols.common import (
    MAX_LOGPROBS,
    DeadlineError,
    EngineOutput,
    FinishReason,
    PreprocessedRequest,
    RequestError,
    ShedError,
)
from dynamo_tpu_torch.runtime.engine import Context
from dynamo_tpu_torch.runtime.failover import FAILOVER
from dynamo_tpu_torch.utils.deadline import OVERLOAD
from dynamo_tpu_torch.utils.faults import FAULTS
from dynamo_tpu_torch.utils.retry import RETRIES
from dynamo_tpu_torch.utils.tracing import tracer

logger = logging.getLogger(__name__)


class TorchEngine:
    def __init__(
        self,
        cfg: EngineConfig,
        params=None,
        device: str | None = None,
        on_kv_event: Callable[[KvEvent], None] | None = None,
        on_metrics: Callable[[dict], None] | None = None,
        on_kv_actual: Callable[[dict], None] | None = None,
        block_manager=None,
    ) -> None:
        cfg.validate()
        self.cfg = cfg
        self.device = resolve_device(device)
        self._params = params
        # KvBlockManager (G2/G3 tiers) or None. An int8 G1 offers (int8
        # data, scales): an unquantized tier layout cannot hold them.
        self.kvbm = block_manager
        layout = getattr(getattr(block_manager, "cfg", None), "layout", None)
        if cfg.kv_quant == "int8" and layout is not None and layout.quant != "int8":
            raise ValueError(
                "kv_quant='int8' requires the block manager's "
                "KvLayoutConfig to be quantized too (quant='int8') — an "
                "unquantized G2/G3 layout cannot hold the int8 G1's "
                "scale sidecars"
            )
        # Side channels, buffered on the engine thread and flushed once
        # per loop pass (_flush_side_channels): block-pool KV events,
        # per-request actual-reuse records, the metrics snapshot.
        self._external_kv_event = on_kv_event
        self._on_metrics = on_metrics
        self._on_kv_actual = on_kv_actual
        self._kv_events_buffer: list[KvEvent] = []
        self._kv_actuals_buffer: list[dict] = []
        self._reused_device_blocks = 0
        self._reused_host_blocks = 0
        self._reused_disk_blocks = 0
        self._reused_peer_blocks = 0
        # Disagg decode side: request_id -> sequence awaiting remote KV.
        self._remote: dict[str, Sequence] = {}
        # KVBM adaptive onboard gate: EMA bytes/s of host→device onboards
        # and EMA tok/s of prefill compute, on the engine's clock.
        self._onboard_bps: float | None = None
        self._prefill_tps: float | None = None
        self._onboard_skips = 0
        self._onboard_probes = 0
        # (start event, end event, bytes) of onboard scatters on the card
        # whose device time is not read yet.
        self._onboard_timings: deque = deque()
        # Requests completed through a fallback (remote KV lost ⇒ local
        # recompute): degraded_requests_total.
        self._degraded_requests = 0
        # Engine-thread heartbeat: the last loop pass (last_dispatch_age_s).
        self._last_dispatch_mono = time.monotonic()
        # Pipelined unified dispatches: issued-but-unprocessed records.
        self._inflight: deque = deque()
        # The previous dispatch's device tokens and id(seq) -> metadata
        # row map (the device feed).
        self._prev_unified_out = None
        self._prev_unified_rows: dict[int, int] = {}
        # Round-robin deferral offset for compose_unified.
        self._unified_rotation = 0
        # Admitted sequences whose prompts are still being fed chunk by
        # chunk (decode lanes interleave with long prefills).
        self._prefilling: list[Sequence] = []
        self.runner: ModelRunner | None = None
        self.allocator: BlockAllocator | None = None
        self.scheduler: Scheduler | None = None

        self._loop: asyncio.AbstractEventLoop | None = None
        self._submit_q: queue.Queue = queue.Queue()
        self._wakeup = threading.Event()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._dead: Exception | None = None
        self._prefix_hits = 0
        self._prefix_lookups = 0
        self._draining = False
        # Un-prefilled prompt tokens, refreshed by the engine thread (the
        # only place it may walk the waiting deque).
        self._prefill_backlog_tokens = 0
        # Dispatch counters (engine thread writes, readers after stop).
        self.unified_dispatches = 0
        self.unified_decode_tokens = 0
        self.unified_prefill_tokens = 0
        # Speculative decode: delivered tokens vs decode lane-steps run
        # under speculation, drafted/accepted draft tokens, and the
        # auto-gate's rolling window (cfg.speculative_break_even).
        self._spec_tokens = 0
        self._spec_steps = 0
        self._spec_drafted = 0
        self._spec_accepted = 0
        self._spec_enabled = True
        self._spec_win_tokens = 0
        self._spec_win_steps = 0
        self._plain_steps_since_disable = 0
        self.spec_probe_count = 0
        self._spec_probing = False
        # Compile lifecycle: init -> warming -> ready; the deferred warm
        # tail (made one per idle step); the degraded-serving flag.
        self._state = "init"
        self._warm_tail: deque = deque()
        self._served_unwarmed = False
        # SLO-aware co-location: owns the prefill quantum of every
        # dispatch; fed one ITL sample per retired dispatch with decode
        # lanes, timed on an injectable clock (the mocker charges its
        # simulated cost to it).
        self.coloc = ColocController(cfg)
        self._clock = time.monotonic
        self._last_unified_retire: float | None = None
        self._unified_fill_ratio = 0.0
        # Per-class waiting depth, refreshed by the engine thread.
        self._waiting_by_class = {slo.INTERACTIVE: 0, slo.BATCH: 0}
        # Step flight recorder: one record per dispatch, served by
        # /debug/steps, dumped to disk when the engine loop faults.
        self.flight = FlightRecorder(
            cfg.flight_record_capacity, cfg.flight_record_dir
        )

    # -- lifecycle ----------------------------------------------------------
    async def start(self) -> None:
        self._loop = asyncio.get_running_loop()
        self.allocator = BlockAllocator(
            self.cfg.num_blocks,
            self.cfg.block_size,
            enable_prefix_caching=self.cfg.enable_prefix_caching,
            on_event=self._queue_kv_event,
        )
        self.scheduler = Scheduler(self.cfg, self.allocator)
        # Weight init / upload happens off the event loop.
        await asyncio.to_thread(self._build_runner)
        self._state = "warming"
        self._thread = threading.Thread(
            target=self._engine_loop, name="torch-engine", daemon=True
        )
        self._thread.start()

    def _build_runner(self) -> None:
        self.runner = ModelRunner(
            self.cfg, params=self._params, device=self.device,
            rng_seed=self.cfg.seed,
        )
        self._params = None  # the runner holds the device copy

    async def stop(self) -> None:
        self._stop.set()
        self._wakeup.set()
        if self._thread:
            await asyncio.to_thread(self._thread.join, 30.0)
            if self._thread.is_alive():
                raise RuntimeError("engine thread did not stop within 30 s")
        self._save_manifest()

    # -- compile lifecycle ----------------------------------------------------
    def _save_manifest(self) -> None:
        """Persist the shapes serving executed, so the next launch's
        warmup makes exactly that set first."""
        path = self.cfg.shape_manifest_path
        if path is None or self.runner is None:
            return
        if not self.runner.compile_stats.manifest.shapes:
            return
        try:
            self.runner.save_manifest(path)
        except OSError:
            logger.exception("shape manifest save failed")

    def _load_manifest(self) -> ShapeManifest | None:
        path = self.cfg.shape_manifest_path
        if path is None:
            return None
        return ShapeManifest.load(
            path, fingerprint_key(engine_fingerprint(self.cfg))
        )

    async def warmup(self) -> int:
        """Make the serving program set before taking traffic (on the
        engine thread; see ModelRunner.warmup): on the card, capture one
        CUDA graph per program. Returns the number of programs made; the
        engine is "ready" when it returns."""
        if self._dead:
            raise RuntimeError(f"engine dead: {self._dead}")
        fut: asyncio.Future = self._loop.create_future()
        self._submit_q.put(("warmup", fut))
        self._wakeup.set()
        return await fut

    def _run_warmup(self, fut) -> None:
        """Make the HOT program set synchronously (the future resolves
        when it is made and the engine is ready); the tail — grid shapes
        a loaded manifest says serving did not execute — is made one
        program per idle engine step afterwards."""
        loop = self._loop

        def resolve(action, value):
            loop.call_soon_threadsafe(
                lambda: action(value) if not fut.done() else None
            )

        try:
            manifest = self._load_manifest()
            hot, tail = self.runner.warmup_plan(manifest)
            if manifest is not None:
                logger.info(
                    "shape-manifest warmup: %d hot shapes (observed set), "
                    "%d deferred to background", len(hot), len(tail),
                )
            n = self.runner.run_warm_ops(hot)
            self._warm_tail.extend(tail)
            self._state = "ready"
            resolve(fut.set_result, n)
        except Exception as exc:  # the warmup future re-raises on the caller
            resolve(fut.set_exception, exc)

    def _warm_one_tail(self) -> None:
        """Make ONE deferred program shape between engine steps. A
        failure raises: the engine loop dies loudly, as it does for a
        failed capture at first use."""
        _key, op = self._warm_tail.popleft()
        self.runner.run_warm_ops([(_key, op)])

    def _admission_held(self) -> bool:
        """warmup_gate="hold": no new work starts until the hot program
        set is made; requests queue in the scheduler meanwhile."""
        return self.cfg.warmup_gate == "hold" and self._state != "ready"

    def _note_unwarmed_traffic(self) -> None:
        """Degraded mode: an engine that takes traffic before warmup
        serves it (each program captured at first use, counted) and says
        so."""
        if self._state == "warming":
            self._state = "ready"
            self._served_unwarmed = True
            logger.warning(
                "serving before warmup completed — each program is captured "
                "at its first use (degraded; see mid_traffic_compiles_total)"
            )

    @property
    def state(self) -> str:
        """"init" (not started), "warming" (hot program set not made
        yet), "ready" (made, or degraded serving acknowledged)."""
        return self._state

    @property
    def is_ready(self) -> bool:
        return self._state == "ready"

    @property
    def served_unwarmed(self) -> bool:
        return self._served_unwarmed

    @property
    def warm_tail_pending(self) -> int:
        return len(self._warm_tail)

    # -- graceful drain -----------------------------------------------------
    def begin_drain(self) -> None:
        """Refuse new requests (``generate`` raises ShedError) while every
        submitted sequence runs to completion; readiness() reports
        "draining"."""
        if not self._draining:
            self._draining = True
            logger.info("engine draining: refusing new work")

    @property
    def draining(self) -> bool:
        return self._draining

    @property
    def drained(self) -> bool:
        """True when nothing is left in flight: no scheduled work, no
        issued-but-unprocessed dispatches, no queued submissions."""
        return (
            self.scheduler is not None
            and not self.scheduler.has_work
            and not self._remote
            and not self._inflight
            and self._submit_q.empty()
        )

    async def wait_drained(self, timeout_s: float = 30.0) -> bool:
        """Await in-flight completion after begin_drain(); True if the
        engine drained within ``timeout_s``."""
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            if self._dead or self.drained:
                return self._dead is None
            await asyncio.sleep(0.02)
        return self.drained

    def readiness(self) -> dict:
        """Snapshot for /health, /metrics and the admission watermarks,
        with the reference's names for the fields this engine has."""
        d = {
            "state": "draining" if self._draining else self._state,
            "served_unwarmed": self._served_unwarmed,
            "warm_tail_pending": len(self._warm_tail),
            "degraded_requests_total": self._degraded_requests,
            "draining": self._draining,
            "shed_requests_total": OVERLOAD.shed_total,
            "shed_interactive_total": OVERLOAD.shed_class_total(slo.INTERACTIVE),
            "shed_batch_total": OVERLOAD.shed_class_total(slo.BATCH),
            "deadline_exceeded_total": OVERLOAD.deadline_total,
            "abandoned_traces_total": tracer().abandoned_total,
            "flight_steps_total": self.flight.total_steps,
            "gpu_prefix_cache_hit_rate": self.prefix_hit_rate,
            "spec_tokens_per_step": self.spec_tokens_per_step,
            "spec_active": int(self._spec_active),
            "spec_drafted_tokens_total": self._spec_drafted,
            "spec_accepted_tokens_total": self._spec_accepted,
            # KV observatory: actual reuse per tier.
            "kv_reused_device_blocks_total": self._reused_device_blocks,
            "kv_reused_host_blocks_total": self._reused_host_blocks,
            "kv_reused_disk_blocks_total": self._reused_disk_blocks,
            "kv_reused_peer_blocks_total": self._reused_peer_blocks,
            "kvbm_kv_quant_ratio": round(
                getattr(self.runner, "kv_bytes_ratio", 1.0), 4),
            "last_dispatch_age_s": round(
                time.monotonic() - self._last_dispatch_mono, 3
            ),
        }
        d.update(self._kvbm_gauges())
        if self.scheduler is not None:
            # len() reads off the engine thread are atomic.
            d["num_requests_waiting"] = len(self.scheduler.waiting)
            usable = max(self.allocator.num_blocks - 1, 1)
            d["gpu_cache_usage_perc"] = (usable - self.allocator.num_free) / usable
            d["prefill_backlog_tokens"] = self._prefill_backlog_tokens
            # Engine-thread-refreshed per-class split of the waiting depth.
            d["num_waiting_interactive"] = self._waiting_by_class[slo.INTERACTIVE]
            d["num_waiting_batch"] = self._waiting_by_class[slo.BATCH]
        d["unified_step_tokens_decode_total"] = self.unified_decode_tokens
        d["unified_step_tokens_prefill_total"] = self.unified_prefill_tokens
        d["batch_fill_ratio"] = round(self._unified_fill_ratio, 4)
        d.update(self.coloc.snapshot())
        if self.runner is not None:
            d.update(self.runner.compile_stats.snapshot())
        return d

    @property
    def spec_tokens_per_step(self) -> float:
        """Mean delivered tokens per speculative decode step (>= 1.0)."""
        return self._spec_tokens / max(self._spec_steps, 1)

    @property
    def _spec_active(self) -> bool:
        return bool(self.cfg.speculative_k and self._spec_enabled)

    @property
    def spec_active(self) -> bool:
        """Whether speculation drives decode now (False = auto-gated off
        below cfg.speculative_break_even)."""
        return self._spec_active

    def _validate_request(self, pre: PreprocessedRequest) -> None:
        """Refuse what this engine does not serve, loudly (RequestError →
        HTTP 400), instead of serving it wrong."""
        s = pre.sampling
        if pre.logprobs is not None and pre.logprobs > MAX_LOGPROBS:
            raise RequestError(
                f"top_logprobs={pre.logprobs} exceeds the supported "
                f"maximum of {MAX_LOGPROBS}"
            )
        extras = bool(
            s.frequency_penalty or s.presence_penalty
            or pre.logprobs is not None
        )
        if extras and not self.cfg.sampling_extras:
            raise RequestError(
                "frequency_penalty/presence_penalty/logprobs are disabled "
                "on this engine (sampling_extras=False)"
            )
        if extras and self.cfg.speculative_k:
            raise RequestError(
                "frequency_penalty/presence_penalty/logprobs are not "
                "supported with speculative decoding"
            )
        if pre.mm_segments:
            raise RequestError(
                "not served by this engine yet: multimodal segments")

    @property
    def prefix_hit_rate(self) -> float:
        if not self._prefix_lookups:
            return 0.0
        return self._prefix_hits / self._prefix_lookups

    # -- AsyncEngine --------------------------------------------------------
    async def generate(self, request: Context) -> AsyncIterator[dict]:
        if self._dead:
            raise RuntimeError(f"engine dead: {self._dead}")
        if self._draining:
            # Class-tagged so the per-class shed split never diverges
            # from the total.
            OVERLOAD.note_shed(
                "engine.draining", request_class=_payload_class(request.payload)
            )
            raise ShedError(
                "engine draining — retry another instance", draining=True
            )
        pre = (
            PreprocessedRequest.from_wire(request.payload)
            if isinstance(request.payload, dict)
            else request.payload
        )
        if pre.deadline is not None and pre.deadline.expired:
            OVERLOAD.note_deadline("engine.arrival")
            raise DeadlineError("request deadline expired before admission")
        self._validate_request(pre)
        out_q: asyncio.Queue = asyncio.Queue()
        loop = self._loop
        if loop is None:
            raise RuntimeError("engine not started")

        def emit(token: int | None, finish: FinishReason | None, lp=None) -> None:
            loop.call_soon_threadsafe(out_q.put_nowait, (token, finish, lp))

        seq = Sequence(
            request_id=request.id,
            prompt_tokens=list(pre.token_ids),
            sampling=pre.sampling,
            stop=pre.stop,
            emit=emit,
            logprobs=pre.logprobs,
            deadline=pre.deadline,
            slo_class=_request_class(pre),
        )
        tracer().adopt(request.id, pre.trace)
        tracer().mark(request.id, "engine_queued")
        self._submit_q.put(("add", seq))
        self._wakeup.set()
        async for item in self._stream(request, seq, out_q):
            yield item

    async def _stream(
        self, request: Context, seq: Sequence, out_q: asyncio.Queue
    ) -> AsyncIterator[dict]:
        count = 0
        last_tok_s: float | None = None
        try:
            while True:
                token, finish, lp = await out_q.get()
                if token is not None:
                    count += 1
                    now = time.monotonic()
                    if count == 1:
                        tracer().mark(request.id, "first_token")
                        # Token computed → on the stream closes the TTFT
                        # decomposition; steady decode is its own span.
                        tracer().span_end(request.id, "decode_first")
                        tracer().span_begin(request.id, "decode")
                    else:
                        # Per-token ITL: the aggregate decode interval
                        # hides a single stalled gap.
                        tracer().observe_itl(1000.0 * (now - last_tok_s), request.id)
                    last_tok_s = now
                    yield EngineOutput(
                        token_ids=[token], cum_tokens=count,
                        logprobs=[lp] if lp is not None else None,
                    ).to_wire()
                if finish is not None:
                    if finish is FinishReason.ERROR:
                        # An engine fault ends the stream normally with an
                        # ERROR frame: record it, or the capture shows a
                        # clean completion for a request that died.
                        tracer().mark_if_active(request.id, "error")
                    yield EngineOutput(
                        token_ids=[], finish_reason=finish, cum_tokens=count
                    ).to_wire()
                    return
                if request.is_stopped:
                    yield EngineOutput(
                        token_ids=[],
                        finish_reason=FinishReason.CANCELLED,
                        cum_tokens=count,
                    ).to_wire()
                    return
        except Exception:
            # The finally below pops the trace before the consumer's own
            # except clause could mark it: mark the error here.
            tracer().mark_if_active(request.id, "error")
            raise
        finally:
            tracer().finish(request.id)
            if seq.status is not SeqStatus.FINISHED:
                self._submit_q.put(("abort", seq))
                self._wakeup.set()

    # -- engine thread ------------------------------------------------------
    def _engine_loop(self) -> None:
        try:
            while not self._stop.is_set():
                busy = self._step_unified()
                # Heartbeat: every loop pass proves the thread alive.
                self._last_dispatch_mono = time.monotonic()
                if not busy and self._warm_tail:
                    # Idle step: make one deferred program, between
                    # traffic rather than under it.
                    self._warm_one_tail()
                    busy = True
                self._flush_side_channels()
                if not busy:
                    self._wakeup.wait(timeout=0.01)
                    self._wakeup.clear()
        except Exception as exc:  # top of the thread: fail every request loudly
            logger.exception("engine loop died")
            self._dead = exc
            # The black box first: the steps leading into the fault are
            # the postmortem evidence (best-effort, never raises).
            self.flight.dump_fault(f"{type(exc).__name__}: {exc}")
            for seq in list(self.scheduler.running.values()) + list(
                self.scheduler.waiting
            ):
                seq.status = SeqStatus.FINISHED
                seq.emit(None, FinishReason.ERROR)
            while True:
                try:
                    op, arg = self._submit_q.get_nowait()
                except queue.Empty:
                    break
                if op == "add":
                    arg.status = SeqStatus.FINISHED
                    arg.emit(None, FinishReason.ERROR)
                    continue
                # A pending warmup or remote-prefill future fails, never
                # hangs, on a dead engine.
                if op == "warmup":
                    futs = [arg]
                elif op == "add_remote":
                    futs = [arg[1]]
                elif op == "remote_prefill_batch":
                    futs = [f for _, _, f in arg]
                else:
                    futs = []
                for fut in futs:
                    self._loop.call_soon_threadsafe(
                        lambda f=fut, e=exc: f.done() or f.set_exception(
                            RuntimeError(f"engine dead: {e}")
                        )
                    )

    def _drain_submissions(self) -> None:
        # Wire-delivered blocks queued back to back land in one scatter
        # per request (flushed before any other submission, so a finish
        # always finds its blocks landed).
        frames: dict[str, list] = {}
        while True:
            try:
                op, arg = self._submit_q.get_nowait()
            except queue.Empty:
                break
            if op == "scatter_remote":
                frames.setdefault(arg[0], []).append(arg[1:])
                continue
            for rid, items in frames.items():
                self._scatter_remote(rid, items)
            frames = {}
            if op == "add":
                self.scheduler.add(arg)
            elif op == "abort":
                self.scheduler.abort(arg)
            elif op == "warmup":
                self._run_warmup(arg)
            elif op == "remote_prefill_batch":
                self._run_remote_prefill_batch(arg)
            elif op == "add_remote":
                self._admit_remote(*arg)
            elif op == "scatter_remote_batch":
                self._scatter_remote_batch(*arg)
            elif op == "activate_remote":
                self._activate_remote(*arg)
            elif op == "cancel_remote":
                self._cancel_remote(arg)
        for rid, items in frames.items():
            self._scatter_remote(rid, items)

    def _step_unified(self) -> bool:
        """One engine iteration: retire ready dispatches, admit prefills,
        compose ONE token-budget batch mixing decode lanes with chunked-
        prefill quanta, dispatch it."""
        self._drain_submissions()
        did = False
        if self.scheduler.waiting:
            self.scheduler.expire_waiting()
        # 1. Retire in-flight dispatches: device-ready ones, plus the
        #    oldest when the pipeline is at depth. Speculation runs
        #    depth 1: each dispatch's variable progress, and the host
        #    history prompt lookup drafts from, must be host-known before
        #    the next issue.
        depth = 1 if self._spec_active else self.cfg.pipeline_depth
        while self._inflight and (
            len(self._inflight) >= depth or self._inflight[0][1].ready()
        ):
            self._process_unified_chunk(self._inflight.popleft())
            self._drain_submissions()
            did = True
        # 2. Admit new prompts into the prefilling set.
        self._admit_prefills()
        # 3. Compose + dispatch one mixed batch (asynchronous).
        if len(self._inflight) < depth and self._issue_unified():
            return True
        # 4. Nothing new to issue — retire the oldest dispatch if any.
        if self._inflight:
            self._process_unified_chunk(self._inflight.popleft())
            return True
        return did

    # Tokens of trailing history the prompt-lookup bigram scan walks per
    # lane per dispatch (bounded so a match-less long context cannot
    # stall the engine thread).
    DRAFT_SCAN_WINDOW = 512

    def _draft_tokens(self, seq: Sequence) -> list[int]:
        """Prompt-lookup drafts for one greedy decode lane: the latest
        earlier occurrence of the trailing bigram in the host token
        history supplies up to speculative_k continuation tokens."""
        cfg = self.cfg
        limit = min(
            cfg.speculative_k,
            # Every draft position's KV write stays inside max_model_len.
            seq.context_cap(cfg.max_model_len) - 1,
            # A spec span never exceeds decode's half of the budget.
            max(1, cfg.unified_token_budget // 2) - 1,
        )
        if seq.stop.max_tokens is not None:
            # Drafts past the request's remaining budget would be
            # delivered, then discarded.
            limit = min(
                limit,
                seq.stop.max_tokens - seq.folded_output
                - len(seq.output_tokens) - 1,
            )
        if limit <= 0:
            return []
        prompt, out = seq.prompt_tokens, seq.output_tokens
        P = len(prompt)
        n = P + len(out)
        if n < 3:
            return []

        def tok(i: int) -> int:
            return prompt[i] if i < P else out[i - P]

        a, b = tok(n - 2), tok(n - 1)
        floor = max(0, n - 3 - self.DRAFT_SCAN_WINDOW)
        for j in range(n - 3, floor - 1, -1):
            if tok(j) == a and tok(j + 1) == b:
                return [tok(i) for i in range(j + 2, min(j + 2 + limit, n))]
        return []

    def _issue_unified(self) -> bool:
        """Compose one token-budget batch (decode lanes first — draft-
        verify spans while speculation is active — then prefill quanta)
        and dispatch it through ModelRunner.unified_step. Returns True if
        anything was issued."""
        t_compose = time.monotonic()
        cfg = self.cfg
        spec_on = self._spec_active
        lookahead = (cfg.speculative_k if spec_on else 0) + 1
        decode_ready = [
            seq for seq in self.scheduler.decode_batch(lookahead=lookahead)
            # A lane whose newest token lives in a dispatch older than
            # the one the row map describes waits until that retires.
            if seq.inflight_chunks == 0 or id(seq) in self._prev_unified_rows
        ]
        prefill_items = [
            (s, len(s.prompt_tokens) - s.prefill_cursor)
            for s in self._prefilling
            if s.status is SeqStatus.PREFILLING
        ]
        # Draft rows ride only the budget-ladder program; a step that
        # needs the extras program composes plain decode spans (extras
        # requests are refused on a speculative engine anyway).
        has_extras = cfg.sampling_extras and (
            any(s.needs_extras for s in decode_ready)
            or any(s.needs_extras for s, _ in prefill_items)
        )
        draft_map: dict[int, list[int]] = {}
        if spec_on and not has_extras:
            for seq in decode_ready:
                if seq.inflight_chunks > 0:
                    continue  # token not host-known yet
                t = seq.sampling.temperature
                if t is not None and t > 0.0:
                    continue  # sampled lanes accept no drafts by law
                drafts = self._draft_tokens(seq)
                if drafts:
                    draft_map[id(seq)] = drafts
        decode_items = [
            (seq, 1 + len(draft_map.get(id(seq), []))) for seq in decode_ready
        ]
        decode_take, prefill_take = compose_unified(
            decode_items, prefill_items, cfg.unified_token_budget,
            self.coloc.quantum, rotation=self._unified_rotation,
        )
        if not decode_take and not prefill_take:
            return False
        self._unified_rotation += len(decode_take)

        S = self.runner.unified_slots
        use_prev = np.zeros(S, bool)
        prev_row = np.zeros(S, np.int32)
        lanes = []
        draft_lens: list[int] = []
        roles: list[tuple] = []  # (seq, kind, start, n, deliver)
        n_drafted = 0
        for seq, width in decode_take:
            s = len(lanes)
            n = seq.device_len
            drafts = draft_map.get(id(seq), []) if width > 1 else []
            if drafts:
                # Draft-verify span: the host-known last token plus the
                # drafts, verified inside the dispatch.
                lanes.append(([seq.last_token] + drafts, seq.block_ids, n - 1,
                              self._lane_sampling(seq)))
                draft_lens.append(len(drafts))
                roles.append((seq, "spec", n - 1, len(drafts), True))
                n_drafted += len(drafts)
                seq.inflight_chunks += 1
                seq.sched_len = seq.total_len  # reconciled at process time
                continue
            if seq.inflight_chunks > 0:
                use_prev[s] = True
                prev_row[s] = self._prev_unified_rows[id(seq)]
                tok = 0  # replaced on device by the previous dispatch's sample
            else:
                tok = seq.last_token
            lanes.append(([tok], seq.block_ids, n - 1, self._lane_sampling(seq)))
            draft_lens.append(0)
            roles.append((seq, "decode", n - 1, 1, True))
            seq.inflight_chunks += 1
            seq.sched_len = n + 1
        for seq, n in prefill_take:
            start = seq.prefill_cursor
            toks = seq.prompt_tokens[start : start + n]
            lanes.append((toks, seq.block_ids, start, self._lane_sampling(seq)))
            draft_lens.append(0)
            seq.prefill_cursor = start + n
            done = seq.prefill_cursor >= len(seq.prompt_tokens)
            roles.append((seq, "prefill", start, n, done))
            seq.inflight_chunks += 1
            if done:
                # Decodable from the NEXT dispatch: its first generated
                # token is this dispatch's sample, read on device through
                # the feed; sched_len counts that pending token.
                seq.status = SeqStatus.RUNNING
                seq.sched_len = seq.total_len + 1

        extras = None
        if has_extras:
            extras = {
                "slots": [(q.slot if q.slot is not None else -1) for q, *_r in roles],
                # Each decode span's FED token is counted; prefill quanta
                # never are.
                "counts_add": [kind == "decode" for _, kind, *_r in roles],
                "reset": [], "freq": [], "pres": [],
            }
            for q, *_r in roles:
                extras["reset"].append(q.counts_reset_pending)
                q.counts_reset_pending = False
                extras["freq"].append(q.sampling.frequency_penalty or 0.0)
                extras["pres"].append(q.sampling.presence_penalty or 0.0)

        # Dispatch start, paired with the retire time for the coloc ITL
        # sample (the runner issues asynchronously: the device time shows
        # up as the inter-retire interval).
        t_dispatch = self._clock()
        out = self.runner.unified_step(
            lanes, feed=(self._prev_unified_out, prev_row, use_prev),
            draft_lens=draft_lens if n_drafted else None, extras=extras,
        )
        t_issue = self._clock()
        self._prev_unified_out = out.last
        self._prev_unified_rows = {
            id(seq): i for i, (seq, *_r) in enumerate(roles)
        }
        n_dec = len(decode_take)
        n_pre = sum(n for _, n in prefill_take)
        self.unified_dispatches += 1
        self.unified_decode_tokens += n_dec
        self.unified_prefill_tokens += n_pre
        self._spec_drafted += n_drafted
        # Fill against the rung actually run: an extras dispatch pads to
        # the top rung.
        total_toks = n_dec + n_pre + n_drafted
        padded = (
            _bucket(cfg.unified_token_budget) if extras is not None
            else token_budget(total_toks, cfg.unified_token_budget)
        )
        self._unified_fill_ratio = total_toks / padded
        # Whether this dispatch's decode lanes feed the auto-gate's window
        # is fixed AT ISSUE: plain dispatches in flight when a re-probe
        # turns the gate on must not count as spec steps.
        spec_counted = spec_on and not has_extras
        compose_ms = 1000.0 * (time.monotonic() - t_compose)
        stats = (n_dec, n_pre, t_issue, t_dispatch, n_drafted, compose_ms,
                 self._unified_fill_ratio)
        self._inflight.append((roles, out, spec_counted, stats))
        if n_drafted == 0:
            # Spec dispatches record at retire (their accepted counts are
            # on the device until then); every other dispatch at issue.
            self._note_step(
                "unified", decode_tokens=n_dec, prefill_tokens=n_pre,
                fill=self._unified_fill_ratio, dispatch_ms=compose_ms,
                lanes=len(roles),
            )
        # Auto-gate re-probe: after speculative_probe_steps plain decode
        # steps, run a short probe window and re-judge.
        if cfg.speculative_k and not self._spec_enabled and decode_take:
            self._plain_steps_since_disable += 1
            if self._plain_steps_since_disable >= cfg.speculative_probe_steps:
                self._spec_enabled = True
                self._spec_probing = True
                self._spec_win_tokens = 0
                self._spec_win_steps = 0
                self.spec_probe_count += 1
                logger.info("speculative decode re-probing")
        return True

    def _process_unified_chunk(self, record) -> None:
        """Force one unified dispatch's tokens and run the host-side
        bookkeeping: decode lanes deliver their token, draft-verify spans
        their accepted drafts and bonus, completed prefill lanes the
        prompt's first token, every lane registers the blocks its KV
        writes filled."""
        roles, out, spec_counted, stats = record
        n_dec, n_pre, t_issue, t_dispatch, drafted, compose_ms, fill = stats
        toks = out.tokens()
        spec = out.spec()
        lp = None
        if any(seq.logprobs is not None for seq, *_r in roles):
            lp = out.logprobs()
        now = self._clock()
        if n_dec:
            # The coloc ITL sample, taken once the dispatch's tokens are
            # ready: a dispatch issued before the previous one retired
            # (pipelined) kept its lanes waiting the inter-retire
            # interval; otherwise dispatch start → retire. The max with
            # the issue-side time covers a runner that pays its cost
            # inside the issue call (the mocker). Draft rows stretch the
            # dispatch as prefill rows do: they count as prefill evidence.
            last = self._last_unified_retire
            if last is not None and last >= t_dispatch:
                gap_ms = 1000.0 * (now - last)
            else:
                gap_ms = 1000.0 * (now - t_dispatch)
            self.coloc.observe(
                max(gap_ms, 1000.0 * (t_issue - t_dispatch)),
                n_dec, n_pre + drafted,
            )
        self._last_unified_retire = now
        if n_pre and not n_dec:
            # Prefill-only dispatch: a clean recompute-rate sample for the
            # KVBM adaptive onboard gate (pipelining can only overstate
            # the interval: the conservative direction for the gate).
            self._note_prefill_rate(n_pre, self._clock() - t_issue)
        for seq, *_rest in roles:
            seq.inflight_chunks -= 1
        n_drafted = n_accepted = 0
        for i, (seq, kind, start, n, deliver) in enumerate(roles):
            if kind in ("decode", "spec"):
                if seq.status is not SeqStatus.RUNNING:
                    continue  # stopped while in flight; token discarded
                if spec_counted:
                    # Every decode lane-step of a dispatch issued with
                    # speculation active is one spec step; delivered
                    # tokens are the numerator.
                    self._spec_steps += 1
                    self._spec_win_steps += 1
                if kind == "spec":
                    emitted, counts = spec
                    c = int(counts[i])
                    n_drafted += n
                    n_accepted += max(0, c - 1)
                    for j in range(c):
                        if seq.status is not SeqStatus.RUNNING:
                            break
                        # The step fed seq.last_token (and the accepted
                        # drafts): their KV is in the cache now.
                        if seq.hashes is not None:
                            seq.hashes.append(seq.last_token)
                        self.scheduler.register_filled_blocks(seq, seq.total_len)
                        self._deliver(seq, int(emitted[i, j]))
                        self._spec_tokens += 1
                        self._spec_win_tokens += 1
                    seq.sched_len = seq.total_len
                    continue
                # The step fed seq.last_token — its KV is now in cache.
                if seq.hashes is not None:
                    seq.hashes.append(seq.last_token)
                self.scheduler.register_filled_blocks(seq, seq.total_len)
                tok = int(toks[i])
                self._deliver(seq, tok, self._lp_at(lp, seq, i, tok))
                if spec_counted:
                    self._spec_tokens += 1
                    self._spec_win_tokens += 1
            else:
                if seq.status not in (SeqStatus.PREFILLING, SeqStatus.RUNNING):
                    continue  # aborted mid-prompt; KV writes were harmless
                self.scheduler.register_filled_blocks(seq, start + n)
                if deliver and seq.status is SeqStatus.RUNNING:
                    if self.kvbm is not None:
                        # Prompt fully fed: stage its blocks into G2.
                        self._offload_prompt_blocks(seq)
                    tok = int(toks[i])
                    self._deliver(seq, tok, self._lp_at(lp, seq, i, tok))
        for seq, *_rest in roles:
            if seq.defer_release and seq.inflight_chunks == 0:
                seq.defer_release = False
                self.scheduler._release(seq)
        self._spec_accepted += n_accepted
        if drafted:
            # dispatch_ms stays the issue-side compose time, as on every
            # other record.
            self._note_step(
                "spec", decode_tokens=n_dec, prefill_tokens=n_pre, fill=fill,
                dispatch_ms=compose_ms, lanes=len(roles), drafted=drafted,
                accepted=n_accepted,
            )
        if self.cfg.speculative_k:
            self._maybe_gate_speculation()

    def _note_step(
        self,
        kind: str,
        *,
        decode_tokens: int = 0,
        prefill_tokens: int = 0,
        fill: float = 0.0,
        dispatch_ms: float = 0.0,
        lanes: int = 0,
        drafted: int = 0,
        accepted: int = 0,
    ) -> None:
        """One dispatch's flight record (engine thread). Counter fields
        are snapshots, so a reader diffs adjacent records to attribute a
        stall, a shed or a quantum change to the step that paid it."""
        cs = self.runner.compile_stats
        sched = self.scheduler
        self.flight.note_step(
            kind,
            decode_tokens=decode_tokens,
            prefill_tokens=prefill_tokens,
            batch_fill_ratio=fill,
            dispatch_ms=dispatch_ms,
            lanes=lanes,
            drafted=drafted,
            accepted=accepted,
            inflight_depth=len(self._inflight),
            waiting=len(sched.waiting),
            running=len(sched.running),
            compile_stall_ms_total=cs.compile_stall_ms_total,
            mid_traffic_compiles_total=cs.mid_traffic_compiles,
            shed_total=OVERLOAD.shed_total,
            deadline_total=OVERLOAD.deadline_total,
            quantum=self.coloc.quantum,
            itl_ema_ms=self.coloc.itl_ema_ms,
            headroom_ms=self.coloc.headroom_ms,
        )

    def debug_steps(self, n: int | None = None) -> list[dict]:
        """The flight recorder's last ``n`` step records — the
        /debug/steps payload (llm/http_service.py)."""
        return self.flight.snapshot(n)

    @staticmethod
    def _lp_at(lp, seq: Sequence, lane: int, token: int) -> dict | None:
        """One lane's logprob entry from the extras program's outputs
        (None when the dispatch carried none or the request did not ask)."""
        if lp is None or seq.logprobs is None:
            return None
        clp, tids, tlps = lp
        k = seq.logprobs
        return {
            "id": token,
            "logprob": float(clp[lane]),
            "top": [[int(i), float(v)] for i, v in zip(tids[lane][:k], tlps[lane][:k])],
        }

    def _maybe_gate_speculation(self) -> None:
        """Auto-gate: below break-even delivered tokens per step over a
        window, speculation costs verify rows for less than one extra
        token — fall back to plain decode, and re-probe after
        cfg.speculative_probe_steps plain steps. A re-probe judges after
        only speculative_probe_window steps."""
        window = (
            self.cfg.speculative_probe_window
            if self._spec_probing
            else self.cfg.speculative_window
        )
        if self._spec_win_steps < window:
            return
        rate = self._spec_win_tokens / self._spec_win_steps
        self._spec_probing = False
        if rate < self.cfg.speculative_break_even:
            self._spec_enabled = False
            self._plain_steps_since_disable = 0
            logger.info(
                "speculative decode disabled: %.2f tok/step < break-even "
                "%.2f over %d steps",
                rate, self.cfg.speculative_break_even, self._spec_win_steps,
            )
        self._spec_win_tokens = 0
        self._spec_win_steps = 0

    @staticmethod
    def _lane_sampling(seq: Sequence) -> tuple[float, int, float, int]:
        s = seq.sampling
        # Seeds fold deterministically into int32 range (-1 = unseeded).
        seed = -1 if s.seed is None else int(s.seed) % 0x7FFFFFFF
        return (
            s.temperature if s.temperature is not None else 0.0,
            s.top_k or 0,
            s.top_p if s.top_p is not None else 1.0,
            seed,
        )

    def _admit_prefills(self) -> None:
        """Admit waiting prompts into the PREFILLING set (prefix-hit
        accounting, cursor setup); composition takes quanta from it."""
        sched = self.scheduler
        self._prefilling = [
            s for s in self._prefilling if s.status is SeqStatus.PREFILLING
        ]
        if (
            sched.waiting
            and len(self._prefilling) < self.cfg.prefill_batch
            and not self._admission_held()
            and not self.coloc.admit_prefill()
        ):
            # Per-phase admission: decode is over its ITL SLO, so new
            # prompts stay queued this step (bounded by the controller's
            # anti-starvation streak; PREFILLING sequences keep making
            # floor-quantum progress).
            return
        while (
            not self._admission_held()
            and len(self._prefilling) < self.cfg.prefill_batch
        ):
            seq = sched.next_prefill()
            if seq is None:
                break
            self._note_unwarmed_traffic()
            if seq.first_token_s is None:
                # Admission: the waiting time becomes a queue_wait span
                # and the prefill span opens (closed at the first token).
                # A preempted sequence re-admitted after its first token
                # opens neither.
                if not tracer().has_span(seq.request_id, "queue_wait"):
                    tracer().add_span(
                        seq.request_id, "queue_wait", start_mono=seq.arrival_s
                    )
                tracer().span_begin(seq.request_id, "prefill")
            if self.kvbm is not None:
                self._onboard_host_prefix(seq)
            self._prefix_lookups += 1
            if seq.num_cached_prefix:
                self._prefix_hits += 1
            self._note_kv_actual(seq)
            seq.status = SeqStatus.PREFILLING
            seq.prefill_cursor = seq.num_cached_prefix
            self._prefilling.append(seq)

    def _note_kv_actual(self, seq: Sequence) -> None:
        """Record what this request actually reused, split by tier — the
        engine-side half of the router's predicted-vs-actual loop. Called
        at admission after any host-prefix onboard, once per request (a
        re-admission after preemption or a remote-KV degradation does not
        count again); buffered, flushed with the side channels."""
        if seq.kv_actual_reported:
            return
        seq.kv_actual_reported = True
        bs = self.cfg.block_size
        # num_cached_prefix covers the G1 hit plus everything onboarded;
        # the device share is the remainder.
        device = max(
            0,
            seq.num_cached_prefix // bs - seq.reuse_host_blocks
            - seq.reuse_disk_blocks - seq.reuse_peer_blocks,
        )
        seq.reuse_device_blocks = device
        self._reused_device_blocks += device
        self._reused_host_blocks += seq.reuse_host_blocks
        self._reused_disk_blocks += seq.reuse_disk_blocks
        self._reused_peer_blocks += seq.reuse_peer_blocks
        self._kv_actuals_buffer.append(
            {
                "kind": "kv_actual",
                "id": seq.request_id,
                # Never re-opens a finished trace; "" when this process
                # holds no trace for the request.
                "trace": tracer().trace_id_if_active(seq.request_id) or "",
                "isl_blocks": (len(seq.prompt_tokens) + bs - 1) // bs,
                "device_blocks": device,
                "host_blocks": seq.reuse_host_blocks,
                "disk_blocks": seq.reuse_disk_blocks,
                "peer_blocks": seq.reuse_peer_blocks,
                "unix": time.time(),
            }
        )

    # -- KVBM (G2 host / G3 disk tiers) ----------------------------------------
    # Blocks an adaptive-gate rate probe moves: enough bytes for a stable
    # bandwidth sample, few enough that the first request on a slow link
    # pays milliseconds.
    PROBE_BLOCKS = 4

    def _note_prefill_rate(self, tokens: int, dt: float) -> None:
        """EMA of prefill throughput — the recompute side of the adaptive
        onboard gate's cost model."""
        if tokens <= 0 or dt <= 0:
            return
        tps = tokens / dt
        self._prefill_tps = (
            tps if self._prefill_tps is None
            else 0.7 * self._prefill_tps + 0.3 * tps
        )

    def _note_onboard_rate(self, nbytes: int, dt: float) -> None:
        """EMA of host→device onboard bandwidth — the transfer side of the
        gate's cost model (every sample a byte-capped window)."""
        if nbytes <= 0 or dt <= 0:
            return
        bps = nbytes / dt
        self._onboard_bps = (
            bps if self._onboard_bps is None
            else 0.7 * self._onboard_bps + 0.3 * bps
        )

    def _onboard_host_prefix(self, seq: Sequence) -> None:
        """G2→G1: extend the G1 prefix hit with host-tier blocks — scatter
        their bytes into the sequence's already-allocated blocks, in
        place, then register them. Engine thread, before the prefill's
        first dispatch (stream order puts the scatter ahead of it)."""
        bs = self.cfg.block_size
        P = len(seq.prompt_tokens)
        start = seq.num_cached_prefix // bs
        limit = (P - 1) // bs  # always leave >= 1 token to compute
        if seq.hashes is None or start >= limit:
            return
        hashes = seq.hashes.sequence_hashes()[start:limit]
        # A bytes-free match first: deciding to skip must not itself pay
        # the prefix-sized host memcpy that match_host does.
        n_match = self.kvbm.count_host_match(hashes)
        if n_match < len(hashes):
            # Two-touch disk promotion of whatever G2 misses, so the NEXT
            # request with this prefix hits G2 (no-op without a G3).
            self.kvbm.request_disk_promotion(hashes[n_match:])
        if n_match == 0:
            return
        r = self.runner
        layout = getattr(getattr(self.kvbm, "cfg", None), "layout", None)
        block_bytes = layout.block_bytes if layout is not None else 0
        if self.cfg.kvbm_adaptive_gate and self._onboard_bps is None:
            # No bandwidth estimate yet: probe PROBE_BLOCKS and
            # extrapolate; the rest of the prefix recomputes.
            self._onboard_probes += 1
            hashes = hashes[: self.PROBE_BLOCKS]
        elif (
            self.cfg.kvbm_adaptive_gate
            and self._onboard_bps and self._prefill_tps
            and (n_match * block_bytes) / self._onboard_bps
            > (n_match * bs) / self._prefill_tps
        ):
            # Moving the bytes is predicted slower than recomputing them:
            # treat the hit as a miss (the prefill recomputes identical
            # KV). Every 32nd skip re-probes, bounded to PROBE_BLOCKS, so
            # a stale estimate cannot pin the gate shut.
            self._onboard_skips += 1
            if self._onboard_skips % 32 != 0:
                return
            self._onboard_probes += 1
            hashes = hashes[: self.PROBE_BLOCKS]
        prepare = getattr(r, "prepare_blocks_host", None)  # the mocker has none
        # Unquantized rows in the cache's own bytes land straight in pinned
        # staging on the card: one asynchronous copy to the device.
        staging = None
        if (prepare is not None and layout is not None and layout.quant is None
                and layout.dtype == self.cfg.dtype):
            staging = r.onboard_staging(len(hashes))
            if staging is not None and staging[1].shape[1] != layout.block_elems:
                staging = None
        matches = self.kvbm.match_host(
            hashes, out=None if staging is None else staging[1])
        if not matches:  # raced an eviction between count and fetch
            return
        blocks = [seq.block_ids[start + i] for i in range(len(matches))]
        sc_rows = None
        try:
            # Host-side validation BEFORE any cache write: a bad row fails
            # here with the cache untouched, so recomputing is valid.
            if staging is not None:
                rows = staging[0][: len(matches)]
            elif layout is not None and layout.quant == "int8" and prepare is not None:
                rows, sc_rows = r.import_host_rows([m[3] for m in matches], layout)
            elif prepare is not None:
                rows = prepare([m[3] for m in matches])
            else:
                rows = [m[3] for m in matches]
        except Exception:  # noqa: BLE001 — nothing written yet: recompute
            logger.exception("bad host-tier rows for %s; recomputing", seq.request_id)
            return
        try:
            t0 = self._clock()
            timer = getattr(r, "timing_event", lambda: None)()
            if prepare is not None:
                r.scatter_many_prepared(blocks, rows)
                if sc_rows is not None:
                    r.set_block_scales(blocks, sc_rows)
            else:
                r.scatter_many(blocks, rows)
            nbytes = len(matches) * block_bytes
            if timer is None:
                self._note_onboard_rate(nbytes, max(self._clock() - t0, 1e-6))
            else:
                # On the card the scatter is asynchronous: its device time
                # is read once its end event has passed (_settle_onboards),
                # never by waiting here.
                self._onboard_timings.append((timer, r.timing_event(), nbytes))
            for block, (h, parent, tokens, _data) in zip(blocks, matches):
                self.allocator.register(
                    block, h, parent_hash=parent, token_ids=list(tokens))
            seq.num_cached_prefix = (start + len(matches)) * bs
            # Actual-reuse attribution: G2-native vs G3-origin blocks.
            disk_n = self.kvbm.count_disk_origin([m[0] for m in matches])
            seq.reuse_host_blocks += len(matches) - disk_n
            seq.reuse_disk_blocks += disk_n
        except Exception as exc:
            if prepare is not None:
                # The failure is in or after the in-place cache write: the
                # blocks may hold partial rows the allocator does not know
                # of — recomputing over them is not safe. Fatal: the
                # engine loop fails every sequence loudly.
                raise RuntimeError(
                    "host onboard failed at/after the KV scatter for "
                    f"{seq.request_id}; cache state is unrecoverable"
                ) from exc
            logger.exception("host onboard failed for %s; recomputing", seq.request_id)

    def _offload_prompt_blocks(self, seq: Sequence) -> None:
        """G1→G2: stage the prompt's full blocks into the host tier. One
        device gather into pinned host memory, asynchronous: the engine
        thread pays the enqueue, the KVBM pump's worker thread waits on
        the copy's event."""
        bs = self.cfg.block_size
        full = len(seq.prompt_tokens) // bs
        if seq.hashes is None:
            return
        todo = []
        for idx in range(full):
            h = seq.hashes.blocks[idx]
            if self.kvbm.has_host(h.sequence_hash):
                continue
            todo.append((seq.block_ids[idx], h))
        if not todo:
            return
        ids = [b for b, _ in todo]
        datas = self.runner.gather_many_async(ids)
        scales = (self.runner.gather_scales_async(ids)
                  if getattr(self.runner, "kv_quant", None) else None)
        self.kvbm.offer_batch(
            [(h.sequence_hash, h.parent_sequence_hash, h.tokens) for _, h in todo],
            datas, scales=scales,
        )

    def _kvbm_gauges(self) -> dict:
        """The block manager's tier telemetry, kvbm_-prefixed for every
        metric surface; empty without a block manager."""
        if self.kvbm is None:
            return {}
        try:
            st = self.kvbm.stats()
        except Exception:  # noqa: BLE001 — a telemetry probe must not fail readiness
            logger.exception("kvbm stats failed")
            return {}
        g = {f"kvbm_{k}": st.get(k, 0) for k in _KVBM_STATS}
        # Host→device onboard rate: the EMA the adaptive gate keeps.
        g["kvbm_link_g2g1_bps"] = round(self._onboard_bps, 1) if self._onboard_bps else 0.0
        return g

    def _settle_onboards(self) -> None:
        """Fold the device time of every onboard scatter that has run into
        the onboard-rate EMA (engine thread; never waits)."""
        while self._onboard_timings and self._onboard_timings[0][1].query():
            start, end, nbytes = self._onboard_timings.popleft()
            self._note_onboard_rate(nbytes, max(start.elapsed_time(end) / 1000.0, 1e-6))

    @property
    def degraded_requests(self) -> int:
        """Requests completed through a degradation path (remote KV lost ⇒
        local recompute) rather than dropped."""
        return self._degraded_requests

    def prefix_overlap(self, token_ids: list[int]) -> float:
        """Fraction of this prompt already covered by the G1 prefix cache —
        the per-request hit rate the disagg decision needs. A read-only
        peek at the allocator from the caller's thread."""
        if not self.cfg.enable_prefix_caching or not token_ids:
            return 0.0
        bs = self.cfg.block_size
        hashes = TokenBlockSequence.from_tokens(token_ids, block_size=bs).sequence_hashes()
        n = 0
        for h in hashes[: (len(token_ids) - 1) // bs]:
            if not self.allocator.is_registered(h):
                break
            n += 1
        return n * bs / len(token_ids)

    # -- disaggregation: the prefill side --------------------------------------
    async def prefill_only(
        self, pre: PreprocessedRequest, request_id: str, device: bool = False
    ) -> tuple[int, list] | None:
        """One prompt's prefill: (first_token, blocks) — every block that
        covers the prompt, on the host (or one device snapshot with
        ``device=True``, the device channel). None when the engine cannot
        admit it now (the caller requeues)."""
        return await self.prefill_only_batch([(pre, request_id, device)])[0]

    def prefill_only_batch(
        self, items: list[tuple[PreprocessedRequest, str, bool]]
    ) -> list[asyncio.Future]:
        """Batched remote prefill; items are (request, request_id,
        device_snapshot). One future per item, resolved to (first_token,
        blocks) — or None when not admitted — as EACH prompt completes:
        the waves run depth-first, so early finishers ship while later
        prompts still compute."""
        futs = [self._loop.create_future() for _ in items]
        if self._draining:
            # A draining prefill worker refuses: the queue redelivers each
            # item to a live worker.
            for pre, _rid, _device in items:
                OVERLOAD.note_shed("engine.draining", request_class=_request_class(pre))
            for fut in futs:
                fut.set_result(None)
            return futs
        seqs = []
        for (pre, rid, device), fut in zip(items, futs):
            seqs.append((
                Sequence(
                    request_id=rid,
                    prompt_tokens=list(pre.token_ids),
                    sampling=pre.sampling,
                    stop=pre.stop,
                    emit=lambda t, f, lp=None: None,
                    slo_class=_request_class(pre),
                ),
                device,
                fut,
            ))
        self._submit_q.put(("remote_prefill_batch", seqs))
        self._wakeup.set()
        return futs

    def _run_remote_prefill_batch(self, seqs) -> None:
        loop = self._loop

        def resolve(fut: asyncio.Future, value) -> None:
            loop.call_soon_threadsafe(
                lambda: fut.set_result(value) if not fut.done() else None)

        # The waves replay the step programs, whose output buffers the
        # next pipelined dispatch would read its feed from: retire every
        # dispatch in flight first, so the next one feeds from the host.
        while self._inflight:
            self._process_unified_chunk(self._inflight.popleft())
        bs = self.cfg.block_size
        # Keyed by id(seq), not request_id: at-least-once delivery can put
        # two copies of one request in one batch.
        done: set[int] = set()

        def finish(seq: Sequence, device: bool, fut, token: int) -> None:
            """Register, gather, resolve and RELEASE one completed prompt
            at once: its caller ships while later waves compute."""
            try:
                self.scheduler.register_filled_blocks(seq, len(seq.prompt_tokens))
                if self.kvbm is not None:
                    self._offload_prompt_blocks(seq)
                ids = seq.block_ids[: (len(seq.prompt_tokens) + bs - 1) // bs]
                quantized = getattr(self.runner, "kv_quant", None)
                if device:
                    from dynamo_tpu_torch.disagg.device_transfer import BlockBatch

                    # One gather for the whole prompt (a snapshot: the
                    # blocks are released below), scatter-ready as a unit.
                    blocks = BlockBatch(
                        self.runner.gather_many_device(ids),
                        scales=(self.runner.gather_scales_device(ids)
                                if quantized else None),
                    )
                elif quantized:
                    # Wire frames of an int8 pair are PACKED rows.
                    blocks = self.runner.export_block_rows(ids)
                else:
                    # One batched host copy; each frame is copied out of
                    # it, so a queued frame never pins the whole batch.
                    batch = self.runner.gather_many(ids)
                    blocks = [np.array(batch[j]) for j in range(len(ids))]
                # The prefill span closes once the blocks are ready to
                # ship; kv_transfer starts from here (disagg/worker.py).
                tracer().span_end(seq.request_id, "prefill")
                resolve(fut, (token, blocks))
            except Exception:  # noqa: BLE001 — fails ONE item: the decode side recomputes
                logger.exception("remote prefill gather failed for %s", seq.request_id)
                resolve(fut, None)
            finally:
                done.add(id(seq))
                self.scheduler._release(seq)
                seq.status = SeqStatus.FINISHED

        admitted: list[tuple[Sequence, bool, asyncio.Future]] = []
        try:
            for seq, device, fut in seqs:
                if (
                    not self._admission_held()
                    and len(seq.prompt_tokens) < self.cfg.max_model_len
                    and self.scheduler.admit(seq)
                ):
                    self._note_unwarmed_traffic()
                    tracer().add_span(seq.request_id, "queue_wait",
                                      start_mono=seq.arrival_s)
                    tracer().span_begin(seq.request_id, "prefill")
                    admitted.append((seq, device, fut))
                else:
                    resolve(fut, None)
            cursors: dict[int, int] = {}
            meta: dict[int, tuple] = {}
            for seq, device, fut in admitted:
                if self.kvbm is not None:
                    self._onboard_host_prefix(seq)
                self._prefix_lookups += 1
                if seq.num_cached_prefix:
                    self._prefix_hits += 1
                self._note_kv_actual(seq)
                cursors[id(seq)] = seq.num_cached_prefix
                meta[id(seq)] = (device, fut)
            # Depth-first waves of unified_step spans — the warmed
            # programs, replayed: the first sequences keep their lanes
            # until their prompts complete, then the next takes the
            # freed budget.
            pending = [seq for seq, _, _ in admitted]
            while pending:
                items = [(s, len(s.prompt_tokens) - cursors[id(s)]) for s in pending]
                _, take = compose_unified(
                    [], items, self.cfg.unified_token_budget,
                    self.cfg.unified_prefill_quantum,
                )
                take = take[: self.runner.unified_slots]
                lanes = [
                    (s.prompt_tokens[cursors[id(s)] : cursors[id(s)] + n],
                     s.block_ids, cursors[id(s)], self._lane_sampling(s))
                    for s, n in take
                ]
                t0 = self._clock()
                out = self.runner.unified_step(lanes)
                toks = out.tokens()
                n_pre = sum(n for _, n in take)
                self.unified_dispatches += 1
                self.unified_prefill_tokens += n_pre
                self._note_prefill_rate(n_pre, self._clock() - t0)
                self._note_step("unified", prefill_tokens=n_pre, lanes=len(take))
                still = []
                for i, (seq, n) in enumerate(take):
                    c = min(cursors[id(seq)] + n, len(seq.prompt_tokens))
                    cursors[id(seq)] = c
                    if c >= len(seq.prompt_tokens):
                        device, fut = meta[id(seq)]
                        finish(seq, device, fut, int(toks[i]))
                    else:
                        still.append(seq)
                in_wave = {id(s) for s, _ in take}
                pending = still + [s for s in pending if id(s) not in in_wave]
        except Exception:  # noqa: BLE001 — the finally resolves every unserved future None
            logger.exception("batched remote prefill failed")
        finally:
            for seq, _, fut in admitted:
                if id(seq) not in done:
                    resolve(fut, None)
                    self.scheduler._release(seq)
                    seq.status = SeqStatus.FINISHED

    # -- disaggregation: the decode side ---------------------------------------
    def begin_remote(self, request: Context, pre: PreprocessedRequest):
        """Admit ``request`` with remote KV. Returns an awaitable resolving
        to (info, stream) — info has ``num_blocks`` and ``start_block``
        (the prefix-cache hit: only the suffix is transferred) — or None
        when admission failed (the caller serves it locally)."""
        if self._draining:
            OVERLOAD.note_shed("engine.draining", request_class=_request_class(pre))
            raise ShedError("engine draining — retry another instance", draining=True)
        if pre.deadline is not None and pre.deadline.expired:
            OVERLOAD.note_deadline("engine.arrival")
            raise DeadlineError("request deadline expired before admission")
        self._validate_request(pre)
        tracer().adopt(request.id, pre.trace)
        out_q: asyncio.Queue = asyncio.Queue()
        loop = self._loop

        def emit(token, finish, lp=None):
            loop.call_soon_threadsafe(out_q.put_nowait, (token, finish, lp))

        seq = Sequence(
            request_id=request.id,
            prompt_tokens=list(pre.token_ids),
            sampling=pre.sampling,
            stop=pre.stop,
            emit=emit,
            logprobs=pre.logprobs,
            deadline=pre.deadline,
            slo_class=_request_class(pre),
        )
        fut: asyncio.Future = loop.create_future()
        self._submit_q.put(("add_remote", (seq, fut)))
        self._wakeup.set()

        async def wait():
            info = await fut
            if info is None:
                return None
            return info, self._stream(request, seq, out_q)

        return wait()

    def _admit_remote(self, seq: Sequence, fut: asyncio.Future) -> None:
        info = None
        if (
            not self._admission_held()
            and len(seq.prompt_tokens) < self.cfg.max_model_len
            and self.scheduler.admit(seq)
        ):
            self._note_unwarmed_traffic()
            tracer().add_span(seq.request_id, "queue_wait", start_mono=seq.arrival_s)
            seq.status = SeqStatus.WAITING_REMOTE
            self._remote[seq.request_id] = seq
            bs = self.cfg.block_size
            info = {
                "num_blocks": (len(seq.prompt_tokens) + bs - 1) // bs,
                "start_block": seq.num_cached_prefix // bs,
            }
            # Completeness ledger: a lost frame must degrade to recompute,
            # never activate over a hole of stale KV.
            seq.remote_span = (info["start_block"], info["num_blocks"])
            seq.remote_landed = set()
        self._loop.call_soon_threadsafe(
            lambda: fut.set_result(info) if not fut.done() else None)

    def cancel_remote(self, request_id: str) -> None:
        """The decode side bailed before enqueueing: free the admitted
        sequence (thread-safe)."""
        self._submit_q.put(("cancel_remote", request_id))
        self._wakeup.set()

    def _cancel_remote(self, request_id: str) -> None:
        seq = self._remote.pop(request_id, None)
        if seq is not None and seq.status is SeqStatus.WAITING_REMOTE:
            self.scheduler.abort(seq)

    def on_remote_block(self, request_id: str, seq_idx: int, data) -> None:
        """Receiver callback: one block's bytes arrived (thread-safe)."""
        self._submit_q.put(("scatter_remote", (request_id, seq_idx, data)))
        self._wakeup.set()

    def on_remote_blocks(self, request_id: str, start_idx: int, data) -> None:
        """Receiver callback: an [N, ...] device snapshot arrived (the
        device channel), scattered in one go (thread-safe)."""
        self._submit_q.put(("scatter_remote_batch", (request_id, start_idx, data)))
        self._wakeup.set()

    def on_remote_finish(self, request_id: str, first_token: int) -> None:
        """Receiver callback: every block sent; activate decode."""
        self._submit_q.put(("activate_remote", (request_id, first_token)))
        self._wakeup.set()

    def _degrade_remote_to_local(self, request_id: str, why: str) -> None:
        """The KV handoff for ``request_id`` died (transfer failure,
        prefill-worker death, corrupt frame): release its blocks and
        requeue it for LOCAL prefill — the request completes through
        recompute, which overwrites whatever the transfer left. Late
        frames find nothing in ``_remote`` and are ignored."""
        seq = self._remote.pop(request_id, None)
        if seq is None or seq.status is not SeqStatus.WAITING_REMOTE:
            return
        logger.warning(
            "remote prefill for %s degraded to local recompute (%s)", request_id, why)
        self._degraded_requests += 1
        # A degraded request legitimately completes without a kv_transfer
        # span: trace_merge reads this mark.
        tracer().mark_if_active(request_id, "degraded_local")
        seq.remote_span = None
        seq.remote_landed = set()
        self.scheduler.requeue_for_recompute(seq)

    def _remote_span_check(self, seq: Sequence, lo: int, hi: int) -> None:
        start, total = seq.remote_span or (0, len(seq.block_ids))
        if not (start <= lo and hi <= total):
            # Below-span blocks are SHARED prefix-cache blocks other
            # sequences read: writing there would corrupt them all.
            raise ValueError(
                f"blocks [{lo}, {hi}) outside the remote span [{start}, {total})")

    def _scatter_remote(self, request_id: str, items: list) -> None:
        """Land one request's wire frames — (block index, host bytes)
        pairs queued back to back — in one scatter. Wire-supplied indices
        and payloads are validated first: a corrupt frame degrades ONE
        request to local recompute, never the engine."""
        seq = self._remote.get(request_id)
        if seq is None or seq.status is not SeqStatus.WAITING_REMOTE:
            return
        r = self.runner
        try:
            idxs = [i for i, _ in items]
            for i in idxs:
                self._remote_span_check(seq, i, i + 1)
            ids = [seq.block_ids[i] for i in idxs]
            datas = [d for _, d in items]
            if getattr(r, "kv_quant", None):
                # Quantized pairs ship PACKED rows: data + scale rows.
                rows, scales = r.import_host_rows(datas, r._quant_layout())
                r.scatter_many_prepared(ids, rows)
                r.set_block_scales(ids, scales)
            else:
                r.scatter_many(ids, datas)
            seq.remote_landed.update(idxs)
        except Exception:  # noqa: BLE001 — degrades the request
            logger.exception("bad remote KV frame for %s", request_id)
            self._degrade_remote_to_local(request_id, "corrupt KV frame")

    def _scatter_remote_batch(self, request_id: str, start_idx: int, data) -> None:
        seq = self._remote.get(request_id)
        if seq is None or seq.status is not SeqStatus.WAITING_REMOTE:
            return
        try:
            n = len(data)
            self._remote_span_check(seq, start_idx, start_idx + n)
            ids = seq.block_ids[start_idx : start_idx + n]
            blocks, scales = (data.consume() if hasattr(data, "consume")
                              else (data, None))
            self.runner.scatter_many_device(ids, blocks)
            if scales is not None:
                self.runner.set_block_scales(ids, scales)
            seq.remote_landed.update(range(start_idx, start_idx + n))
        except Exception:  # noqa: BLE001 — degrades the request
            logger.exception("bad remote KV batch for %s", request_id)
            self._degrade_remote_to_local(request_id, "corrupt KV batch")

    def _activate_remote(self, request_id: str, first_token: int) -> None:
        seq = self._remote.get(request_id)
        if seq is None or seq.status is not SeqStatus.WAITING_REMOTE:
            return
        if seq.remote_span is not None:
            start, total = seq.remote_span
            missing = len(set(range(start, total)) - seq.remote_landed)
            if missing > 0:
                # A finish over a hole: decoding would read stale KV.
                self._degrade_remote_to_local(
                    request_id,
                    f"incomplete remote KV ({missing} of {total - start} "
                    "blocks never landed)",
                )
                return
        self._remote.pop(request_id, None)
        seq.status = SeqStatus.RUNNING
        self.scheduler.register_filled_blocks(seq, len(seq.prompt_tokens))
        if self.kvbm is not None:
            self._offload_prompt_blocks(seq)
        self._deliver(seq, first_token)

    def _expire_stale_remotes(self) -> None:
        """A prefill worker that died mid-transfer must not pin decode
        slots: WAITING_REMOTE sequences past remote_kv_timeout_s degrade
        to local recompute; past their deadline they finish DEADLINE."""
        now = time.monotonic()
        for rid, seq in list(self._remote.items()):
            if seq.deadline is not None and seq.deadline.expired:
                OVERLOAD.note_deadline("engine.remote")
                self._remote.pop(rid, None)
                self.scheduler.abort(seq, FinishReason.DEADLINE)
            elif now - seq.arrival_s > self.cfg.remote_kv_timeout_s:
                self._degrade_remote_to_local(rid, "remote KV timeout")

    # -- side channels ------------------------------------------------------
    def _queue_kv_event(self, ev: KvEvent) -> None:
        self._kv_events_buffer.append(ev)

    def _flush_side_channels(self) -> None:
        """Engine thread only: walks the scheduler's deques and drains the
        side-channel buffers, none of which are locked."""
        if self._remote:
            self._expire_stale_remotes()
        if self._onboard_timings:
            self._settle_onboards()
        if self._external_kv_event:
            for ev in self._kv_events_buffer:
                try:
                    self._external_kv_event(ev)
                except Exception:  # noqa: BLE001 — a subscriber bug must not kill the loop
                    logger.exception("kv event callback failed")
        self._kv_events_buffer.clear()
        if self._kv_actuals_buffer:
            for rec in self._kv_actuals_buffer:
                try:
                    tracer().export(rec)
                    if self._on_kv_actual is not None:
                        self._on_kv_actual(rec)
                except Exception:  # noqa: BLE001 — observability must not kill the loop
                    logger.exception("kv actual export failed")
            self._kv_actuals_buffer.clear()
        sched = self.scheduler
        # Un-prefilled prompt tokens and the per-class waiting split (the
        # engine thread is the only place the waiting deque may be walked).
        self._prefill_backlog_tokens = sum(
            len(s.prompt_tokens) for s in sched.waiting
        ) + sum(
            len(s.prompt_tokens) - s.prefill_cursor
            for s in self._prefilling
            if s.status is SeqStatus.PREFILLING
        )
        self._waiting_by_class = sched.waiting_by_class()
        if self._on_metrics is None:
            return
        m = sched.metrics()
        m["gpu_prefix_cache_hit_rate"] = self.prefix_hit_rate
        if self.kvbm is not None:
            # Why the host tier is (not) used: the adaptive gate's skips
            # and its onboard-rate estimate.
            m["kvbm_onboard_skips"] = self._onboard_skips
            if self._onboard_bps is not None:
                m["kvbm_onboard_bps"] = round(self._onboard_bps, 1)
        # Actual reuse per tier and the KVBM's tier telemetry; the
        # weight-quant fields keep their ForwardPassMetrics defaults
        # until the port has them.
        m["kv_reused_device_blocks_total"] = self._reused_device_blocks
        m["kv_reused_host_blocks_total"] = self._reused_host_blocks
        m["kv_reused_disk_blocks_total"] = self._reused_disk_blocks
        m["kv_reused_peer_blocks_total"] = self._reused_peer_blocks
        m["kvbm_kv_quant_ratio"] = round(getattr(self.runner, "kv_bytes_ratio", 1.0), 4)
        m.update(self._kvbm_gauges())
        m["degraded_requests_total"] = self._degraded_requests
        if self.cfg.speculative_k:
            m["spec_tokens_per_step"] = self.spec_tokens_per_step
            m["spec_active"] = int(self._spec_active)
        m["spec_drafted_tokens_total"] = self._spec_drafted
        m["spec_accepted_tokens_total"] = self._spec_accepted
        m["unified_step_tokens_decode_total"] = self.unified_decode_tokens
        m["unified_step_tokens_prefill_total"] = self.unified_prefill_tokens
        m["batch_fill_ratio"] = round(self._unified_fill_ratio, 4)
        m.update(self.coloc.snapshot())
        m["prefill_backlog_tokens"] = self._prefill_backlog_tokens
        m.update(self.runner.compile_stats.snapshot())
        m["engine_ready"] = int(self._state == "ready")
        m["warm_tail_pending"] = len(self._warm_tail)
        m["faults_injected_total"] = FAULTS.total_injected
        m["retries_total"] = RETRIES.total
        m["shed_requests_total"] = OVERLOAD.shed_total
        m["shed_interactive_total"] = OVERLOAD.shed_class_total(slo.INTERACTIVE)
        m["shed_batch_total"] = OVERLOAD.shed_class_total(slo.BATCH)
        m["num_waiting_interactive"] = self._waiting_by_class[slo.INTERACTIVE]
        m["num_waiting_batch"] = self._waiting_by_class[slo.BATCH]
        m["deadline_exceeded_total"] = OVERLOAD.deadline_total
        m["draining"] = int(self._draining)
        m["failover_total"] = FAILOVER.total
        m["failover_success_total"] = FAILOVER.success_total
        m["workers_marked_dead_total"] = FAILOVER.marked_dead_total
        m["last_dispatch_age_s"] = round(
            time.monotonic() - self._last_dispatch_mono, 3
        )
        m["abandoned_traces_total"] = tracer().abandoned_total
        m["flight_steps_total"] = self.flight.total_steps
        try:
            self._on_metrics(m)
        except Exception:  # noqa: BLE001 — metrics export must not kill the loop
            logger.exception("metrics callback failed")

    def _deliver(self, seq: Sequence, token: int, lp: dict | None = None) -> None:
        seq.output_tokens.append(token)
        if seq.first_token_s is None:
            seq.first_token_s = time.monotonic()
            # First token computed: the prefill span ends, decode_first
            # covers the hop until _stream puts it on the wire.
            tracer().span_end(seq.request_id, "prefill")
            tracer().span_begin(seq.request_id, "decode_first")
        reason = seq.should_stop()
        if reason is None and seq.total_len >= self.cfg.max_model_len:
            reason = FinishReason.LENGTH
        if reason is None and seq.deadline is not None and seq.deadline.expired:
            # Mid-generation expiry: the delivered tokens stream out with
            # a DEADLINE finish; further decode work is cancelled (blocks
            # free once no dispatch carrying the sequence is in flight).
            OVERLOAD.note_deadline("engine.decode")
            reason = FinishReason.DEADLINE
        seq.emit(token, None, lp)
        if reason is not None:
            self.scheduler.finish(seq, reason)


#: KvBlockManager.stats() keys every metric surface carries, kvbm_-prefixed.
_KVBM_STATS = (
    "host_registered", "host_usage", "disk_registered", "disk_usage",
    "host_evictions_total", "disk_evictions_total", "host_stored_blocks_total",
    "host_hit_blocks_total", "host_miss_blocks_total", "promoted_blocks_total",
    "promotions_requested_total", "offloaded_blocks_total",
    "link_g1g2_bps", "link_g2g3_bps", "link_g3g2_bps",
    "quant_host_density", "quant_disk_density", "quant_bytes_saved_total",
    "g4_pulls_total", "g4_pull_bytes_total", "g4_pull_fallbacks_total",
    "link_peer_bps",
    "integrity_failures_total", "integrity_failures_host", "integrity_failures_disk",
    "integrity_failures_peer", "integrity_failures_frame",
    "scrub_scanned_total", "scrub_detected_total",
)


def _request_class(pre: PreprocessedRequest) -> str:
    """The request's SLO class from the annotations wire; unlabeled
    requests are interactive."""
    return slo.normalize_class((pre.annotations or {}).get(slo.ANNOTATION_KEY))


def _payload_class(payload) -> str:
    """The class straight off a raw payload (wire dict or parsed request),
    for refusal paths that run before the wire is parsed."""
    ann = (
        payload.get("annotations")
        if isinstance(payload, dict)
        else getattr(payload, "annotations", None)
    )
    return slo.normalize_class((ann or {}).get(slo.ANNOTATION_KEY))
