"""TorchEngine: the serving engine (port of the unified step of
dynamo_tpu/engine/engine.py's TpuEngine).

Continuous batching over a paged KV cache with prefix caching. Every
engine step is ONE ragged dispatch mixing decode lanes with chunked-
prefill quanta (``_step_unified``); dispatches are pipelined
``pipeline_depth`` deep, each decode lane reading its previous token on
the device (the runner's feed), so the host never waits on a fetch to
issue the next step.

Threading model: model dispatch runs on a dedicated engine thread;
asyncio callers talk to it through thread-safe queues. Implements the
AsyncEngine contract: ``generate(Context)`` streams ``EngineOutput``
wire dicts.

Graceful drain: ``begin_drain`` refuses new requests with ``ShedError``
while every submitted sequence runs to completion; ``readiness()`` is
the snapshot ``/health``, ``/metrics`` and the admission gate read.

Not in this slice: KVBM tiers, disaggregation, peers, speculative
decoding, penalties/logprobs, multimodal, shape manifests, the flight
recorder, tracing and deadlines (ROADMAP queue A). Requests that ask for
any of them are refused with ``RequestError``.
"""

from __future__ import annotations

import asyncio
import logging
import queue
import threading
import time
from collections import deque
from typing import AsyncIterator

import numpy as np

from dynamo_tpu_torch import resolve_device
from dynamo_tpu_torch.engine.config import EngineConfig
from dynamo_tpu_torch.engine.kv_cache import BlockAllocator
from dynamo_tpu_torch.engine.runner import ModelRunner
from dynamo_tpu_torch.engine.scheduler import Scheduler, compose_unified
from dynamo_tpu_torch.engine.sequence import Sequence, SeqStatus
from dynamo_tpu_torch.llm.protocols.common import (
    EngineOutput,
    FinishReason,
    PreprocessedRequest,
    RequestError,
    ShedError,
)
from dynamo_tpu_torch.runtime.engine import Context
from dynamo_tpu_torch.utils.overload import OVERLOAD

logger = logging.getLogger(__name__)


class TorchEngine:
    def __init__(
        self,
        cfg: EngineConfig,
        params=None,
        device: str | None = None,
    ) -> None:
        cfg.validate()
        self.cfg = cfg
        self.device = resolve_device(device)
        self._params = params
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

    # -- lifecycle ----------------------------------------------------------
    async def start(self) -> None:
        self._loop = asyncio.get_running_loop()
        self.allocator = BlockAllocator(
            self.cfg.num_blocks,
            self.cfg.block_size,
            enable_prefix_caching=self.cfg.enable_prefix_caching,
        )
        self.scheduler = Scheduler(self.cfg, self.allocator)
        # Weight init / upload happens off the event loop.
        await asyncio.to_thread(self._build_runner)
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
            "state": "draining" if self._draining else "ready",
            "draining": self._draining,
            "shed_requests_total": OVERLOAD.shed_total,
            "gpu_prefix_cache_hit_rate": self.prefix_hit_rate,
        }
        if self.scheduler is not None:
            # len() reads off the engine thread are atomic.
            d["num_requests_waiting"] = len(self.scheduler.waiting)
            usable = max(self.allocator.num_blocks - 1, 1)
            d["gpu_cache_usage_perc"] = (usable - self.allocator.num_free) / usable
            d["prefill_backlog_tokens"] = self._prefill_backlog_tokens
        d["unified_step_tokens_decode_total"] = self.unified_decode_tokens
        d["unified_step_tokens_prefill_total"] = self.unified_prefill_tokens
        return d

    @staticmethod
    def _validate_request(pre: PreprocessedRequest) -> None:
        """Refuse what this slice does not serve, loudly (RequestError →
        HTTP 400), instead of serving it wrong."""
        s = pre.sampling
        refused = [
            (pre.logprobs is not None, "logprobs"),
            (s.frequency_penalty or s.presence_penalty,
             "frequency/presence penalties"),
            (pre.mm_segments, "multimodal segments"),
            (pre.remote_prefill, "remote prefill"),
            (pre.deadline_ms is not None, "request deadlines"),
        ]
        for on, what in refused:
            if on:
                raise RequestError(f"not served by this engine yet: {what}")

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
            OVERLOAD.note_shed("engine.draining")
            raise ShedError(
                "engine draining — retry another instance", draining=True
            )
        pre = (
            PreprocessedRequest.from_wire(request.payload)
            if isinstance(request.payload, dict)
            else request.payload
        )
        self._validate_request(pre)
        out_q: asyncio.Queue = asyncio.Queue()
        loop = self._loop
        if loop is None:
            raise RuntimeError("engine not started")

        def emit(token: int | None, finish: FinishReason | None) -> None:
            loop.call_soon_threadsafe(out_q.put_nowait, (token, finish))

        seq = Sequence(
            request_id=request.id,
            prompt_tokens=list(pre.token_ids),
            sampling=pre.sampling,
            stop=pre.stop,
            emit=emit,
        )
        self._submit_q.put(("add", seq))
        self._wakeup.set()
        async for item in self._stream(request, seq, out_q):
            yield item

    async def _stream(
        self, request: Context, seq: Sequence, out_q: asyncio.Queue
    ) -> AsyncIterator[dict]:
        count = 0
        try:
            while True:
                token, finish = await out_q.get()
                if token is not None:
                    count += 1
                    yield EngineOutput(token_ids=[token], cum_tokens=count).to_wire()
                if finish is not None:
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
        finally:
            if seq.status is not SeqStatus.FINISHED:
                self._submit_q.put(("abort", seq))
                self._wakeup.set()

    # -- engine thread ------------------------------------------------------
    def _engine_loop(self) -> None:
        try:
            while not self._stop.is_set():
                busy = self._step_unified()
                self._prefill_backlog_tokens = sum(
                    len(s.prompt_tokens) for s in self.scheduler.waiting
                ) + sum(
                    len(s.prompt_tokens) - s.prefill_cursor
                    for s in self._prefilling
                    if s.status is SeqStatus.PREFILLING
                )
                if not busy:
                    self._wakeup.wait(timeout=0.01)
                    self._wakeup.clear()
        except Exception as exc:  # top of the thread: fail every request loudly
            logger.exception("engine loop died")
            self._dead = exc
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

    def _drain_submissions(self) -> None:
        while True:
            try:
                op, arg = self._submit_q.get_nowait()
            except queue.Empty:
                return
            if op == "add":
                self.scheduler.add(arg)
            elif op == "abort":
                self.scheduler.abort(arg)

    def _step_unified(self) -> bool:
        """One engine iteration: retire ready dispatches, admit prefills,
        compose ONE token-budget batch mixing decode lanes with chunked-
        prefill quanta, dispatch it."""
        self._drain_submissions()
        did = False
        depth = self.cfg.pipeline_depth
        # 1. Retire in-flight dispatches: device-ready ones, plus the
        #    oldest when the pipeline is at depth.
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

    def _issue_unified(self) -> bool:
        """Compose one token-budget batch (decode lanes first, then
        prefill quanta) and dispatch it through
        ModelRunner.unified_step. Returns True if anything was issued."""
        cfg = self.cfg
        decode_ready = [
            seq for seq in self.scheduler.decode_batch()
            # A lane whose newest token lives in a dispatch older than
            # the one the row map describes waits until that retires.
            if seq.inflight_chunks == 0 or id(seq) in self._prev_unified_rows
        ]
        prefill_items = [
            (s, len(s.prompt_tokens) - s.prefill_cursor)
            for s in self._prefilling
            if s.status is SeqStatus.PREFILLING
        ]
        decode_take, prefill_take = compose_unified(
            decode_ready, prefill_items, cfg.unified_token_budget,
            cfg.unified_prefill_quantum, rotation=self._unified_rotation,
        )
        if not decode_take and not prefill_take:
            return False
        self._unified_rotation += len(decode_take)

        S = self.runner.unified_slots
        use_prev = np.zeros(S, bool)
        prev_row = np.zeros(S, np.int32)
        lanes = []
        roles: list[tuple] = []  # (seq, kind, start, n, deliver)
        for seq in decode_take:
            s = len(lanes)
            n = seq.device_len
            if seq.inflight_chunks > 0:
                use_prev[s] = True
                prev_row[s] = self._prev_unified_rows[id(seq)]
                tok = 0  # replaced on device by the previous dispatch's sample
            else:
                tok = seq.last_token
            lanes.append(([tok], seq.block_ids, n - 1, self._lane_sampling(seq)))
            roles.append((seq, "decode", n - 1, 1, True))
            seq.inflight_chunks += 1
            seq.sched_len = n + 1
        for seq, n in prefill_take:
            start = seq.prefill_cursor
            toks = seq.prompt_tokens[start : start + n]
            lanes.append((toks, seq.block_ids, start, self._lane_sampling(seq)))
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

        out = self.runner.unified_step(
            lanes, feed=(self._prev_unified_out, prev_row, use_prev)
        )
        self._prev_unified_out = out.last
        self._prev_unified_rows = {
            id(seq): i for i, (seq, *_r) in enumerate(roles)
        }
        self.unified_dispatches += 1
        self.unified_decode_tokens += len(decode_take)
        self.unified_prefill_tokens += sum(n for _, n in prefill_take)
        self._inflight.append((roles, out))
        return True

    def _process_unified_chunk(self, record) -> None:
        """Force one unified dispatch's tokens and run the host-side
        bookkeeping: decode lanes deliver their token, completed prefill
        lanes the prompt's first token, every lane registers the blocks
        its KV writes filled."""
        roles, out = record
        toks = out.tokens()
        for seq, *_rest in roles:
            seq.inflight_chunks -= 1
        for i, (seq, kind, start, n, deliver) in enumerate(roles):
            if kind == "decode":
                if seq.status is not SeqStatus.RUNNING:
                    continue  # stopped while in flight; token discarded
                # The step fed seq.last_token — its KV is now in cache.
                if seq.hashes is not None:
                    seq.hashes.append(seq.last_token)
                self.scheduler.register_filled_blocks(seq, seq.total_len)
                self._deliver(seq, int(toks[i]))
            else:
                if seq.status not in (SeqStatus.PREFILLING, SeqStatus.RUNNING):
                    continue  # aborted mid-prompt; KV writes were harmless
                self.scheduler.register_filled_blocks(seq, start + n)
                if deliver and seq.status is SeqStatus.RUNNING:
                    self._deliver(seq, int(toks[i]))
        for seq, *_rest in roles:
            if seq.defer_release and seq.inflight_chunks == 0:
                seq.defer_release = False
                self.scheduler._release(seq)

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
        while len(self._prefilling) < self.cfg.prefill_batch:
            seq = sched.next_prefill()
            if seq is None:
                break
            self._prefix_lookups += 1
            if seq.num_cached_prefix:
                self._prefix_hits += 1
            seq.status = SeqStatus.PREFILLING
            seq.prefill_cursor = seq.num_cached_prefix
            self._prefilling.append(seq)

    def _deliver(self, seq: Sequence, token: int) -> None:
        seq.output_tokens.append(token)
        if seq.first_token_s is None:
            seq.first_token_s = time.monotonic()
        reason = seq.should_stop()
        if reason is None and seq.total_len >= self.cfg.max_model_len:
            reason = FinishReason.LENGTH
        seq.emit(token, None)
        if reason is not None:
            self.scheduler.finish(seq, reason)
