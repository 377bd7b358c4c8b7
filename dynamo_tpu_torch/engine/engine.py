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

Not in this port yet: KVBM tiers, disaggregation, peers, multimodal, the
flight recorder, tracing and deadlines (ROADMAP queue A). Requests that
ask for any of them are refused with ``RequestError``.
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
from dynamo_tpu_torch.engine.compile_cache import (
    ShapeManifest,
    engine_fingerprint,
    fingerprint_key,
)
from dynamo_tpu_torch.engine.config import EngineConfig
from dynamo_tpu_torch.engine.kv_cache import BlockAllocator
from dynamo_tpu_torch.engine.runner import ModelRunner
from dynamo_tpu_torch.engine.scheduler import Scheduler, compose_unified
from dynamo_tpu_torch.engine.sequence import Sequence, SeqStatus
from dynamo_tpu_torch.llm.protocols.common import (
    MAX_LOGPROBS,
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
            "draining": self._draining,
            "shed_requests_total": OVERLOAD.shed_total,
            "gpu_prefix_cache_hit_rate": self.prefix_hit_rate,
            "spec_tokens_per_step": self.spec_tokens_per_step,
            "spec_active": int(self._spec_active),
            "spec_drafted_tokens_total": self._spec_drafted,
            "spec_accepted_tokens_total": self._spec_accepted,
        }
        if self.scheduler is not None:
            # len() reads off the engine thread are atomic.
            d["num_requests_waiting"] = len(self.scheduler.waiting)
            usable = max(self.allocator.num_blocks - 1, 1)
            d["gpu_cache_usage_perc"] = (usable - self.allocator.num_free) / usable
            d["prefill_backlog_tokens"] = self._prefill_backlog_tokens
        d["unified_step_tokens_decode_total"] = self.unified_decode_tokens
        d["unified_step_tokens_prefill_total"] = self.unified_prefill_tokens
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
        refused = [
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

        def emit(token: int | None, finish: FinishReason | None, lp=None) -> None:
            loop.call_soon_threadsafe(out_q.put_nowait, (token, finish, lp))

        seq = Sequence(
            request_id=request.id,
            prompt_tokens=list(pre.token_ids),
            sampling=pre.sampling,
            stop=pre.stop,
            emit=emit,
            logprobs=pre.logprobs,
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
                token, finish, lp = await out_q.get()
                if token is not None:
                    count += 1
                    yield EngineOutput(
                        token_ids=[token], cum_tokens=count,
                        logprobs=[lp] if lp is not None else None,
                    ).to_wire()
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
                if not busy and self._warm_tail:
                    # Idle step: make one deferred program, between
                    # traffic rather than under it.
                    self._warm_one_tail()
                    busy = True
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
                elif op == "warmup" and not arg.done():
                    self._loop.call_soon_threadsafe(
                        lambda f=arg, e=exc: f.done() or f.set_exception(
                            RuntimeError(f"engine dead: {e}")
                        )
                    )

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
            elif op == "warmup":
                self._run_warmup(arg)

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
            cfg.unified_prefill_quantum, rotation=self._unified_rotation,
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

        out = self.runner.unified_step(
            lanes, feed=(self._prev_unified_out, prev_row, use_prev),
            draft_lens=draft_lens if n_drafted else None, extras=extras,
        )
        self._prev_unified_out = out.last
        self._prev_unified_rows = {
            id(seq): i for i, (seq, *_r) in enumerate(roles)
        }
        self.unified_dispatches += 1
        self.unified_decode_tokens += len(decode_take)
        self.unified_prefill_tokens += sum(n for _, n in prefill_take)
        self._spec_drafted += n_drafted
        # Whether this dispatch's decode lanes feed the auto-gate's window
        # is fixed AT ISSUE: plain dispatches in flight when a re-probe
        # turns the gate on must not count as spec steps.
        spec_counted = spec_on and not has_extras
        self._inflight.append((roles, out, spec_counted))
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
        roles, out, spec_counted = record
        toks = out.tokens()
        spec = out.spec()
        lp = None
        if any(seq.logprobs is not None for seq, *_r in roles):
            lp = out.logprobs()
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
                    tok = int(toks[i])
                    self._deliver(seq, tok, self._lp_at(lp, seq, i, tok))
        for seq, *_rest in roles:
            if seq.defer_release and seq.inflight_chunks == 0:
                seq.defer_release = False
                self.scheduler._release(seq)
        self._spec_accepted += n_accepted
        if self.cfg.speculative_k:
            self._maybe_gate_speculation()

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
        while (
            not self._admission_held()
            and len(self._prefilling) < self.cfg.prefill_batch
        ):
            seq = sched.next_prefill()
            if seq is None:
                break
            self._note_unwarmed_traffic()
            self._prefix_lookups += 1
            if seq.num_cached_prefix:
                self._prefix_hits += 1
            seq.status = SeqStatus.PREFILLING
            seq.prefill_cursor = seq.num_cached_prefix
            self._prefilling.append(seq)

    def _deliver(self, seq: Sequence, token: int, lp: dict | None = None) -> None:
        seq.output_tokens.append(token)
        if seq.first_token_s is None:
            seq.first_token_s = time.monotonic()
        reason = seq.should_stop()
        if reason is None and seq.total_len >= self.cfg.max_model_len:
            reason = FinishReason.LENGTH
        seq.emit(token, None, lp)
        if reason is not None:
            self.scheduler.finish(seq, reason)
