"""Mid-stream worker-death failover: the ingress-side survival plane
(port of dynamo_tpu/runtime/failover.py).

- **Eligibility** is by error class: only transport/engine-death errors
  (the ``ConnectionError`` lineage — the receiver's ``WorkerDiedError``,
  the bus's ``NoSubscriberError``, injected ``FaultError``s — and the
  engine's ``ERROR`` finish frame) fail over. ``ShedError``,
  ``DeadlineError`` and ``RequestError`` never do.
- **Replay** re-routes through the PushRouter, which already evicted the
  dead instance, with prompt + the tokens already emitted as the new
  prompt: the new worker prefills the delivered prefix and its first
  generated token is token K+1, so a greedy stream continues without a
  skip or a repeat. ``max_tokens``/``min_tokens`` shrink by K.
- A death after the last token, or after a stop token, is answered with
  a synthesized finish frame instead of a replay.
- A failover counts as a success once the replay has delivered all that
  is owed — the terminal frame, or the token that reaches ``max_tokens``
  or is a stop id. (The reference counts the terminal frame only, which
  a frontend's detokenizer, stopping at ``max_tokens``, never reads.)
- **Bounded**: ``max_attempts`` failovers, then ``FailoverExhausted``
  (HTTP 502).

- **Deadlines**: a request whose deadline expired by the time of the
  death gets ``DeadlineError`` (HTTP 504) instead of a replay; a replay
  carries the REMAINING budget (re-shipping the original ``deadline_ms``
  would reset the deadline on the new worker).
- **Tracing**: the replay keeps the original trace id; the ``failover``
  span covers the client-visible resume gap (death → the replay's first
  frame), and each completed failover exports a ``kind="failover"``
  record (reason, attempt, old and new worker, resume token) to the
  capture.

``FAILOVER`` is the process-wide counter registry (``failover_total``,
``failover_success_total``, ``workers_marked_dead_total``, per reason).
"""

from __future__ import annotations

import asyncio
import logging
import threading
from typing import Any, AsyncIterator

from dynamo_tpu_torch.llm.protocols.common import (
    DeadlineError,
    FailoverExhausted,
    FinishReason,
    ShedError,
    WorkerDiedError,
)
from dynamo_tpu_torch.utils.deadline import OVERLOAD, Deadline
from dynamo_tpu_torch.utils.tracing import TraceContext, tracer

logger = logging.getLogger(__name__)

#: Bounded failover attempts per request (re-dispatches, not counting the
#: original).
DEFAULT_MAX_ATTEMPTS = 3


class FailoverStats:
    """Process-wide failover accounting, split per reason."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.attempts_by_reason: dict[str, int] = {}
        self.success_by_reason: dict[str, int] = {}
        self.marked_dead_by_reason: dict[str, int] = {}

    @staticmethod
    def _bump(table: dict[str, int], reason: str) -> None:
        table[reason] = table.get(reason, 0) + 1

    def note_attempt(self, reason: str) -> None:
        with self._lock:
            self._bump(self.attempts_by_reason, reason)

    def note_success(self, reason: str) -> None:
        with self._lock:
            self._bump(self.success_by_reason, reason)

    def note_marked_dead(self, reason: str) -> None:
        with self._lock:
            self._bump(self.marked_dead_by_reason, reason)

    @property
    def total(self) -> int:
        with self._lock:
            return sum(self.attempts_by_reason.values())

    @property
    def success_total(self) -> int:
        with self._lock:
            return sum(self.success_by_reason.values())

    @property
    def marked_dead_total(self) -> int:
        with self._lock:
            return sum(self.marked_dead_by_reason.values())


FAILOVER = FailoverStats()


def failover_eligible(exc: BaseException) -> bool:
    """Transport/engine-death classification: the ConnectionError lineage
    and a torn frame. Shed/Deadline/Request errors are RuntimeError or
    ValueError subclasses and never match."""
    return isinstance(exc, (ConnectionError, asyncio.IncompleteReadError))


def _finish_reason(item: Any) -> str | None:
    if isinstance(item, dict):
        return item.get("finish_reason")
    fr = getattr(item, "finish_reason", None)
    return getattr(fr, "value", fr)


def _token_ids(item: Any) -> list[int]:
    if isinstance(item, dict):
        return list(item.get("token_ids") or [])
    return list(getattr(item, "token_ids", None) or [])


class FailoverEngine:
    """AsyncEngine around the PushRouter: replays a stream that died with
    an engine-death error onto a surviving worker. It sits between the
    Detokenizer and the router, so the detokenizer sees one continuous
    token stream across the failover."""

    def __init__(self, downstream, max_attempts: int = DEFAULT_MAX_ATTEMPTS):
        self._next = downstream
        self.max_attempts = max_attempts

    def __getattr__(self, name):
        # Router surface (client, mark_dead, mode) for whoever inspects
        # the pipeline's terminal engine.
        return getattr(self._next, name)

    async def generate(self, request) -> AsyncIterator[Any]:
        wire = request.payload if isinstance(request.payload, dict) else None
        replayable = wire is not None and "token_ids" in wire
        stop = (wire.get("stop") or {}) if replayable else {}
        deadline = (
            Deadline.from_wire(wire.get("deadline_ms")) if replayable else None
        )
        trace_id = tracer().trace_id(request.id)
        emitted: list[int] = []
        yielded_any = False
        attempt = 0
        last_reason = ""
        counted = False
        ctx = request
        resumed: AsyncIterator[Any] | None = None

        def succeed() -> None:
            nonlocal counted
            if attempt and not counted:
                counted = True
                FAILOVER.note_success(last_reason)

        while True:
            death: BaseException | None = None
            stream = resumed if resumed is not None else self._next.generate(ctx)
            resumed = None
            death_from_error_frame = False
            try:
                async for item in stream:
                    fr = _finish_reason(item)
                    if fr == FinishReason.ERROR.value:
                        # An engine fault frame ends the stream normally:
                        # re-type it as death instead of delivering it.
                        death = WorkerDiedError(
                            "engine fault: stream ended with an ERROR finish frame"
                        )
                        death_from_error_frame = True
                        break
                    emitted.extend(_token_ids(item))
                    if attempt and isinstance(item, dict) and "cum_tokens" in item:
                        # The replay engine counts from 1 again; the
                        # client's cumulative count keeps climbing.
                        item = dict(item)
                        item["cum_tokens"] = len(emitted)
                    yielded_any = True
                    if fr is not None or _owed_delivered(stop, emitted) is not None:
                        succeed()
                    yield item
                    if fr is not None:
                        return
            except (GeneratorExit, asyncio.CancelledError):
                raise
            except BaseException as exc:  # noqa: BLE001 — classified below
                if not failover_eligible(exc):
                    raise
                death = exc
            if death is None:
                # Clean end without a terminal frame (single-shot payloads).
                succeed()
                return
            reason = type(death).__name__
            last_reason = reason
            old_worker = request.annotations.get("worker_id")
            if death_from_error_frame and old_worker is not None:
                # The fault frame came over a healthy transport, so the
                # router's own detection did not fire: evict here, or the
                # replay routes straight back to the faulted worker.
                mark = getattr(self._next, "mark_dead", None)
                if mark is not None:
                    mark(old_worker, "engine_fault")
            if not replayable and yielded_any:
                raise FailoverExhausted(
                    f"stream died ({reason}) after partial non-token output; "
                    f"not replayable",
                    attempts=attempt,
                ) from death
            if attempt >= self.max_attempts:
                raise FailoverExhausted(
                    f"failover attempts exhausted ({self.max_attempts}) — "
                    f"last error: {death}",
                    attempts=attempt,
                ) from death
            # Death between the final token frame and the tokenless
            # terminal frame: everything owed was delivered — synthesize
            # the finish instead of replaying past the true end.
            synth = _owed_delivered(stop, emitted)
            if synth is not None:
                succeed()
                yield {
                    "token_ids": [], "text": None, "finish_reason": synth,
                    "cum_tokens": len(emitted), "kv_transfer_params": None,
                }
                return
            if deadline is not None and deadline.expired:
                OVERLOAD.note_deadline("failover")
                raise DeadlineError("request deadline expired during failover") from death
            attempt += 1
            FAILOVER.note_attempt(reason)
            # Keep the ORIGINAL trace id across the seam: a dead worker
            # sharing this process's tracer (mocker fleets) closed the
            # trace in its teardown; re-adopt it under the same id so the
            # failover span, the replay's spans and the finish join one
            # timeline.
            tracer().adopt(request.id, TraceContext(trace_id, sent_unix=None))
            tracer().mark(request.id, "failover")
            tracer().span_begin(request.id, "failover")
            logger.warning(
                "request %s: worker %s died mid-stream (%s) — failover "
                "attempt %d/%d resuming at token %d",
                request.id, hex(old_worker) if old_worker else "?",
                reason, attempt, self.max_attempts, len(emitted),
            )
            if replayable:
                ctx = request.map(self._replay_wire(wire, emitted, deadline))
            # The router re-picks without the evicted corpse; a ShedError
            # (no healthy capacity left) is exhaustion here. A replay whose
            # first frame dies too loops back through the bounded path.
            # The failover span closes at the replay's first frame.
            replay = self._next.generate(ctx)
            try:
                first = await replay.__anext__()
            except StopAsyncIteration:
                tracer().span_end(request.id, "failover")
                succeed()
                return
            except ShedError as exc:
                tracer().span_end(request.id, "failover")
                raise FailoverExhausted(
                    f"no healthy capacity for failover: {exc}", attempts=attempt
                ) from exc
            except (GeneratorExit, asyncio.CancelledError):
                tracer().span_end(request.id, "failover")
                raise
            except BaseException as exc:  # noqa: BLE001 — classified below
                tracer().span_end(request.id, "failover")
                if not failover_eligible(exc):
                    raise
                resumed = _raising(exc)
                continue
            tracer().span_end(request.id, "failover")
            self._export_record(
                request.id, reason, attempt, old_worker,
                request.annotations.get("worker_id"), len(emitted),
            )
            resumed = _resume(replay, first)

    @staticmethod
    def _replay_wire(wire: dict, emitted: list[int], deadline=None) -> dict[str, Any]:
        """The replay request: prompt + emitted tokens, stop budgets
        shrunk by the emitted count, the remaining deadline re-stamped."""
        w = dict(wire)
        w["token_ids"] = list(wire["token_ids"]) + list(emitted)
        stop = dict(w.get("stop") or {})
        if stop.get("max_tokens") is not None:
            stop["max_tokens"] = max(1, stop["max_tokens"] - len(emitted))
        if stop.get("min_tokens"):
            stop["min_tokens"] = max(0, stop["min_tokens"] - len(emitted))
        w["stop"] = stop
        if deadline is not None:
            w["deadline_ms"] = deadline.to_wire()
        return w

    @staticmethod
    def _export_record(request_id: str, reason: str, attempt: int,
                       old_worker, new_worker, resumed_at: int) -> None:
        """The ``kind="failover"`` line of the ``DYNTPU_TRACE`` capture."""
        try:
            tracer().export({
                "kind": "failover",
                "id": request_id,
                "trace": tracer().trace_id_if_active(request_id) or "",
                "reason": reason,
                "attempt": attempt,
                "old_worker": old_worker,
                "new_worker": new_worker,
                "resumed_at_token": resumed_at,
            })
        except Exception:  # noqa: BLE001 — observability must not fail failover
            logger.exception("failover record export failed")


def _owed_delivered(stop: dict, emitted: list[int]) -> str | None:
    """The finish reason when ``emitted`` already holds everything the
    request is owed (``max_tokens`` reached, or a stop id last), else
    None."""
    if stop.get("max_tokens") is not None and len(emitted) >= stop["max_tokens"]:
        return FinishReason.LENGTH.value
    if (emitted and not stop.get("ignore_eos")
            and emitted[-1] in (stop.get("stop_token_ids") or ())):
        return FinishReason.STOP.value
    return None


async def _resume(stream, first) -> AsyncIterator[Any]:
    """The replay stream with its first (already awaited) frame put back
    in front, so the failover loop handles every frame alike."""
    yield first
    async for item in stream:
        yield item


async def _raising(exc: BaseException) -> AsyncIterator[Any]:
    """A stream that dies at once: routes a replay's first-frame death
    back into the loop's one bounded death path."""
    raise exc
    yield  # pragma: no cover — makes this an async generator
