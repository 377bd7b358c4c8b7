"""Engine-facing request/response protocol (port of
dynamo_tpu/llm/protocols/common.py).

The wire dictionaries are the reference's, field for field, so a request
serialized by either package deserializes in the other. In process a
request carries a ``Deadline`` and a ``TraceContext``; on the wire they
travel as ``deadline_ms`` (remaining budget, re-anchored on receipt) and
``trace``.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Any

from dynamo_tpu_torch.utils.deadline import Deadline
from dynamo_tpu_torch.utils.tracing import TraceContext

# Top alternatives reported per generated token (ops/sampling.py
# token_logprobs); the reference's cap.
MAX_LOGPROBS = 8


class RequestError(ValueError):
    """A client-caused request failure (unsupported parameter, over-limit
    value). The HTTP layer maps this to 400."""


class ShedError(RuntimeError):
    """The request was refused to protect the serving system (a draining
    engine). Retryable by the client: the HTTP layer maps it to 429
    (capacity) or 503 (draining) with ``Retry-After``."""

    def __init__(
        self,
        message: str,
        retry_after_s: float = 1.0,
        draining: bool = False,
    ) -> None:
        super().__init__(message)
        self.retry_after_s = retry_after_s
        self.draining = draining


class DeadlineError(RuntimeError):
    """The request's deadline expired before it finished; whatever work
    remained was cancelled, not executed. Maps to HTTP 504."""


class WorkerDiedError(ConnectionError):
    """The worker serving this request died: the response stream closed
    without a terminal frame, the dispatch found a dead subject, or the
    engine faulted mid-stream. A ConnectionError, so transport filters
    (retry policies, the failover plane) classify it as peer death, never
    as a request fault: this class, and only this one, is eligible for
    mid-stream failover. Maps to HTTP 502 when failover is unavailable or
    exhausted.

    ``transport_dead`` is set by the transport layer when the evidence is
    the socket itself (no terminal frame, connect refused or timed out);
    a worker-reported error frame leaves it False. Both fail over; only
    the former evicts the worker from the router's view."""

    transport_dead: bool = False


class FailoverExhausted(RuntimeError):
    """Mid-stream failover ran out of attempts or healthy capacity: a
    terminal state that nothing upstream retries. Maps to HTTP 502."""

    def __init__(self, message: str, attempts: int = 0) -> None:
        super().__init__(message)
        self.attempts = attempts


class FinishReason(str, enum.Enum):
    STOP = "stop"            # eos or stop sequence
    LENGTH = "length"        # hit max_tokens / context limit
    CANCELLED = "cancelled"  # client went away
    ERROR = "error"
    SHED = "shed"
    DEADLINE = "deadline_exceeded"


@dataclass
class StopConditions:
    """When to stop generating."""

    max_tokens: int | None = None
    stop: list[str] = field(default_factory=list)
    stop_token_ids: list[int] = field(default_factory=list)
    min_tokens: int | None = None
    ignore_eos: bool = False

    def to_wire(self) -> dict[str, Any]:
        return {
            "max_tokens": self.max_tokens,
            "stop": self.stop,
            "stop_token_ids": self.stop_token_ids,
            "min_tokens": self.min_tokens,
            "ignore_eos": self.ignore_eos,
        }

    @staticmethod
    def from_wire(d: dict[str, Any]) -> "StopConditions":
        return StopConditions(
            max_tokens=d.get("max_tokens"),
            stop=list(d.get("stop") or []),
            stop_token_ids=list(d.get("stop_token_ids") or []),
            min_tokens=d.get("min_tokens"),
            ignore_eos=bool(d.get("ignore_eos", False)),
        )


@dataclass
class SamplingOptions:
    """How to sample."""

    temperature: float | None = None
    top_p: float | None = None
    top_k: int | None = None
    seed: int | None = None
    frequency_penalty: float | None = None
    presence_penalty: float | None = None

    @property
    def greedy(self) -> bool:
        return self.temperature is None or self.temperature <= 0.0

    def to_wire(self) -> dict[str, Any]:
        return {
            "temperature": self.temperature,
            "top_p": self.top_p,
            "top_k": self.top_k,
            "seed": self.seed,
            "frequency_penalty": self.frequency_penalty,
            "presence_penalty": self.presence_penalty,
        }

    @staticmethod
    def from_wire(d: dict[str, Any]) -> "SamplingOptions":
        return SamplingOptions(
            temperature=d.get("temperature"),
            top_p=d.get("top_p"),
            top_k=d.get("top_k"),
            seed=d.get("seed"),
            frequency_penalty=d.get("frequency_penalty"),
            presence_penalty=d.get("presence_penalty"),
        )


@dataclass
class PreprocessedRequest:
    """Tokenized request flowing to an engine."""

    token_ids: list[int]
    sampling: SamplingOptions = field(default_factory=SamplingOptions)
    stop: StopConditions = field(default_factory=StopConditions)
    model: str = ""
    logprobs: int | None = None
    annotations: dict[str, Any] = field(default_factory=dict)
    # Absolute deadline; on the wire ``deadline_ms``, the remaining
    # budget at serialization.
    deadline: Deadline | None = None
    # Trace identity: travels where ``deadline_ms`` travels so every
    # hop's spans join one per-request timeline.
    trace: TraceContext | None = None
    remote_prefill: bool = False
    mm_segments: list[dict[str, Any]] = field(default_factory=list)

    def to_wire(self) -> dict[str, Any]:
        wire = {
            "token_ids": self.token_ids,
            "sampling": self.sampling.to_wire(),
            "stop": self.stop.to_wire(),
            "model": self.model,
            "logprobs": self.logprobs,
            "annotations": self.annotations,
            "remote_prefill": self.remote_prefill,
        }
        if self.deadline is not None:
            wire["deadline_ms"] = self.deadline.to_wire()
        if self.trace is not None:
            wire["trace"] = self.trace.to_wire()
        if self.mm_segments:
            wire["mm_segments"] = self.mm_segments
        return wire

    @staticmethod
    def from_wire(d: dict[str, Any]) -> "PreprocessedRequest":
        return PreprocessedRequest(
            token_ids=list(d["token_ids"]),
            sampling=SamplingOptions.from_wire(d.get("sampling") or {}),
            stop=StopConditions.from_wire(d.get("stop") or {}),
            model=d.get("model", ""),
            logprobs=d.get("logprobs"),
            annotations=d.get("annotations") or {},
            deadline=Deadline.from_wire(d.get("deadline_ms")),
            trace=TraceContext.from_wire(d.get("trace")),
            remote_prefill=bool(d.get("remote_prefill", False)),
            mm_segments=list(d.get("mm_segments") or []),
        )


@dataclass
class EngineOutput:
    """One streamed delta from an engine."""

    token_ids: list[int] = field(default_factory=list)
    text: str | None = None
    finish_reason: FinishReason | None = None
    cum_tokens: int = 0
    logprobs: list[dict[str, Any]] | None = None
    kv_transfer_params: dict[str, Any] | None = None

    def to_wire(self) -> dict[str, Any]:
        wire = {
            "token_ids": self.token_ids,
            "text": self.text,
            "finish_reason": self.finish_reason.value if self.finish_reason else None,
            "cum_tokens": self.cum_tokens,
            "kv_transfer_params": self.kv_transfer_params,
        }
        if self.logprobs is not None:
            wire["logprobs"] = self.logprobs
        return wire

    @staticmethod
    def from_wire(d: dict[str, Any]) -> "EngineOutput":
        fr = d.get("finish_reason")
        return EngineOutput(
            token_ids=list(d.get("token_ids") or []),
            text=d.get("text"),
            finish_reason=FinishReason(fr) if fr else None,
            cum_tokens=d.get("cum_tokens", 0),
            logprobs=d.get("logprobs"),
            kv_transfer_params=d.get("kv_transfer_params"),
        )
