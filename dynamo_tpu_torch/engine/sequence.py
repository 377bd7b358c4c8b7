"""In-engine sequence state (port of dynamo_tpu/engine/sequence.py)."""

from __future__ import annotations

import enum
import time
from dataclasses import dataclass, field
from typing import Callable

from dynamo_tpu_torch.llm.protocols.common import (
    FinishReason,
    SamplingOptions,
    StopConditions,
)
from dynamo_tpu_torch.llm.tokens import TokenBlockSequence


class SeqStatus(enum.Enum):
    WAITING = "waiting"
    RUNNING = "running"
    FINISHED = "finished"
    # Disagg decode side: blocks allocated, KV inbound from a prefill worker.
    WAITING_REMOTE = "waiting_remote"
    # Admitted (slot + blocks held) but the prompt is still being prefilled
    # chunk by chunk; excluded from decode batches until the last chunk.
    PREFILLING = "prefilling"


@dataclass
class Sequence:
    request_id: str
    prompt_tokens: list[int]
    sampling: SamplingOptions
    stop: StopConditions
    # Called from the engine thread with (token_id | None, finish | None,
    # logprob entry | None).
    emit: Callable[..., None]

    status: SeqStatus = SeqStatus.WAITING
    output_tokens: list[int] = field(default_factory=list)
    block_ids: list[int] = field(default_factory=list)
    num_cached_prefix: int = 0      # tokens covered by prefix-cache hit
    slot: int | None = None         # decode batch slot
    arrival_s: float = field(default_factory=time.monotonic)
    first_token_s: float | None = None
    # Chained block hashes over prompt+output (prefix-cache registration).
    hashes: TokenBlockSequence | None = None
    # Chunked prefill: prompt tokens whose KV is already computed
    # (includes any prefix-cache hit). Meaningful while PREFILLING.
    prefill_cursor: int = 0
    # OpenAI logprobs: None = not requested; N = the chosen token's
    # logprob plus the top-N alternatives per generated token.
    logprobs: int | None = None
    # Penalties path: the slot's [vocab] row of the count buffer is zeroed
    # before this sequence's first extras dispatch (slots are reused).
    counts_reset_pending: bool = True
    # Pipelined dispatch: chunks issued to the device but not yet
    # processed. While > 0 the sequence's blocks are pinned (in-flight KV
    # writes) and its device-side length runs ahead of total_len.
    inflight_chunks: int = 0
    sched_len: int = 0           # device-side length (total_len + issued)
    defer_release: bool = False  # finished while chunks were in flight
    # Rolling-buffer eviction (fully windowed models): logical pages
    # [0, evicted_pages) went back to the allocator, and their block_ids
    # entries hold the 0 sentinel (the trash block, never allocated and
    # never scanned: a windowed scan starts above them). See
    # Scheduler.evict_behind_window.
    evicted_pages: int = 0
    # Tokens delivered before a preemption folded them into the prompt
    # (Scheduler.requeue_for_recompute): they still count toward
    # max_tokens / min_tokens.
    folded_output: int = 0
    # Absolute request deadline (utils/deadline.Deadline) or None: checked
    # on arrival, while waiting, and at every delivered token.
    deadline: object = None
    # SLO class (llm/slo.py): "batch" sequences are the cheapest shed and
    # preemption victims.
    slo_class: str = "interactive"
    # Disagg decode side completeness ledger (WAITING_REMOTE only): the
    # (start_block, num_blocks) span whose KV must arrive, and the block
    # indices that actually landed. Activation over a hole degrades to
    # local recompute instead of decoding stale KV.
    remote_span: tuple[int, int] | None = None
    remote_landed: set[int] = field(default_factory=set)
    # KV observatory: prefix blocks this request reused at admission, per
    # tier (device = the G1 prefix cache, host/disk = onboarded from the
    # KVBM's G2, of which disk = promoted from G3 earlier), reported once
    # (kv_actual_reported guards the re-admission after a preemption);
    # peer = onboarded rows a G4 pull brought into G2.
    reuse_device_blocks: int = 0
    reuse_host_blocks: int = 0
    reuse_disk_blocks: int = 0
    reuse_peer_blocks: int = 0
    kv_actual_reported: bool = False
    # G4 peer-pull parking (engine _maybe_park_for_peer_pull): the
    # in-flight pull this admitted-but-parked sequence waits on, its
    # give-up point on the engine's clock (past it the sequence proceeds
    # by local recompute, counted degraded), and the once-per-request
    # guard.
    peer_pull_key: int | None = None
    peer_pull_deadline: float = 0.0
    peer_pull_tried: bool = False
    # While True the sequence is RUNNING but takes no decode lane: it is
    # admitted, yet its prompt waits on the peer pull — decode_batch would
    # otherwise treat the un-prefilled prompt as cached context.
    peer_parked: bool = False

    @property
    def total_len(self) -> int:
        return len(self.prompt_tokens) + len(self.output_tokens)

    @property
    def last_token(self) -> int:
        if self.output_tokens:
            return self.output_tokens[-1]
        return self.prompt_tokens[-1]

    @property
    def device_len(self) -> int:
        """Host length plus issued-but-unprocessed decode steps."""
        return max(self.sched_len, self.total_len)

    def context_cap(self, max_model_len: int) -> int:
        """Remaining KV writes the context limit allows (<= 0: no further
        decode steps or block growth — the sequence finishes when its
        in-flight chunks are processed)."""
        return max_model_len - self.device_len + 1

    @property
    def needs_extras(self) -> bool:
        """True when dispatches carrying this sequence must run the
        extras program (penalties and/or logprob outputs)."""
        s = self.sampling
        return bool(
            s.frequency_penalty or s.presence_penalty
            or self.logprobs is not None
        )

    def should_stop(self) -> FinishReason | None:
        if not self.output_tokens:
            return None
        n = self.folded_output + len(self.output_tokens)
        if self.stop.min_tokens and n < self.stop.min_tokens:
            return None
        if not self.stop.ignore_eos and (
            self.output_tokens[-1] in self.stop.stop_token_ids
        ):
            return FinishReason.STOP
        if self.stop.max_tokens is not None and n >= self.stop.max_tokens:
            return FinishReason.LENGTH
        return None
