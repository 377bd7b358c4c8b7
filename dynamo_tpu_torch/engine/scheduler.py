"""Continuous-batching scheduler: watermark admission, block growth,
preemption, prefix-cache reuse (port of dynamo_tpu/engine/scheduler.py).

Invariant: before a decode step for a sequence with n tokens, KV slots for
positions [0, n-1] exist — the step feeds token t[n-1], writes its KV at
position n-1, and samples t[n]. Block hashes therefore chain over *fed*
tokens, so a block is registered exactly when its KV is fully written.
"""

from __future__ import annotations

import logging
import time
from collections import deque

from dynamo_tpu_torch.engine.config import EngineConfig
from dynamo_tpu_torch.engine.kv_cache import BlockAllocator
from dynamo_tpu_torch.engine.sequence import Sequence, SeqStatus
from dynamo_tpu_torch.llm.protocols.common import FinishReason
from dynamo_tpu_torch.llm.tokens import TokenBlockSequence
from dynamo_tpu_torch.utils.deadline import OVERLOAD

logger = logging.getLogger(__name__)


def compose_unified(
    decode_seqs: list,
    prefill_items: list[tuple],
    budget: int,
    quantum: int,
    rotation: int = 0,
) -> tuple[list, list[tuple]]:
    """Token-budget batch composition for the unified step — a copy of
    the reference's pure policy function:

    - ``decode_seqs``: sequences wanting one decode span each, either
      bare sequences (width-1 spans) or ``(seq, width)`` pairs;
    - ``prefill_items``: (seq, remaining_prompt_tokens) in arrival order;
    - returns (decode_take, [(seq, take_n), ...]).

    Decode fills first; when prefill work exists one quantum of budget is
    reserved for it (never squeezing decode below half the budget); while
    decode shares the batch each prompt takes at most ``quantum`` tokens;
    an over-budget decode population is taken from ``rotation`` round
    robin, so deferral rotates across steps.
    """
    widths = [
        (item[1] if isinstance(item, tuple) else 1) for item in decode_seqs
    ]
    total_prefill = sum(r for _, r in prefill_items if r > 0)
    reserve = min(quantum, total_prefill, budget) if total_prefill else 0
    if decode_seqs:
        reserve = min(reserve, budget - min(sum(widths), budget // 2))
    space = max(budget - reserve, 0)
    n_lanes = len(decode_seqs)
    if space <= 0 or not decode_seqs:
        decode_take = []
        used = 0
    elif space < sum(widths):
        off = rotation % n_lanes
        order = list(range(off, n_lanes)) + list(range(off))
        decode_take = []
        used = 0
        for i in order:
            if used + widths[i] <= space:
                decode_take.append(decode_seqs[i])
                used += widths[i]
    else:
        decode_take = list(decode_seqs)
        used = sum(widths)
    rem = budget - used
    per_seq_cap = quantum if decode_take else budget
    prefill_take: list[tuple] = []
    for seq, r in prefill_items:
        n = min(r, per_seq_cap, rem)
        if n <= 0:
            continue
        prefill_take.append((seq, n))
        rem -= n
        if rem <= 0:
            break
    return decode_take, prefill_take


class Scheduler:
    def __init__(self, cfg: EngineConfig, allocator: BlockAllocator) -> None:
        self.cfg = cfg
        self.allocator = allocator
        self.waiting: deque[Sequence] = deque()
        self.running: dict[int, Sequence] = {}  # slot -> seq
        self._free_slots: list[int] = list(range(cfg.max_num_seqs - 1, -1, -1))

    # -- queue management ---------------------------------------------------
    def add(self, seq: Sequence) -> None:
        if len(seq.prompt_tokens) >= self.cfg.max_model_len:
            seq.status = SeqStatus.FINISHED
            seq.emit(None, FinishReason.ERROR)
            return
        if seq.deadline is not None and seq.deadline.expired:
            # Already expired on arrival: executing it would only waste
            # prefill compute nobody reads.
            OVERLOAD.note_deadline("engine.arrival")
            seq.status = SeqStatus.FINISHED
            seq.emit(None, FinishReason.DEADLINE)
            return
        self.waiting.append(seq)
        if self.cfg.max_waiting and len(self.waiting) > self.cfg.max_waiting:
            # Depth bound: shed cheapest-first, then oldest-first
            # (llm/slo.py) — any waiting batch request is a cheaper victim
            # than every interactive one, and within the class the head
            # has waited longest. A typed finish, never a silent drop.
            victim = self._shed_victim()
            self.waiting.remove(victim)
            OVERLOAD.note_shed("engine.waiting", request_class=victim.slo_class)
            logger.warning(
                "waiting list over bound (%d): shedding oldest %s %s",
                self.cfg.max_waiting, victim.slo_class, victim.request_id,
            )
            victim.status = SeqStatus.FINISHED
            victim.emit(None, FinishReason.SHED)

    def _shed_victim(self) -> Sequence:
        """Cheapest-first victim over the waiting list: the oldest
        batch-class entry when any batch work waits, else the head (a
        min-scan, not the head: requeue_for_recompute puts recomputed
        work at the front, so deque order is not arrival order)."""
        victim: Sequence | None = None
        for s in self.waiting:
            if s.slo_class == "batch" and (
                victim is None or s.arrival_s < victim.arrival_s
            ):
                victim = s
        return victim if victim is not None else self.waiting[0]

    def expire_waiting(self) -> int:
        """Sweep the waiting list for expired work: deadline-expired
        sequences finish with DEADLINE; sequences older than
        ``max_queue_delay_s`` finish with SHED. Called once per engine
        step while anything waits — a queued prefill past its deadline is
        shed, not executed. Returns the number removed."""
        if not self.waiting:
            return 0
        age_bound = self.cfg.max_queue_delay_s
        now = time.monotonic() if age_bound else 0.0
        kept: deque[Sequence] = deque()
        removed = 0
        for seq in self.waiting:
            if seq.deadline is not None and seq.deadline.expired:
                OVERLOAD.note_deadline("engine.queued")
                seq.status = SeqStatus.FINISHED
                seq.emit(None, FinishReason.DEADLINE)
                removed += 1
            elif age_bound and now - seq.arrival_s > age_bound:
                OVERLOAD.note_shed(
                    "engine.waiting_age", request_class=seq.slo_class
                )
                seq.status = SeqStatus.FINISHED
                seq.emit(None, FinishReason.SHED)
                removed += 1
            else:
                kept.append(seq)
        if removed:
            self.waiting = kept
        return removed

    def abort(
        self, seq: Sequence, reason: FinishReason = FinishReason.CANCELLED
    ) -> None:
        if seq.status is SeqStatus.FINISHED:
            return
        if (
            seq.status
            in (SeqStatus.RUNNING, SeqStatus.WAITING_REMOTE, SeqStatus.PREFILLING)
            and seq.slot is not None
        ):
            if seq.inflight_chunks > 0:
                seq.defer_release = True
            else:
                self._release(seq)
        elif seq in self.waiting:
            self.waiting.remove(seq)
        seq.status = SeqStatus.FINISHED
        seq.emit(None, reason)

    @property
    def has_work(self) -> bool:
        return bool(self.waiting or self.running)

    # -- admission (prefill) ------------------------------------------------
    def next_prefill(self) -> Sequence | None:
        """Pop, fund, and slot the next admissible waiting sequence."""
        if not self.waiting or not self._free_slots:
            return None
        seq = self.waiting[0]
        if not self.admit(seq):
            return None
        self.waiting.remove(seq)
        return seq

    def admit(self, seq: Sequence) -> bool:
        """Fund and slot one sequence (block table, prefix-cache hit,
        batch slot)."""
        if not self._free_slots:
            return False
        bs = self.cfg.block_size
        P = len(seq.prompt_tokens)

        # The prompt's block hashes, once: the prefix probe and the
        # sequence's own chain.
        probe = TokenBlockSequence.from_tokens(seq.prompt_tokens, block_size=bs)
        seq.hashes = TokenBlockSequence(block_size=bs)
        # Prefix match on full prompt blocks, capped so ≥1 token is computed.
        matched: list[int] = []
        if self.cfg.enable_prefix_caching:
            limit = (P - 1) // bs
            matched = self.allocator.match_prefix(probe.sequence_hashes()[:limit])
        cached_tokens = len(matched) * bs

        total_blocks = (P + bs - 1) // bs
        need = total_blocks - len(matched)
        watermark_blocks = int(self.allocator.num_blocks * self.cfg.watermark)
        if self.allocator.num_free - need < watermark_blocks:
            for b in matched:
                self.allocator.release(b)
            return False
        try:
            new_blocks = self.allocator.allocate_many(need)
        except MemoryError:
            for b in matched:
                self.allocator.release(b)
            return False

        seq.block_ids = matched + new_blocks
        seq.num_cached_prefix = cached_tokens
        seq.hashes = probe
        seq.sched_len = seq.total_len
        seq.slot = self._free_slots.pop()
        seq.status = SeqStatus.RUNNING
        self.running[seq.slot] = seq
        return True

    def register_filled_blocks(self, seq: Sequence, covered_tokens: int) -> None:
        """Register every block whose KV is now fully written (the first
        `covered_tokens` positions)."""
        if not self.cfg.enable_prefix_caching or seq.hashes is None:
            return
        bs = self.cfg.block_size
        full = covered_tokens // bs
        hashes = seq.hashes.blocks
        for idx in range(full):
            block = seq.block_ids[idx]
            if block == 0:
                continue  # a rolling-buffer evicted page (the sentinel)
            h = hashes[idx]
            self.allocator.register(
                block,
                h.sequence_hash,
                parent_hash=h.parent_sequence_hash,
                token_ids=list(h.tokens),
            )

    def evict_behind_window(self, seq: Sequence, covered: int) -> int:
        """Rolling-buffer eviction for fully windowed models (Mistral):
        release the blocks whose every position lies behind the window of
        every query the sequence can still issue (the earliest is at
        ``covered - 1`` or later, so keys below ``covered - window`` are
        dead). Their table entries become the 0 sentinel, which a
        windowed scan never reaches, so the tables stay valid without
        compaction. A registered block lands in the allocator's reusable
        pool: its KV stays valid and findable by hash for prefix hits.
        Returns the number of blocks released."""
        if not self.cfg.model.rolling_buffer:
            return 0
        w = self.cfg.model.sliding_window
        upto = min(max(covered - w, 0) // self.cfg.block_size,
                   len(seq.block_ids))
        n = 0
        for i in range(seq.evicted_pages, upto):
            b = seq.block_ids[i]
            if b:
                self.allocator.release(b)
                seq.block_ids[i] = 0
                n += 1
        seq.evicted_pages = max(seq.evicted_pages, upto)
        return n

    # -- decode -------------------------------------------------------------
    def decode_batch(self, lookahead: int = 1) -> list[Sequence]:
        """Sequences taking part in the next decode step, after ensuring
        each has blocks for `lookahead` incoming KV writes counted from
        its device-side length (may preempt on pressure)."""
        bs = self.cfg.block_size
        # Iterate in arrival order so preemption victims are the newest.
        batch: list[Sequence] = []
        for seq in sorted(self.running.values(), key=lambda s: s.arrival_s):
            if seq.status is not SeqStatus.RUNNING:
                continue
            if seq.peer_parked:
                # Admitted but parked on a G4 peer pull: its prompt is not
                # prefilled, so a decode lane built from it would
                # fabricate context (engine _maybe_park_for_peer_pull).
                continue
            if seq.context_cap(self.cfg.max_model_len) <= 0:
                continue  # finishes when its in-flight chunks retire
            needed_block = min(
                (seq.device_len - 2 + lookahead) // bs,
                self.cfg.max_blocks_per_seq - 1,
            )
            while needed_block >= len(seq.block_ids):
                try:
                    seq.block_ids.append(self.allocator.allocate())
                except MemoryError:
                    victim = self._pick_victim(exclude=seq)
                    if victim is not None:
                        self._preempt(victim)
                    elif seq.inflight_chunks == 0:
                        self._preempt(seq)
                        break
                    else:
                        # Nothing preemptible: stall until the pipeline
                        # drains and zombie blocks free up.
                        return []
            if seq.status is SeqStatus.RUNNING:
                batch.append(seq)
        # A later iteration may have preempted an earlier batch member.
        return [s for s in batch if s.status is SeqStatus.RUNNING]

    def _pick_victim(self, exclude: Sequence) -> Sequence | None:
        candidates = [
            s
            for s in self.running.values()
            if s is not exclude
            and s.status is SeqStatus.RUNNING
            and s.inflight_chunks == 0  # in-flight KV writes pin blocks
        ]
        if not candidates:
            return None
        # Cheapest-first preemption (llm/slo.py): any batch sequence before
        # every interactive one; within the class the newest arrival pays
        # (it has made the least progress).
        return max(
            candidates, key=lambda s: (s.slo_class == "batch", s.arrival_s)
        )

    def _preempt(self, seq: Sequence) -> None:
        logger.info("preempting %s (blocks exhausted)", seq.request_id)
        self.requeue_for_recompute(seq)

    def requeue_for_recompute(self, seq: Sequence) -> None:
        """Release everything and requeue for full recompute (the fed
        tokens become the new prompt, so generation resumes seamlessly).
        Shared by preemption and the disagg degradation path: a
        WAITING_REMOTE sequence whose KV transfer died falls back to local
        prefill through here."""
        self._release(seq)
        seq.prompt_tokens = seq.prompt_tokens + seq.output_tokens
        seq.folded_output += len(seq.output_tokens)
        seq.output_tokens = []
        seq.hashes = None
        seq.num_cached_prefix = 0
        seq.sched_len = 0
        seq.evicted_pages = 0  # re-admission funds the whole prompt again
        # Re-admission may land in a slot whose count-buffer row holds
        # another sequence's history: re-arm the reset.
        seq.counts_reset_pending = True
        seq.status = SeqStatus.WAITING
        self.waiting.appendleft(seq)

    def finish(self, seq: Sequence, reason: FinishReason) -> None:
        seq.status = SeqStatus.FINISHED
        seq.sched_len = seq.total_len
        seq.emit(None, reason)
        if seq.inflight_chunks > 0:
            # In-flight chunks still write into these blocks — release
            # when the pipeline drains.
            seq.defer_release = True
        else:
            self._release(seq)

    def waiting_by_class(self) -> dict[str, int]:
        """Waiting-list depth split by SLO class (engine thread only: it
        iterates the deque the engine mutates)."""
        out = {"interactive": 0, "batch": 0}
        for s in self.waiting:
            out[s.slo_class if s.slo_class in out else "interactive"] += 1
        return out

    # -- metrics ------------------------------------------------------------
    def metrics(self) -> dict:
        """ForwardPassMetrics snapshot of the scheduler's own fields."""
        usable = self.allocator.num_blocks - 1
        active = usable - self.allocator.num_free
        return {
            "request_active_slots": len(self.running),
            "request_total_slots": self.cfg.max_num_seqs,
            "kv_active_blocks": active,
            "kv_total_blocks": usable,
            "num_requests_waiting": len(self.waiting),
            "gpu_cache_usage_perc": active / max(usable, 1),
            "gpu_prefix_cache_hit_rate": 0.0,  # updated by the engine
        }

    def _release(self, seq: Sequence) -> None:
        for b in seq.block_ids:
            if b:  # 0: a rolling-buffer evicted page, already released
                self.allocator.release(b)
        seq.block_ids = []
        if seq.slot is not None:
            del self.running[seq.slot]
            self._free_slots.append(seq.slot)
            seq.slot = None
