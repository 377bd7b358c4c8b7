"""Per-tier block pool: lifecycle state machine + sequence-hash reuse
(port of dynamo_tpu/block_manager/pool.py).

Reference: lib/llm/src/block_manager/{block.rs,pool.rs,block/registry.rs} —
states Reset → Partial → Complete → Registered (docs/architecture/
kvbm_components.md:67-94), active pool (ref-held) + inactive pool
(registered, ref 0, LRU-evictable, discoverable by sequence hash),
`allocate_blocks` / `register_blocks` / `match_sequence_hashes`
(pool.rs:339-444). Register/remove events feed the event plane
(block_manager/events.rs) — same shape the router's indexer consumes.
"""

from __future__ import annotations

import enum
import logging
from collections import OrderedDict
from dataclasses import dataclass
from typing import Callable, Sequence

from dynamo_tpu_torch.block_manager.storage import Storage
from dynamo_tpu_torch.engine.kv_cache import KvEvent

logger = logging.getLogger(__name__)


class BlockState(enum.Enum):
    RESET = "reset"
    PARTIAL = "partial"
    COMPLETE = "complete"
    REGISTERED = "registered"


@dataclass
class Block:
    idx: int
    state: BlockState = BlockState.RESET
    ref: int = 0
    sequence_hash: int | None = None
    parent_hash: int | None = None
    tokens: tuple[int, ...] = ()
    # Integrity envelope (block_manager/integrity.py): CRC32 over the
    # row as written, stamped at the G1→G2 store law and carried beside
    # the block through every tier. None = pre-envelope block (trusted).
    checksum: int | None = None

    def _reset(self) -> None:
        self.state = BlockState.RESET
        self.sequence_hash = None
        self.parent_hash = None
        self.tokens = ()
        self.checksum = None


class BlockPool:
    """Active/inactive pool over one Storage tier."""

    def __init__(
        self,
        storage: Storage,
        on_event: Callable[[KvEvent], None] | None = None,
    ) -> None:
        self.storage = storage
        self.on_event = on_event
        self.blocks = [Block(i) for i in range(storage.num_blocks)]
        self._free: list[int] = list(range(storage.num_blocks - 1, -1, -1))
        self._by_hash: dict[int, int] = {}
        self._inactive: OrderedDict[int, None] = OrderedDict()  # idx, LRU
        # Tier telemetry (KV observatory): registered blocks LRU-evicted
        # under allocation pressure, and registrations that created a NEW
        # hash entry (dedup re-registrations excluded) — both monotonic.
        self.evictions_total = 0
        self.registrations_total = 0

    # -- capacity -----------------------------------------------------------
    @property
    def num_free(self) -> int:
        return len(self._free) + len(self._inactive)

    @property
    def num_registered(self) -> int:
        return len(self._by_hash)

    def usage(self) -> float:
        total = len(self.blocks)
        return 1.0 - self.num_free / total if total else 0.0

    # -- allocation ---------------------------------------------------------
    def allocate_blocks(self, n: int) -> list[Block]:
        """n RESET blocks ref=1, evicting LRU inactive on pressure
        (raises MemoryError if impossible)."""
        if self.num_free < n:
            raise MemoryError(f"need {n} blocks, have {self.num_free}")
        out = []
        for _ in range(n):
            if self._free:
                idx = self._free.pop()
            else:
                idx = self._evict_lru()
            b = self.blocks[idx]
            b._reset()
            b.state = BlockState.PARTIAL
            b.ref = 1
            out.append(b)
        return out

    def _evict_lru(self) -> int:
        idx, _ = self._inactive.popitem(last=False)
        b = self.blocks[idx]
        if b.sequence_hash is not None:
            del self._by_hash[b.sequence_hash]
            self.evictions_total += 1
            self._emit("removed", [b.sequence_hash])
        b._reset()
        return idx

    # -- registration -------------------------------------------------------
    def register_block(
        self,
        block: Block,
        sequence_hash: int,
        parent_hash: int | None = None,
        tokens: Sequence[int] = (),
        checksum: int | None = None,
    ) -> Block:
        """COMPLETE→REGISTERED; if the hash is already registered, the
        duplicate is released and the canonical holder returned (ref+1)
        (reference: pool.rs register dedup via registry)."""
        existing = self._by_hash.get(sequence_hash)
        if existing is not None and existing != block.idx:
            self.release(block)
            canon = self.blocks[existing]
            canon.ref += 1
            self._inactive.pop(existing, None)
            return canon
        block.state = BlockState.REGISTERED
        block.sequence_hash = sequence_hash
        block.parent_hash = parent_hash
        block.tokens = tuple(tokens)
        block.checksum = checksum
        self._by_hash[sequence_hash] = block.idx
        self.registrations_total += 1
        self._emit(
            "stored", [sequence_hash], parent_hash, [list(tokens)] if tokens else None
        )
        return block

    def adopt(
        self,
        idx: int,
        sequence_hash: int,
        parent_hash: int | None,
        tokens: Sequence[int],
        checksum: int | None,
    ) -> Block | None:
        """Restart recovery: re-register a crash-survived block at its
        FIXED storage index (the bytes are already on disk — there is
        nothing to allocate or write). Returns None when the index is
        already taken or the hash already registered elsewhere (a torn
        sidecar must never shadow live state). Startup-only: the O(n)
        free-list removal never runs on the serving path."""
        b = self.blocks[idx]
        if b.state is not BlockState.RESET or sequence_hash in self._by_hash:
            return None
        self._free.remove(idx)
        b.state = BlockState.REGISTERED
        b.ref = 0
        b.sequence_hash = sequence_hash
        b.parent_hash = parent_hash
        b.tokens = tuple(tokens)
        b.checksum = checksum
        self._by_hash[sequence_hash] = idx
        self._inactive[idx] = None  # ref 0: evictable, discoverable
        self.registrations_total += 1
        self._emit(
            "stored", [sequence_hash], parent_hash,
            [list(tokens)] if tokens else None,
        )
        return b

    def quarantine(self, block: Block) -> None:
        """Forcibly unregister a CORRUPT block: the hash must never match
        again, and the frame returns to the free list once unreferenced.
        Callers hold the tier lock and have already dropped their own
        match ref. A still-referenced frame stays allocated (hash-less)
        and is reclaimed by the LRU under pressure."""
        h = block.sequence_hash
        if h is not None and self._by_hash.get(h) == block.idx:
            del self._by_hash[h]
            self._emit("removed", [h])
        if block.state is BlockState.RESET:
            return  # already freed
        block.sequence_hash = None
        block.parent_hash = None
        block.checksum = None
        if block.ref <= 0:
            self._inactive.pop(block.idx, None)
            block._reset()
            self._free.append(block.idx)

    # -- reuse --------------------------------------------------------------
    def match_sequence_hashes(self, hashes: Sequence[int]) -> list[Block]:
        """Longest registered prefix run (consecutive from the first hash);
        each returned block gets ref+1 (reference: pool.rs:339
        match_sequence_hashes)."""
        out = []
        for h in hashes:
            idx = self._by_hash.get(h)
            if idx is None:
                break
            b = self.blocks[idx]
            b.ref += 1
            self._inactive.pop(idx, None)
            out.append(b)
        return out

    def get_by_hash(self, h: int) -> Block | None:
        idx = self._by_hash.get(h)
        return self.blocks[idx] if idx is not None else None

    def registered_hashes(self) -> list[int]:
        """All registered sequence hashes (the exported blockset —
        block_manager/remote.py)."""
        return list(self._by_hash)

    # -- release ------------------------------------------------------------
    def release(self, block: Block) -> None:
        block.ref -= 1
        if block.ref > 0:
            return
        block.ref = 0
        if block.state is BlockState.REGISTERED:
            self._inactive[block.idx] = None  # keep bytes; discoverable
        else:
            block._reset()
            self._free.append(block.idx)

    # -- events -------------------------------------------------------------
    def _emit(self, kind, hashes, parent=None, tokens=None) -> None:
        if self.on_event:
            self.on_event(
                KvEvent(
                    kind=kind,
                    block_hashes=hashes,
                    parent_hash=parent,
                    token_ids=tokens,
                )
            )
