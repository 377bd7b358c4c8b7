"""Host-side KV block accounting: allocation, ref counting, prefix
caching (port of the BlockAllocator of dynamo_tpu/engine/kv_cache.py).

A block is *allocated* to a sequence, *registered* under its sequence
hash once full, and on release either joins the reusable pool (still
holding valid KV, discoverable by hash) or the free list. Allocation
prefers truly free blocks and evicts LRU reusable blocks only on
pressure. Block 0 is the trash block for padded writes — never
allocated. Illegal lifecycle transitions raise ``BlockStateError``.

Not in this slice: striped allocation for kv_sp and the KV events that
feed the router (ROADMAP queue A).
"""

from __future__ import annotations

import enum
from collections import OrderedDict


class BlockState(enum.Enum):
    FREE = "free"              # on the free list, no KV content
    ACTIVE = "active"          # refcounted by ≥1 sequence, not yet hashed
    REGISTERED = "registered"  # refcounted AND published under its hash
    REUSABLE = "reusable"      # refcount 0 but hash-discoverable (LRU pool)


class BlockStateError(RuntimeError):
    """An illegal block lifecycle transition (use-after-free, double free,
    registering an unallocated block, ...)."""


class BlockAllocator:
    def __init__(
        self,
        num_blocks: int,
        block_size: int,
        enable_prefix_caching: bool = True,
    ) -> None:
        self.num_blocks = num_blocks
        self.block_size = block_size
        self.enable_prefix_caching = enable_prefix_caching
        self._free: list[int] = list(range(num_blocks - 1, 0, -1))
        self._refs: dict[int, int] = {}
        self._hash_to_block: dict[int, int] = {}
        self._block_to_hash: dict[int, int] = {}
        # Registered blocks with refcount 0, LRU order (oldest first).
        self._reusable: OrderedDict[int, None] = OrderedDict()

    # -- typestate ----------------------------------------------------------
    def state(self, block: int) -> BlockState:
        if block in self._refs:
            return (
                BlockState.REGISTERED
                if block in self._block_to_hash
                else BlockState.ACTIVE
            )
        if block in self._reusable:
            return BlockState.REUSABLE
        return BlockState.FREE

    def _expect(self, block: int, *states: BlockState, op: str) -> None:
        got = self.state(block)
        if got not in states:
            raise BlockStateError(
                f"{op}(block={block}): state is {got.value}, expected "
                f"{'/'.join(s.value for s in states)}"
            )

    # -- capacity -----------------------------------------------------------
    @property
    def num_free(self) -> int:
        return len(self._free) + len(self._reusable)

    def is_registered(self, sequence_hash: int) -> bool:
        return sequence_hash in self._hash_to_block

    # -- allocation ---------------------------------------------------------
    def allocate(self) -> int:
        """Allocate one block (refcount 1); evicts LRU reusable on
        pressure."""
        if self._free:
            block = self._free.pop()
        elif self._reusable:
            block, _ = self._reusable.popitem(last=False)
            self._forget(block)
        else:
            raise MemoryError("out of KV blocks")
        self._refs[block] = 1
        return block

    def allocate_many(self, n: int) -> list[int]:
        if self.num_free < n:
            raise MemoryError(f"need {n} blocks, have {self.num_free}")
        return [self.allocate() for _ in range(n)]

    def release(self, block: int) -> None:
        self._expect(
            block, BlockState.ACTIVE, BlockState.REGISTERED, op="release"
        )
        self._refs[block] -= 1
        if self._refs[block] > 0:
            return
        del self._refs[block]
        if block in self._block_to_hash and self.enable_prefix_caching:
            self._reusable[block] = None
            self._reusable.move_to_end(block)
        else:
            self._forget(block)
            self._free.append(block)

    # -- prefix caching -----------------------------------------------------
    def register(self, block: int, sequence_hash: int) -> None:
        """Publish a full block under its chained sequence hash."""
        self._expect(
            block, BlockState.ACTIVE, BlockState.REGISTERED, op="register"
        )
        if not self.enable_prefix_caching:
            return
        if sequence_hash in self._hash_to_block:
            # Duplicate content (keep the first registration) or an
            # idempotent re-register of this very block.
            return
        self._hash_to_block[sequence_hash] = block
        self._block_to_hash[block] = sequence_hash

    def match_prefix(self, sequence_hashes: list[int]) -> list[int]:
        """Longest run of cached blocks for a chained hash list; each
        matched block's refcount is bumped (caller owns a reference)."""
        matched: list[int] = []
        for h in sequence_hashes:
            block = self._hash_to_block.get(h)
            if block is None:
                break
            if block in self._reusable:
                del self._reusable[block]
                self._refs[block] = 1
            else:
                self._refs[block] += 1
            matched.append(block)
        return matched

    def _forget(self, block: int) -> None:
        h = self._block_to_hash.pop(block, None)
        if h is not None:
            self._hash_to_block.pop(h, None)
