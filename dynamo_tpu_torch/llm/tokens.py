"""Token sequences and chained block hashing (port of
dynamo_tpu/llm/tokens.py).

The engine's prefix cache keys on *sequence hashes*: fixed-size token
blocks hashed in a chain, so a block's identity captures its whole
prefix. The chain is the reference's (parent sequence hash, then the
block's little-endian u32 tokens); the hash function is the standard
library's 64-bit BLAKE2b instead of xxh3, because the port depends on
nothing beyond PyTorch and numpy. Hash values therefore differ between
the packages; the chaining, and so every cache decision, is the same.
"""

from __future__ import annotations

import hashlib
import struct
from dataclasses import dataclass, field
from typing import Iterable, Sequence

DEFAULT_BLOCK_SIZE = 16
HASH_SEED = 1337


# The keyed hasher of the default seed, copied per hash: cheaper than
# keying a new one each time.
_SEEDED = hashlib.blake2b(digest_size=8, key=struct.pack("<Q", HASH_SEED))


def compute_hash(data: bytes, seed: int = HASH_SEED) -> int:
    if seed == HASH_SEED:
        h = _SEEDED.copy()
        h.update(data)
    else:
        h = hashlib.blake2b(data, digest_size=8, key=struct.pack("<Q", seed))
    return int.from_bytes(h.digest(), "little")


def compute_salt_hash(salt: bytes | str = b"") -> int:
    """Per-model/per-tenant salt folded into the first block's chain."""
    if isinstance(salt, str):
        salt = salt.encode()
    return compute_hash(salt)


def _tokens_bytes(tokens: Sequence[int]) -> bytes:
    return struct.pack(f"<{len(tokens)}I", *[t & 0xFFFFFFFF for t in tokens])


def compute_block_hash(tokens: Sequence[int]) -> int:
    """Local (parent-independent) hash of one block's tokens."""
    return compute_hash(_tokens_bytes(tokens))


def compute_sequence_hash(parent: int, tokens: Sequence[int]) -> int:
    """Chained hash: parent sequence hash (or the salt hash for the first
    block) followed by this block's tokens."""
    return compute_hash(struct.pack("<Q", parent) + _tokens_bytes(tokens))


@dataclass(frozen=True)
class TokenBlock:
    """A complete, immutable block of `block_size` tokens."""

    tokens: tuple[int, ...]
    block_hash: int
    sequence_hash: int
    parent_sequence_hash: int

    @staticmethod
    def build(tokens: Sequence[int], parent_sequence_hash: int) -> "TokenBlock":
        toks = tuple(tokens)
        raw = _tokens_bytes(toks)  # packed once for both hashes
        return TokenBlock(
            tokens=toks,
            block_hash=compute_hash(raw),
            sequence_hash=compute_hash(
                struct.pack("<Q", parent_sequence_hash) + raw
            ),
            parent_sequence_hash=parent_sequence_hash,
        )


@dataclass
class TokenBlockSequence:
    """A growable token sequence chunked into hash-chained blocks:
    complete blocks are immutable; the partial tail accumulates until it
    reaches `block_size`."""

    block_size: int = DEFAULT_BLOCK_SIZE
    salt_hash: int = field(default_factory=lambda: compute_salt_hash())
    blocks: list[TokenBlock] = field(default_factory=list)
    partial: list[int] = field(default_factory=list)

    @staticmethod
    def from_tokens(
        tokens: Iterable[int],
        block_size: int = DEFAULT_BLOCK_SIZE,
        salt: bytes | str = b"",
    ) -> "TokenBlockSequence":
        seq = TokenBlockSequence(
            block_size=block_size, salt_hash=compute_salt_hash(salt)
        )
        seq.extend(tokens)
        return seq

    def __len__(self) -> int:
        return len(self.blocks) * self.block_size + len(self.partial)

    @property
    def last_sequence_hash(self) -> int:
        return self.blocks[-1].sequence_hash if self.blocks else self.salt_hash

    def sequence_hashes(self) -> list[int]:
        """Chained hashes of all complete blocks."""
        return [b.sequence_hash for b in self.blocks]

    def append(self, token: int) -> TokenBlock | None:
        """Append one token; returns the newly completed block, if any."""
        self.partial.append(token)
        if len(self.partial) == self.block_size:
            block = TokenBlock.build(self.partial, self.last_sequence_hash)
            self.blocks.append(block)
            self.partial = []
            return block
        return None

    def extend(self, tokens: Iterable[int]) -> list[TokenBlock]:
        """Append many tokens; returns all newly completed blocks. Whole
        blocks are hashed from slices, not token by token (a long prompt
        is hashed at admission on the engine thread)."""
        tokens = list(tokens)
        completed: list[TokenBlock] = []
        bs = self.block_size
        i = min(bs - len(self.partial), len(tokens)) if self.partial else 0
        for t in tokens[:i]:
            b = self.append(t)
            if b is not None:
                completed.append(b)
        while i + bs <= len(tokens):
            block = TokenBlock.build(tokens[i:i + bs], self.last_sequence_hash)
            self.blocks.append(block)
            completed.append(block)
            i += bs
        self.partial.extend(tokens[i:])
        return completed
