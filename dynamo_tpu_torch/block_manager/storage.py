"""Storage tiers: where block bytes physically live (port of
dynamo_tpu/block_manager/storage.py).

G1 is the engine's paged cache on the device, addressed by block index
(gather/scatter happen there — ops/kv_copy.py); G2 is host DRAM as one
numpy arena (an onboard copies rows out of it, and the scatter stages
them through pinned memory); G3 is an mmap'd file. Every tier exposes the same [num_blocks, block_elems]
view contract so transfers are layout-agnostic byte moves.
"""

from __future__ import annotations

import json
import logging
import mmap
import os
from pathlib import Path

import numpy as np

from dynamo_tpu_torch.block_manager.config import KvLayoutConfig
from dynamo_tpu_torch.block_manager.integrity import (
    CHECKSUM_ALGO,
    INTEGRITY,
    block_checksum,
)
from dynamo_tpu_torch.utils.atomic_io import atomic_write_bytes
from dynamo_tpu_torch.utils.faults import FAULTS

logger = logging.getLogger(__name__)

_NP_DTYPE = {
    # bfloat16 buffers are viewed as uint16 on the host (numpy has no bf16).
    "bfloat16": np.uint16,
    "float16": np.float16,
    "float32": np.float32,
    "int8": np.int8,
}


def _arena_spec(layout: KvLayoutConfig) -> tuple[int, np.dtype]:
    """(elements-per-block, numpy dtype) for a tier arena, derived from
    the layout's EXPLICIT byte accounting (bytes_per_element + scale
    sidecar — config.py), never from the compute dtype alone: a
    quantized tier stores packed uint8 rows of block_bytes (int8 data +
    f32 scales), and sizing those rows off ``layout.dtype`` was exactly
    the silent mixed-precision capacity bug."""
    if layout.quant == "int8":
        return layout.block_bytes, np.dtype(np.uint8)
    return layout.block_elems, np.dtype(_NP_DTYPE[layout.dtype])


class Storage:
    """[num_blocks] of block_elems elements (or packed byte rows when
    the layout is quantized — see _arena_spec)."""

    kind = "abstract"

    def __init__(self, num_blocks: int, layout: KvLayoutConfig) -> None:
        self.num_blocks = num_blocks
        self.layout = layout

    @property
    def bytes_per_block(self) -> int:
        return self.layout.block_bytes

    @property
    def capacity_bytes(self) -> int:
        return self.num_blocks * self.layout.block_bytes

    def write_block(self, idx: int, data: np.ndarray) -> None:
        raise NotImplementedError

    def read_block(self, idx: int) -> np.ndarray:
        raise NotImplementedError


class HostStorage(Storage):
    """G2: one contiguous host-DRAM arena."""

    kind = "host"

    def __init__(self, num_blocks: int, layout: KvLayoutConfig) -> None:
        super().__init__(num_blocks, layout)
        elems, dtype = _arena_spec(layout)
        self._arena = np.zeros((num_blocks, elems), dtype)

    def write_block(self, idx: int, data: np.ndarray) -> None:
        self._arena[idx] = data.reshape(-1).view(self._arena.dtype)

    def read_block(self, idx: int) -> np.ndarray:
        return self._arena[idx]


class DiskStorage(Storage):
    """G3: mmap'd local file (reference: storage/disk.rs).

    ``persist=True`` makes the tier crash-consistent
    (docs/architecture/integrity.md): a block-index sidecar at
    ``<path>.index`` records (idx, hash, parent, tokens, crc) per
    resident block, written tmp+``os.replace``+fsync AFTER the block
    bytes are flushed — so a crash mid-offload yields a shorter VALID
    set at restart (the sidecar either names the block with its final
    checksum or doesn't name it at all), never a torn block served as
    valid. Recovery re-verifies every named block's bytes against its
    checksum before adopting it.
    """

    kind = "disk"

    def __init__(
        self,
        num_blocks: int,
        layout: KvLayoutConfig,
        path: str | Path,
        persist: bool = False,
    ) -> None:
        super().__init__(num_blocks, layout)
        self.path = Path(path)
        self.persist = persist
        self.index_path = Path(str(self.path) + ".index")
        self._index: dict[int, dict] = {}
        self._recovered: list[tuple] = []
        size = num_blocks * layout.block_bytes
        self.path.parent.mkdir(parents=True, exist_ok=True)
        if persist and self.path.exists():
            # Non-destructive open: size the file without truncating the
            # crash-survived bytes, then let sidecar recovery decide
            # which blocks are real.
            with open(self.path, "r+b") as fh:
                fh.truncate(size)
        else:
            # Rows only become truth once the sidecar names them (via
            # atomic_io), so a tear here is invisible to recovery.
            with open(self.path, "wb") as fh:
                fh.truncate(size)
        self._fd = os.open(self.path, os.O_RDWR)
        self._map = mmap.mmap(self._fd, size)
        _, self._dtype = _arena_spec(layout)
        if persist:
            self._recover()

    def write_block(self, idx: int, data: np.ndarray) -> None:
        off = idx * self.layout.block_bytes
        raw = data.reshape(-1).view(self._dtype).tobytes()
        if FAULTS.active:
            # Silent SSD bit-rot / a write cut short by a crash. Armed
            # AFTER the envelope was stamped upstream, so the corruption
            # is exactly what the read/scrub verification must catch.
            raw = FAULTS.corrupt("kvbm.corrupt_disk", raw)
            raw = FAULTS.corrupt("kvbm.torn_write", raw)
        self._map[off : off + len(raw)] = raw

    def read_block(self, idx: int) -> np.ndarray:
        off = idx * self.layout.block_bytes
        raw = self._map[off : off + self.layout.block_bytes]
        return np.frombuffer(raw, self._dtype)

    # -- crash-consistent sidecar -------------------------------------------
    def record_block(
        self,
        idx: int,
        sequence_hash: int,
        parent_hash: int | None,
        tokens: tuple[int, ...],
        checksum: int | None,
    ) -> None:
        """Persist one block's index entry. Ordering is the consistency
        contract: the data region is msync'd FIRST, then the sidecar
        (atomic replace) names the block — the sidecar never references
        bytes that could still be lost."""
        if not self.persist:
            return
        self._index[idx] = {
            "hash": int(sequence_hash),
            "parent": None if parent_hash is None else int(parent_hash),
            "tokens": [int(t) for t in tokens],
            "crc": None if checksum is None else int(checksum),
        }
        self._flush_index()

    def drop_block(self, idx: int) -> None:
        """Un-name an evicted/quarantined block so a restart can never
        resurrect it."""
        if not self.persist or idx not in self._index:
            return
        del self._index[idx]
        self._flush_index()

    def _flush_index(self) -> None:
        self._map.flush()
        payload = json.dumps(
            {
                "algo": CHECKSUM_ALGO,
                "block_bytes": self.layout.block_bytes,
                "blocks": {str(i): rec for i, rec in self._index.items()},
            }
        ).encode("utf-8")
        if FAULTS.active:
            # A torn sidecar (crash mid-replace on a non-atomic fs):
            # recovery must degrade to an empty index, never adopt junk.
            payload = FAULTS.corrupt("kvbm.torn_write", payload)
        atomic_write_bytes(self.index_path, payload)

    def _recover(self) -> None:
        """Load the sidecar, verify every named block's bytes against its
        recorded checksum, and expose the valid set via
        ``recovered_entries()`` (the manager adopts them into the pool).
        Anything unverifiable — torn JSON, algorithm drift, layout drift,
        checksum mismatch — is dropped, counted, and overwritten later."""
        try:
            doc = json.loads(self.index_path.read_bytes())
        except (OSError, ValueError):
            return
        if not isinstance(doc, dict) or doc.get("algo") != CHECKSUM_ALGO:
            logger.warning(
                "disk sidecar %s: unknown checksum algo %r; starting fresh",
                self.index_path, (doc or {}).get("algo"),
            )
            return
        if doc.get("block_bytes") != self.layout.block_bytes:
            logger.warning(
                "disk sidecar %s: layout drift (%s != %s bytes/block); "
                "starting fresh",
                self.index_path, doc.get("block_bytes"),
                self.layout.block_bytes,
            )
            return
        dropped = 0
        for key, rec in (doc.get("blocks") or {}).items():
            try:
                idx = int(key)
                h = int(rec["hash"])
                parent = rec.get("parent")
                parent = None if parent is None else int(parent)
                tokens = tuple(int(t) for t in rec.get("tokens", ()))
                crc = rec.get("crc")
                crc = None if crc is None else int(crc)
            except (KeyError, TypeError, ValueError):
                dropped += 1
                continue
            if not 0 <= idx < self.num_blocks:
                dropped += 1
                continue
            if crc is not None and block_checksum(self.read_block(idx)) != crc:
                # A torn write the crash window produced: the sidecar
                # named the block but the bytes never fully landed.
                dropped += 1
                continue
            self._index[idx] = {
                "hash": h,
                "parent": parent,
                "tokens": list(tokens),
                "crc": crc,
            }
            self._recovered.append((idx, h, parent, tokens, crc))
        if dropped:
            INTEGRITY.note_scrub(dropped, dropped)
            for _ in range(dropped):
                INTEGRITY.note_failure("disk")
            logger.warning(
                "disk sidecar %s: dropped %d torn/invalid block(s) at "
                "recovery; serving the remaining %d valid",
                self.index_path, dropped, len(self._recovered),
            )

    def recovered_entries(self) -> list[tuple]:
        """(idx, hash, parent, tokens, crc) per crash-survived VALID
        block — consumed once by the manager at construction."""
        return list(self._recovered)

    def close(self) -> None:
        self._map.close()
        os.close(self._fd)


class DeviceStorage(Storage):
    """G1: handle onto the engine's paged device cache.

    The engine owns the cache tensors; this wraps gather (block → host
    bytes) and scatter (host bytes → block) callables so the pool/offload
    machinery never touches torch directly.
    """

    kind = "device"

    def __init__(
        self, num_blocks: int, layout: KvLayoutConfig, gather, scatter
    ) -> None:
        super().__init__(num_blocks, layout)
        self._gather = gather
        self._scatter = scatter

    def write_block(self, idx: int, data: np.ndarray) -> None:
        self._scatter(idx, data)

    def read_block(self, idx: int) -> np.ndarray:
        return self._gather(idx)


class NullStorage(Storage):
    """Test double: no bytes at all (KVBM logic tests without a
    device)."""

    kind = "null"

    def write_block(self, idx: int, data: np.ndarray) -> None:
        pass

    def read_block(self, idx: int) -> np.ndarray:
        elems, dtype = _arena_spec(self.layout)
        return np.zeros(elems, dtype)
