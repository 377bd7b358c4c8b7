"""Per-block integrity envelope: checksummed tier crossings (port of
dynamo_tpu/block_manager/integrity.py).

Every KV block gets a CRC32 stamped ONCE, at the G1→G2 store law
(`KvBlockManager._store_host`), over the row exactly as written — for a
quantized tier that is the packed uint8 row (int8 data ‖ f32 scales,
block_manager/quant.py), for an unquantized tier the raw element row. The checksum
rides beside the block through every tier (`Block.checksum`, the G3
sidecar, the G4 wire record, the disagg frame header) and is verified at
every trust-boundary crossing:

==================  =====================================  ============
seam                verification site                      failure tier
==================  =====================================  ============
G2→G1 onboard       `KvBlockManager.match_host`            ``host``
G3→G2 promotion     `OffloadManager._onboard_blocking`     ``disk``
G3 scrub            `KvBlockManager.scrub_tick`            ``disk``
G3 restart          `DiskStorage` sidecar recovery         ``disk``
G4 pull             (not in the port yet)                  ``peer``
disagg tcp frame    `KvReceiver._on_conn`                  ``frame``
disagg native       `NativeKvReceiver._handle`             ``frame``
==================  =====================================  ============

A verification failure NEVER errors the request: the block is
quarantined (evicted from its tier, hash barred from re-announce) and
the sequence rides the existing degrade-to-recompute path byte-identical
(host-miss recompute, the disagg completeness ledger). The per-tier counters here are the attribution surface the
chaos gate closes over: every injected corruption must show up in
exactly one split (docs/architecture/integrity.md).

Counters are PROCESS-WIDE (like utils/faults.FAULTS): the disagg
receivers verify frames with no block-manager in reach, and a
single-process bench fleet needs one ledger to reconcile injected vs
detected corruption against.
"""

from __future__ import annotations

import threading
import zlib

import numpy as np

#: Checksum algorithm version, advertised in the peer blockset layout
#: fingerprint and the disagg layout handshake so mixed fleets REFUSE
#: instead of exchanging rows one side cannot verify. Bump on any change
#: to the algorithm OR the byte domain it covers.
CHECKSUM_ALGO = "crc32-v1"

#: Verification tiers (the per-tier counter splits).
TIERS = ("host", "disk", "peer", "frame")


def block_checksum(data) -> int:
    """CRC32 over the block's raw bytes, dtype-agnostic: the same bytes
    yield the same value whether viewed as a packed uint8 row, a float32
    arena row, or the `tobytes()` wire payload."""
    if isinstance(data, np.ndarray):
        data = np.ascontiguousarray(data.reshape(-1))
        return zlib.crc32(data.view(np.uint8)) & 0xFFFFFFFF
    return zlib.crc32(data) & 0xFFFFFFFF


def verify_block(data, checksum: int | None) -> bool:
    """True when ``data`` matches its envelope. ``None`` means the block
    predates the envelope (no stamp to check against) — trusted, so a
    rolling upgrade never mass-quarantines a warm tier."""
    if checksum is None:
        return True
    return block_checksum(data) == checksum


class IntegrityStats:
    """Process-wide corruption-detection ledger (per-tier splits)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.failures: dict[str, int] = {t: 0 for t in TIERS}
        self.scrub_scanned = 0
        self.scrub_detected = 0

    def note_failure(self, tier: str) -> None:
        with self._lock:
            self.failures[tier] = self.failures.get(tier, 0) + 1

    def note_scrub(self, scanned: int, detected: int) -> None:
        with self._lock:
            self.scrub_scanned += scanned
            self.scrub_detected += detected

    @property
    def total(self) -> int:
        with self._lock:
            return sum(self.failures.values())

    def snapshot(self) -> dict[str, int]:
        """Flat digest, merged into KvBlockManager.stats() (and from
        there onto every ``kvbm_``-prefixed metric surface)."""
        with self._lock:
            d = {f"integrity_failures_{t}": self.failures.get(t, 0)
                 for t in TIERS}
            d["integrity_failures_total"] = sum(self.failures.values())
            d["scrub_scanned_total"] = self.scrub_scanned
            d["scrub_detected_total"] = self.scrub_detected
            return d

    def reset(self) -> None:
        """Test/bench isolation only — production counters are monotonic."""
        with self._lock:
            self.failures = {t: 0 for t in TIERS}
            self.scrub_scanned = 0
            self.scrub_detected = 0


INTEGRITY = IntegrityStats()
