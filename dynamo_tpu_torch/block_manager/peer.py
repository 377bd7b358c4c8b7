"""G4 peer tier: fleet-wide KV pulls priced against local recompute (port
of dynamo_tpu/block_manager/peer.py).

Grows the blockset export of block_manager/remote.py into the tier the
reference's distributed KVBM describes (lib/llm/src/block_manager.rs
export_local_blockset / import_remote_blockset) and NetKV prices:

- :class:`PeerBlockServer` also ADVERTISES its measured serve-rate EMA
  in the blockset record, and can pace its stream to a simulated link
  (``serve_link_gbps``, the mocker's peer-link cost model,
  ``MockerConfig.peer_link_gbps``).
- :class:`PeerBlockClient` owns the pull-vs-recompute law: a pull is
  dispatched only when its predicted transfer time (the measured pull
  EMA, else the peer's advertised rate, else the calibrated
  ``HANDOFF_GBPS``) beats the predicted recompute time (the engine's
  live prefill EMA, else the calibrated ``PREFILL_TIME_PER_TOKEN_US``).
  Fetches run under the shared retry policy with the ``kvbm.peer_pull``
  fault point inside each attempt, so a peer that dies mid-pull costs
  the request its pull and it recomputes.
- :class:`Reannouncer` re-publishes a worker's resident block hashes as
  idempotent ``stored`` events on the KV event plane, periodically and
  whenever anyone broadcasts on ``KV_REANNOUNCE_PLANE``: a rejoined
  router replica's radix view converges in one round.
- :class:`PrefixHeat` ranks prefix chains by decayed touch counts;
  :func:`preplace` pushes the hottest chains into a joining worker's
  host tier BEFORE it takes traffic (the planner's scale-up hook).

The calibrated constants are read as ``calibration.NAME`` when a price
is made: the port's calibration module reads its H100 record on first
access (planner/calibration.py), and a name bound at import would freeze
the value.

Layout compatibility is a hard handshake: the blockset record carries
the whole block-geometry fingerprint (dtype and quant included), and a
mixed-precision peer is REFUSED at apply time, never repacked. Packed
int8 rows therefore move bit for bit (half the bytes), bf16 rows raw.
"""

from __future__ import annotations

import asyncio
import logging
import threading
import time
from typing import Callable, Sequence

import numpy as np

from dynamo_tpu_torch.block_manager.config import KvLayoutConfig
from dynamo_tpu_torch.block_manager.integrity import CHECKSUM_ALGO
from dynamo_tpu_torch.block_manager.offload import RateEMA
from dynamo_tpu_torch.block_manager.remote import (
    KV_BLOCKS_ENDPOINT,
    RemoteBlockClient,
    RemoteBlockServer,
    block_frame,
    block_record,
    match_bytes,
    off_loop,
)
from dynamo_tpu_torch.llm.kv_router.protocols import (
    KV_REANNOUNCE_PLANE,
    KvCacheEventData,
)
from dynamo_tpu_torch.planner import calibration
from dynamo_tpu_torch.runtime.transports import wire
from dynamo_tpu_torch.utils.faults import FAULTS
from dynamo_tpu_torch.utils.retry import BLOCK_IMPORT, retry_async

logger = logging.getLogger(__name__)

__all__ = [
    "KV_BLOCKS_ENDPOINT",
    "PeerBlockClient",
    "PeerBlockServer",
    "PrefixHeat",
    "Reannouncer",
    "layout_fingerprint",
    "preplace",
    "request_reannounce",
]


def layout_fingerprint(layout: KvLayoutConfig) -> dict:
    """The wire-form block-geometry handshake. Every field that changes
    the stored bytes is in it: two workers whose fingerprints differ in
    ANY field (dtype and quant included) refuse each other's blocks
    rather than reinterpret them. ``checksum`` is the integrity
    envelope's algorithm version: a legacy peer without it is refused
    loudly, its rows being unverifiable."""
    return {
        "num_layers": layout.num_layers,
        "page_size": layout.page_size,
        "num_kv_heads": layout.num_kv_heads,
        "head_dim": layout.head_dim,
        "dtype": layout.dtype,
        "quant": layout.quant,
        "checksum": CHECKSUM_ALGO,
    }


class PeerBlockServer(RemoteBlockServer):
    """Serve side of the G4 tier: blockset export + paced block serving
    with an advertised throughput EMA riding the blockset record."""

    def __init__(
        self,
        drt,
        component,
        manager,
        layout: KvLayoutConfig | dict | None = None,
        refresh_s: float = 1.0,
        serve_link_gbps: float = 0.0,
    ) -> None:
        if isinstance(layout, KvLayoutConfig):
            layout = layout_fingerprint(layout)
        super().__init__(drt, component, manager, layout, refresh_s)
        # Simulated link pacing (the mocker's peer-link cost model): > 0
        # sleeps the stream bytes / (gbps · 1e9) per block, so a mocker
        # fleet's pull timings, and the client's measured rate EMA,
        # reflect the configured link instead of loopback memcpy speed.
        self.serve_link_gbps = serve_link_gbps
        # Seconds of that pacing slept so far: the simulated link's time.
        self.paced_s = 0.0
        self._serve_rate = RateEMA()
        self._published_bps = 0.0

    async def _publish(self) -> None:
        hashes = self._hashes()
        bps = self._serve_rate.value
        if hashes == self._published and _rates_close(
            bps, self._published_bps
        ):
            return
        await self._drt.store.put(
            self._key,
            wire.packb(
                {
                    "hashes": sorted(hashes),
                    "layout": self._layout,
                    "serve_bps": bps,
                }
            ),
            lease_id=self._drt.primary_lease_id,
        )
        # Only after the put succeeds (a transient store failure keeps
        # the record dirty for the refresh loop).
        self._published = hashes
        self._published_bps = bps

    async def generate(self, request):
        hashes = list(request.payload.get("hashes") or [])
        frames = bool(request.payload.get("frames"))
        t0 = time.monotonic()
        blocks = await off_loop(match_bytes(self._manager, len(hashes)),
                                self._manager.match_host, hashes)
        total = 0
        owed = 0.0  # link time served but not slept yet
        batch, held = [], 0  # blocks of the frame being built
        for row in blocks:
            if frames:
                nbytes = np.asarray(row[3]).nbytes
                batch.append(row)
                held += nbytes
            else:
                record, nbytes = block_record(*row)
                yield record
            total += nbytes
            if self.serve_link_gbps > 0:
                # The link's time for these bytes, slept in installments of
                # at least PACE_QUANTUM_S: a sleep per small block would
                # cost an event-loop pass each, far more than the link.
                owed += nbytes / (self.serve_link_gbps * 1e9)
            pace = owed >= PACE_QUANTUM_S
            if batch and (pace or held >= FRAME_BYTES):
                yield block_frame(batch)  # what the link carried so far
                batch, held = [], 0
            if pace:
                self.paced_s += owed
                await asyncio.sleep(owed)
                owed = 0.0
        if batch:
            yield block_frame(batch)
        if owed > 0:
            self.paced_s += owed
            await asyncio.sleep(owed)
        if total:
            self._serve_rate.note(total, max(time.monotonic() - t0, 1e-9))


#: Block bytes one batched frame of a PeerBlockServer carries at most.
FRAME_BYTES = 4 << 20

#: Smallest pacing sleep of a PeerBlockServer on a simulated link.
PACE_QUANTUM_S = 1e-3


def _rates_close(a: float, b: float, tol: float = 0.2) -> bool:
    """Re-advertise only when the serve EMA moved materially (> 20%):
    every advertisement is a store put the whole fleet watches."""
    if a == b:
        return True
    hi = max(abs(a), abs(b))
    return abs(a - b) <= tol * hi


class PeerBlockClient(RemoteBlockClient):
    """Pull side of the G4 tier: peer tracking + the pricing law.

    Counter and EMA fields are written only on the asyncio loop and read
    lock-free by the manager's stats() (GIL-atomic int/float reads, the
    contract of every other KVBM gauge)."""

    def __init__(
        self,
        drt,
        component,
        layout: KvLayoutConfig | dict | None = None,
        layout_cfg: KvLayoutConfig | None = None,
    ) -> None:
        if isinstance(layout, KvLayoutConfig):
            layout_cfg = layout_cfg or layout
            layout = layout_fingerprint(layout)
        super().__init__(drt, component, layout)
        self._layout_cfg = layout_cfg
        self._peer_bps: dict[str, float] = {}   # advertised serve EMAs
        self._pull_rate = RateEMA()             # measured pull throughput
        self.pulls_total = 0
        self.pull_bytes_total = 0
        self.pull_fallbacks_total = 0

    # -- peer tracking ------------------------------------------------------
    def _apply(self, key: str, raw: bytes | None) -> None:
        wid = key[len(self._prefix):]
        bps = (
            float(wire.unpackb(raw).get("serve_bps") or 0.0)
            if raw is not None
            else 0.0
        )
        super()._apply(key, raw)
        # An advertised rate survives only for ACCEPTED peers: a refused
        # or withdrawn blockset must not keep pricing pulls.
        if raw is not None and wid in self._blocksets:
            self._peer_bps[wid] = bps
        else:
            self._peer_bps.pop(wid, None)

    # -- pricing law --------------------------------------------------------
    def effective_bps(self, wid: str | None = None) -> float:
        """The link rate a pull from ``wid`` is priced at: the measured
        pull EMA first (ground truth once any pull completed), else the
        peer's advertised serve EMA, else the calibrated channel."""
        if self._pull_rate.bps is not None:
            return self._pull_rate.value
        adv = self._peer_bps.get(wid or "", 0.0)
        if adv > 0:
            return adv
        return calibration.HANDOFF_GBPS * 1e9

    def price(
        self,
        n_blocks: int,
        wid: str | None = None,
        prefill_tps: float | None = None,
    ) -> tuple[float, float]:
        """(pull_s, recompute_s) for ``n_blocks`` prefix blocks — the
        engine's adaptive onboard gate, one tier out: stored block bytes
        over the link rate (+ the calibrated fixed cost of a handoff)
        against block tokens over prefill throughput."""
        layout = self._layout_cfg
        if layout is not None:
            block_bytes, block_tokens = layout.block_bytes, layout.page_size
        else:
            # No layout handed in (a bare client): the calibrated 1B bf16
            # geometry, the router's NetKV default.
            block_bytes, block_tokens = 16 * calibration.KV_BYTES_PER_TOKEN, 16
        bps = self.effective_bps(wid)
        pull_s = calibration.HANDOFF_FIXED_US / 1e6 + n_blocks * block_bytes / max(
            bps, 1.0
        )
        tps = prefill_tps or 1e6 / calibration.PREFILL_TIME_PER_TOKEN_US
        recompute_s = n_blocks * block_tokens / max(tps, 1.0)
        return pull_s, recompute_s

    def plan(
        self,
        hashes: Sequence[int],
        prefill_tps: float | None = None,
    ) -> tuple[str, int] | None:
        """(peer wid, prefix length) when some peer holds a prefix of
        ``hashes`` AND pulling it is priced cheaper than recomputing it;
        None otherwise (no peer, or a losing price)."""
        wid, n = self.best_peer(hashes)
        if wid is None or n == 0:
            return None
        pull_s, recompute_s = self.price(n, wid, prefill_tps)
        if pull_s >= recompute_s:
            return None
        return wid, n

    # -- the pull -----------------------------------------------------------
    async def fetch(self, wid: str, hashes: Sequence[int]):
        """The base fetch under the peer-tier seam: ``kvbm.peer_pull``
        fires INSIDE each attempt (an armed times=N raise exercises the
        retry budget), and retries count on the peer seam."""

        async def attempt():
            await FAULTS.maybe_fail_async("kvbm.peer_pull")
            return await self._fetch_attempt(wid, hashes)

        return await retry_async(attempt, BLOCK_IMPORT, seam="kvbm.peer_pull")

    async def pull_into(
        self,
        manager,
        hashes: Sequence[int],
        prefill_tps: float | None = None,
        force: bool = False,
    ) -> int:
        """The whole G4 pull: price (unless ``force`` — pre-placement
        warms a worker BEFORE it takes traffic, so the price is moot),
        fetch, land in the manager's host tier marked G4-origin. Returns
        the blocks imported; 0 on a losing price, no peer, or a failed
        transfer (the caller recomputes — counted in
        ``pull_fallbacks_total`` only when a transfer was dispatched)."""
        hashes = [h for h in hashes if not manager.has_host(h)]
        if not hashes:
            return 0
        if force:
            planned = self.best_peer(hashes)
            if planned[0] is None or planned[1] == 0:
                return 0
        else:
            planned = self.plan(hashes, prefill_tps)
            if planned is None:
                return 0
        wid, n = planned
        t0 = time.monotonic()
        try:
            blocks = await self.fetch(wid, hashes[:n])
        except asyncio.CancelledError:
            raise
        except Exception:  # noqa: BLE001 — peer death degrades to local recompute by design
            self.pull_fallbacks_total += 1
            logger.warning(
                "G4 pull of %d block(s) from peer %s failed; degrading "
                "to local recompute", n, wid, exc_info=True,
            )
            return 0
        if not blocks:
            return 0
        nbytes = sum(int(np.asarray(d).nbytes) for *_meta, d in blocks)
        self._pull_rate.note(nbytes, max(time.monotonic() - t0, 1e-9))
        imported = await off_loop(nbytes, manager.import_peer_blocks, blocks)
        self.pulls_total += 1
        self.pull_bytes_total += nbytes
        return imported

    # -- telemetry ----------------------------------------------------------
    def stats(self) -> dict:
        """Lock-free G4 digest, merged into KvBlockManager.stats()."""
        return {
            "g4_pulls_total": self.pulls_total,
            "g4_pull_bytes_total": self.pull_bytes_total,
            "g4_pull_fallbacks_total": self.pull_fallbacks_total,
            "link_peer_bps": self._pull_rate.value,
        }


class Reannouncer:
    """Re-publish resident block hashes as idempotent ``stored`` events.

    Subscribes to ``KV_REANNOUNCE_PLANE`` (any broadcast there triggers a
    full re-announce — a rejoined router replica rebuilding its radix
    view) and re-announces every ``interval_s`` regardless, so a
    listener that missed the trigger converges anyway. ``entries_fn``
    returns the worker's resident (hash, parent, tokens) rows —
    ``KvBlockManager.host_entries`` in a deployment."""

    def __init__(
        self,
        drt,
        component,
        publisher,
        entries_fn: Callable[[], list[tuple[int, int | None, tuple]]],
        interval_s: float = 30.0,
    ) -> None:
        self._drt = drt
        self._subject = component.event_subject(KV_REANNOUNCE_PLANE)
        self._publisher = publisher
        self._entries_fn = entries_fn
        self.interval_s = interval_s
        self._sub = None
        self._tasks: list[asyncio.Task] = []
        self.announces_total = 0

    async def start(self) -> "Reannouncer":
        self._sub = await self._drt.bus.subscribe(self._subject)
        self._tasks = [
            asyncio.ensure_future(self._pump()),
            asyncio.ensure_future(self._periodic()),
        ]
        return self

    async def stop(self) -> None:
        for t in self._tasks:
            t.cancel()
        for t in self._tasks:
            try:
                await t
            except asyncio.CancelledError:
                pass
        self._tasks = []

    async def _pump(self) -> None:
        async for _raw in self._sub:
            try:
                self.announce()
            except Exception:  # noqa: BLE001 — one bad announce must not kill the trigger pump
                logger.exception("triggered re-announce failed")

    async def _periodic(self) -> None:
        while True:
            await asyncio.sleep(self.interval_s)
            try:
                self.announce()
            except Exception:  # noqa: BLE001 — the periodic loop retries next tick
                logger.exception("periodic re-announce failed")

    def announce(self) -> int:
        """Publish every resident block as a ``stored`` event, parents
        before children (the radix apply links a child to its parent only
        when the parent node exists). Idempotent on the receiving side —
        re-applying a stored event is a set-add."""
        entries = self._entries_fn()
        for h, parent, tokens in _parents_first(entries):
            self._publisher.publish(
                KvCacheEventData(
                    kind="stored",
                    block_hashes=[h],
                    parent_hash=parent,
                    token_ids=[list(tokens)],
                )
            )
        self.announces_total += 1
        return len(entries)


def _parents_first(
    entries: list[tuple[int, int | None, tuple]]
) -> list[tuple[int, int | None, tuple]]:
    """Topological order: a block precedes its children. Entries whose
    parent is absent from the set are roots (their parent was evicted —
    the radix apply still creates the node, unlinked)."""
    present = {h for h, _, _ in entries}
    by_parent: dict[int | None, list] = {}
    for e in entries:
        key = e[1] if e[1] in present else None
        by_parent.setdefault(key, []).append(e)
    out: list = []
    stack = list(reversed(by_parent.get(None, [])))
    while stack:
        e = stack.pop()
        out.append(e)
        stack.extend(reversed(by_parent.get(e[0], [])))
    if len(out) < len(entries):  # a hash chain has no cycle, but never
        seen = {h for h, _, _ in out}  # drop a block silently
        out.extend(e for e in entries if e[0] not in seen)
    return out


async def request_reannounce(drt, component) -> None:
    """Ask every worker on ``component`` to re-publish its resident
    blocks (a fire-and-forget broadcast on the re-announce plane)."""
    await drt.bus.broadcast(
        component.event_subject(KV_REANNOUNCE_PLANE),
        wire.packb({"unix": time.time()}),
    )


class PrefixHeat:
    """Decayed per-prefix touch counts — the pre-placement picker.

    Fed from route / kv_actual history (one ``note`` per routed request
    with the request's prefix hash chain); ``hottest`` returns the top-k
    chains by accumulated heat. Thread-safe (noted from the engine thread
    or the loop, read by the planner hook)."""

    def __init__(self, max_prefixes: int = 1024, decay: float = 0.98):
        self._lock = threading.Lock()
        self.max_prefixes = max_prefixes
        self.decay = decay
        self._heat: dict[int, float] = {}       # leading hash -> heat
        self._chains: dict[int, list[int]] = {}  # leading hash -> chain

    def note(self, hashes: Sequence[int], weight: float = 1.0) -> None:
        if not hashes:
            return
        key = hashes[0]
        with self._lock:
            for k in self._heat:
                self._heat[k] *= self.decay
            self._heat[key] = self._heat.get(key, 0.0) + weight
            prev = self._chains.get(key)
            if prev is None or len(hashes) > len(prev):
                self._chains[key] = list(hashes)
            if len(self._heat) > self.max_prefixes:
                coldest = min(self._heat, key=self._heat.get)
                del self._heat[coldest]
                self._chains.pop(coldest, None)

    def hottest(self, k: int = 8) -> list[list[int]]:
        with self._lock:
            keys = sorted(self._heat, key=self._heat.get, reverse=True)[:k]
            return [list(self._chains[key]) for key in keys]


async def preplace(
    client: PeerBlockClient,
    manager,
    heat: PrefixHeat,
    top_k: int = 8,
) -> int:
    """Push the hottest prefix chains into ``manager``'s host tier from
    whichever peers hold them — the planner scale-up hook's payload.
    Forced pulls: the joining worker is not serving yet, so its transfer
    time competes with nobody's TTFT. Returns the blocks landed."""
    total = 0
    for chain in heat.hottest(top_k):
        total += await client.pull_into(manager, chain, force=True)
    return total
