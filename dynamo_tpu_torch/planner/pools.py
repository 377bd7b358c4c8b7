"""Worker pools: the per-phase scaling unit of the fleet planner (port of
dynamo_tpu/planner/pools.py).

The single-pool ``Planner`` (planner/planner.py) scales one homogeneous
worker set. A disaggregated deployment has two populations:

- **prefill** workers consume a queue: the signal is the shared prefill
  queue's depth per live worker and the age of its oldest item (depth
  alone misses a stalled pool);
- **decode** workers hold long-lived streams: the signals are KV
  utilization, waiting requests and the decode ITL EMA each worker
  exports (``ForwardPassMetrics.itl_ema_ms``).

Each :class:`WorkerPool` owns its handles, its law and its hysteresis,
so a queue-driven prefill scale-up never touches the decode pool and
the other way round. Shrinking differs by construction:

- a shrinking **decode** pool DRAINS, never kills: the connector's
  retirement (SIGTERM, or the control-plane drain verb; both reach
  cli.py ``_graceful_drain``) finishes the in-flight streams first;
- a shrinking **prefill** pool REQUEUES, never drops: queued items stay
  on the shared work queue, and the retired worker's leased but unacked
  item is redelivered.

Scale-downs run as tracked background tasks: one pool's 30 s grace
period must not freeze the other pool's control loop.
"""

from __future__ import annotations

import asyncio
import logging
from dataclasses import dataclass, field

from dynamo_tpu_torch.planner.obs import PLANNER_OBS
from dynamo_tpu_torch.utils.task import spawn_tracked

logger = logging.getLogger(__name__)


@dataclass
class FleetSample:
    """One observation window's averaged signals, shared by both laws.

    The fleet planner accumulates raw samples (fleet.py ``_Window``)
    and hands each pool this digest at adjustment time; a law reads
    only the axes it owns.

    The two ``*_seen``/``*_samples`` fields are COVERAGE, not load: a
    dead metrics plane or a failing queue probe yields all-zero
    averages that would otherwise read as "idle" and shed capacity
    under a telemetry blip — a blind window must HOLD instead. They
    default to 1 (sighted) so hand-built samples in tests/tools carry
    their face value; only the fleet planner's window digest, which
    knows whether samples actually arrived, reports 0."""

    queue_depth: float = 0.0        # avg queued prefills
    queue_age_s: float = 0.0        # avg oldest-item age
    kv_usage: float = 0.0           # avg gpu_cache_usage_perc (decode pool)
    waiting: float = 0.0            # avg requests waiting per decode worker
    itl_ema_ms: float = 0.0         # avg decode ITL EMA across the pool
    # Per-SLO-class split of the waiting depth (llm/slo.py; the workers'
    # num_waiting_{interactive,batch} gauges). Zero/zero means the
    # deployment is class-blind (pre-SLO workers) and the laws fall back
    # to the unsplit ``waiting`` axis.
    waiting_interactive: float = 0.0
    waiting_batch: float = 0.0
    decode_workers_seen: int = 1    # decode metrics-plane coverage (0=blind)
    queue_samples: int = 1          # queue-probe coverage (0 = blind)


@dataclass
class PrefillLaw:
    """Queue depth/age-driven law. Thresholds are PER LIVE WORKER on the
    depth axis — 8 queued items are pressure for one worker and idle
    backlog for sixteen — while the age bound is absolute: one item
    older than ``age_up_s`` means the pool is stalled at ANY size."""

    queue_up_per_worker: float = 1.0
    queue_down_per_worker: float = 0.1
    age_up_s: float = 5.0

    def decide(self, s: FleetSample, n: int) -> str:
        per_worker = s.queue_depth / max(n, 1)
        if per_worker > self.queue_up_per_worker or s.queue_age_s > self.age_up_s:
            return "up"
        if s.queue_samples == 0:
            # Blind window: every queue probe failed, so the zeros above
            # are absence of telemetry, not absence of work — never
            # shed capacity on a control-plane blip.
            return "hold"
        if (
            per_worker < self.queue_down_per_worker
            and s.queue_age_s < self.age_up_s / 2
        ):
            return "down"
        return "hold"

    def signals(self, s: FleetSample) -> dict:
        return {"queue": s.queue_depth, "queue_age_s": s.queue_age_s}


@dataclass
class DecodeLaw:
    """KV-utilization + ITL-driven law. ITL bounds are optional (None =
    axis off): with an SLO configured, a pool running hot on ITL scales
    up even at low KV occupancy (many short sequences saturate compute
    before memory). Scale-down requires EVERY axis under its low
    watermark — any single hot axis holds the pool.

    The waiting axis is SLO-class-weighted (llm/slo.py): when the scraped metrics carry
    the per-class split, interactive waiters count at full weight and
    batch waiters at ``batch_weight`` — a deep queue of batch work is
    real pressure but not an interactive-latency emergency, so the pool
    grows for it more slowly than for the same depth of humans waiting.
    Class-blind samples (both splits zero) fall back to the unsplit
    depth unchanged."""

    kv_up_threshold: float = 0.80
    kv_down_threshold: float = 0.30
    waiting_up_per_worker: float = 2.0
    waiting_down_per_worker: float = 0.5
    itl_up_ms: float | None = None
    itl_down_ms: float | None = None
    batch_weight: float = 0.5

    def effective_waiting(self, s: FleetSample) -> float:
        """Class-weighted waiting depth. Only waiting that is POSITIVELY
        attributed to the batch class is discounted; any residual
        between the unsplit axis and the split sum (class-blind workers
        in a mixed/rolling-upgrade fleet report zeros for the split
        fields) counts at FULL weight — otherwise one upgraded worker's
        tiny split would mask nine pre-upgrade workers' real backlog
        and the pool would shed capacity under load."""
        split = s.waiting_interactive + s.waiting_batch
        unattributed = max(0.0, s.waiting - split)
        return (
            s.waiting_interactive
            + self.batch_weight * s.waiting_batch
            + unattributed
        )

    def decide(self, s: FleetSample, n: int) -> str:
        waiting = self.effective_waiting(s)
        if (
            s.kv_usage > self.kv_up_threshold
            or waiting > self.waiting_up_per_worker
            or (self.itl_up_ms is not None and s.itl_ema_ms > self.itl_up_ms)
        ):
            return "up"
        if s.decode_workers_seen == 0:
            # Blind window: the metrics plane produced NOTHING, so the
            # all-zero averages are a telemetry outage, not an idle
            # fleet — a loaded pool must not be drained on a blip.
            return "hold"
        idle = (
            s.kv_usage < self.kv_down_threshold
            and waiting < self.waiting_down_per_worker
        )
        if idle and self.itl_down_ms is not None:
            idle = s.itl_ema_ms < self.itl_down_ms
        return "down" if idle else "hold"

    def signals(self, s: FleetSample) -> dict:
        return {
            "kv": s.kv_usage,
            "waiting": round(self.effective_waiting(s), 3),
            "waiting_interactive": s.waiting_interactive,
            "waiting_batch": s.waiting_batch,
            "itl_ema_ms": s.itl_ema_ms,
        }


@dataclass
class PoolConfig:
    name: str                       # "prefill" | "decode" (gauge suffix)
    min_workers: int = 1
    max_workers: int = 4
    # Hysteresis: scale-up reacts immediately (an overloaded pool is the
    # expensive failure) but respects a cooldown so one hot window can't
    # ladder straight to max; scale-down additionally needs
    # ``down_consecutive`` idle adjustment windows in a row — a single
    # quiet window between bursts must not shed capacity the next burst
    # re-pays cold-start for.
    up_cooldown_s: float = 0.0
    down_cooldown_s: float = 0.0
    down_consecutive: int = 2


class WorkerPool:
    """One elastic worker population: handles + law + hysteresis."""

    def __init__(self, cfg: PoolConfig, connector, law) -> None:
        self.cfg = cfg
        self.connector = connector
        self.law = law
        self.handles: list[object] = []
        self.decisions: list[str] = []      # audit tail ("up"/"down"/"hold")
        self._idle_streak = 0
        self._last_up_mono: float | None = None
        self._last_down_mono: float | None = None
        self._drain_tasks: set[asyncio.Task] = set()

    @property
    def size(self) -> int:
        return len(self.handles)

    @property
    def draining(self) -> int:
        return len(self._drain_tasks)

    def _note_size(self) -> None:
        PLANNER_OBS.note_size(self.cfg.name, self.size, self.draining)

    async def ensure_min(self) -> None:
        while len(self.handles) < self.cfg.min_workers:
            self.handles.append(await self.connector.spawn())
        self._note_size()

    async def reap_dead(self) -> int:
        """Crash handling — distinct from drain by construction: a
        DEAD worker (process exit, missed heartbeats — whatever the
        connector's ``alive()`` judges) left ``handles`` without ever
        passing through retirement, so there is nothing to drain — no
        grace period, no drain task, no drain accounting. It is removed
        and REPLACED IMMEDIATELY at target size: the fleet heals to the
        capacity the laws last decided, instead of serving a silent
        worker-sized hole until the next scale-up window. Returns the
        number replaced. Connectors without ``alive()`` opt out (0)."""
        alive = getattr(self.connector, "alive", None)
        if alive is None:
            return 0
        dead = [h for h in self.handles if not alive(h)]
        if not dead:
            return 0
        for h in dead:
            self.handles.remove(h)
        replaced = 0
        for h in dead:
            logger.warning(
                "planner[%s]: worker %s died — replacing immediately "
                "(crash path, no drain)", self.cfg.name,
                getattr(h, "pid", h),
            )
            try:
                self.handles.append(await self.connector.spawn())
                replaced += 1
            except Exception:  # noqa: BLE001 — next tick retries via ensure_min
                logger.exception(
                    "planner[%s]: replacement spawn failed", self.cfg.name
                )
        if replaced:
            # Count what actually HEALED, not what died: a spawn-backend
            # outage must not report a fleet at target when it is short
            # (the next tick's reap/ensure_min retries the deficit).
            rec = PLANNER_OBS.note_replaced_dead(self.cfg.name, replaced)
            from dynamo_tpu_torch.utils.tracing import tracer

            tracer().export(rec)
        self._note_size()
        return replaced

    async def adjust(self, sample: FleetSample) -> str:
        """One adjustment tick: law verdict → hysteresis → action.
        Returns the APPLIED decision ("hold" when hysteresis or bounds
        vetoed the law)."""
        loop_now = asyncio.get_running_loop().time()
        n = self.size
        want = self.law.decide(sample, n)
        decision = "hold"
        if want == "down":
            self._idle_streak += 1
        else:
            self._idle_streak = 0
        if want == "up" and n < self.cfg.max_workers:
            if (
                self._last_up_mono is None
                or loop_now - self._last_up_mono >= self.cfg.up_cooldown_s
            ):
                logger.info(
                    "planner[%s]: scale UP %d->%d (%s)",
                    self.cfg.name, n, n + 1, self.law.signals(sample),
                )
                self.handles.append(await self.connector.spawn())
                self._last_up_mono = loop_now
                decision = "up"
        elif want == "down" and n > self.cfg.min_workers:
            cooled = (
                self._last_down_mono is None
                or loop_now - self._last_down_mono >= self.cfg.down_cooldown_s
            )
            if cooled and self._idle_streak >= self.cfg.down_consecutive:
                logger.info(
                    "planner[%s]: scale DOWN %d->%d (%s)",
                    self.cfg.name, n, n - 1, self.law.signals(sample),
                )
                self._retire(self.handles.pop())
                self._last_down_mono = loop_now
                self._idle_streak = 0
                decision = "down"
        self.decisions.append(decision)
        return decision

    def _retire(self, handle) -> None:
        """Graceful retirement in the background: the connector's drain
        (SIGTERM → cli.py ``_graceful_drain`` / lease revoke) finishes
        in-flight work; the control loop must not block on the grace
        period. The handle leaves ``handles`` NOW (capacity accounting)
        and the drain task is tracked until completion."""

        async def _drain() -> None:
            try:
                await self.connector.drain(handle)
            finally:
                self._drain_tasks.discard(task)
                self._note_size()

        task = spawn_tracked(
            _drain(), name=f"planner-drain-{self.cfg.name}"
        )
        self._drain_tasks.add(task)
        self._note_size()

    async def drain_all(self) -> None:
        """Retire every worker and wait for all drains (planner stop)."""
        while self.handles:
            self._retire(self.handles.pop())
        await self.wait_drained()

    async def wait_drained(self) -> None:
        while self._drain_tasks:
            await asyncio.gather(*list(self._drain_tasks),
                                 return_exceptions=True)
        self._note_size()

    # -- checkpoint (fleet.py owns the file; pools own their slice) --------
    def snapshot_workers(self) -> list[dict]:
        from dynamo_tpu_torch.planner.planner import _proc_start_ticks

        out = []
        for h in self.handles:
            pid = getattr(h, "pid", None)
            out.append(
                {
                    "pid": pid,
                    "started": (
                        _proc_start_ticks(pid) if pid is not None else None
                    ),
                }
            )
        return out

    def restore_workers(self, workers: list) -> int:
        """Adopt still-alive workers from a checkpoint slice. Start-tick
        mismatches (recycled PIDs) are REFUSED by the connector — the
        planner must never manage a stranger process that inherited a
        pid."""
        adopt = getattr(self.connector, "adopt", None)
        if adopt is None:
            return 0
        alive = 0
        for w in workers or []:
            if isinstance(w, dict):
                pid, started = w.get("pid"), w.get("started")
            else:  # oldest state files stored bare pids
                pid, started = w, None
            if pid is None:
                continue
            try:
                handle = adopt(pid, started)
            except TypeError:  # connector with a pid-only adopt()
                handle = adopt(pid)
            if handle is not None:
                self.handles.append(handle)
                alive += 1
        self._note_size()
        return alive


def default_pools(
    prefill_connector,
    decode_connector,
    prefill_cfg: PoolConfig | None = None,
    decode_cfg: PoolConfig | None = None,
    prefill_law: PrefillLaw | None = None,
    decode_law: DecodeLaw | None = None,
) -> tuple[WorkerPool, WorkerPool]:
    """The standard two-pool wiring (CLI + tests)."""
    return (
        WorkerPool(
            prefill_cfg or PoolConfig(name="prefill"),
            prefill_connector,
            prefill_law or PrefillLaw(),
        ),
        WorkerPool(
            decode_cfg or PoolConfig(name="decode"),
            decode_connector,
            decode_law or DecodeLaw(),
        ),
    )
