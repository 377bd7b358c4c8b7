"""FleetPlanner: two-pool prefill/decode autoscaling (port of
dynamo_tpu/planner/fleet.py).

One metric-sampling loop feeds two independent
:class:`~dynamo_tpu_torch.planner.pools.WorkerPool`s:

- the **prefill** pool scales on the shared prefill queue's depth (per
  worker) and oldest-item age (``PrefillQueue.stats()``);
- the **decode** pool scales on KV utilization, waiting requests per
  worker and the decode ITL EMA scraped from the metrics plane
  (``ForwardPassMetrics.itl_ema_ms``, the co-location controller's).

Pools are isolated by construction: each holds its own handles, law,
hysteresis and connector (prefill and decode workers are different
commands), so a queue spike grows only the prefill pool and KV pressure
only the decode pool. Each metric tick also reaps crashed workers and
replaces them at once (``WorkerPool.reap_dead``).

Every adjustment tick writes three sinks (planner/obs.py): the decision
JSONL, the ``PLANNER_OBS`` gauges on the /metrics surfaces, and
``kind="planner"`` records in the ``DYNTPU_TRACE`` capture.

The checkpoint is versioned: v2 files store per-pool worker slices; a
v1 file of the single-pool planner loads its workers into the DECODE
pool (they serve ``generate``).
"""

from __future__ import annotations

import asyncio
import json
import logging
import time
from dataclasses import dataclass, field
from pathlib import Path

from dynamo_tpu_torch.llm.kv_router.metrics_aggregator import KvMetricsAggregator
from dynamo_tpu_torch.planner.obs import PLANNER_OBS
from dynamo_tpu_torch.planner.pools import FleetSample, WorkerPool
from dynamo_tpu_torch.utils.atomic_io import atomic_write_text

logger = logging.getLogger(__name__)

STATE_VERSION = 2


@dataclass
class FleetPlannerConfig:
    namespace: str = "dynamo"
    # Component whose metrics plane the DECODE pool is scored on (decode
    # workers serve `generate` + `load_metrics` there). The prefill pool
    # needs no metrics endpoint — its signal is the queue itself.
    decode_component: str = "torch"
    metric_interval_s: float = 1.0
    adjustment_interval_s: float = 10.0
    state_path: str | None = None
    decision_log_path: str | None = None


@dataclass
class _Window:
    """Raw samples accumulated between adjustment ticks."""

    depths: list[float] = field(default_factory=list)
    ages: list[float] = field(default_factory=list)
    kvs: list[float] = field(default_factory=list)
    waitings: list[float] = field(default_factory=list)
    waitings_interactive: list[float] = field(default_factory=list)
    waitings_batch: list[float] = field(default_factory=list)
    itls: list[float] = field(default_factory=list)
    workers_seen: int = 0

    def add_queue(self, depth: int, age_s: float) -> None:
        self.depths.append(float(depth))
        self.ages.append(float(age_s))

    def add_metrics(self, metrics: dict) -> None:
        if metrics:
            vals = list(metrics.values())
            self.workers_seen = max(self.workers_seen, len(vals))
            self.kvs.append(
                sum(m.gpu_cache_usage_perc for m in vals) / len(vals)
            )
            self.waitings.append(
                sum(m.num_requests_waiting for m in vals) / len(vals)
            )
            # Per-SLO-class split (llm/slo.py): zero on class-blind
            # workers, in which case the laws fall back to the unsplit
            # axis (pools.DecodeLaw.effective_waiting).
            self.waitings_interactive.append(
                sum(
                    getattr(m, "num_waiting_interactive", 0) for m in vals
                ) / len(vals)
            )
            self.waitings_batch.append(
                sum(
                    getattr(m, "num_waiting_batch", 0) for m in vals
                ) / len(vals)
            )
            self.itls.append(sum(m.itl_ema_ms for m in vals) / len(vals))

    def add(self, depth: int, age_s: float, metrics: dict) -> None:
        self.add_queue(depth, age_s)
        self.add_metrics(metrics)

    @staticmethod
    def _avg(xs: list[float]) -> float:
        return sum(xs) / len(xs) if xs else 0.0

    def digest(self) -> FleetSample:
        # Coverage fields report what ACTUALLY arrived this window: a
        # window whose every sample attempt failed digests to zeros
        # with zero coverage, and the laws hold instead of shrinking
        # (pools.py — blind ≠ idle).
        return FleetSample(
            queue_depth=self._avg(self.depths),
            queue_age_s=self._avg(self.ages),
            kv_usage=self._avg(self.kvs),
            waiting=self._avg(self.waitings),
            waiting_interactive=self._avg(self.waitings_interactive),
            waiting_batch=self._avg(self.waitings_batch),
            itl_ema_ms=self._avg(self.itls),
            decode_workers_seen=self.workers_seen,
            queue_samples=len(self.depths),
        )


class FleetPlanner:
    def __init__(
        self,
        drt,
        cfg: FleetPlannerConfig,
        prefill_pool: WorkerPool,
        decode_pool: WorkerPool,
        on_scale_up=None,
    ) -> None:
        from dynamo_tpu_torch.disagg.queue import PrefillQueue

        self._drt = drt
        self.cfg = cfg
        self.prefill = prefill_pool
        self.decode = decode_pool
        self._queue = PrefillQueue(drt, cfg.namespace)
        self._aggregator: KvMetricsAggregator | None = None
        self._task: asyncio.Task | None = None
        # Scale-up hook: awaited as ``on_scale_up(pool_name, new_size)``
        # after a pool grows, so a deployment can push its hottest
        # prefixes to the joining worker before traffic reaches it.
        # Failures are logged, never allowed to break the control loop.
        self._on_scale_up = on_scale_up

    @property
    def pools(self) -> tuple[WorkerPool, WorkerPool]:
        return (self.prefill, self.decode)

    # -- checkpoint/resume -------------------------------------------------
    def _save_state(self) -> None:
        if self.cfg.state_path is None:
            return
        path = Path(self.cfg.state_path)
        path.parent.mkdir(parents=True, exist_ok=True)
        pools = {}
        for pool in self.pools:
            snapshot = getattr(pool.connector, "snapshot", None)
            pools[pool.cfg.name] = {
                "workers": pool.snapshot_workers(),
                "connector": snapshot() if snapshot is not None else {},
            }
        state = {
            "version": STATE_VERSION,
            "namespace": self.cfg.namespace,
            "pools": pools,
            "ts": time.time(),
        }
        # Atomic AND durable (utils/atomic_io): the bare rename left the
        # replace able to roll back to a zero-length file across power
        # loss — which _resume_state would read as "start fresh" and
        # orphan both pools' checkpointed workers.
        atomic_write_text(path, json.dumps(state))

    def _resume_state(self) -> None:
        if self.cfg.state_path is None:
            return
        path = Path(self.cfg.state_path)
        if not path.exists():
            return
        try:
            state = json.loads(path.read_text())
        except ValueError:
            logger.warning("planner state %s unreadable; starting fresh", path)
            return
        if not isinstance(state, dict):
            logger.warning("planner state %s malformed; starting fresh", path)
            return
        if "pools" not in state:
            # v1 single-pool file (planner/planner.py layout): its
            # workers were decode-serving `generate` workers — adopt
            # them into the decode pool, leave prefill to spawn fresh.
            workers = state.get("workers") or []
            restore = getattr(self.decode.connector, "restore", None)
            if restore is not None and state.get("connector"):
                restore(state["connector"])
            alive = self.decode.restore_workers(workers)
            if alive:
                logger.info(
                    "planner: migrated %d worker(s) from single-pool "
                    "state %s into the decode pool", alive, path,
                )
            return
        for pool in self.pools:
            slice_ = state["pools"].get(pool.cfg.name)
            if not isinstance(slice_, dict):
                continue
            restore = getattr(pool.connector, "restore", None)
            if restore is not None and slice_.get("connector"):
                restore(slice_["connector"])
            alive = pool.restore_workers(slice_.get("workers") or [])
            if alive:
                logger.info(
                    "planner: resumed %d %s worker(s) from %s",
                    alive, pool.cfg.name, path,
                )

    # -- lifecycle ---------------------------------------------------------
    async def start(self) -> "FleetPlanner":
        comp = self._drt.namespace(self.cfg.namespace).component(
            self.cfg.decode_component
        )
        self._aggregator = await KvMetricsAggregator(
            self._drt, comp, interval_s=self.cfg.metric_interval_s
        ).start()
        self._resume_state()
        for pool in self.pools:
            await pool.ensure_min()
        self._save_state()
        self._task = asyncio.ensure_future(self._run())
        return self

    async def _run(self) -> None:
        window = _Window()
        next_adjust = (
            asyncio.get_running_loop().time() + self.cfg.adjustment_interval_s
        )
        while True:
            # The two sample sources are INDEPENDENT coverage axes
            # (pools.py FleetSample): a failing queue probe must not
            # blind the decode pool's metrics read (which is a
            # non-raising attribute access) or vice versa.
            try:
                depth, age = await self._queue.stats()
                window.add_queue(depth, age)
            except asyncio.CancelledError:
                return
            except Exception:
                logger.exception("planner queue sample failed")
            window.add_metrics(self._aggregator.endpoints.metrics)
            # Crash healing every METRIC tick, not just adjustment
            # ticks: a dead worker is replaced immediately at target
            # size with no drain accounting (pools.reap_dead — crash ≠
            # drain), so detection latency is one sample interval.
            healed = False
            for pool in self.pools:
                try:
                    healed = bool(await pool.reap_dead()) or healed
                    if pool.size < pool.cfg.min_workers:
                        # Replacement spawns can fail (backend outage):
                        # keep retrying the deficit every tick rather
                        # than serving a worker-sized hole until the
                        # next law-driven scale-up.
                        await pool.ensure_min()
                        healed = True
                except asyncio.CancelledError:
                    return
                except Exception:
                    logger.exception(
                        "planner[%s] dead-worker reap failed",
                        pool.cfg.name,
                    )
            if healed:
                self._save_state()
            if asyncio.get_running_loop().time() >= next_adjust:
                try:
                    await self._adjust(window.digest())
                except asyncio.CancelledError:
                    return
                except Exception:
                    logger.exception("planner adjustment failed")
                window = _Window()
                next_adjust = (
                    asyncio.get_running_loop().time()
                    + self.cfg.adjustment_interval_s
                )
            await asyncio.sleep(self.cfg.metric_interval_s)

    async def _adjust(self, sample: FleetSample) -> None:
        from dynamo_tpu_torch.utils.tracing import tracer

        changed = False
        for pool in self.pools:
            decision = await pool.adjust(sample)
            changed = changed or decision != "hold"
            rec = PLANNER_OBS.note_decision(
                pool.cfg.name,
                decision,
                pool.size,
                signals=pool.law.signals(sample),
                draining=pool.draining,
            )
            tracer().export(rec)
            self._log_decision(rec)
            if decision == "up" and self._on_scale_up is not None:
                try:
                    await self._on_scale_up(pool.cfg.name, pool.size)
                except asyncio.CancelledError:
                    raise
                except Exception:
                    logger.exception(
                        "planner[%s] scale-up hook failed", pool.cfg.name
                    )
        if changed:
            self._save_state()

    def _log_decision(self, rec: dict) -> None:
        """Append one pool-decision line to the decision JSONL (same
        shape as the capture record; write failures never break the
        control loop)."""
        if self.cfg.decision_log_path is None:
            return
        try:
            path = Path(self.cfg.decision_log_path)
            path.parent.mkdir(parents=True, exist_ok=True)
            with path.open("a") as f:
                f.write(json.dumps(rec) + "\n")
        except OSError as exc:
            logger.warning("planner decision log write failed: %s", exc)

    async def stop(self, drain_workers: bool = False) -> None:
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass
            self._task = None
        if self._aggregator is not None:
            await self._aggregator.stop()
        if drain_workers:
            for pool in self.pools:
                await pool.drain_all()
        else:
            for pool in self.pools:
                await pool.wait_drained()
        self._save_state()
