"""Planner: the auto-scaler that watches load watermarks and scales
workers (port of dynamo_tpu/planner/planner.py).

Control loop:
- every ``metric_interval_s``: sample the prefill queue's depth and each
  live worker's ForwardPassMetrics (KV utilization, waiting requests)
  through the metrics plane into the current observation window;
- every ``adjustment_interval_s``: scale ±1 worker within [min_workers,
  max_workers] — up when the window's average queue depth, KV
  utilization or waiting requests cross a high watermark, down when all
  sit under their low watermarks. With a ``PerfProfile`` and an SLA the
  window's load steps the pool toward load / per-worker capacity.

Scale-down is graceful: the connector SIGTERMs the worker, which drains
(its instances deregister, routers move to the survivors, the in-flight
streams finish over their TCP response streams).

Connectors say what a worker is: ``SubprocessConnector`` spawns a shell
command per worker and checkpoints their pids (with each process's
start time, so a recycled pid is never adopted); tests inject an
in-process connector.
"""

from __future__ import annotations

import asyncio
import json
import logging
import os
import signal
import subprocess
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Protocol

from dynamo_tpu_torch.llm.kv_router.metrics_aggregator import KvMetricsAggregator
from dynamo_tpu_torch.llm.kv_router.protocols import ForwardPassMetrics
from dynamo_tpu_torch.utils.atomic_io import atomic_write_text

logger = logging.getLogger(__name__)


@dataclass
class PlannerConfig:
    namespace: str = "dynamo"
    # The workers' component: the port's workers serve
    # dyn://dynamo.torch.generate.
    component: str = "torch"
    min_workers: int = 1
    max_workers: int = 4          # the card budget
    metric_interval_s: float = 1.0
    adjustment_interval_s: float = 10.0
    # Watermarks
    queue_up_threshold: float = 1.0    # avg queued prefills per sample
    queue_down_threshold: float = 0.1
    kv_up_threshold: float = 0.80      # avg gpu_cache_usage_perc
    kv_down_threshold: float = 0.30
    waiting_up_threshold: float = 2.0  # avg requests waiting per worker
    waiting_down_threshold: float = 0.5  # hysteresis: don't flap around _up
    # Checkpoint file for crash/restart resume. None disables
    # persistence.
    state_path: str | None = None
    # SLA-driven scaling (profiled TTFT/ITL interpolation): when a PerfProfile is set on the Planner and either
    # bound is given, the adjustment targets load/capacity directly
    # (±1 per interval toward the target) instead of pure watermarks.
    ttft_sla_ms: float | None = None
    itl_sla_ms: float | None = None
    # Scaling-decision time series: one JSONL line per adjustment tick
    # ({ts, decision, workers, queue, kv, waiting[, load, target]}), for
    # inspection after the fact. None disables.
    decision_log_path: str | None = None


class WorkerConnector(Protocol):
    """Deployment backend: spawn/retire one worker. ``alive`` is
    optional — connectors exposing it opt their pools into crash
    healing (pools.WorkerPool.reap_dead)."""

    async def spawn(self) -> object: ...
    async def drain(self, handle: object) -> None: ...


class SubprocessConnector:
    """Spawns workers as OS processes from a shell command template.

    ``cmd`` runs under the shell with ``{index}`` substituted; retirement
    sends SIGTERM (prefill workers finish their current item; decode workers
    drop their lease on shutdown)."""

    def __init__(self, cmd: str) -> None:
        self.cmd = cmd
        self._count = 0

    async def spawn(self) -> subprocess.Popen:
        self._count += 1
        cmd = self.cmd.format(index=self._count)
        logger.info("planner: spawning worker: %s", cmd)
        # fork/exec can stall the loop for tens of ms under memory
        # pressure; the planner shares its loop with the metrics watch.
        return await asyncio.to_thread(
            subprocess.Popen, cmd, shell=True, start_new_session=True
        )

    # Checkpointed alongside the worker pids so a planner restart doesn't
    # hand out {index} values still held by adopted workers.
    def snapshot(self) -> dict:
        return {"count": self._count}

    def restore(self, state: dict) -> None:
        self._count = max(self._count, int(state.get("count", 0)))

    def alive(self, handle) -> bool:
        """Crash detection for pools.reap_dead: a spawned Popen that
        exited (poll() returns its code) or an adopted pid that vanished
        is DEAD — it gets replaced immediately, with none of drain's
        grace accounting (crash ≠ drain)."""
        poll = getattr(handle, "poll", None)
        if poll is not None:
            return poll() is None
        try:
            os.kill(handle.pid, 0)
        except (ProcessLookupError, PermissionError):
            return False
        return True

    async def drain(self, handle) -> None:
        logger.info("planner: draining worker pid %d", handle.pid)
        handle.send_signal(signal.SIGTERM)
        try:
            await asyncio.to_thread(handle.wait, 30)
        except subprocess.TimeoutExpired:
            # A worker stuck past the grace period (mid graph capture,
            # say) must not keep holding its card after the planner
            # released it.
            logger.warning("worker pid %d ignored SIGTERM; killing", handle.pid)
            handle.kill()
            await asyncio.to_thread(handle.wait)
        # An adopted worker is not this process's child: no exit code.
        logger.info("planner: worker pid %d exited (code %s)", handle.pid,
                    getattr(handle, "returncode", None))

    def adopt(self, pid: int, started: float | None = None):
        """Re-attach a worker from a previous planner life (checkpoint
        resume). Returns a drain-able handle, or None if the pid is gone —
        or was RECYCLED: the checkpointed process start time must match, so
        the planner never SIGTERMs an unrelated process that inherited the
        pid after a reboot/crash."""
        try:
            os.kill(pid, 0)
        except (ProcessLookupError, PermissionError):
            return None
        if started is not None:
            now_started = _proc_start_ticks(pid)
            if now_started is not None and now_started != started:
                logger.info(
                    "planner: pid %d was recycled (start %s != %s); "
                    "not adopting", pid, now_started, started,
                )
                return None
        return _AdoptedProcess(pid)


def _proc_start_ticks(pid: int) -> float | None:
    """Kernel start time of `pid` in clock ticks (/proc/<pid>/stat field 22);
    None where /proc isn't available."""
    try:
        stat = Path(f"/proc/{pid}/stat").read_text()
    except OSError:
        return None
    # Field 2 (comm) may contain spaces/parens — split after the last ')'.
    fields = stat.rsplit(")", 1)[-1].split()
    return float(fields[19])  # 22nd overall; 20th after pid+comm


class _AdoptedProcess:
    """A worker process we didn't spawn this life but still own: quacks
    enough like Popen for SubprocessConnector.drain."""

    def __init__(self, pid: int) -> None:
        self.pid = pid

    def send_signal(self, sig: int) -> None:
        try:
            os.kill(self.pid, sig)
        except ProcessLookupError:
            pass

    def kill(self) -> None:
        self.send_signal(signal.SIGKILL)

    def wait(self, timeout: float | None = None) -> None:
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            try:
                os.kill(self.pid, 0)
            except (ProcessLookupError, PermissionError):
                return
            if deadline is not None and time.monotonic() > deadline:
                raise subprocess.TimeoutExpired(f"pid {self.pid}", timeout)
            time.sleep(0.1)


@dataclass
class _Window:
    """One observation window's accumulated samples."""

    queue_depths: list[int] = field(default_factory=list)
    kv_usages: list[float] = field(default_factory=list)
    waitings: list[float] = field(default_factory=list)
    loads: list[float] = field(default_factory=list)  # total concurrency

    def add(self, depth: int, metrics: dict[int, ForwardPassMetrics]) -> None:
        self.queue_depths.append(depth)
        # Observed total concurrent demand (the perf profile's concurrency
        # axis): running + waiting across the pool, OR the queue depth when
        # it's larger / when no metrics arrive. max() rather than sum
        # because a queued remote prefill is usually ALSO an admitted
        # decode-side slot — summing would double-count every disagg
        # request — while depth alone keeps a backlog visible when the
        # metrics plane is empty (fresh spawn, crashed workers).
        load = float(depth)
        if metrics:
            vals = list(metrics.values())
            self.kv_usages.append(
                sum(m.gpu_cache_usage_perc for m in vals) / len(vals)
            )
            self.waitings.append(
                sum(m.num_requests_waiting for m in vals) / len(vals)
            )
            load = max(
                load,
                float(
                    sum(
                        m.request_active_slots + m.num_requests_waiting
                        for m in vals
                    )
                ),
            )
        self.loads.append(load)

    @staticmethod
    def _avg(xs: list) -> float:
        return sum(xs) / len(xs) if xs else 0.0

    @property
    def avg_queue(self) -> float:
        return self._avg(self.queue_depths)

    @property
    def avg_kv(self) -> float:
        return self._avg(self.kv_usages)

    @property
    def avg_waiting(self) -> float:
        return self._avg(self.waitings)

    @property
    def avg_load(self) -> float:
        return self._avg(self.loads)


class Planner:
    def __init__(
        self,
        drt,
        cfg: PlannerConfig,
        connector: WorkerConnector | None = None,
        worker_cmd: str | None = None,
        profile=None,  # PerfProfile for SLA-driven scaling (profiles.py)
    ) -> None:
        if connector is None:
            if worker_cmd is None:
                raise ValueError("need a connector or --worker-cmd")
            connector = SubprocessConnector(worker_cmd)
        from dynamo_tpu_torch.disagg.queue import PrefillQueue

        self._drt = drt
        self.cfg = cfg
        self.connector = connector
        # Reuse PrefillQueue so the queue-name contract lives in one place.
        self._queue = PrefillQueue(drt, cfg.namespace)
        self._aggregator: KvMetricsAggregator | None = None
        self._handles: list[object] = []
        self._task: asyncio.Task | None = None
        self.decisions: list[str] = []  # audit log ("up"/"down"/"hold")
        self.profile = profile

    @property
    def num_workers(self) -> int:
        return len(self._handles)

    # -- checkpoint/resume -------------------------------------------------
    def _save_state(self) -> None:
        if self.cfg.state_path is None:
            return
        path = Path(self.cfg.state_path)
        path.parent.mkdir(parents=True, exist_ok=True)
        workers = []
        for h in self._handles:
            pid = getattr(h, "pid", None)
            workers.append(
                {
                    "pid": pid,
                    "started": (
                        _proc_start_ticks(pid) if pid is not None else None
                    ),
                }
            )
        snapshot = getattr(self.connector, "snapshot", None)
        state = {
            "namespace": self.cfg.namespace,
            "workers": workers,
            "connector": snapshot() if snapshot is not None else {},
            "decisions": self.decisions[-32:],
            "ts": time.time(),
        }
        # Atomic AND durable (utils/atomic_io): the bare rename left the
        # replace able to roll back to a zero-length file across power
        # loss — which _resume_state would read as "start fresh" and
        # orphan every checkpointed worker.
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
        if isinstance(state, dict) and (
            state.get("version", 1) >= 2 or "pools" in state
        ):
            # A two-pool fleet checkpoint (planner/fleet.py). Silently
            # ignoring it would adopt NOTHING, spawn fresh workers, and
            # then overwrite the file in v1 format — orphaning every
            # worker the fleet planner had checkpointed (they'd hold
            # their cards forever, unmanaged). Refuse loudly instead.
            raise RuntimeError(
                f"planner state {path} was written by the two-pool fleet "
                "planner — restart with --two-pool (or move the state "
                "file) instead of orphaning its workers"
            )
        restore = getattr(self.connector, "restore", None)
        if restore is not None and state.get("connector"):
            restore(state["connector"])
        adopt = getattr(self.connector, "adopt", None)
        if adopt is None:
            return
        alive = 0
        for w in state.get("workers") or []:
            if isinstance(w, dict):
                pid, started = w.get("pid"), w.get("started")
            else:  # older state files stored bare pids
                pid, started = w, None
            if pid is None:
                continue
            try:
                handle = adopt(pid, started)
            except TypeError:  # connector with a pid-only adopt()
                handle = adopt(pid)
            if handle is not None:
                self._handles.append(handle)
                alive += 1
        if alive:
            logger.info(
                "planner: resumed %d worker(s) from %s", alive, path
            )

    async def start(self) -> "Planner":
        comp = self._drt.namespace(self.cfg.namespace).component(
            self.cfg.component
        )
        self._aggregator = await KvMetricsAggregator(
            self._drt, comp, interval_s=self.cfg.metric_interval_s
        ).start()
        self._resume_state()
        while len(self._handles) < self.cfg.min_workers:
            self._handles.append(await self.connector.spawn())
        self._save_state()
        self._task = asyncio.ensure_future(self._run())
        return self

    async def _run(self) -> None:
        window = _Window()
        next_adjust = (
            asyncio.get_running_loop().time() + self.cfg.adjustment_interval_s
        )
        while True:
            try:
                depth = await self._queue.depth()
                window.add(depth, self._aggregator.endpoints.metrics)
            except asyncio.CancelledError:
                return
            except Exception:
                logger.exception("planner metric sample failed")
            if asyncio.get_running_loop().time() >= next_adjust:
                try:
                    await self._adjust(window)
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

    async def _adjust(self, w: _Window) -> None:
        cfg = self.cfg
        n = len(self._handles)
        if self.profile is not None and (
            cfg.ttft_sla_ms is not None or cfg.itl_sla_ms is not None
        ):
            await self._adjust_sla(w, n)
            return
        pressure = (
            w.avg_queue > cfg.queue_up_threshold
            or w.avg_kv > cfg.kv_up_threshold
            or w.avg_waiting > cfg.waiting_up_threshold
        )
        idle = (
            w.avg_queue < cfg.queue_down_threshold
            and w.avg_kv < cfg.kv_down_threshold
            and w.avg_waiting < cfg.waiting_down_threshold
        )
        if pressure and n < cfg.max_workers:
            logger.info(
                "planner: scale UP %d->%d (queue %.2f kv %.2f waiting %.2f)",
                n, n + 1, w.avg_queue, w.avg_kv, w.avg_waiting,
            )
            self._handles.append(await self.connector.spawn())
            self.decisions.append("up")
        elif idle and n > cfg.min_workers:
            logger.info(
                "planner: scale DOWN %d->%d (queue %.2f kv %.2f)",
                n, n - 1, w.avg_queue, w.avg_kv,
            )
            handle = self._handles.pop()
            await self.connector.drain(handle)
            self.decisions.append("down")
        else:
            self.decisions.append("hold")
        self._log_decision(w)
        self._save_state()

    async def _adjust_sla(self, w: _Window, n: int) -> None:
        """Profile-driven scaling: workers needed = observed load /
        per-worker SLA capacity, stepped ±1 per interval toward the
        target within the card budget."""
        cfg = self.cfg
        target = self.profile.target_workers(
            w.avg_load,
            ttft_sla_ms=cfg.ttft_sla_ms,
            itl_sla_ms=cfg.itl_sla_ms,
        )
        target = max(cfg.min_workers, min(cfg.max_workers, target))
        if target > n:
            logger.info(
                "planner[sla]: scale UP %d->%d (load %.1f, target %d)",
                n, n + 1, w.avg_load, target,
            )
            self._handles.append(await self.connector.spawn())
            self.decisions.append("up")
        elif target < n:
            logger.info(
                "planner[sla]: scale DOWN %d->%d (load %.1f, target %d)",
                n, n - 1, w.avg_load, target,
            )
            await self.connector.drain(self._handles.pop())
            self.decisions.append("down")
        else:
            self.decisions.append("hold")
        self._log_decision(w, load=w.avg_load, target=target)
        self._save_state()

    def _log_decision(self, w: _Window, **extra) -> None:
        """Append one adjustment tick to the decision JSONL (see
        PlannerConfig.decision_log_path). Append-only so an operator can
        tail/plot it live; write failures never break the control loop.

        The same decision also lands on the metric surfaces and in the
        ``DYNTPU_TRACE`` capture via the planner observatory
        (planner/obs.py) — the JSONL used to be the ONLY sink, which
        left a flapping planner invisible to Prometheus. The legacy
        single pool reports under the pool name ``worker``."""
        from dynamo_tpu_torch.planner.obs import PLANNER_OBS
        from dynamo_tpu_torch.utils.tracing import tracer

        decision = self.decisions[-1] if self.decisions else "hold"
        rec = PLANNER_OBS.note_decision(
            "worker",
            decision,
            len(self._handles),
            signals={
                "queue": w.avg_queue,
                "kv": w.avg_kv,
                "waiting": w.avg_waiting,
                **extra,
            },
        )
        tracer().export(rec)
        if self.cfg.decision_log_path is None:
            return
        line = {
            "ts": round(time.time(), 3),
            "decision": decision,
            "workers": len(self._handles),
            "queue": round(w.avg_queue, 4),
            "kv": round(w.avg_kv, 4),
            "waiting": round(w.avg_waiting, 4),
            **{k: round(v, 4) for k, v in extra.items()},
        }
        try:
            path = Path(self.cfg.decision_log_path)
            path.parent.mkdir(parents=True, exist_ok=True)
            with path.open("a") as f:
                f.write(json.dumps(line) + "\n")
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
            while self._handles:
                await self.connector.drain(self._handles.pop())
        self._save_state()
