"""Replicated-ingress trace replay on the mocker (port of
benchmarks/ingress_bench.py; CPU only, no card).

    python -m dynamo_tpu_torch.tools.ingress_bench [--requests N]
        [--workers W] [--replicas R] [--seed S]

Replays a Mooncake-style trace — prompts that share a prefix tree plus
unique suffixes, ~25% of them batch class — through the replicated
ingress of the port:

    client → admission gate (SLO-class-weighted watermarks,
    load-proportional Retry-After) → FailoverEngine → PushRouter (round
    robin over the ROUTER REPLICAS) → bus → RouterService replica (its
    own KvIndexerSharded and KvMetricsAggregator, KV-aware worker pick,
    its own FailoverEngine) → bus → one of the mocker workers → TCP
    response stream relayed back through the replica.

Each worker's block arena is sized from the trace's own LRU
hit-rate-against-size curve (``analyze``). Mid-replay one router replica
is killed abruptly (frame-less response aborts, discovery left dirty: a
crashed process) and rejoins later with a fresh, empty radix view; the
events it missed are measured as its applied-watermark lag
(``RouterReplicaSet.staleness``). A mid-run overload burst drives the
admission gate into its class-weighted band. Pacing is closed-loop (a
concurrency cap in arrival order), so no gate bets on host speed.

Gates (``run_gates``): no lost or hung request; per-class p99 TTFT under
its SLO (or 8× its p50 on a slow host); no cross-class SLO inversion;
the burst sheds batch first; every replica's route-audit error p95 under
its bound over the merged capture (``DYNTPU_TRACE``); the rejoined
replica's staleness measured above zero.

The trace synthesizer and the LRU analysis are this module's own copies
of the JAX package's benchmark helpers; block hashes are the port's
(BLAKE2b), so the two tools' curves differ in hash identity only.
"""

from __future__ import annotations

import asyncio
import logging
import os
import random
import sys
import time
from collections import OrderedDict

import numpy as np

logger = logging.getLogger(__name__)

#: Token values stay in [1, 250]: CPython interns small ints, so a long
#: trace of list[int] prompts stays small. Prefix-hash identity is over
#: token SEQUENCES, so a small alphabet loses no radix structure.
VOCAB = 250


def synth_prompts(
    num_requests: int, isl_mean: int, vocab_size: int, seed: int,
    reuse: float = 0.5, branching: int = 3, depth: int = 3,
) -> list[list[int]]:
    """Prompts of a random prefix tree: each node carries a run of
    tokens; a prompt is a root→node path (its shared prefix, depth 1
    the "system prompts", deeper nodes conversation turns) plus a unique
    suffix (the synthesizer law of benchmarks/synthesizer.py)."""
    rng = np.random.default_rng(seed)
    prefix_budget = max(1, int(isl_mean * reuse))
    run_len = max(1, prefix_budget // max(depth, 1))

    def grow(level: int) -> dict:
        node = {"tokens": rng.integers(0, vocab_size, run_len).tolist(), "children": []}
        if level < depth:
            node["children"] = [grow(level + 1) for _ in range(branching)]
        return node

    root = grow(1)

    def sample_path() -> list[int]:
        out: list[int] = []
        node = root
        while True:
            out += node["tokens"]
            if not node["children"] or rng.random() < 0.25:
                return out
            node = node["children"][int(rng.integers(len(node["children"])))]

    prompts = []
    for _ in range(num_requests):
        prefix = sample_path() if reuse > 0 else []
        suffix_len = max(1, int(rng.normal(isl_mean - len(prefix), isl_mean * 0.1)))
        tokens = prefix + rng.integers(0, vocab_size, suffix_len).tolist()
        rng.normal(0, 1)   # the synthesizer's output-length draw, kept for its stream
        prompts.append(tokens)
    return prompts


def build_trace(
    requests: int, isl_mean: int, osl: int, seed: int
) -> tuple[list[list[int]], list[str]]:
    """Mooncake-style trace: prompts of a shared prefix tree and a
    deterministic SLO class per request (~25% batch). Returns (prompts,
    classes)."""
    del osl  # every request asks for the replay's fixed output length
    prompts = [[max(1, t) for t in p]
               for p in synth_prompts(requests, isl_mean, VOCAB, seed)]
    rng = random.Random(seed + 1)
    classes = ["batch" if rng.random() < 0.25 else "interactive" for _ in prompts]
    return prompts, classes


def _lru_replay(hash_lists: list[list[int]], capacity: int) -> float:
    """Hit rate of an LRU block cache of ``capacity`` blocks over the
    trace in arrival order (a hit refreshes recency, a miss inserts and
    evicts the coldest)."""
    lru: OrderedDict[int, None] = OrderedDict()
    hits = total = 0
    for hashes in hash_lists:
        for h in hashes:
            total += 1
            if h in lru:
                hits += 1
                lru.move_to_end(h)
            else:
                lru[h] = None
                if len(lru) > capacity:
                    lru.popitem(last=False)
    return hits / total if total else 0.0


def analyze(prompts: list[list[int]], block_size: int = 16) -> dict:
    """The trace's prefix-cache curve: per request the chained hashes of
    its full prompt blocks, the ideal (infinite-cache) hit rate, and the
    LRU hit rate at cache sizes 16, 64, 256, … up to the unique blocks."""
    from dynamo_tpu_torch.llm.tokens import TokenBlockSequence

    hash_lists = []
    for p in prompts:
        n_full = len(p) // block_size
        hash_lists.append([] if n_full == 0 else list(TokenBlockSequence.from_tokens(
            list(p[: n_full * block_size]), block_size=block_size
        ).sequence_hashes()[:n_full]))
    total_blocks = sum(len(h) for h in hash_lists)
    unique_blocks = len({h for hl in hash_lists for h in hl})
    sizes, n = [], 16
    while n < unique_blocks:
        sizes.append(n)
        n *= 4
    sizes.append(max(unique_blocks, 16))
    return {
        "requests": len(prompts), "block_size": block_size,
        "total_prompt_blocks": total_blocks, "unique_prompt_blocks": unique_blocks,
        "ideal_hit_rate": round((total_blocks - unique_blocks) / total_blocks, 4)
        if total_blocks else 0.0,
        "curve": [{"cache_blocks": c, "hit_rate": round(_lru_replay(hash_lists, c), 4)}
                  for c in sorted(set(sizes))],
    }


def size_prefix_cache(
    prompts: list[list[int]], block_size: int,
    active_floor: int, sample: int = 10_000,
) -> tuple[int, dict]:
    """Size each worker's block arena from the trace's own LRU
    hit-rate-against-size curve (``analyze``): the smallest
    capacity reaching ≥80% of the largest-cache hit rate, floored by
    what concurrent actives need. Returns (num_blocks, analyzer report
    on the sample)."""
    report = analyze(prompts[: min(sample, len(prompts))], block_size=block_size)
    curve = report["curve"]
    best = max((pt["hit_rate"] for pt in curve), default=0.0)
    chosen = curve[-1]["cache_blocks"] if curve else active_floor
    for pt in curve:
        if best > 0 and pt["hit_rate"] >= 0.8 * best:
            chosen = pt["cache_blocks"]
            break
    per_worker = max(active_floor, chosen)
    return per_worker, report


async def run_ingress(
    requests: int = 100_000,
    workers: int = 8,
    replicas: int = 2,
    isl_mean: int = 96,
    osl: int = 3,
    concurrency: int = 128,
    seed: int = 20260805,
    slo_interactive_ms: float = 4_000.0,
    slo_batch_ms: float = 20_000.0,
    kill_at: float = 0.35,
    rejoin_at: float = 0.55,
    burst_at: float = 0.70,
    max_inflight: int = 420,
    max_engine_waiting: int = 400,
    burst_extra: int = 160,
    burst_attempts: int = 600,
    watchdog_s: float = 180.0,
) -> dict:
    from dynamo_tpu_torch.engine.config import EngineConfig
    from dynamo_tpu_torch.llm.admission import (
        AdmissionConfig,
        AdmissionController,
        AdmissionRejected,
    )
    from dynamo_tpu_torch.llm.kv_router.publisher import (
        KvEventPublisher,
        WorkerMetricsPublisher,
    )
    from dynamo_tpu_torch.llm.kv_router.replicas import RouterReplicaSet
    from dynamo_tpu_torch.llm.kv_router.scheduler import KvRouterConfig
    from dynamo_tpu_torch.llm.protocols.common import (
        PreprocessedRequest,
        SamplingOptions,
        StopConditions,
    )
    from dynamo_tpu_torch.mocker import MockerConfig, MockerEngine
    from dynamo_tpu_torch.models.config import ModelConfig
    from dynamo_tpu_torch.runtime.distributed import DistributedRuntime
    from dynamo_tpu_torch.runtime.egress import PushRouter
    from dynamo_tpu_torch.runtime.engine import Context
    from dynamo_tpu_torch.runtime.failover import FailoverEngine
    from dynamo_tpu_torch.utils.tracing import tracer

    t_start = time.monotonic()
    prompts, classes = build_trace(requests, isl_mean, osl, seed)
    block_size = 16
    # Active floor: every lane of every worker funded for prompt + osl.
    blocks_per_seq = (isl_mean + osl) // block_size + 2
    max_num_seqs = 64
    active_floor = max_num_seqs * blocks_per_seq
    num_blocks, prefix_report = size_prefix_cache(
        prompts, block_size, active_floor
    )
    logger.warning(
        "ingress replay: %d requests, %d workers x %d blocks "
        "(prefix-analyzer knee; ideal hit %.1f%%), %d replicas",
        requests, workers, num_blocks, 100 * prefix_report[
            "ideal_hit_rate"
        ], replicas,
    )

    cfg = EngineConfig(
        model=ModelConfig.tiny_test(),
        num_blocks=num_blocks,
        max_num_seqs=max_num_seqs,
        max_model_len=512,
        dtype="float32",
        # Overload is shed at the ADMISSION gate (class-weighted, the
        # contract under test); engine-side bounds stay off so every
        # 429 is attributable to the gate.
        max_waiting=0,
    )

    drt0 = await DistributedRuntime.in_process()

    async def sub_drt():
        return await DistributedRuntime.in_process(
            store=drt0.store, bus=drt0.bus, runtime=drt0.runtime
        )

    # -- the worker fleet --------------------------------------------------
    engines = []
    instances = []
    for i in range(workers):
        drt = await sub_drt()
        comp = drt.namespace("ingress").component("worker")
        wm = WorkerMetricsPublisher()
        pub = KvEventPublisher(drt, comp, drt.primary_lease_id)
        eng = MockerEngine(cfg, MockerConfig(
            seed=i,
            vocab_size=VOCAB,
            decode_time_per_step_us=800.0,
            prefill_time_per_token_us=1.0,
        ))
        eng._external_kv_event = pub.publish_engine_event
        eng._on_metrics = wm.publish
        eng._on_kv_actual = pub.publish_hit_actual
        await eng.start()
        instances.append(
            await comp.endpoint("generate").serve(eng)
        )
        await wm.create_endpoint(comp)
        engines.append(eng)

    # -- the router replica set --------------------------------------------
    replica_set = await RouterReplicaSet(
        sub_drt, "ingress.worker.generate",
        cfg=KvRouterConfig(block_size=block_size),
    ).start(replicas)

    # -- the frontend ------------------------------------------------------
    # Tight connect-back bound: a request dispatched INTO the replica
    # kill window stalls exactly this long before the mark-dead fast
    # path + failover re-route it — it is the dominant term in the
    # post-kill TTFT tail.
    push = await PushRouter.create(
        drt0, "ingress.router.generate", connect_timeout_s=2.0
    )
    front = FailoverEngine(push)

    def fleet_stats() -> dict:
        # Aggregate live pressure across the fleet — the admission
        # watermark feed (one frontend, N engines).
        return {
            "num_requests_waiting": sum(
                len(e.scheduler.waiting) for e in engines
                if e.scheduler is not None
            ),
        }

    # The class-weighted gate: the frontend inflight cap is the primary
    # axis (it sees the cell's whole backlog — engine queues, bus, TCP
    # relays — which is exactly what a production ingress caps); the
    # engine-waiting watermark rides as the backstop for deployments
    # whose backlog concentrates at the schedulers. Batch trips either
    # at HALF the configured level (AdmissionConfig defaults).
    admission = AdmissionController(
        AdmissionConfig(
            max_inflight=max_inflight,
            max_engine_waiting=max_engine_waiting,
            retry_after_s=1.0,
            retry_after_max_s=30.0,
        ),
        engine_stats=fleet_stats,
    )

    # -- per-request client ------------------------------------------------
    # (status, cls, ttft_ms, done_t, origin, detail); appends are
    # loop-thread-only (asyncio tasks), no lock needed.
    results: list[tuple] = []

    async def one(idx: int, prompt: list[int], cls: str,
                  origin: str = "trace") -> tuple:
        status, ttft_ms, detail = "ok", -1.0, ""
        try:
            permit = admission.admit(request_class=cls)
        except AdmissionRejected as exc:
            return ("shed", cls, -1.0, time.monotonic() - t_start,
                    origin, f"{exc.reason}:{exc.retry_after_s:g}")
        req = PreprocessedRequest(
            token_ids=prompt,
            sampling=SamplingOptions(temperature=0.0),
            stop=StopConditions(max_tokens=osl, ignore_eos=True),
            annotations={"request_class": cls},
        )
        ctx = Context(req.to_wire())
        t0 = time.monotonic()
        toks = 0
        try:
            async for item in front.generate(ctx):
                got = item.get("token_ids", [])
                if got and ttft_ms < 0:
                    ttft_ms = 1000.0 * (time.monotonic() - t0)
                toks += len(got)
            if toks < osl:
                status, detail = "short", f"{toks}/{osl} tokens"
        except Exception as exc:  # noqa: BLE001 — classified by the gates
            status, detail = "error", f"{type(exc).__name__}: {exc}"
        finally:
            permit.release()
            tracer().finish(ctx.id)
        return (status, cls, ttft_ms, time.monotonic() - t_start,
                origin, detail)

    async def guarded(idx, prompt, cls, origin="trace"):
        try:
            r = await asyncio.wait_for(
                one(idx, prompt, cls, origin), watchdog_s
            )
        except asyncio.TimeoutError:
            r = ("hang", cls, -1.0, time.monotonic() - t_start,
                 origin, f"req {idx}: WATCHDOG")
        results.append(r)
        return r

    # -- chaos + staleness instrumentation --------------------------------
    progress = {"done": 0}
    kill_n = int(requests * kill_at)
    rejoin_n = int(requests * rejoin_at)
    burst_n = int(requests * burst_at)
    chaos = {
        "killed_at": None, "rejoined_at": None,
        "burst": None, "staleness_samples": [],
    }
    killed_replica = {"handle": None}

    async def chaos_loop():
        while progress["done"] < requests:
            done = progress["done"]
            if chaos["killed_at"] is None and done >= kill_n:
                h = replica_set.replicas[0]
                killed_replica["handle"] = h
                await replica_set.kill(h)
                chaos["killed_at"] = done
            if (
                chaos["killed_at"] is not None
                and chaos["rejoined_at"] is None
                and done >= rejoin_n
            ):
                await replica_set.rejoin(killed_replica["handle"])
                chaos["rejoined_at"] = done
            if chaos["rejoined_at"] is not None:
                st = replica_set.staleness()
                chaos["staleness_samples"].append({
                    "done": done,
                    "rejoined_lag": st["replicas"][0]["applied_lag"],
                    "applied_max": st["applied_max"],
                })
            await asyncio.sleep(0.25)

    chaos_task = asyncio.ensure_future(chaos_loop())

    # -- the replay: closed-loop arrival-order pacing ----------------------
    sem = asyncio.Semaphore(concurrency)
    inflight: set[asyncio.Task] = set()

    async def paced(idx):
        try:
            await guarded(idx, prompts[idx], classes[idx])
        finally:
            progress["done"] += 1
            sem.release()

    burst_tasks: list[asyncio.Task] = []
    burst_stats = {"batch_shed": 0, "batch_sent": 0,
                   "interactive_shed": 0, "interactive_sent": 0}

    async def overload_burst():
        """Extra offered load past the trace's closed loop, itself
        closed-loop at ``burst_extra`` additional in-flight: total
        admitted load is pinned INSIDE the class-weighted band — above
        the batch inflight threshold (``max_inflight/2``), below the
        interactive cap — on any machine speed, which is the
        cheapest-first design point: batch arrivals 429 with a
        load-proportional Retry-After while every interactive arrival
        is admitted and served. Sheds hold no slot, so the burst loop
        keeps offering through its attempt budget. Shed counts come
        from the burst's OWN result rows (origin == "burst"), never a
        delta of the process-global admission counters — the trace loop
        keeps running through the window and its sheds must not be
        misattributed to (or masked by) the burst."""
        rng = random.Random(seed + 2)
        bsem = asyncio.Semaphore(burst_extra)
        sent = []

        async def burst_one(j: int, cls: str, p: list[int]) -> tuple:
            try:
                return await guarded(requests + j, p, cls, origin="burst")
            finally:
                bsem.release()

        for j in range(burst_attempts):
            cls = "batch" if rng.random() < 0.5 else "interactive"
            burst_stats[f"{cls}_sent"] += 1
            p = prompts[rng.randrange(len(prompts))]
            await bsem.acquire()
            sent.append(asyncio.ensure_future(burst_one(j, cls, p)))
        burst_tasks.extend(sent)
        outcomes = await asyncio.gather(*sent)
        for st, cls, _t, _dt, _origin, _d in outcomes:
            if st == "shed":
                burst_stats[f"{cls}_shed"] += 1
        chaos["burst"] = dict(burst_stats)

    burst_fired = {"task": None}
    for idx in range(requests):
        await sem.acquire()
        t = asyncio.ensure_future(paced(idx))
        inflight.add(t)
        t.add_done_callback(inflight.discard)
        if burst_fired["task"] is None and idx >= burst_n:
            burst_fired["task"] = asyncio.ensure_future(overload_burst())
    if burst_fired["task"] is None:  # tiny runs: fire at the end
        burst_fired["task"] = asyncio.ensure_future(overload_burst())
    await asyncio.gather(*list(inflight))
    await burst_fired["task"]
    await chaos_task
    wall_s = time.monotonic() - t_start

    # Let the engines' kv_actual exports + plane broadcasts flush.
    await asyncio.sleep(0.5)

    # -- digest ------------------------------------------------------------
    # The zero-lost/zero-hung gates cover BOTH populations (trace +
    # burst extras); the resolved-count check covers the trace only
    # (burst extras are deliberate over-offer, mostly shed); TTFT
    # samples come from every ADMITTED request — holding interactive
    # p99 THROUGH the burst is the point.
    by_status: dict[str, int] = {}
    sheds_by_class = {"interactive": 0, "batch": 0}
    trace_rows = 0
    for st, cls, _t, _dt, origin, _d in results:
        by_status[st] = by_status.get(st, 0) + 1
        if st == "shed":
            sheds_by_class[cls] = sheds_by_class.get(cls, 0) + 1
        if origin == "trace":
            trace_rows += 1

    # One percentile definition across the tool set (route_audit reuses
    # trace_merge's on purpose — a third local rank rule is drift).
    from dynamo_tpu_torch.tools.route_audit import _pctl as pctl

    ttft: dict[str, list[float]] = {"interactive": [], "batch": []}
    windows: dict[int, dict[str, list[float]]] = {}
    horizon = max(r[3] for r in results) if results else 1.0
    n_windows = 20
    for st, cls, t_ms, done_t, _origin, _d in results:
        if st == "ok" and t_ms >= 0:
            ttft[cls].append(t_ms)
            w = min(n_windows - 1, int(n_windows * done_t / horizon))
            windows.setdefault(w, {"interactive": [], "batch": []})[
                cls
            ].append(t_ms)
    inversions = []
    for w, split in sorted(windows.items()):
        if not split["interactive"] or not split["batch"]:
            continue
        pi = pctl(split["interactive"], 0.99)
        pb = pctl(split["batch"], 0.99)
        # A cross-class SLO inversion is the cell FAVORING batch while
        # interactive suffers: interactive misses its SLO in a window
        # where batch both meets its own AND is being served materially
        # faster. General overload (both classes slow together) is the
        # overall p99 gate's job, not an inversion.
        if (
            pi > slo_interactive_ms
            and pb <= slo_batch_ms
            and pb < 0.9 * pi
        ):
            inversions.append(
                {"window": w, "interactive_p99": round(pi, 1),
                 "batch_p99": round(pb, 1)}
            )

    staleness = replica_set.staleness()
    rejoined_lag_max = max(
        (s["rejoined_lag"] for s in chaos["staleness_samples"]),
        default=0,
    )
    adm = admission.snapshot()

    n_burst = len(results) - trace_rows
    report = {
        "requests": requests,
        "workers": workers,
        "replicas": replicas,
        "resolved": trace_rows,
        "burst_extras": n_burst,
        "by_status": by_status,
        "wall_s": round(wall_s, 1),
        "req_per_s": round((requests + n_burst) / max(wall_s, 1e-9), 1),
        "ttft_p50_ms": {
            cls: round(pctl(v, 0.50), 1) for cls, v in ttft.items()
        },
        "ttft_p99_ms": {
            cls: round(pctl(v, 0.99), 1) for cls, v in ttft.items()
        },
        "slo_ms": {
            "interactive": slo_interactive_ms, "batch": slo_batch_ms,
        },
        "inversions": inversions,
        "sheds_by_class": sheds_by_class,
        "chaos": {
            "killed_at_request": chaos["killed_at"],
            "rejoined_at_request": chaos["rejoined_at"],
            "rejoined_lag_max": rejoined_lag_max,
            "staleness_samples": len(chaos["staleness_samples"]),
            "staleness_final": staleness,
        },
        "burst": dict(burst_stats),
        "admission": adm,
        "prefix_cache": {
            "num_blocks_per_worker": num_blocks,
            "ideal_hit_rate": prefix_report["ideal_hit_rate"],
            "curve": prefix_report["curve"],
        },
        "failover": None,   # filled below
        "trace_capture": os.environ.get("DYNTPU_TRACE", ""),
    }
    from dynamo_tpu_torch.runtime.failover import FAILOVER

    report["failover"] = {
        "failover_total": dict(FAILOVER.attempts_by_reason),
        "failover_success_total": dict(FAILOVER.success_by_reason),
        "workers_marked_dead_total": dict(FAILOVER.marked_dead_by_reason),
    }

    # -- teardown ----------------------------------------------------------
    await replica_set.stop()
    for inst, eng in zip(instances, engines):
        try:
            await inst.stop()
        except Exception:  # noqa: BLE001 — teardown
            pass
        await eng.stop()
    await drt0.shutdown()
    return report


def run_gates(
    report: dict, max_abs_p95: float = 4.0, tail_ratio: float = 8.0,
) -> list[str]:
    """The hard gates over the replay report + the merged multi-replica
    capture (tools/route_audit.py). Returns failures (empty = green).

    The per-class TTFT bound is ``max(SLO, tail_ratio * p50)``: the
    nominal SLO on a machine fast enough to be meaningful, and a
    machine-speed-normalized tail check everywhere else — a slow/shared
    CI host raises p50 and p99 together, while the failure this gate
    exists to catch (an overload spiral, a class being starved) blows
    the p99/p50 ratio out regardless of host speed."""
    failures: list[str] = []
    by = report["by_status"]
    if by.get("hang"):
        failures.append(f"{by['hang']} request(s) HUNG past the watchdog")
    if by.get("error"):
        failures.append(
            f"{by['error']} request(s) errored — the replica kill must "
            "be absorbed by failover while a healthy replica remains"
        )
    if by.get("short"):
        failures.append(
            f"{by['short']} request(s) LOST tokens (short streams)"
        )
    if report["resolved"] < report["requests"]:
        failures.append(
            f"only {report['resolved']}/{report['requests']} trace "
            "requests resolved"
        )
    # Per-class SLOs + inversion windows.
    for cls in ("interactive", "batch"):
        p99 = report["ttft_p99_ms"].get(cls, 0.0)
        p50 = report["ttft_p50_ms"].get(cls, 0.0)
        slo = report["slo_ms"][cls]
        bound = max(slo, tail_ratio * p50)
        if p99 > bound:
            failures.append(
                f"{cls} p99 TTFT {p99:.0f} ms > bound {bound:.0f} ms "
                f"(SLO {slo:.0f}, {tail_ratio:g}x p50 {p50:.0f})"
            )
    if report["inversions"]:
        failures.append(
            f"{len(report['inversions'])} cross-class SLO inversion "
            f"window(s): {report['inversions'][:3]}"
        )
    # Cheapest-first shedding: the burst's OWN batch arrivals must have
    # been refused, and interactive sheds — from ANY origin, the trace
    # loop included — must stay negligible next to batch's.
    burst = report["burst"]
    total_sheds = report.get("sheds_by_class", {})
    batch_shed_total = total_sheds.get(
        "batch", burst.get("batch_shed", 0)
    )
    interactive_shed_total = total_sheds.get(
        "interactive", burst.get("interactive_shed", 0)
    )
    if burst.get("batch_shed", 0) <= 0:
        failures.append(
            "overload burst shed ZERO batch requests — the class-"
            "weighted watermark never engaged"
        )
    if interactive_shed_total > max(2, batch_shed_total // 10):
        failures.append(
            f"interactive absorbed sheds ({interactive_shed_total} vs "
            f"batch {batch_shed_total}, all origins) — degradation is "
            "not cheapest-first"
        )
    # Replica chaos actually happened + staleness measured.
    if report["chaos"]["killed_at_request"] is None:
        failures.append("the replica kill never fired")
    if report["chaos"]["rejoined_at_request"] is None:
        failures.append("the replica rejoin never fired")
    elif report["chaos"]["rejoined_lag_max"] <= 0:
        failures.append(
            "rejoined replica's staleness was never measured > 0 — "
            "either no events were missed (implausible under load) or "
            "the instrument is broken"
        )
    # Load-proportional Retry-After actually engaged under the burst.
    hints = report["admission"].get("retry_after_by_reason", {})
    if burst.get("batch_shed", 0) and not hints:
        failures.append("429s carried no derived Retry-After hints")
    # Route-audit bound across ALL replicas, over the merged capture.
    capture = report.get("trace_capture")
    if capture:
        from dynamo_tpu_torch.tools.route_audit import (
            join_report,
            load_records,
            run_asserts,
        )

        routes, actuals, _ = load_records([capture])
        audit = join_report(routes, actuals)
        report["route_audit"] = {
            k: audit[k] for k in (
                "routes", "actuals", "joined", "join_rate",
                "orphan_routes", "overlap_error", "per_replica",
            )
        }
        allowed_orphans = max(20, report["requests"] // 1000)
        failures += run_asserts(
            audit, min_join=0.99, max_orphan_routes=allowed_orphans,
            max_abs_p95=max_abs_p95,
        )
    else:
        failures.append(
            "no DYNTPU_TRACE capture — the multi-replica route-audit "
            "bound cannot be checked (set DYNTPU_TRACE)"
        )
    return failures


def main(argv: list[str] | None = None) -> int:
    import argparse
    import json

    ap = argparse.ArgumentParser(
        prog="python -m dynamo_tpu_torch.tools.ingress_bench",
        description="replicated-ingress trace replay proof",
    )
    ap.add_argument("--requests", type=int, default=int(
        os.environ.get("BENCH_INGRESS_REQUESTS", 100_000)
    ))
    ap.add_argument("--workers", type=int, default=int(
        os.environ.get("BENCH_INGRESS_WORKERS", 8)
    ))
    ap.add_argument("--replicas", type=int, default=int(
        os.environ.get("BENCH_INGRESS_REPLICAS", 2)
    ))
    ap.add_argument("--seed", type=int, default=int(
        os.environ.get("BENCH_INGRESS_SEED", 20260805)
    ))
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.WARNING)
    report = asyncio.run(run_ingress(
        requests=args.requests, workers=args.workers,
        replicas=args.replicas, seed=args.seed,
    ))
    failures = run_gates(report)
    print(json.dumps(report, indent=2))
    if failures:
        print("INGRESS GATES FAILED:\n  " + "\n  ".join(failures),
              file=sys.stderr)
        return 1
    print("ingress gates: OK", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
