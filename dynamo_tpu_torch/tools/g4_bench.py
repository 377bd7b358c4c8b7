"""G4 peer-tier proof on the mocker (port of benchmarks/g4_bench.py; CPU
only, no card).

    python -m dynamo_tpu_torch.tools.g4_bench [--assert] [--seed S]
        [--prefixes P] [--join-requests N]

Three legs over in-process mocker fleets, through the whole G4 plane of
the port: blockset discovery on the store, paced block serving over the
request plane, the admission-time pricing law and the engine's park and
resume path (block_manager/peer.py, engine/engine.py):

1. **Pull win** — a cold worker whose prompt prefix lives only on a
   fleet peer must reach its first token >= 2x sooner by PULLING the rows
   than an identical cold worker recomputing the same prompt (the median
   of ``PULL_TRIALS`` prompts). The serve side is paced at the calibrated
   link (``MockerConfig.peer_link_gbps`` → ``PeerBlockServer.serve_link_gbps``
   = ``calibration.HANDOFF_GBPS``).
2. **Predictive pre-placement** — a popularity-skewed prefix workload
   feeds a :class:`~dynamo_tpu_torch.block_manager.peer.PrefixHeat`; a
   joining cold worker that gets ``preplace()``'d (the fleet planner's
   ``on_scale_up`` payload) must reach a steady WARM hit rate >= 2x
   sooner, counted in requests, than the same join without it. "Warm"
   counts G1/G2 hits with no new G4 pull: an on-demand pull still parks
   its first toucher, the latency pre-placement removes.
3. **Peer death mid-pull** — with the transfer held in flight (the
   ``kvbm.peer_pull`` delay seam) the serving peer's runtime is shut
   down; the parked request must complete by local recompute within its
   deadline — the stream the closed-form law gives, counted degraded,
   the fallback on the G4 counters, no hang under the watchdog.

Every worker's cost model is ``calibration.calibrated_mocker_config()``:
the recompute side is priced from the committed H100 calibration record
(planner/calibration_h100.json), as the pull-vs-recompute law prices it.
Seeded (``--seed``): one seed replays one trace.

The pull-win gate reads each TTFT on the simulation's clock (``_generate``):
the device time the mocker charged, the link time the serving peer's
pacing slept, and the host's CPU time over the request on the two
threads that serve it (the event loop's, where the pull, the serving
peer and the client run, and the engine's). On a host with cores of its
own, as the card's has, that sums to the wall time; on a loaded CPU,
wall time stretches the pull's host work (its thread crossings, its
frames) while the recompute's simulated sleep does not, and the ratio
read there says how busy the machine was. Wall-clock TTFTs are reported
beside.
"""

from __future__ import annotations

import asyncio
import logging
import random
import sys
import time

logger = logging.getLogger(__name__)

BLOCK_SIZE = 16
NAMESPACE, COMPONENT = "kv", "torch"


def expected_stream(prompt: list[int], osl: int, vocab: int) -> list[int]:
    """The deterministic tokens any healthy serving path must produce."""
    from dynamo_tpu_torch.mocker import det_next_token

    out: list[int] = []
    prev, pos = prompt[-1], len(prompt)
    for _ in range(osl):
        prev = int(det_next_token(prev, pos, vocab))
        out.append(prev)
        pos += 1
    return out


def _ecfg(**kw):
    from dynamo_tpu_torch.engine.config import EngineConfig
    from dynamo_tpu_torch.models.config import ModelConfig

    kw.setdefault("num_blocks", 192)
    kw.setdefault("max_num_seqs", 4)
    kw.setdefault("max_model_len", 2048)
    # The G2→G1 adaptive gate's probe ramp is the offload path's story;
    # these legs measure tier PLACEMENT, so onboard the whole match.
    kw.setdefault("kvbm_adaptive_gate", False)
    return EngineConfig(model=ModelConfig.tiny_test(), dtype="float32", **kw)


def _layout():
    from dynamo_tpu_torch.block_manager import KvLayoutConfig

    # block_elems == 8: the mocker runner's 8-float block rows.
    return KvLayoutConfig(
        num_layers=1, page_size=1, num_kv_heads=1, head_dim=4,
        dtype="float32",
    )


async def _generate(engine, prompt, n=4, link=None):
    """(tokens, wall TTFT, TTFT on the simulation's clock: the mocker's
    charged device time, ``link``'s paced seconds (a serving
    PeerBlockServer) and the CPU time of this event loop's thread and of
    the engine's thread, each from the request's submission to its first
    token)."""
    from dynamo_tpu_torch.llm.protocols.common import (
        PreprocessedRequest,
        SamplingOptions,
        StopConditions,
    )
    from dynamo_tpu_torch.runtime.engine import Context

    req = PreprocessedRequest(
        token_ids=list(prompt),
        sampling=SamplingOptions(temperature=0.0),
        stop=StopConditions(max_tokens=n, ignore_eos=True),
    )
    engine_cpu = time.pthread_getcpuclockid(engine._thread.ident)

    def clock() -> float:
        return (engine.runner.charged_clock() + time.thread_time()
                + time.clock_gettime(engine_cpu)
                + (link.paced_s if link is not None else 0.0))

    out: list[int] = []
    ttft = ttft_clock = None
    t0, c0 = time.monotonic(), clock()
    async for item in engine.generate(Context(req.to_wire())):
        if ttft is None:
            ttft, ttft_clock = time.monotonic() - t0, clock() - c0
        out += item.get("token_ids", [])
    if ttft is None:
        ttft, ttft_clock = time.monotonic() - t0, clock() - c0
    return out, ttft, ttft_clock


async def _spawn_worker(main, *, cfg=None, link_gbps=0.0, host_blocks=128,
                        on_kv_actual=None):
    """One mocker worker on the shared fleet planes: runtime (own lease),
    KVBM, engine priced by the H100 calibration. Returns (drt, kvbm,
    engine)."""
    from dynamo_tpu_torch.block_manager import KvbmConfig, KvBlockManager
    from dynamo_tpu_torch.mocker.engine import MockerEngine
    from dynamo_tpu_torch.planner import calibration as cal
    from dynamo_tpu_torch.runtime.distributed import DistributedRuntime

    drt = await DistributedRuntime.in_process(store=main.store, bus=main.bus)
    kvbm = await KvBlockManager(
        KvbmConfig(layout=_layout(), host_blocks=host_blocks)
    ).start()
    eng = MockerEngine(
        cfg or _ecfg(),
        cal.calibrated_mocker_config(
            seed=1, deterministic_tokens=True, peer_link_gbps=link_gbps,
        ),
        block_manager=kvbm,
        on_kv_actual=on_kv_actual,
    )
    await eng.start()
    # A worker warms its programs before it takes traffic.
    await eng.warmup()
    return drt, kvbm, eng


async def _export_peer(drt, kvbm, eng):
    """Export a worker's host tier as a G4 peer, paced at the worker's
    configured simulated link (MockerConfig.peer_link_gbps)."""
    from dynamo_tpu_torch.block_manager.peer import PeerBlockServer

    comp = drt.namespace(NAMESPACE).component(COMPONENT)
    return await PeerBlockServer(
        drt, comp, kvbm, layout=_layout(), refresh_s=0.05,
        serve_link_gbps=eng.runner.sim.peer_link_gbps,
    ).start()


async def _attach_client(drt, kvbm, want_hashes, depth, timeout=10.0):
    """A G4 client on ``drt``, attached to ``kvbm`` once discovery shows a
    peer holding ``depth`` blocks of ``want_hashes``."""
    from dynamo_tpu_torch.block_manager.peer import (
        PeerBlockClient,
        layout_fingerprint,
    )

    comp = drt.namespace(NAMESPACE).component(COMPONENT)
    # Handshake on the mocker layout, but price with the calibrated
    # default geometry (no layout_cfg): the 8-float sim rows are not real
    # KV bytes — pricing them as such would make every pull lose to
    # recomputing "one token", a simulation artefact.
    client = await PeerBlockClient(
        drt, comp, layout_fingerprint(_layout())
    ).start()
    deadline = asyncio.get_running_loop().time() + timeout
    while client.best_peer(want_hashes)[1] < depth:
        if asyncio.get_running_loop().time() >= deadline:
            await client.stop()
            raise TimeoutError("G4 peer discovery never converged")
        await asyncio.sleep(0.02)
    kvbm.attach_peer_client(client)
    return client


def _chain(tokens):
    from dynamo_tpu_torch.llm.tokens import TokenBlockSequence

    return TokenBlockSequence.from_tokens(
        tokens, block_size=BLOCK_SIZE
    ).sequence_hashes()


async def _wait_host(kvbm, n, timeout=10.0):
    deadline = asyncio.get_running_loop().time() + timeout
    while kvbm.stats()["host_registered"] < n:
        if asyncio.get_running_loop().time() >= deadline:
            raise TimeoutError(
                f"host tier never reached {n} registered blocks "
                f"(at {kvbm.stats()['host_registered']})"
            )
        await asyncio.sleep(0.02)


# ---------------------------------------------------------------------------
# leg 1: pull beats recompute at the calibrated link
# ---------------------------------------------------------------------------

PULL_TRIALS = 3    # prompts of the pull-win leg; its gate reads the median


async def _leg_pull_win(main) -> dict:
    from dynamo_tpu_torch.planner import calibration as cal

    prompts = [[(7 * i + 3 + k) % 31991 for i in range(1600)]   # 100 blocks
               for k in range(PULL_TRIALS)]
    prefix_blocks = (len(prompts[0]) - 1) // BLOCK_SIZE
    drt_a, kvbm_a, eng_a = await _spawn_worker(
        main, link_gbps=cal.HANDOFF_GBPS, host_blocks=128 * PULL_TRIALS
    )
    server = None
    drt_b = kvbm_b = eng_b = client = None
    drt_c = kvbm_c = eng_c = None
    try:
        cold = [(await _generate(eng_a, p))[0] for p in prompts]
        await _wait_host(kvbm_a, PULL_TRIALS * prefix_blocks)
        # C: cold, NO peer client — the recompute baseline.
        drt_c, kvbm_c, eng_c = await _spawn_worker(main)
        trials, identical, rd = [], True, {}
        for p, cold_toks in zip(prompts, cold):
            # B: cold, peer-attached — parks at admission, pulls, resumes.
            # A fresh B and a fresh export of A each trial: the rates a
            # pull measures (the client's, and the serving peer's
            # advertised one) price the next, and these rows are too few
            # to measure a link.
            if server is not None:
                await server.stop()
            server = await _export_peer(drt_a, kvbm_a, eng_a)
            drt_b, kvbm_b, eng_b = await _spawn_worker(main)
            client = await _attach_client(drt_b, kvbm_b, _chain(p), prefix_blocks)
            pulled_toks, wall_pull, ttft_pull = await _generate(eng_b, p, link=server)
            recomputed_toks, wall_recompute, ttft_recompute = await _generate(eng_c, p)
            identical &= pulled_toks == cold_toks == recomputed_toks
            trials.append((ttft_pull, ttft_recompute, wall_pull, wall_recompute))
            b_rd = eng_b.readiness()
            for k in ("kvbm_g4_pulls_total", "kvbm_g4_pull_bytes_total",
                      "kv_reused_peer_blocks_total"):
                rd[k] = rd.get(k, 0) + b_rd[k]
            rd["kvbm_link_peer_bps"] = b_rd["kvbm_link_peer_bps"]
            await eng_b.stop()
            await client.stop()
            await kvbm_b.stop()
            await drt_b.shutdown()
            drt_b = kvbm_b = eng_b = client = None
        # The median trial by its speedup on the simulation's clock.
        trials.sort(key=lambda t: t[1] / max(t[0], 1e-9))
        ttft_pull, ttft_recompute, wall_pull, wall_recompute = trials[len(trials) // 2]
        return {
            "prompt_tokens": len(prompts[0]),
            "prefix_blocks": prefix_blocks,
            "trials": len(trials),
            "ttft_pull_ms": ttft_pull * 1e3,
            "ttft_recompute_ms": ttft_recompute * 1e3,
            "speedup": ttft_recompute / max(ttft_pull, 1e-9),
            "speedups": [t[1] / max(t[0], 1e-9) for t in trials],
            "wall_ttft_pull_ms": wall_pull * 1e3,
            "wall_ttft_recompute_ms": wall_recompute * 1e3,
            "wall_speedup": wall_recompute / max(wall_pull, 1e-9),
            "streams_identical": identical,
            "pulls_total": rd["kvbm_g4_pulls_total"],
            "pull_bytes_total": rd["kvbm_g4_pull_bytes_total"],
            "reused_peer_blocks": rd["kv_reused_peer_blocks_total"],
            "link_peer_bps": rd["kvbm_link_peer_bps"],
        }
    finally:
        for eng in (eng_b, eng_c, eng_a):
            if eng is not None:
                await eng.stop()
        if client is not None:
            await client.stop()
        if server is not None:
            await server.stop()
        for kvbm in (kvbm_b, kvbm_c, kvbm_a):
            if kvbm is not None:
                await kvbm.stop()
        for drt in (drt_b, drt_c, drt_a):
            if drt is not None:
                await drt.shutdown()


# ---------------------------------------------------------------------------
# leg 2: predictive pre-placement — a cold join reaches steady state sooner
# ---------------------------------------------------------------------------

PREFIX_BLOCKS = 4          # 64-token shared prefixes
STEADY_WINDOW = 6          # consecutive warm requests = steady state


def _prefix_tokens(p: int) -> list[int]:
    # A distinct leading token per prefix -> distinct hash chains.
    return [(p + 1) * 1000 + i for i in range(PREFIX_BLOCKS * BLOCK_SIZE)]


def _join_trace(rng, prefixes: int, requests: int) -> list[int]:
    """Popularity-skewed prefix draws; every prefix appears at least once,
    so the join without pre-placement must first-touch all of them."""
    pop = [max(prefixes - p, 1) for p in range(prefixes)]
    trace = list(range(prefixes))
    trace += rng.choices(range(prefixes), weights=pop, k=requests - prefixes)
    rng.shuffle(trace)
    return trace


async def _join_and_serve(main, heat, trace, preplaced: bool) -> dict:
    """One cold join serving ``trace``; returns its warm-up curve."""
    from dynamo_tpu_torch.block_manager.peer import preplace

    hot = heat.hottest(1)[0]
    drt, kvbm, eng = None, None, None
    client = None
    actuals: list[dict] = []
    try:
        drt, kvbm, eng = await _spawn_worker(
            main, host_blocks=96, on_kv_actual=actuals.append
        )
        client = await _attach_client(drt, kvbm, hot, PREFIX_BLOCKS)
        preplaced_blocks = 0
        if preplaced:
            preplaced_blocks = await preplace(client, kvbm, heat, top_k=64)
        warm: list[bool] = []
        for i, p in enumerate(trace):
            tail = [29000 + i * 8 + j for j in range(8)]
            pulls_before = client.pulls_total
            await _generate(eng, _prefix_tokens(p) + tail, n=2)
            rec = actuals[-1]
            # Warm = the prefix came from tiers already ON this worker
            # (G1/G2, pre-placed peer-origin rows included) with no new G4
            # pull: an on-demand pull parks the request on the transfer,
            # the latency pre-placement removes.
            warm.append(
                rec["device_blocks"] + rec["host_blocks"]
                + rec["peer_blocks"] >= PREFIX_BLOCKS
                and client.pulls_total == pulls_before
            )
        steady = len(trace) + STEADY_WINDOW  # sentinel: never steady
        for i in range(STEADY_WINDOW, len(trace) + 1):
            if all(warm[i - STEADY_WINDOW:i]):
                steady = i
                break
        return {
            "requests": len(trace),
            "warm_hits": sum(warm),
            "requests_to_steady": steady,
            "preplaced_blocks": preplaced_blocks,
        }
    finally:
        if eng is not None:
            await eng.stop()
        if client is not None:
            await client.stop()
        if kvbm is not None:
            await kvbm.stop()
        if drt is not None:
            await drt.shutdown()


async def _leg_preplace(main, seed: int, prefixes: int,
                        join_requests: int) -> dict:
    from dynamo_tpu_torch.block_manager.peer import PrefixHeat

    rng = random.Random(seed)
    drt_a, kvbm_a, eng_a = await _spawn_worker(main, host_blocks=96)
    server = None
    try:
        # Warm the donor with the whole prefix set; the heat mirrors the
        # popularity a router would have observed.
        heat = PrefixHeat(decay=0.995)
        pop = [max(prefixes - p, 1) for p in range(prefixes)]
        for p in range(prefixes):
            toks = _prefix_tokens(p) + [28000 + p]
            await _generate(eng_a, toks, n=2)
            heat.note(_chain(_prefix_tokens(p)), weight=pop[p])
        await _wait_host(kvbm_a, prefixes * PREFIX_BLOCKS)
        server = await _export_peer(drt_a, kvbm_a, eng_a)

        trace = _join_trace(rng, prefixes, join_requests)
        nopre = await _join_and_serve(main, heat, trace, preplaced=False)
        pre = await _join_and_serve(main, heat, trace, preplaced=True)
        return {
            "prefixes": prefixes,
            "join_requests": join_requests,
            "no_preplace": nopre,
            "preplace": pre,
            "speedup": (
                nopre["requests_to_steady"]
                / max(pre["requests_to_steady"], 1)
            ),
        }
    finally:
        await eng_a.stop()
        if server is not None:
            await server.stop()
        await kvbm_a.stop()
        await drt_a.shutdown()


# ---------------------------------------------------------------------------
# leg 3: the peer killed mid-pull — recompute, degraded, no hang
# ---------------------------------------------------------------------------

PEER_TIMEOUT_S = 0.5       # the parked request's kvbm_peer_timeout_s
PULL_HOLD_S = 2.0          # the kvbm.peer_pull delay holding the transfer
WATCHDOG_S = 30.0


async def _leg_peer_death(main) -> dict:
    from dynamo_tpu_torch.utils.faults import FAULTS

    prompt = [(11 * i + 5) % 31991 for i in range(40)]
    drt_a, kvbm_a, eng_a = await _spawn_worker(main)
    server = None
    drt_b = kvbm_b = eng_b = client = None
    try:
        await _generate(eng_a, prompt)
        await _wait_host(kvbm_a, 2)
        server = await _export_peer(drt_a, kvbm_a, eng_a)

        drt_b, kvbm_b, eng_b = await _spawn_worker(
            main, cfg=_ecfg(kvbm_peer_timeout_s=PEER_TIMEOUT_S)
        )
        client = await _attach_client(drt_b, kvbm_b, _chain(prompt), 2)

        # Hold the transfer in flight, then kill the serving peer under it
        # (its runtime down, lease revoked, no unpublish) — the deadline
        # must resume the request by recompute.
        FAULTS.arm("kvbm.peer_pull", "delay", times=None, delay_s=PULL_HOLD_S)
        t0 = time.monotonic()
        task = asyncio.ensure_future(_generate(eng_b, prompt))
        deadline = asyncio.get_running_loop().time() + 10
        while not eng_b._peer_parked:
            if asyncio.get_running_loop().time() >= deadline:
                raise TimeoutError("request never parked on the pull")
            await asyncio.sleep(0.01)
        await drt_a.shutdown()
        drt_a, server = None, None
        toks, *_ = await asyncio.wait_for(task, timeout=WATCHDOG_S)
        wall = time.monotonic() - t0

        vocab = eng_b.runner.sim.vocab_size
        rd = eng_b.readiness()
        return {
            "completed": True,
            "wall_s": wall,
            "stream_identical": toks == expected_stream(prompt, 4, vocab),
            "degraded_requests": eng_b.degraded_requests,
            "pull_fallbacks_total": rd["kvbm_g4_pull_fallbacks_total"],
            "reused_peer_blocks": rd["kv_reused_peer_blocks_total"],
        }
    finally:
        FAULTS.disarm("kvbm.peer_pull")
        for eng in (eng_b, eng_a):
            if eng is not None:
                await eng.stop()
        if kvbm_b is not None:
            try:
                await kvbm_b.drain_pulls(timeout_s=10)
            except TimeoutError:
                logger.warning("a G4 pull was still in flight at teardown")
        if client is not None:
            await client.stop()
        if server is not None:
            await server.stop()
        for kvbm in (kvbm_b, kvbm_a):
            if kvbm is not None:
                await kvbm.stop()
        for drt in (drt_b, drt_a):
            if drt is not None:
                await drt.shutdown()


# ---------------------------------------------------------------------------
# harness
# ---------------------------------------------------------------------------

async def run_g4(
    seed: int = 20260806,
    prefixes: int = 8,
    join_requests: int = 24,
) -> dict:
    from dynamo_tpu_torch.runtime.distributed import DistributedRuntime

    main = await DistributedRuntime.in_process()
    try:
        pull = await _leg_pull_win(main)
        pre = await _leg_preplace(main, seed, prefixes, join_requests)
        death = await _leg_peer_death(main)
    finally:
        await main.shutdown()
    return {"seed": seed, "pull": pull, "preplace": pre, "peer_death": death}


def run_gates(report: dict) -> list[str]:
    """The reference's hard gates. Returns the failures."""
    failures: list[str] = []
    pull = report["pull"]
    if not pull["streams_identical"]:
        failures.append("pull: streams diverged across the tier")
    if pull["speedup"] < 2.0:
        failures.append(
            f"pull: TTFT speedup {pull['speedup']:.2f}x < 2x "
            f"(pull {pull['ttft_pull_ms']:.2f} ms vs recompute "
            f"{pull['ttft_recompute_ms']:.2f} ms)"
        )
    if pull["pulls_total"] < 1 or pull["reused_peer_blocks"] < 1:
        failures.append("pull: no G4 pull was actually taken")
    pre = report["preplace"]
    if pre["speedup"] < 2.0:
        failures.append(
            f"preplace: steady-state speedup {pre['speedup']:.2f}x < 2x "
            f"(no-preplace {pre['no_preplace']['requests_to_steady']} "
            f"vs preplace {pre['preplace']['requests_to_steady']} "
            "requests)"
        )
    if pre["preplace"]["preplaced_blocks"] < 1:
        failures.append("preplace: nothing was pre-placed")
    death = report["peer_death"]
    if not death["completed"]:
        failures.append("peer_death: request hung")
    if not death["stream_identical"]:
        failures.append("peer_death: recomputed stream diverged")
    if death["degraded_requests"] != 1:
        failures.append(
            f"peer_death: degraded_requests {death['degraded_requests']} != 1"
        )
    if death["pull_fallbacks_total"] < 1:
        failures.append("peer_death: fallback not counted on the G4 surface")
    if death["reused_peer_blocks"] != 0:
        failures.append("peer_death: phantom peer reuse counted")
    return failures


def main(argv: list[str] | None = None) -> int:
    import argparse
    import json

    ap = argparse.ArgumentParser(
        prog="python -m dynamo_tpu_torch.tools.g4_bench",
        description="G4 peer-tier proof over in-process mocker fleets",
    )
    ap.add_argument("--assert", dest="check", action="store_true",
                    help="exit 1 when a gate fails")
    ap.add_argument("--seed", type=int, default=20260806)
    ap.add_argument("--prefixes", type=int, default=8)
    ap.add_argument("--join-requests", type=int, default=24)
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.WARNING)
    report = asyncio.run(run_g4(
        seed=args.seed, prefixes=args.prefixes,
        join_requests=args.join_requests,
    ))
    failures = run_gates(report)
    print(json.dumps(report, indent=2))
    if failures:
        print("G4 GATES FAILED:\n  " + "\n  ".join(failures), file=sys.stderr)
        return 1 if args.check else 0
    print("G4 gates: OK", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
