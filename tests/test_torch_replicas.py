"""The port's router replica set (dynamo_tpu_torch/llm/kv_router/
replicas.py), the instance metadata a RouterService serves, and the
replicated-ingress tool (dynamo_tpu_torch/tools/ingress_bench.py): the
replica cases of tests/test_ingress_scale.py on port mocker workers.

A killed replica's in-flight requests fail over to the survivor through
the frontend's FailoverEngine with the streams any healthy path makes
(the deterministic mocker); the rejoined replica's missed-event lag is
measured, and the re-announce its rejoin asks for rebuilds the fresh
radix view. The ingress tool's trace is the JAX synthesizer's, token for
token, and its small run passes its full gate set."""

from __future__ import annotations

import asyncio
import json

import pytest

from dynamo_tpu_torch.engine.config import EngineConfig
from dynamo_tpu_torch.llm.protocols.common import (
    PreprocessedRequest,
    SamplingOptions,
    StopConditions,
)
from dynamo_tpu_torch.models.config import ModelConfig
from dynamo_tpu_torch.runtime.distributed import DistributedRuntime

pytestmark = pytest.mark.anyio


def _cfg(**kw) -> EngineConfig:
    base = dict(model=ModelConfig.tiny_test(), num_blocks=64, max_num_seqs=4,
                max_model_len=128, dtype="float32")
    base.update(kw)
    return EngineConfig(**base)


def _expected(prompt: list[int], osl: int, vocab: int) -> list[int]:
    from dynamo_tpu_torch.mocker import det_next_token

    out, prev, pos = [], prompt[-1], len(prompt)
    for _ in range(osl):
        prev = int(det_next_token(prev, pos, vocab))
        out.append(prev)
        pos += 1
    return out


def test_deterministic_streams_are_the_reference_law():
    from benchmarks.chaos_bench import expected_stream

    for prompt in ([1, 2, 3], list(range(40, 64))):
        assert _expected(prompt, 12, 997) == expected_stream(prompt, 12, 997)


async def _fleet(vocab: int, n_workers: int = 2):
    from dynamo_tpu_torch.llm.kv_router.publisher import (
        KvEventPublisher,
        WorkerMetricsPublisher,
    )
    from dynamo_tpu_torch.mocker import MockerConfig, MockerEngine

    drt0 = await DistributedRuntime.in_process()

    async def sub_drt():
        return await DistributedRuntime.in_process(
            store=drt0.store, bus=drt0.bus, runtime=drt0.runtime)

    workers = []
    for i in range(n_workers):
        drt = await sub_drt()
        comp = drt.namespace("rt").component("w")
        eng = MockerEngine(
            _cfg(num_blocks=256, enable_prefix_caching=True),
            MockerConfig(vocab_size=vocab, seed=i, deterministic_tokens=True,
                         decode_time_per_step_us=4000.0))
        pub = KvEventPublisher(drt, comp, drt.primary_lease_id)
        wm = WorkerMetricsPublisher()
        eng._external_kv_event = pub.publish_engine_event
        eng._on_metrics = wm.publish
        await eng.start()
        inst = await comp.endpoint("generate").serve(eng)
        await wm.create_endpoint(comp)
        workers.append((inst, eng))
    return drt0, sub_drt, workers


async def test_replica_kill_fails_over_and_rejoin_staleness_measured():
    from dynamo_tpu_torch.llm.kv_router.replicas import RouterReplicaSet
    from dynamo_tpu_torch.runtime.egress import PushRouter
    from dynamo_tpu_torch.runtime.engine import Context
    from dynamo_tpu_torch.runtime.failover import FailoverEngine
    from dynamo_tpu_torch.utils.tracing import tracer

    vocab = 997
    drt0, sub_drt, workers = await _fleet(vocab)
    rs = await RouterReplicaSet(sub_drt, "rt.w.generate").start(2)
    push = await PushRouter.create(drt0, "rt.router.generate", connect_timeout_s=2.0)
    front = FailoverEngine(push)

    async def one(i: int, osl: int = 10):
        prompt = [(i * 7 + j) % (vocab - 1) + 1 for j in range(24)]
        req = PreprocessedRequest(token_ids=prompt, sampling=SamplingOptions(temperature=0.0),
                                  stop=StopConditions(max_tokens=osl, ignore_eos=True))
        ctx = Context(req.to_wire())
        out = []
        async for item in front.generate(ctx):
            out += item.get("token_ids", [])
        tracer().finish(ctx.id)
        assert out == _expected(prompt, osl, vocab)

    try:
        await asyncio.gather(*[one(i) for i in range(4)])

        async def killer():
            await asyncio.sleep(0.02)
            await rs.kill(rs.replicas[0])

        # Mid-stream kill: every request still completes, exactly.
        await asyncio.gather(asyncio.gather(*[one(10 + i) for i in range(6)]), killer())
        assert [r.alive for r in rs.replicas] == [False, True]
        # Traffic while replica 0 is down: the events it will never see.
        await asyncio.gather(*[one(30 + i) for i in range(4)])
        before = rs.replicas[0]
        fresh = await rs.rejoin(before)
        assert fresh.replica_id == 0 and fresh.rejoined_unix is not None
        assert fresh.instance_id != before.instance_id
        assert await rs.rejoin(fresh) is fresh
        await asyncio.gather(*[one(50 + i) for i in range(4)])
        await asyncio.sleep(0.1)
        st = rs.staleness()
        rec = st["replicas"][0]
        assert rec["rejoined"] is True and rec["alive"] is True
        # The missed history is measured, not assumed away.
        assert rec["applied_lag"] > 0
        assert st["applied_max"] > 0 and st["max_applied_lag"] == rec["applied_lag"]
        assert st["replicas"][1]["applied_lag"] == 0
    finally:
        await rs.stop()
        for inst, eng in workers:
            await inst.stop()
            await eng.stop()
        await drt0.shutdown()


async def test_rejoin_reannounce_rebuilds_the_fresh_radix_view():
    """The re-announce half of the JAX package's replica-rejoin case: each
    worker runs a ``Reannouncer`` over its host tier, and the rejoined
    replica's fresh radix view must re-cover a prefix stored BEFORE its
    downtime — events its subscription can never replay — before any
    post-rejoin traffic could have re-published it; then the replica's
    own route decisions predict the prefix again."""
    from dynamo_tpu_torch.block_manager import KvbmConfig, KvBlockManager, KvLayoutConfig
    from dynamo_tpu_torch.block_manager.peer import Reannouncer
    from dynamo_tpu_torch.llm.kv_router.audit import ROUTE_OBS
    from dynamo_tpu_torch.llm.kv_router.publisher import (
        KvEventPublisher,
        WorkerMetricsPublisher,
    )
    from dynamo_tpu_torch.llm.kv_router.replicas import RouterReplicaSet
    from dynamo_tpu_torch.llm.tokens import TokenBlockSequence
    from dynamo_tpu_torch.mocker import MockerConfig, MockerEngine
    from dynamo_tpu_torch.runtime.egress import PushRouter
    from dynamo_tpu_torch.runtime.engine import Context
    from dynamo_tpu_torch.runtime.failover import FailoverEngine
    from dynamo_tpu_torch.utils.tracing import tracer

    vocab = 997
    drt0 = await DistributedRuntime.in_process()

    async def sub_drt():
        return await DistributedRuntime.in_process(
            store=drt0.store, bus=drt0.bus, runtime=drt0.runtime)

    # 8-float rows: the mocker runner's simulated KV geometry.
    layout = KvLayoutConfig(num_layers=1, page_size=1, num_kv_heads=1, head_dim=4,
                            dtype="float32")
    workers = []
    for i in range(2):
        drt = await sub_drt()
        comp = drt.namespace("rt").component("w")
        kvbm = await KvBlockManager(KvbmConfig(layout=layout, host_blocks=64)).start()
        eng = MockerEngine(
            _cfg(num_blocks=256, enable_prefix_caching=True),
            MockerConfig(vocab_size=vocab, seed=i, deterministic_tokens=True,
                         decode_time_per_step_us=4000.0),
            block_manager=kvbm)
        pub = KvEventPublisher(drt, comp, drt.primary_lease_id)
        wm = WorkerMetricsPublisher()
        eng._external_kv_event = pub.publish_engine_event
        eng._on_metrics = wm.publish
        await eng.start()
        inst = await comp.endpoint("generate").serve(eng)
        await wm.create_endpoint(comp)
        # interval_s far out: only the rejoin's broadcast may drive the
        # announce, so convergence proves the trigger path.
        ann = await Reannouncer(drt, comp, pub, kvbm.host_entries,
                                interval_s=3600.0).start()
        workers.append((inst, eng, ann, kvbm))
    rs = await RouterReplicaSet(sub_drt, "rt.w.generate").start(2)
    push = await PushRouter.create(drt0, "rt.router.generate", connect_timeout_s=2.0)
    front = FailoverEngine(push)

    async def one(i: int, osl: int = 10):
        prompt = [(i * 7 + j) % (vocab - 1) + 1 for j in range(24)]
        req = PreprocessedRequest(token_ids=prompt, sampling=SamplingOptions(temperature=0.0),
                                  stop=StopConditions(max_tokens=osl, ignore_eos=True))
        ctx = Context(req.to_wire())
        out = []
        async for item in front.generate(ctx):
            out += item.get("token_ids", [])
        tracer().finish(ctx.id)
        assert out == _expected(prompt, osl, vocab)

    # The probe prefix: request 0's prompt, served (and its KV events
    # published) strictly BEFORE the kill; its full block is what the
    # rejoined replica must re-learn from the re-announce alone.
    probe = [(0 * 7 + j) % (vocab - 1) + 1 for j in range(24)]
    probe_hashes = TokenBlockSequence.from_tokens(probe, block_size=16).sequence_hashes()
    assert probe_hashes

    async def _wait(pred, timeout_s: float, what: str):
        deadline = asyncio.get_running_loop().time() + timeout_s
        while not pred():
            assert asyncio.get_running_loop().time() < deadline, f"timed out: {what}"
            await asyncio.sleep(0.02)

    try:
        await asyncio.gather(*[one(i) for i in range(4)])
        await _wait(lambda: any(probe_hashes[0] in {e[0] for e in kvbm.host_entries()}
                                for _, _, _, kvbm in workers),
                    5.0, "probe block host offload")

        async def killer():
            await asyncio.sleep(0.02)
            await rs.kill(rs.replicas[0])

        await asyncio.gather(asyncio.gather(*[one(10 + i) for i in range(6)]), killer())
        await asyncio.gather(*[one(30 + i) for i in range(4)])
        announces_before = sum(a.announces_total for _, _, a, _ in workers)
        rejoined = await rs.rejoin(rs.replicas[0])

        # Before any post-rejoin traffic: the rejoin's broadcast reached the
        # Reannouncers, and their stored events rebuilt the probe prefix.
        deadline = asyncio.get_running_loop().time() + 5.0
        while True:
            m = await rejoined.service.kv_router.indexer.find_matches(probe_hashes)
            if max(m.values(), default=0) >= 1:
                break
            assert asyncio.get_running_loop().time() < deadline, (
                "rejoined radix view never re-covered the pre-kill prefix")
            await asyncio.sleep(0.02)
        assert sum(a.announces_total for _, _, a, _ in workers) > announces_before

        # The rejoined replica's own decisions predict the probe prefix
        # again (not pinned at the stale zero a rejoin without re-announce
        # would carry).
        routes_before = ROUTE_OBS.routes_total
        rejoined_overlap = None
        for _ in range(12):
            await one(0)
            snap = ROUTE_OBS.snapshot(64)
            fresh = snap["recent"][-(snap["routes_total"] - routes_before):]
            recs = [r for r in fresh if r["replica_id"] == 0
                    and r["isl_blocks"] == (len(probe) + 15) // 16]
            if recs:
                rejoined_overlap = max(r["overlap_blocks"] for r in recs)
                break
        assert rejoined_overlap is not None, "rejoined replica never decided a probe"
        assert rejoined_overlap >= len(probe_hashes)
    finally:
        await rs.stop()
        for inst, eng, ann, kvbm in workers:
            await ann.stop()
            await inst.stop()
            await eng.stop()
            await kvbm.stop()
        await drt0.shutdown()


async def test_router_service_serves_its_instance_metadata():
    """Each replica's discovery record says what it routes to and under
    which replica id (a worker's record carries no metadata)."""
    from dynamo_tpu_torch.llm.kv_router.replicas import RouterReplicaSet
    from dynamo_tpu_torch.runtime.component import Instance

    drt0, sub_drt, workers = await _fleet(101, n_workers=1)
    rs = await RouterReplicaSet(sub_drt, "rt.w.generate").start(2)
    try:
        routers = await drt0.store.get_prefix("instances/rt/router/generate:")
        metas = sorted((Instance.from_json(v).metadata for v in routers.values()),
                       key=lambda m: m["replica_id"])
        assert metas == [{"routes_to": "dyn://rt.w.generate", "replica_id": 0},
                         {"routes_to": "dyn://rt.w.generate", "replica_id": 1}]
        inst = Instance.from_json(next(iter(
            (await drt0.store.get_prefix("instances/rt/w/generate:")).values())))
        assert inst.metadata == {}
        # Metadata is description, not identity.
        assert Instance(inst.endpoint, inst.lease_id, inst.subject, {"x": 1}) == inst
    finally:
        await rs.stop()
        for inst_, eng in workers:
            await inst_.stop()
            await eng.stop()
        await drt0.shutdown()


def test_ingress_trace_is_the_reference_synthesizer():
    from benchmarks.ingress_bench import build_trace as j_build_trace
    from dynamo_tpu_torch.tools.ingress_bench import build_trace

    for seed in (1, 20260805):
        assert build_trace(300, 96, 3, seed) == j_build_trace(300, 96, 3, seed)


async def test_ingress_tool_smoke_gates(tmp_path, monkeypatch):
    """A small run of the replicated-ingress replay with its full gate
    set: replica kill and rejoin, the overload burst shedding batch
    first, per-class TTFT bounds, and the multi-replica route-audit
    bound over the merged capture."""
    from dynamo_tpu_torch.tools.ingress_bench import run_gates, run_ingress
    from dynamo_tpu_torch.utils.tracing import reset_tracer

    capture = tmp_path / "ingress.jsonl"
    monkeypatch.setenv("DYNTPU_TRACE", str(capture))
    reset_tracer(str(capture))
    try:
        report = await run_ingress(requests=400, workers=2, replicas=2, concurrency=64,
                                   max_inflight=220, burst_extra=90, burst_attempts=300,
                                   watchdog_s=120.0)
        # At 400 requests the rejoined replica's stale window dominates
        # its route sample, hence the looser bound than a long run's.
        failures = run_gates(report, max_abs_p95=8.0)
        assert not failures, failures
        assert report["by_status"].get("hang", 0) == 0
        assert report["burst"]["batch_shed"] > 0
        assert report["chaos"]["rejoined_lag_max"] > 0
        assert report["route_audit"]["per_replica"]
        json.dumps(report)
    finally:
        reset_tracer(None)
