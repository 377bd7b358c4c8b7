"""The port's KV observatory (dynamo_tpu_torch/llm/kv_router audit,
indexer staleness, aggregator failure counting, the engine's actual
reuse records, tools/route_audit.py, /debug/routes and the metrics
exporter) on the CPU: the cases of tests/test_kv_observatory.py on port
objects — the KVBM tier cases too, on the port's block manager — with
the same records through the JAX package's observatory and audit tool
where both exist."""

import asyncio
import time
from types import SimpleNamespace

import pytest

from dynamo_tpu.llm.kv_router.audit import RouteAuditRecord as JRec
from dynamo_tpu.llm.kv_router.audit import RouteObservatory as JObs
from dynamo_tpu_torch.engine.config import EngineConfig
from dynamo_tpu_torch.llm.http_client import fetch
from dynamo_tpu_torch.llm.kv_router.audit import RouteAuditRecord, RouteObservatory
from dynamo_tpu_torch.llm.kv_router.indexer import KvIndexer, KvIndexerSharded
from dynamo_tpu_torch.llm.kv_router.metrics_aggregator import (
    KvMetricsAggregator,
    ProcessedEndpoints,
)
from dynamo_tpu_torch.llm.kv_router.protocols import (
    KV_HIT_RATE_PLANE,
    ForwardPassMetrics,
    KvCacheEventData,
    RouterEvent,
)
from dynamo_tpu_torch.llm.kv_router.scheduler import (
    DefaultWorkerSelector,
    KvRouterConfig,
)
from dynamo_tpu_torch.llm.protocols.common import (
    PreprocessedRequest,
    SamplingOptions,
    StopConditions,
)
from dynamo_tpu_torch.mocker import MockerConfig, MockerEngine
from dynamo_tpu_torch.models.config import ModelConfig
from dynamo_tpu_torch.runtime.engine import Context
from dynamo_tpu_torch.runtime.transports import wire
from dynamo_tpu_torch.utils.faults import FAULTS
from dynamo_tpu_torch.utils.recorder import Recorder

pytestmark = pytest.mark.anyio


def _stored(hashes, parent=None, published=None):
    return RouterEvent(
        worker_id=hashes[0] % 7 + 1,
        event=KvCacheEventData(kind="stored", block_hashes=hashes, parent_hash=parent),
        published_unix=published,
    )


# ---------------------------------------------------------------------------
# selector: the full candidate field
# ---------------------------------------------------------------------------


def test_selector_exposes_all_candidates():
    sel = DefaultWorkerSelector(KvRouterConfig(), seed=0)
    eps = ProcessedEndpoints(metrics={
        1: ForwardPassMetrics(kv_active_blocks=10, kv_total_blocks=100),
        2: ForwardPassMetrics(kv_active_blocks=90, kv_total_blocks=100,
                              num_requests_waiting=3),
    })
    d = sel.select(eps, {1: 4}, isl=64)
    assert d.worker_id == 1
    assert {c["worker"] for c in d.candidates} == {1, 2}
    loser = next(c for c in d.candidates if c["worker"] == 2)
    winner = next(c for c in d.candidates if c["worker"] == 1)
    assert loser["logit"] < winner["logit"] and loser["usage"] > winner["usage"]
    assert winner["overlap_blocks"] == 4


def test_network_aware_candidates_carry_their_transfer_cost():
    """A worker advertising no ingest rate is priced at the measured
    default link; the term shows on every candidate's record."""
    cfg = KvRouterConfig(network_aware=True)
    sel = DefaultWorkerSelector(cfg, seed=0)
    eps = ProcessedEndpoints(metrics={
        1: ForwardPassMetrics(kv_total_blocks=100),
        2: ForwardPassMetrics(kv_total_blocks=100),
    })
    d = sel.select(eps, {2: 2}, isl=64)
    by = {c["worker"]: c for c in d.candidates}
    want_ms = 1000.0 * 4 * cfg.block_bytes / (cfg.default_link_gbps * 1e9)
    assert by[1]["transfer_ms"] == pytest.approx(want_ms, abs=1e-3)
    assert by[1]["transfer_term"] == 1.0 and by[2]["transfer_term"] == 0.5
    assert d.worker_id == 2


# ---------------------------------------------------------------------------
# indexer staleness
# ---------------------------------------------------------------------------


async def test_indexer_staleness_accounting():
    idx = KvIndexer().start()
    now = time.time()
    idx.apply(_stored([1, 2], published=now - 0.06))
    idx.apply(_stored([3], parent=2, published=now - 0.06))
    assert idx.pending_events == 2
    await idx.find_matches([1, 2, 3])
    st = idx.stats()
    assert st["kv_events_applied_total"] == 2 and st["kv_events_pending"] == 0
    assert st["kv_event_lag_count"] == 2 and st["kv_event_lag_max_ms"] >= 50.0
    assert st["kv_radix_blocks"] == 3
    wm = idx.watermark()
    assert wm["applied"] == 2 and wm["pending"] == 0 and "lag_p99_ms" in wm
    for wid in (2, 4):
        idx.apply(RouterEvent(wid, KvCacheEventData(kind="cleared")))
    await idx.find_matches([1])
    assert idx.stats()["kv_radix_evicted_blocks_total"] >= 3
    await idx.stop()


async def test_indexer_direct_apply_path_counts_too():
    idx = KvIndexer()  # never started: no consumer task
    idx.apply(_stored([10, 11], published=time.time()))
    assert await idx.find_matches([10, 11]) != {}
    assert idx.events_applied_total == 1
    assert idx.stats()["kv_event_lag_count"] == 1


async def test_sharded_equivalence_and_determinism():
    events = []
    for w in range(1, 6):
        parent = None
        for h in [w * 100 + i for i in range(4)]:
            events.append(RouterEvent(w, KvCacheEventData(
                kind="stored", block_hashes=[h], parent_hash=parent),
                published_unix=time.time()))
            parent = h
    flat = KvIndexer().start()
    shard_a = KvIndexerSharded(4).start()
    shard_b = KvIndexerSharded(4).start()
    for ev in events:
        for idx in (flat, shard_a, shard_b):
            idx.apply(ev)
    for q in ([100, 101, 102, 103], [300, 301], [500, 999], [42]):
        expect = await flat.find_matches(q)
        assert await shard_a.find_matches(q) == expect
        assert await shard_b.find_matches(q) == expect
    counts_a = [s.events_applied_total for s in shard_a.shards]
    assert counts_a == [s.events_applied_total for s in shard_b.shards]
    assert sum(counts_a) == len(events)
    st = shard_a.stats()
    assert st["kv_events_applied_total"] == len(events) and st["kv_indexer_shards"] == 4
    await asyncio.gather(flat.stop(), shard_a.stop(), shard_b.stop())


async def test_sharded_staleness_under_delayed_apply_fault():
    idx = KvIndexerSharded(2).start()
    try:
        FAULTS.arm("indexer.apply", "delay", times=4, delay_s=0.05)
        t0 = time.time()
        for w in (1, 2, 3, 4):
            idx.apply(RouterEvent(w, KvCacheEventData(
                kind="stored", block_hashes=[w * 10]), published_unix=t0))
        await asyncio.sleep(0.02)
        assert idx.pending_events > 0
        wm = idx.watermark()
        assert wm["pending"] > 0 and len(wm["per_shard_pending"]) == 2
        assert await idx.find_matches([10]) == {1: 1}
        st = idx.stats()
        assert st["kv_events_applied_total"] == 4 and st["kv_events_pending"] == 0
        assert st["kv_event_lag_count"] == 4 and st["kv_event_lag_max_ms"] >= 25.0
    finally:
        FAULTS.disarm("indexer.apply")
        await idx.stop()


async def test_indexer_apply_drop_fault_counts_dropped():
    idx = KvIndexer().start()
    try:
        FAULTS.arm("indexer.apply", "drop", times=1)
        idx.apply(_stored([77], published=time.time()))
        await asyncio.sleep(0.05)
        assert await idx.find_matches([77]) == {}
        assert idx.events_dropped_total == 1 and idx.events_applied_total == 0
    finally:
        FAULTS.disarm("indexer.apply")
        await idx.stop()


# ---------------------------------------------------------------------------
# aggregator: failure counting, stale-after-TTL, coalesced scrapes
# ---------------------------------------------------------------------------


class _StubRouter:
    def __init__(self, ids):
        self.ids = ids
        self.client = SimpleNamespace(
            instances=lambda: [SimpleNamespace(instance_id=i) for i in self.ids])


async def test_aggregator_counts_failures_and_drops_after_ttl():
    agg = KvMetricsAggregator(None, None, endpoint_ttl_s=0.15)
    agg._router = _StubRouter([1, 2])
    failing: set[int] = set()

    async def scrape_one(iid):
        if iid in failing:
            raise RuntimeError("endpoint down")
        return ForwardPassMetrics(kv_active_blocks=iid)

    agg._scrape_one = scrape_one
    eps = await agg.scrape()
    assert set(eps.metrics) == {1, 2} and agg.scrape_failures_total == 0
    failing.add(2)
    eps = await agg.scrape()
    assert agg.scrape_failures_total == 1 and set(eps.metrics) == {1, 2}
    assert eps.metrics[2].kv_active_blocks == 2
    await asyncio.sleep(0.2)
    eps = await agg.scrape()
    assert set(eps.metrics) == {1}
    assert agg.stale_endpoint_drops_total >= 1 and agg.scrape_failures_total == 2
    assert not agg.stale
    await asyncio.sleep(0.2)
    assert agg.stale


async def test_aggregator_coalesces_forced_scrapes():
    """N deciders hitting a stale snapshot share one fleet scrape."""
    agg = KvMetricsAggregator(None, None, endpoint_ttl_s=5.0)
    agg._router = _StubRouter([1, 2])
    calls = []

    async def scrape_one(iid):
        calls.append(iid)
        await asyncio.sleep(0.01)
        return ForwardPassMetrics(kv_active_blocks=iid)

    agg._scrape_one = scrape_one
    got = await asyncio.gather(*[agg.scrape_coalesced() for _ in range(8)])
    assert sorted(calls) == [1, 2] and all(set(e.metrics) == {1, 2} for e in got)


# ---------------------------------------------------------------------------
# route observatory, against the JAX package's
# ---------------------------------------------------------------------------


def test_route_observatory_ring_and_gauges():
    """The same records and providers through both observatories: the
    same snapshot (ring, totals, wire records) and merged gauges."""
    out = []
    for obs_cls, rec_cls in ((RouteObservatory, RouteAuditRecord), (JObs, JRec)):
        obs = obs_cls(capacity=2)
        for i in range(3):
            obs.record(rec_cls(request_id=f"r{i}", trace_id=f"t{i}", worker_id=i,
                               overlap_blocks=i, isl_blocks=4, logit=0.5,
                               decision_ms=1.0, unix=100.0 + i,
                               indexer={"applied": 7, "pending": 0}))
        obs.register_provider(lambda: {"kv_events_applied_total": 5,
                                       "kv_event_lag_p99_ms": 2.0})
        obs.register_provider(lambda: {"kv_events_applied_total": 3,
                                       "kv_event_lag_p99_ms": 4.0})
        obs.register_provider(lambda: 1 / 0)
        out.append((obs.snapshot(8), obs.gauges()))
        obs.reset()
        assert obs.snapshot(8)["routes_total"] == 0
    assert out[0] == out[1]
    snap, g = out[0]
    assert snap["routes_total"] == 3 and snap["predicted_blocks_total"] == 3
    assert len(snap["recent"]) == 2 and snap["recent"][-1]["trace"] == "t2"
    assert g["kv_events_applied_total"] == 8.0 and g["kv_event_lag_p99_ms"] == 4.0


# ---------------------------------------------------------------------------
# engine: actual reuse, gauges and the metrics callback in sync
# ---------------------------------------------------------------------------


def _ecfg():
    return EngineConfig(model=ModelConfig.tiny_test(), num_blocks=64, max_num_seqs=4,
                        max_model_len=256, dtype="float32")


async def _generate(engine, prompt, n=4):
    req = PreprocessedRequest(token_ids=list(prompt),
                              sampling=SamplingOptions(temperature=0.0),
                              stop=StopConditions(max_tokens=n, ignore_eos=True))
    out = []
    async for item in engine.generate(Context(req.to_wire())):
        out += item.get("token_ids", [])
    return out


async def test_engine_reports_actuals_and_keeps_gauges_in_sync():
    """A prompt cold (reuse 0), then warm (device tier): a kv_actual
    record each, the cumulative counter, and the readiness snapshot, the
    metrics callback's dict and the ForwardPassMetrics wire agree on
    every KV observatory key. Without a KVBM the host, disk and peer
    tiers read 0."""
    actuals: list[dict] = []
    metrics: list[dict] = []
    eng = MockerEngine(_ecfg(), MockerConfig(seed=1), on_kv_actual=actuals.append,
                       on_metrics=metrics.append)
    await eng.start()
    prompt = list(range(40))  # 2 full blocks + tail
    await _generate(eng, prompt)
    await asyncio.sleep(0.05)
    assert len(actuals) == 1
    cold = actuals[0]
    assert cold["kind"] == "kv_actual" and cold["isl_blocks"] == 3
    assert (cold["device_blocks"], cold["host_blocks"], cold["disk_blocks"],
            cold["peer_blocks"]) == (0, 0, 0, 0)
    await _generate(eng, prompt)
    await asyncio.sleep(0.05)
    assert actuals[1]["device_blocks"] == 2 and eng._reused_device_blocks == 2
    rd = eng.readiness()
    m = metrics[-1]
    fpm = ForwardPassMetrics.from_wire(wire.unpackb(wire.packb(m)))
    for key in ("kv_reused_device_blocks_total", "kv_reused_host_blocks_total",
                "kv_reused_disk_blocks_total", "kv_reused_peer_blocks_total"):
        assert getattr(fpm, key) == m[key] == rd[key], key
    assert fpm.kv_reused_device_blocks_total == 2
    assert fpm.kv_total_blocks == 63 and fpm.request_total_slots == 4
    assert fpm.engine_ready == int(rd["state"] == "ready") and fpm.flight_steps_total > 0
    assert fpm.unified_step_tokens_prefill_total > 0
    assert fpm.kvbm_kv_quant_ratio == 1.0 and fpm.weight_quant_active == 0.0
    await eng.stop()


def test_metric_surfaces_carry_kv_observatory_fields():
    from dynamo_tpu.llm.metrics_exporter import _GAUGES as J_GAUGES
    from dynamo_tpu_torch.llm.metrics_exporter import _GAUGES

    assert _GAUGES == J_GAUGES[:11] + (
        ("mid_traffic_compiles_total",
         "Programs made under traffic (CUDA graphs captured)"),) + J_GAUGES[12:]
    m = ForwardPassMetrics()
    for key, _help in _GAUGES:
        assert hasattr(m, key), key
    w = m.to_wire()
    w.update(kv_reused_device_blocks_total=11, kv_reused_host_blocks_total=7,
             kvbm_host_usage=0.5, kvbm_link_g3g2_bps=123.4)
    back = ForwardPassMetrics.from_wire(wire.unpackb(wire.packb(w)))
    assert back.kv_reused_device_blocks_total == 11 and back.kvbm_host_usage == 0.5
    assert back.kvbm_link_g3g2_bps == 123.4 and back.kv_reused_host_blocks_total == 7


# ---------------------------------------------------------------------------
# tools/route_audit.py against benchmarks/route_audit.py
# ---------------------------------------------------------------------------


def _route_rec(trace, overlap, pending=0, worker=1, replica=0):
    return {"kind": "route", "id": f"req-{trace}", "trace": trace,
            "worker_id": worker, "overlap_blocks": overlap, "isl_blocks": 8,
            "logit": 0.1, "decision_ms": 2.0, "candidates": [],
            "indexer": {"applied": 10, "pending": pending, "lag_p99_ms": 4.0},
            "indexer_shards": 1, "metrics_age_ms": 100.0, "replica_id": replica,
            "unix": 1000.0}


def _actual_rec(trace, device=0, host=0, disk=0):
    return {"kind": "kv_actual", "id": f"req-{trace}", "trace": trace,
            "isl_blocks": 8, "device_blocks": device, "host_blocks": host,
            "disk_blocks": disk, "unix": 1000.0}


CAPTURES = {
    "mixed": [_route_rec("t1", 4), _actual_rec("t1", device=4),
              _route_rec("t2", 6, pending=3, worker=2), _actual_rec("t2", 1, 1),
              _route_rec("t3", 2, replica=1), _actual_rec("t3", 0)],
    "orphan": [_route_rec("t9", 4), _route_rec("t1", 4), _actual_rec("t1", 4)],
    "no_actuals": [_route_rec("t1", 4)],
}


@pytest.mark.parametrize("name", sorted(CAPTURES))
def test_route_audit_join_and_gates_match_the_jax_tool(name, tmp_path):
    from benchmarks import route_audit as j_audit
    from dynamo_tpu_torch.tools import route_audit as t_audit

    cap = tmp_path / "cap.jsonl"
    rec = Recorder(cap)
    for r in CAPTURES[name]:
        rec.record(r)
    rec.close()
    t_routes, t_actuals, t_planner = t_audit.load_records([str(cap)])
    j_routes, j_actuals, _ = j_audit.load_records([str(cap)])
    assert (t_routes, t_actuals, t_planner) == (j_routes, j_actuals, [])
    for stale in (1, 3):
        t_rep = t_audit.join_report(t_routes, t_actuals, stale)
        assert t_rep == j_audit.join_report(j_routes, j_actuals, stale)
        for bound in (None, 0.5):
            assert t_audit.run_asserts(t_rep, 0.95, 0, max_abs_p95=bound) == \
                j_audit.run_asserts(t_rep, 0.95, 0, max_abs_p95=bound)
    rc = t_audit.main([str(cap), "--assert", "--json"])
    assert rc == j_audit.main([str(cap), "--assert", "--json"])
    assert rc == (0 if name == "mixed" else 1)
    if name == "mixed":
        rep = t_audit.join_report(t_routes, t_actuals)
        assert rep["joined"] == 3 and rep["overlap_error"]["exact"] == 1
        assert rep["staleness"]["mispredicted_while_stale"] == 1
        assert rep["per_replica"]["1"]["joined"] == 1


# ---------------------------------------------------------------------------
# /debug/routes and the router's own records
# ---------------------------------------------------------------------------


async def test_debug_routes_endpoint():
    from dynamo_tpu_torch.llm.discovery import ModelManager
    from dynamo_tpu_torch.llm.http_service import HttpService
    from dynamo_tpu_torch.llm.kv_router.audit import ROUTE_OBS

    before = ROUTE_OBS.routes_total
    ROUTE_OBS.record(RouteAuditRecord(request_id="r", trace_id="t", worker_id=1,
                                      overlap_blocks=2, isl_blocks=4, logit=0.0,
                                      decision_ms=1.0))
    service = HttpService(ModelManager(), host="127.0.0.1", port=0)
    await service.start()
    try:
        r = await fetch("127.0.0.1", service.port, "GET", "/debug/routes?n=4")
        assert r.status == 200
        body = r.json()
        assert body["routes_total"] == before + 1 and body["recent"][-1]["trace"] == "t"
        assert "kv_router_routes_total" in body["gauges"]
        r = await fetch("127.0.0.1", service.port, "GET", "/metrics")
        assert "kv_router_routes_total" in r.body.decode()
        r = await fetch("127.0.0.1", service.port, "GET", "/debug/routes?n=x")
        assert r.status == 400
    finally:
        await service.stop()


async def test_router_audits_each_decision_and_publishes_the_prediction():
    """find_best_match over two mocker workers: one route record per
    decision (watermark, candidates, metrics age) in ROUTE_OBS, the
    router's gauges registered, and a ``predicted`` record on the
    hit-rate plane; the worker's ``actual`` record closes it."""
    from dynamo_tpu_torch.llm.kv_router.audit import ROUTE_OBS
    from dynamo_tpu_torch.llm.kv_router.publisher import (
        KvEventPublisher,
        WorkerMetricsPublisher,
    )
    from dynamo_tpu_torch.llm.kv_router.router import KvRouter
    from dynamo_tpu_torch.runtime.distributed import DistributedRuntime
    from dynamo_tpu_torch.runtime.egress import PushRouter, RouterMode

    drt = await DistributedRuntime.in_process()
    comp = drt.namespace("obs").component("worker")
    wm = WorkerMetricsPublisher()
    pub = KvEventPublisher(drt, comp, drt.primary_lease_id)
    eng = MockerEngine(_ecfg(), MockerConfig(seed=3),
                       on_kv_event=pub.publish_engine_event, on_metrics=wm.publish,
                       on_kv_actual=pub.publish_hit_actual)
    await eng.start()
    await comp.endpoint("generate").serve(eng)
    await wm.create_endpoint(comp)
    hits = await drt.bus.subscribe(comp.event_subject(KV_HIT_RATE_PLANE))
    router = await KvRouter(drt, comp).start()
    push = await PushRouter.create(drt, "obs.worker.generate", mode=RouterMode.KV,
                                   selector=router.selector_fn)
    before = ROUTE_OBS.routes_total
    try:
        prompt = list(range(50))  # 3 full blocks, all reusable (49 // 16)
        for _ in range(2):
            req = PreprocessedRequest(token_ids=prompt,
                                      sampling=SamplingOptions(temperature=0.0),
                                      stop=StopConditions(max_tokens=2, ignore_eos=True))
            async for _item in push.generate(Context(req.to_wire())):
                pass
            for _ in range(100):
                await asyncio.sleep(0.01)
                if router.indexer.pending_events == 0:
                    break
        snap = ROUTE_OBS.snapshot(2)
        assert snap["routes_total"] == before + 2
        recs = snap["recent"]
        assert [r["overlap_blocks"] for r in recs] == [0, 3]
        assert recs[-1]["worker_id"] == drt.primary_lease_id
        assert recs[-1]["candidates"][0]["worker"] == drt.primary_lease_id
        assert {"applied", "pending", "lag_p99_ms"} <= set(recs[-1]["indexer"])
        g = ROUTE_OBS.gauges()
        assert g["kv_events_applied_total"] >= 3 and g["kv_router_metrics_stale"] == 0
        kinds = []
        while len(kinds) < 4:
            kinds.append(wire.unpackb(await asyncio.wait_for(hits.__anext__(), 2)))
        predicted = [k for k in kinds if k["kind"] == "predicted"]
        actual = [k for k in kinds if k["kind"] == "actual"]
        assert [p["overlap_blocks"] for p in predicted] == [0, 3]
        assert [a["device_blocks"] for a in actual] == [0, 3]
    finally:
        hits.close()
        await router.stop()
        await eng.stop()
        await drt.shutdown()


# ---------------------------------------------------------------------------
# metrics exporter
# ---------------------------------------------------------------------------


async def test_metrics_exporter_serves_and_pushes_worker_gauges():
    """Two workers' load metrics through the exporter: ``/metrics`` (one
    series per worker for every gauge), ``/health`` (the scraped
    workers), and the push loop's PushGateway POSTs to a local gateway."""
    from dynamo_tpu_torch.llm.discovery import ModelManager
    from dynamo_tpu_torch.llm.http_service import HttpService, _text_response
    from dynamo_tpu_torch.llm.kv_router.publisher import WorkerMetricsPublisher
    from dynamo_tpu_torch.llm.metrics_exporter import _GAUGES, MetricsExporter
    from dynamo_tpu_torch.runtime.distributed import DistributedRuntime

    pushed = []

    class Gateway(HttpService):
        _ROUTES = {"/metrics/job/jobx": ("POST", "_push")}

        async def _push(self, req, _w):
            pushed.append(req.body.decode())
            return _text_response(200, "")

    gw = Gateway(ModelManager(), host="127.0.0.1", port=0)
    await gw.start()
    drt_a = await DistributedRuntime.in_process()
    drt_b = await DistributedRuntime.in_process(store=drt_a.store, bus=drt_a.bus,
                                                runtime=drt_a.runtime)
    for drt, active in ((drt_a, 3), (drt_b, 5)):
        wm = WorkerMetricsPublisher()
        wm.publish({"kv_active_blocks": active, "kv_reused_device_blocks_total": 24})
        await wm.create_endpoint(drt.namespace("dynamo").component("torch"))
    exp = await MetricsExporter(drt_a, host="127.0.0.1", port=0, interval_s=0.05,
                                push_url=f"http://127.0.0.1:{gw.port}",
                                push_interval_s=0.1, push_job="jobx").start()
    try:
        for _ in range(100):
            if len(exp.aggregator.endpoints.metrics) == 2 and pushed:
                break
            await asyncio.sleep(0.05)
        text = (await fetch("127.0.0.1", exp.port, "GET", "/metrics")).body.decode()
        labels = 'namespace="dynamo",component="torch"'
        assert f"dyntpu_worker_count{{{labels}}} 2" in text
        for drt, active in ((drt_a, 3), (drt_b, 5)):
            w = f'{labels},worker="{drt.primary_lease_id:x}"'
            assert f"dyntpu_kv_active_blocks{{{w}}} {active}" in text
            assert f"dyntpu_kv_reused_device_blocks_total{{{w}}} 24" in text
        assert sum(line.startswith("# TYPE") for line in text.splitlines()) == \
            len(_GAUGES) + 1
        health = (await fetch("127.0.0.1", exp.port, "GET", "/health")).json()
        assert sorted(health["workers"]) == sorted(
            f"{d.primary_lease_id:x}" for d in (drt_a, drt_b))
        assert exp.push_count >= 1 and "dyntpu_worker_count" in pushed[0]
    finally:
        await exp.stop()
        await gw.stop()
        await drt_a.shutdown()


# ---------------------------------------------------------------------------
# KVBM tier telemetry
# ---------------------------------------------------------------------------

_LAYOUT8 = dict(num_layers=1, page_size=1, num_kv_heads=1, head_dim=4, dtype="float32")
# block_elems == 1*2*1*1*4 == 8: the mocker runner's 8-float block rows


def _row(seed: float):
    import numpy as np

    return np.full((8,), seed, np.float32)


async def _settle(mgr, n):
    deadline = asyncio.get_running_loop().time() + 5
    while mgr.stats()["host_registered"] < n:
        assert asyncio.get_running_loop().time() < deadline
        await asyncio.sleep(0.02)


def _counters(st: dict) -> dict:
    """The stats digest less the wall-clock rates."""
    return {k: v for k, v in st.items() if not k.endswith("_bps")}


async def test_kvbm_stats_counters_and_disk_origin(tmp_path):
    """The reference case on the port's manager, and the same operations
    on the JAX package's manager: every counter of the two stats digests
    agrees step by step (rates are wall clock: only their sign is held)."""
    from dynamo_tpu.block_manager import KvbmConfig as JKvbmConfig
    from dynamo_tpu.block_manager import KvBlockManager as JKvBlockManager
    from dynamo_tpu.block_manager import KvLayoutConfig as JKvLayoutConfig
    from dynamo_tpu_torch.block_manager import KvbmConfig, KvBlockManager, KvLayoutConfig

    async def run(mgr_cls, cfg_cls, lay_cls, path):
        mgr = await mgr_cls(cfg_cls(layout=lay_cls(**_LAYOUT8), host_blocks=4,
                                    disk_blocks=8, disk_path=str(path))).start()
        seen = []
        try:
            mgr.offer(100, None, [1] * 4, _row(1.0))
            mgr.offer(200, 100, [2] * 4, _row(2.0))
            await _settle(mgr, 2)
            await mgr._g2_to_g3.drain()
            st = mgr.stats()
            assert st["host_stored_blocks_total"] == 2
            assert st["offloaded_blocks_total"] == 2
            assert st["link_g1g2_bps"] > 0 and st["link_g2g3_bps"] > 0
            assert st["disk_registered"] == 2
            seen.append(_counters(st))
            assert mgr.count_host_match([100, 200, 999]) == 2
            st = mgr.stats()
            assert st["host_hit_blocks_total"] == 2 and st["host_miss_blocks_total"] == 1
            for b in mgr.host_pool.allocate_blocks(4):
                mgr.host_pool.release(b)
            assert mgr.stats()["host_evictions_total"] >= 2
            assert mgr.count_host_match([100, 200]) == 0
            assert await mgr.onboard_from_disk([100, 200]) == 2
            st = mgr.stats()
            assert st["promoted_blocks_total"] == 2 and st["link_g3g2_bps"] > 0
            assert mgr.count_disk_origin([100, 200]) == 2
            assert mgr.count_disk_origin([999]) == 0
            seen.append(_counters(mgr.stats()))
            for b in mgr.host_pool.allocate_blocks(4):
                mgr.host_pool.release(b)
            assert mgr.count_host_match([100]) == 0
            mgr.offer(100, None, [1] * 4, _row(1.0))
            await _settle(mgr, 1)
            assert mgr.count_disk_origin([100]) == 0
            seen.append(_counters(mgr.stats()))
        finally:
            await mgr.stop()
        return seen

    mine = await run(KvBlockManager, KvbmConfig, KvLayoutConfig, tmp_path / "a.bin")
    theirs = await run(JKvBlockManager, JKvbmConfig, JKvLayoutConfig, tmp_path / "b.bin")
    assert mine == theirs


async def test_engine_reports_actuals_split_by_tier():
    """Engine A computes a prompt cold (actual reuse 0) then warm (device
    tier); a FRESH engine B sharing the host tier reuses via G2 — every
    path lands a kv_actual record with the right split, and the readiness
    snapshot, the metrics callback and the ForwardPassMetrics wire agree
    on every KV observatory key."""
    from dynamo_tpu_torch.block_manager import KvbmConfig, KvBlockManager, KvLayoutConfig

    kvbm = await KvBlockManager(KvbmConfig(layout=KvLayoutConfig(**_LAYOUT8),
                                           host_blocks=16)).start()
    actuals_a: list[dict] = []
    metrics_a: list[dict] = []
    eng_a = MockerEngine(_ecfg(), MockerConfig(seed=1), block_manager=kvbm,
                         on_kv_actual=actuals_a.append, on_metrics=metrics_a.append)
    await eng_a.start()
    prompt = list(range(40))  # 2 full blocks + tail
    await _generate(eng_a, prompt)
    await asyncio.sleep(0.05)
    assert len(actuals_a) == 1
    cold = actuals_a[0]
    assert cold["kind"] == "kv_actual" and cold["isl_blocks"] == 3
    assert (cold["device_blocks"], cold["host_blocks"], cold["disk_blocks"]) == (0, 0, 0)
    await _generate(eng_a, prompt)
    await asyncio.sleep(0.05)
    warm = actuals_a[1]
    assert warm["device_blocks"] == 2
    assert warm["host_blocks"] == 0 and warm["disk_blocks"] == 0
    assert eng_a._reused_device_blocks == 2
    rd = eng_a.readiness()
    assert rd["kv_reused_device_blocks_total"] == 2
    assert rd["kvbm_host_registered"] == kvbm.stats()["host_registered"]
    assert metrics_a, "metrics callback never fired"
    m = metrics_a[-1]
    fpm = ForwardPassMetrics.from_wire(wire.unpackb(wire.packb(m)))
    for key in ("kv_reused_device_blocks_total", "kv_reused_host_blocks_total",
                "kv_reused_disk_blocks_total", "kvbm_host_registered",
                "kvbm_host_stored_blocks_total", "kvbm_host_hit_blocks_total"):
        assert key in m, key
        assert getattr(fpm, key) == m[key] == rd[key], key
    await kvbm.drain_offers()
    await eng_a.stop()

    actuals_b: list[dict] = []
    eng_b = MockerEngine(_ecfg(), MockerConfig(seed=2), block_manager=kvbm,
                         on_kv_actual=actuals_b.append)
    await eng_b.start()
    await _generate(eng_b, prompt)
    await asyncio.sleep(0.05)
    assert len(actuals_b) == 1
    host = actuals_b[0]
    assert host["host_blocks"] == 2 and host["device_blocks"] == 0
    assert eng_b.readiness()["kv_reused_host_blocks_total"] == 2
    await eng_b.stop()
    await kvbm.stop()


def test_engine_gauges_carry_every_kvbm_stat():
    """The engine's kvbm_ gauges are exactly the JAX engine's, each a
    ForwardPassMetrics field, and every block-manager stats key is among
    them."""
    import dataclasses

    from dynamo_tpu.block_manager import KvbmConfig as JKvbmConfig
    from dynamo_tpu.block_manager import KvBlockManager as JKvBlockManager
    from dynamo_tpu.block_manager import KvLayoutConfig as JKvLayoutConfig
    from dynamo_tpu.engine.config import EngineConfig as JEngineConfig
    from dynamo_tpu.mocker import MockerEngine as JMockerEngine
    from dynamo_tpu.models.config import ModelConfig as JModelConfig
    from dynamo_tpu_torch.block_manager import KvbmConfig, KvBlockManager, KvLayoutConfig

    kvbm = KvBlockManager(KvbmConfig(layout=KvLayoutConfig(**_LAYOUT8), host_blocks=2))
    g = MockerEngine(_ecfg(), block_manager=kvbm)._kvbm_gauges()
    fields = {f.name for f in dataclasses.fields(ForwardPassMetrics)}
    assert set(g) <= fields
    assert {f"kvbm_{k}" for k in kvbm.stats()} <= set(g)
    jk = JKvBlockManager(JKvbmConfig(layout=JKvLayoutConfig(**_LAYOUT8), host_blocks=2))
    jeng = JMockerEngine(JEngineConfig(model=JModelConfig.tiny_test(), num_blocks=64,
                                       max_num_seqs=4, max_model_len=256, dtype="float32"),
                         block_manager=jk)
    assert set(jeng._kvbm_gauges()) == set(g)
    assert set(jk.stats()) == set(kvbm.stats())
