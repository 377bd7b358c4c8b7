"""The port's planner plane (dynamo_tpu_torch/planner/), case for case
with tests/test_planner.py and tests/test_fleet_planner.py, on the
port's runtime plane: watermark and SLA scaling with zero failed
requests, checkpoint resume, the two pools' independent laws,
hysteresis, drain-not-kill and requeue-not-drop shrinking, crash
healing, the v1→v2 state migration, and the observatory's three sinks.

The laws are held against the JAX package's on the same inputs: the
same FleetSample sequences through both packages' PrefillLaw, DecodeLaw
and WorkerPool, and the same observation windows through both
single-pool planners, give the same decision sequences."""

from __future__ import annotations

import asyncio
import collections
import json
import os

import numpy as np
import pytest

from dynamo_tpu.llm.kv_router import protocols as j_proto
from dynamo_tpu.planner import planner as j_planner
from dynamo_tpu.planner import pools as j_pools
from dynamo_tpu.planner import profiles as j_profiles
from dynamo_tpu.planner.obs import PLANNER_OBS as J_OBS
from dynamo_tpu_torch.llm.engines import EchoEngineCore
from dynamo_tpu_torch.llm.kv_router import protocols as t_proto
from dynamo_tpu_torch.llm.kv_router.publisher import WorkerMetricsPublisher
from dynamo_tpu_torch.llm.protocols.common import (
    PreprocessedRequest,
    SamplingOptions,
    StopConditions,
)
from dynamo_tpu_torch.planner import (
    PLANNER_OBS,
    DecodeLaw,
    FleetPlanner,
    FleetPlannerConfig,
    FleetSample,
    Planner,
    PlannerConfig,
    PoolConfig,
    PrefillLaw,
    WorkerPool,
)
from dynamo_tpu_torch.planner import planner as t_planner
from dynamo_tpu_torch.planner import pools as t_pools
from dynamo_tpu_torch.planner import profiles as t_profiles
from dynamo_tpu_torch.planner.profiles import PerfPoint, PerfProfile
from dynamo_tpu_torch.runtime.distributed import DistributedRuntime
from dynamo_tpu_torch.runtime.egress import PushRouter, RouterMode
from dynamo_tpu_torch.runtime.engine import Context
from dynamo_tpu_torch.utils.faults import FAULTS

pytestmark = pytest.mark.anyio

#: The port's workers serve dyn://dynamo.torch.generate.
COMPONENT = "torch"


@pytest.fixture(autouse=True)
def _clean_planner_obs():
    PLANNER_OBS.reset()
    J_OBS.reset()
    yield
    PLANNER_OBS.reset()
    J_OBS.reset()
    FAULTS.clear()


def test_planner_exports_the_reference_names():
    import dynamo_tpu.planner as j
    import dynamo_tpu_torch.planner as t

    assert t.__all__ == j.__all__
    assert sorted(p.name for p in __import__("pathlib").Path(t.__file__).parent.glob("*.py")) \
        == sorted(p.name for p in __import__("pathlib").Path(j.__file__).parent.glob("*.py"))


class CountingConnector:
    def __init__(self) -> None:
        self.spawned = 0
        self.drained = 0

    async def spawn(self):
        self.spawned += 1
        return object()

    async def drain(self, handle) -> None:
        self.drained += 1


def _req(n_tokens: int = 3):
    return PreprocessedRequest(
        token_ids=list(range(1, n_tokens + 1)),
        sampling=SamplingOptions(),
        stop=StopConditions(max_tokens=n_tokens, ignore_eos=True),
    ).to_wire()


# -- the laws against the JAX package's -------------------------------------------


def _samples(seed: int, n: int = 60) -> list[dict]:
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        waiting = float(rng.choice([0.0, 0.2, 1.0, 3.0, 6.0]))
        split = rng.random()
        out.append(dict(
            queue_depth=float(rng.choice([0.0, 0.05, 0.5, 2.0, 8.0])),
            queue_age_s=float(rng.choice([0.0, 1.0, 3.0, 30.0])),
            kv_usage=float(rng.choice([0.0, 0.2, 0.5, 0.9])),
            waiting=waiting,
            itl_ema_ms=float(rng.choice([0.0, 5.0, 15.0, 30.0])),
            waiting_interactive=waiting * split if rng.random() < 0.5 else 0.0,
            waiting_batch=waiting * (1 - split) if rng.random() < 0.5 else 0.0,
            decode_workers_seen=int(rng.random() < 0.9),
            queue_samples=int(rng.random() < 0.9),
        ))
    return out


@pytest.mark.parametrize("seed", range(4))
def test_laws_decide_as_the_reference(seed):
    rng = np.random.default_rng(100 + seed)
    pkw = dict(queue_up_per_worker=float(rng.choice([0.5, 1.0, 2.0])),
               queue_down_per_worker=float(rng.choice([0.05, 0.1])),
               age_up_s=float(rng.choice([2.0, 5.0])))
    dkw = dict(itl_up_ms=[None, 20.0][seed % 2], itl_down_ms=[None, 10.0][seed % 2],
               batch_weight=float(rng.choice([0.25, 0.5, 1.0])))
    for s in _samples(seed):
        n = int(rng.integers(1, 6))
        js, ts = j_pools.FleetSample(**s), t_pools.FleetSample(**s)
        assert t_pools.PrefillLaw(**pkw).decide(ts, n) == j_pools.PrefillLaw(**pkw).decide(js, n)
        assert t_pools.DecodeLaw(**dkw).decide(ts, n) == j_pools.DecodeLaw(**dkw).decide(js, n)
        assert t_pools.PrefillLaw(**pkw).signals(ts) == j_pools.PrefillLaw(**pkw).signals(js)
        assert t_pools.DecodeLaw(**dkw).signals(ts) == j_pools.DecodeLaw(**dkw).signals(js)


@pytest.mark.parametrize("seed", range(4))
async def test_pool_decision_sequences_match_the_reference(seed):
    """The same samples through both packages' WorkerPool (law plus
    hysteresis: the idle streak, the cooldowns, the bounds) give the
    same applied decisions and sizes, tick for tick."""
    rng = np.random.default_rng(200 + seed)
    cfg = dict(min_workers=int(rng.integers(1, 3)), max_workers=int(rng.integers(3, 6)),
               up_cooldown_s=0.0, down_cooldown_s=0.0,
               down_consecutive=int(rng.integers(1, 4)))
    out = {}
    for name, mod in (("jax", j_pools), ("port", t_pools)):
        conn = CountingConnector()
        pools = [mod.WorkerPool(mod.PoolConfig(name="prefill", **cfg), conn, mod.PrefillLaw()),
                 mod.WorkerPool(mod.PoolConfig(name="decode", **cfg), conn, mod.DecodeLaw())]
        trail = []
        for p in pools:
            await p.ensure_min()
        for s in _samples(seed):
            for p in pools:
                trail.append((await p.adjust(mod.FleetSample(**s)), p.size))
        for p in pools:
            await p.wait_drained()
        out[name] = (trail, conn.spawned, conn.drained)
    assert out["port"] == out["jax"]


def _windows(mod, proto, seed: int, n: int = 30):
    rng = np.random.default_rng(300 + seed)
    wins = []
    for _ in range(n):
        w = mod._Window()
        for _ in range(int(rng.integers(1, 5))):
            metrics = {
                wid: proto.ForwardPassMetrics(
                    gpu_cache_usage_perc=float(rng.choice([0.0, 0.2, 0.9])),
                    num_requests_waiting=int(rng.choice([0, 1, 4])),
                    request_active_slots=int(rng.integers(0, 9)))
                for wid in range(int(rng.integers(0, 3)))}
            w.add(int(rng.choice([0, 0, 1, 3, 9])), metrics)
        wins.append(w)
    return wins


@pytest.mark.parametrize("sla", [False, True], ids=["watermark", "sla"])
@pytest.mark.parametrize("seed", range(3))
async def test_single_pool_planner_decides_as_the_reference(seed, sla, tmp_path):
    """The same observation windows through both single-pool planners'
    adjustment (watermarks, or a profile and a TTFT SLA) give the same
    decisions and worker counts, and the same decision-log fields."""
    out = {}
    for name, mod, proto, prof in (("jax", j_planner, j_proto, j_profiles),
                                   ("port", t_planner, t_proto, t_profiles)):
        p = mod.Planner.__new__(mod.Planner)
        p.cfg = mod.PlannerConfig(min_workers=1, max_workers=4, ttft_sla_ms=200.0 if sla else None,
                                  decision_log_path=str(tmp_path / f"{name}.jsonl"))
        p.connector = CountingConnector()
        p._handles = [object()]
        p.decisions = []
        p.profile = prof.PerfProfile([prof.PerfPoint(1, 100, 15), prof.PerfPoint(4, 200, 16),
                                      prof.PerfPoint(16, 800, 20)]) if sla else None
        trail = []
        for w in _windows(mod, proto, seed):
            await p._adjust(w)
            trail.append((p.decisions[-1], len(p._handles)))
        logged = [{k: v for k, v in json.loads(line).items() if k != "ts"}
                  for line in (tmp_path / f"{name}.jsonl").read_text().splitlines()]
        out[name] = (trail, logged, p.connector.spawned, p.connector.drained)
    assert out["port"] == out["jax"]


@pytest.mark.parametrize("seed", range(3))
def test_perf_profile_matches_the_reference(seed):
    rng = np.random.default_rng(400 + seed)
    conc = sorted(set(int(x) for x in rng.integers(1, 64, 4)))
    pts = [(c, float(rng.uniform(50, 900)), float(rng.uniform(10, 30))) for c in conc]
    jp = j_profiles.PerfProfile([j_profiles.PerfPoint(*p) for p in pts])
    tp = t_profiles.PerfProfile([t_profiles.PerfPoint(*p) for p in pts])
    for c in rng.uniform(0, 100, 20):
        assert tp.ttft_ms(c) == jp.ttft_ms(c) and tp.itl_ms(c) == jp.itl_ms(c)
    for sla in (None, 100.0, 400.0):
        assert tp.max_concurrency_within(sla, 18.0) == jp.max_concurrency_within(sla, 18.0)
        for load in (0.0, 7.0, 55.0):
            assert tp.target_workers(load, sla, None) == jp.target_workers(load, sla, None)


# -- tests/test_planner.py -------------------------------------------------------


class InProcConnector:
    """A worker is an in-process runtime (its own lease) serving the echo
    engine and a metrics endpoint on the shared control plane."""

    def __init__(self, main_drt) -> None:
        self.main = main_drt
        self.spawned = 0
        self.drained = 0

    async def spawn(self):
        drt = await DistributedRuntime.in_process(store=self.main.store, bus=self.main.bus)
        comp = drt.namespace("dynamo").component(COMPONENT)
        await comp.endpoint("generate").serve(EchoEngineCore())
        pub = WorkerMetricsPublisher()
        pub.publish({"gpu_cache_usage_perc": 0.0, "num_requests_waiting": 0})
        await pub.create_endpoint(comp)
        self.spawned += 1
        return drt

    async def drain(self, drt) -> None:
        await drt.shutdown()
        self.drained += 1


async def _until(cond, what: str, timeout: float = 5.0) -> None:
    deadline = asyncio.get_running_loop().time() + timeout
    while not cond():
        assert asyncio.get_running_loop().time() < deadline, what
        await asyncio.sleep(0.03)


async def test_planner_scales_up_on_load_and_down_when_idle(tmp_path):
    drt = await DistributedRuntime.in_process()
    connector = InProcConnector(drt)
    decision_log = tmp_path / "decisions.jsonl"
    planner = Planner(
        drt,
        PlannerConfig(min_workers=1, max_workers=2, metric_interval_s=0.02,
                      adjustment_interval_s=0.15, queue_up_threshold=0.5,
                      queue_down_threshold=0.1, decision_log_path=str(decision_log)),
        connector=connector,
    )
    await planner.start()
    assert planner.num_workers == 1
    push = await PushRouter.create(drt, f"dynamo.{COMPONENT}.generate",
                                   mode=RouterMode.ROUND_ROBIN)
    failures = requests = 0
    stop_traffic = asyncio.Event()

    async def traffic():
        nonlocal failures, requests
        while not stop_traffic.is_set():
            requests += 1
            try:
                async for _ in push.generate(Context(_req())):
                    pass
            except Exception:  # noqa: BLE001 — counted
                failures += 1
            await asyncio.sleep(0.01)

    traffic_task = asyncio.ensure_future(traffic())
    queue = drt.bus.work_queue("dynamo.prefill_queue")
    for i in range(8):
        await queue.enqueue(b"job%d" % i)
    await _until(lambda: planner.num_workers >= 2, f"never scaled up {planner.decisions}")
    assert connector.spawned == 2
    while await queue.dequeue(timeout_s=0.1):
        pass
    await _until(lambda: planner.num_workers <= 1, f"never scaled down {planner.decisions}")
    assert connector.drained == 1
    for i in range(8):
        await queue.enqueue(b"again%d" % i)
    await asyncio.sleep(0.4)
    assert planner.num_workers <= 2
    await asyncio.sleep(0.1)
    stop_traffic.set()
    await traffic_task
    assert requests > 10
    assert failures == 0, f"{failures}/{requests} requests failed"
    await planner.stop(drain_workers=True)
    assert planner.num_workers == 0
    await drt.shutdown()
    lines = [json.loads(line) for line in decision_log.read_text().splitlines()]
    assert {"up", "down"} <= {line["decision"] for line in lines}
    assert all({"ts", "decision", "workers", "queue", "kv", "waiting"} <= set(line)
               for line in lines)


async def test_planner_state_checkpoint_resume(tmp_path):
    state = tmp_path / "dynamo.json"

    class PidConnector:
        def __init__(self):
            self.next_pid = 100
            self.adopted = []
            self.spawned = 0

        async def spawn(self):
            self.spawned += 1
            self.next_pid += 1
            return type("H", (), {"pid": self.next_pid})()

        async def drain(self, handle):
            pass

        def adopt(self, pid):
            if pid % 2:
                return None
            self.adopted.append(pid)
            return type("H", (), {"pid": pid})()

    drt = await DistributedRuntime.in_process()
    conn = PidConnector()
    cfg = PlannerConfig(min_workers=2, metric_interval_s=10, adjustment_interval_s=10,
                        state_path=str(state))
    p1 = Planner(drt, cfg, connector=conn)
    await p1.start()
    assert p1.num_workers == 2
    await p1.stop()
    assert [w["pid"] for w in json.loads(state.read_text())["workers"]] == [101, 102]
    conn2 = PidConnector()
    conn2.next_pid = 200
    p2 = Planner(drt, cfg, connector=conn2)
    await p2.start()
    assert conn2.adopted == [102]
    assert conn2.spawned == 1
    assert p2.num_workers == 2
    await p2.stop()
    assert [w["pid"] for w in json.loads(state.read_text())["workers"]] == [102, 201]
    await drt.shutdown()


def test_perf_profile_interpolation_and_targets(tmp_path):
    prof = PerfProfile([PerfPoint(1, ttft_ms=100, itl_ms=15), PerfPoint(8, ttft_ms=200, itl_ms=16),
                        PerfPoint(32, ttft_ms=800, itl_ms=20)])
    assert prof.ttft_ms(1) == 100
    assert prof.ttft_ms(4.5) == 150
    assert prof.ttft_ms(0.5) == 100
    assert prof.ttft_ms(40) > 800
    assert abs(prof.max_concurrency_within(ttft_sla_ms=200) - 8) < 0.01
    c = prof.max_concurrency_within(ttft_sla_ms=500)
    assert 8 < c < 32 and abs(prof.ttft_ms(c) - 500) < 1.0
    assert prof.max_concurrency_within(ttft_sla_ms=500, itl_sla_ms=16) <= 8.01
    assert prof.max_concurrency_within(ttft_sla_ms=1) == 1.0
    assert prof.target_workers(64, ttft_sla_ms=200) == 8
    assert prof.target_workers(0, ttft_sla_ms=200) == 1
    bench = {"metric": "x", "value": 1.0, "extras": {"sweep": [
        {"concurrency": 1, "p50_ttft_ms": 100, "p50_itl_ms": 15},
        {"concurrency": 16, "p50_ttft_ms": 400, "p50_itl_ms": 18},
        {"concurrency": 32, "p50_ttft_ms": None, "p50_itl_ms": None}]}}
    p = tmp_path / "bench.json"
    p.write_text(json.dumps(bench))
    assert PerfProfile.from_bench_json(p).ttft_ms(16) == 400
    # One profile file serves both packages' planners.
    assert j_profiles.PerfProfile.from_bench_json(p).points == [
        j_profiles.PerfPoint(*vars(q).values()) for q in PerfProfile.from_bench_json(p).points]
    (tmp_path / "empty.json").write_text(json.dumps({"extras": {"sweep": []}}))
    with pytest.raises(ValueError):
        PerfProfile.from_bench_json(tmp_path / "empty.json")


async def test_planner_sla_mode_scales_to_profile_target():
    drt = await DistributedRuntime.in_process()
    connector = InProcConnector(drt)
    prof = PerfProfile([PerfPoint(1, 100, 15), PerfPoint(8, 200, 16), PerfPoint(32, 800, 20)])
    planner = Planner(
        drt, PlannerConfig(min_workers=1, max_workers=3, metric_interval_s=0.02,
                           adjustment_interval_s=0.1, ttft_sla_ms=200.0),
        connector=connector, profile=prof)
    await planner.start()
    queue = drt.bus.work_queue("dynamo.prefill_queue")
    for i in range(20):
        await queue.enqueue(b"job%d" % i)
    await _until(lambda: planner.num_workers >= 3, f"never reached target {planner.decisions}")
    while await queue.dequeue(timeout_s=0.05):
        pass
    await _until(lambda: planner.num_workers <= 1, f"never scaled down {planner.decisions}")
    await planner.stop(drain_workers=True)
    await drt.shutdown()


# -- tests/test_fleet_planner.py: laws and hysteresis ---------------------------


def test_prefill_law_is_queue_driven_and_per_worker():
    law = PrefillLaw(queue_up_per_worker=1.0, queue_down_per_worker=0.1)
    assert law.decide(FleetSample(queue_depth=8), 2) == "up"
    assert law.decide(FleetSample(queue_depth=8), 16) == "hold"
    assert law.decide(FleetSample(queue_depth=0.5, queue_age_s=30), 16) == "up"
    assert law.decide(FleetSample(queue_depth=0.0), 4) == "down"
    assert law.decide(FleetSample(kv_usage=0.99), 1) == "down"


def test_decode_law_is_kv_and_itl_driven():
    law = DecodeLaw(kv_up_threshold=0.8, itl_up_ms=20.0, itl_down_ms=10.0)
    assert law.decide(FleetSample(kv_usage=0.9), 1) == "up"
    assert law.decide(FleetSample(itl_ema_ms=25.0), 1) == "up"
    assert law.decide(FleetSample(queue_depth=50), 1) == "down"
    assert law.decide(FleetSample(kv_usage=0.5), 1) == "hold"
    assert law.decide(FleetSample(itl_ema_ms=15.0), 1) == "hold"
    assert law.decide(FleetSample(kv_usage=0.1, itl_ema_ms=5.0), 1) == "down"


def test_decode_law_class_weighted_pressure():
    law = DecodeLaw(waiting_up_per_worker=2.0, batch_weight=0.5)
    assert law.decide(FleetSample(waiting=3.0, waiting_batch=3.0), n=1) == "hold"
    assert law.decide(FleetSample(waiting=3.0, waiting_interactive=3.0), n=1) == "up"
    assert law.decide(FleetSample(waiting=3.0), n=1) == "up"


def test_laws_hold_when_telemetry_blind():
    from dynamo_tpu_torch.planner.fleet import _Window

    assert DecodeLaw().decide(FleetSample(decode_workers_seen=0), 4) == "hold"
    assert PrefillLaw().decide(FleetSample(queue_samples=0), 4) == "hold"
    s = _Window().digest()
    assert s.queue_samples == 0 and s.decode_workers_seen == 0
    assert DecodeLaw().decide(s, 4) == "hold"
    assert PrefillLaw().decide(s, 4) == "hold"
    w = _Window()
    w.add(0, 0.0, {1: t_proto.ForwardPassMetrics()})
    s = w.digest()
    assert s.decode_workers_seen == 1 and s.queue_samples == 1
    assert DecodeLaw().decide(s, 4) == "down"
    assert PrefillLaw().decide(s, 4) == "down"
    w = _Window()
    w.add_metrics({1: t_proto.ForwardPassMetrics(gpu_cache_usage_perc=0.95)})
    s = w.digest()
    assert s.queue_samples == 0 and s.decode_workers_seen == 1
    assert DecodeLaw().decide(s, 1) == "up"
    assert PrefillLaw().decide(s, 4) == "hold"


async def test_pool_hysteresis_down_consecutive_and_up_cooldown():
    conn = CountingConnector()
    pool = WorkerPool(PoolConfig(name="decode", min_workers=1, max_workers=4,
                                 up_cooldown_s=30.0, down_consecutive=2), conn, DecodeLaw())
    await pool.ensure_min()
    hot, idle = FleetSample(kv_usage=0.95), FleetSample()
    assert await pool.adjust(hot) == "up"
    assert await pool.adjust(hot) == "hold"
    assert pool.size == 2
    assert await pool.adjust(idle) == "hold"
    assert await pool.adjust(idle) == "down"
    await pool.wait_drained()
    assert pool.size == 1 and conn.drained == 1
    pool.cfg.up_cooldown_s = 0.0
    assert await pool.adjust(idle) == "hold"
    assert await pool.adjust(hot) == "up"
    assert await pool.adjust(idle) == "hold"
    assert await pool.adjust(idle) == "down"
    await pool.wait_drained()


# -- two pools --------------------------------------------------------------------


async def test_pools_scale_independently(tmp_path):
    drt = await DistributedRuntime.in_process()
    pf_conn, dec_conn = CountingConnector(), CountingConnector()
    planner = FleetPlanner(
        drt,
        FleetPlannerConfig(metric_interval_s=0.02, adjustment_interval_s=0.12,
                           decision_log_path=str(tmp_path / "decisions.jsonl")),
        WorkerPool(PoolConfig(name="prefill", min_workers=1, max_workers=3,
                              down_consecutive=1), pf_conn, PrefillLaw()),
        WorkerPool(PoolConfig(name="decode", min_workers=1, max_workers=3,
                              down_consecutive=1), dec_conn, DecodeLaw()),
    )
    await planner.start()
    assert planner.prefill.size == 1 and planner.decode.size == 1
    queue = drt.bus.work_queue("dynamo.prefill_queue")
    for i in range(8):
        await queue.enqueue(b"job%d" % i)
    await _until(lambda: planner.prefill.size >= 2, f"prefill {planner.prefill.decisions}")
    assert planner.decode.size == 1, "queue spike leaked into decode pool"
    while await queue.dequeue(timeout_s=0.05):
        pass
    await _until(lambda: planner.prefill.size <= 1, "prefill never shrank")
    assert planner.decode.size == 1
    comp = drt.namespace("dynamo").component(COMPONENT)
    pub = WorkerMetricsPublisher()
    pub.publish({"gpu_cache_usage_perc": 0.95, "num_requests_waiting": 0})
    await pub.create_endpoint(comp)
    await _until(lambda: planner.decode.size >= 2, f"decode {planner.decode.decisions}")
    assert planner.prefill.size == 1, "KV pressure leaked into prefill pool"
    pub.publish({"gpu_cache_usage_perc": 0.05, "num_requests_waiting": 0})
    await _until(lambda: planner.decode.size <= 1, "decode never shrank")
    await planner.stop(drain_workers=True)
    assert planner.prefill.size == 0 and planner.decode.size == 0
    assert pf_conn.drained == pf_conn.spawned
    assert dec_conn.drained == dec_conn.spawned
    await drt.shutdown()


async def test_scale_up_hook_fires_on_up_and_is_contained():
    drt = await DistributedRuntime.in_process()
    calls = []

    async def hook(pool_name, new_size):
        calls.append((pool_name, new_size))
        if len(calls) == 2:
            raise RuntimeError("preplace push blew up")

    planner = FleetPlanner(
        drt, FleetPlannerConfig(),
        WorkerPool(PoolConfig(name="prefill", min_workers=1, max_workers=3),
                   CountingConnector(), PrefillLaw()),
        WorkerPool(PoolConfig(name="decode", min_workers=1, max_workers=3, up_cooldown_s=0.0),
                   CountingConnector(), DecodeLaw()),
        on_scale_up=hook,
    )
    for pool in planner.pools:
        await pool.ensure_min()
    hot = FleetSample(kv_usage=0.95)
    await planner._adjust(hot)
    assert calls == [("decode", 2)]
    await planner._adjust(FleetSample(kv_usage=0.5))
    assert calls == [("decode", 2)]
    await planner._adjust(hot)
    assert calls == [("decode", 2), ("decode", 3)]
    assert planner.decode.size == 3 and planner.prefill.size == 1
    await drt.shutdown()


class SlowStreamEngine:
    """One token per 10 ms: a scale-down lands mid-stream."""

    def __init__(self) -> None:
        self.active = 0
        self.streams_completed = 0

    async def generate(self, request: Context):
        from dynamo_tpu_torch.llm.protocols.common import EngineOutput, FinishReason

        pre = PreprocessedRequest.from_wire(request.payload)
        self.active += 1
        try:
            n = pre.stop.max_tokens or 8
            for i in range(n):
                await asyncio.sleep(0.01)
                yield EngineOutput(token_ids=[i + 1], cum_tokens=i + 1).to_wire()
            yield EngineOutput(token_ids=[], finish_reason=FinishReason.STOP,
                               cum_tokens=n).to_wire()
            self.streams_completed += 1
        finally:
            self.active -= 1


class StreamingConnector:
    """Worker = an in-process runtime serving SlowStreamEngine; ``drain``
    waits for the in-flight streams, then shuts it down."""

    def __init__(self, main_drt) -> None:
        self.main = main_drt
        self.drained = 0

    async def spawn(self):
        drt = await DistributedRuntime.in_process(store=self.main.store, bus=self.main.bus)
        engine = SlowStreamEngine()
        await drt.namespace("dynamo").component(COMPONENT).endpoint("generate").serve(engine)
        return (drt, engine)

    async def drain(self, handle) -> None:
        drt, engine = handle
        deadline = asyncio.get_running_loop().time() + 10
        while engine.active > 0:
            assert asyncio.get_running_loop().time() < deadline
            await asyncio.sleep(0.01)
        await drt.shutdown()
        self.drained += 1


async def test_decode_scale_down_finishes_in_flight_stream():
    drt = await DistributedRuntime.in_process()
    conn = StreamingConnector(drt)
    pool = WorkerPool(PoolConfig(name="decode", min_workers=1, max_workers=2,
                                 down_consecutive=1), conn, DecodeLaw())
    await pool.ensure_min()
    assert await pool.adjust(FleetSample(kv_usage=0.95)) == "up"
    victim_drt, victim_engine = pool.handles[-1]
    push = await PushRouter.create(drt, f"dynamo.{COMPONENT}.generate",
                                   mode=RouterMode.ROUND_ROBIN)
    n_tokens = 40
    got: list[int] = []
    first_token = asyncio.Event()

    async def consume():
        async for item in push.direct(Context(_req(n_tokens)), victim_drt.primary_lease_id):
            toks = item.get("token_ids") or []
            got.extend(toks)
            if toks:
                first_token.set()

    consumer = asyncio.ensure_future(consume())
    await asyncio.wait_for(first_token.wait(), 5)
    assert await pool.adjust(FleetSample()) == "down"
    assert pool.size == 1
    await asyncio.wait_for(consumer, 10)
    assert got == list(range(1, n_tokens + 1))
    assert victim_engine.streams_completed == 1
    await pool.wait_drained()
    assert conn.drained == 1
    await pool.drain_all()
    await drt.shutdown()


class QueueConsumerConnector:
    """Worker = a task draining the shared prefill queue with leased
    dequeues; ``drain`` finishes and acks the current item."""

    def __init__(self, drt, processed: collections.Counter) -> None:
        from dynamo_tpu_torch.disagg.queue import PrefillQueue

        self.queue = PrefillQueue(drt, "dynamo")
        self.processed = processed
        self.drained = 0

    async def spawn(self):
        stop = asyncio.Event()

        async def run():
            while not stop.is_set():
                got = await self.queue.dequeue(timeout_s=0.05)
                if got is None:
                    continue
                item_id, req = got
                await asyncio.sleep(0.02)
                await self.queue.ack(item_id)
                self.processed[req["request_id"]] += 1

        return {"stop": stop, "task": asyncio.ensure_future(run())}

    async def drain(self, handle) -> None:
        handle["stop"].set()
        await handle["task"]
        self.drained += 1


async def test_prefill_scale_down_requeues_exactly_once():
    drt = await DistributedRuntime.in_process()
    processed: collections.Counter = collections.Counter()
    conn = QueueConsumerConnector(drt, processed)
    pool = WorkerPool(PoolConfig(name="prefill", min_workers=1, max_workers=2,
                                 down_consecutive=1), conn, PrefillLaw())
    await pool.ensure_min()
    assert await pool.adjust(FleetSample(queue_depth=8)) == "up"
    n_items = 14
    for i in range(n_items):
        await conn.queue.enqueue({"request_id": f"req-{i}", "token_ids": [1]})
    await asyncio.sleep(0.03)
    FAULTS.arm("control.call", "delay", delay_s=0.005, times=8)
    assert await pool.adjust(FleetSample(queue_depth=0)) == "down"
    await pool.wait_drained()
    assert pool.size == 1 and conn.drained == 1
    await _until(lambda: sum(processed.values()) >= n_items, f"backlog {dict(processed)}", 10)
    await asyncio.sleep(0.1)
    assert sum(processed.values()) == n_items
    assert all(v == 1 for v in processed.values()), dict(processed)
    assert await conn.queue.depth() == 0
    await pool.drain_all()
    await drt.shutdown()


class DyingConnector(CountingConnector):
    """Workers whose ``alive`` the test flips: crash healing."""

    def __init__(self) -> None:
        super().__init__()
        self.dead: set[int] = set()

    async def spawn(self):
        self.spawned += 1
        return type("H", (), {"pid": self.spawned})()

    def alive(self, handle) -> bool:
        return handle.pid not in self.dead


async def test_reap_dead_replaces_at_once_without_drain(tmp_path):
    """A crashed worker is removed and replaced at target size, with no
    drain accounting; the replacement lands in the state file and the
    observatory counts it (pools.reap_dead)."""
    drt = await DistributedRuntime.in_process()
    dec = DyingConnector()
    state = tmp_path / "state.json"
    planner = FleetPlanner(
        drt, FleetPlannerConfig(metric_interval_s=0.02, adjustment_interval_s=10,
                                state_path=str(state)),
        WorkerPool(PoolConfig(name="prefill", min_workers=1), CountingConnector(), PrefillLaw()),
        WorkerPool(PoolConfig(name="decode", min_workers=2, max_workers=2), dec, DecodeLaw()),
    )
    await planner.start()
    assert [h.pid for h in planner.decode.handles] == [1, 2]
    dec.dead.add(1)
    await _until(lambda: [h.pid for h in planner.decode.handles] == [2, 3], "never healed")
    assert dec.drained == 0
    await _until(lambda: [w["pid"] for w in json.loads(state.read_text())["pools"]["decode"][
        "workers"]] == [2, 3], "state file never carried the replacement")
    g = PLANNER_OBS.gauges()
    assert g["planner_replaced_dead_total"] == 1 and g["planner_decode_replaced_dead_total"] == 1
    await planner.stop()
    await drt.shutdown()


# -- state ---------------------------------------------------------------------------


def test_adopt_refuses_recycled_pid():
    from dynamo_tpu_torch.planner.planner import SubprocessConnector, _proc_start_ticks

    conn = SubprocessConnector("true")
    me = os.getpid()
    real_start = _proc_start_ticks(me)
    assert real_start is not None and real_start == j_planner._proc_start_ticks(me)
    assert conn.adopt(me, started=real_start + 12345) is None
    handle = conn.adopt(me, started=real_start)
    assert handle is not None and handle.pid == me
    assert conn.adopt(2**22 + 1234, started=None) is None


class PidConnector:
    def __init__(self, base: int) -> None:
        self.next_pid = base
        self.adopted: list[int] = []
        self.spawned = 0

    async def spawn(self):
        self.spawned += 1
        self.next_pid += 1
        return type("H", (), {"pid": self.next_pid})()

    async def drain(self, handle):
        pass

    def adopt(self, pid, started=None):
        self.adopted.append(pid)
        return type("H", (), {"pid": pid})()


def _fleet(drt, state, pf, dec):
    return FleetPlanner(
        drt, FleetPlannerConfig(metric_interval_s=10, adjustment_interval_s=10,
                                state_path=str(state)),
        WorkerPool(PoolConfig(name="prefill", min_workers=1), pf, PrefillLaw()),
        WorkerPool(PoolConfig(name="decode", min_workers=1), dec, DecodeLaw()),
    )


async def test_v1_single_pool_state_loads_into_decode_pool(tmp_path):
    state = tmp_path / "dynamo.json"
    state.write_text(json.dumps({
        "namespace": "dynamo",
        "workers": [{"pid": 101, "started": None}, {"pid": 102, "started": None}],
        "connector": {"count": 2}, "decisions": ["up"], "ts": 0.0}))
    drt = await DistributedRuntime.in_process()
    pf, dec = PidConnector(200), PidConnector(300)
    planner = _fleet(drt, state, pf, dec)
    await planner.start()
    assert dec.adopted == [101, 102]
    assert planner.decode.size == 2
    assert pf.adopted == [] and planner.prefill.size == 1
    await planner.stop()
    saved = json.loads(state.read_text())
    assert saved["version"] == 2
    assert [w["pid"] for w in saved["pools"]["decode"]["workers"]] == [101, 102]
    assert len(saved["pools"]["prefill"]["workers"]) == 1
    pf2, dec2 = PidConnector(400), PidConnector(500)
    p2 = _fleet(drt, state, pf2, dec2)
    await p2.start()
    assert dec2.adopted == [101, 102] and len(pf2.adopted) == 1
    await p2.stop()
    await drt.shutdown()


async def test_legacy_planner_refuses_v2_fleet_state(tmp_path):
    state = tmp_path / "dynamo.json"
    state.write_text(json.dumps({
        "version": 2, "pools": {"decode": {"workers": [{"pid": 101, "started": 1.0}],
                                           "connector": {"count": 1}}}, "ts": 0.0}))
    drt = await DistributedRuntime.in_process()
    planner = Planner(drt, PlannerConfig(metric_interval_s=10, adjustment_interval_s=10,
                                         state_path=str(state)),
                      connector=CountingConnector())
    with pytest.raises(RuntimeError, match="two-pool"):
        await planner.start()
    assert json.loads(state.read_text())["version"] == 2
    await drt.shutdown()


async def test_malformed_state_starts_fresh(tmp_path):
    state = tmp_path / "bad.json"
    state.write_text("{not json")
    drt = await DistributedRuntime.in_process()
    planner = FleetPlanner(
        drt, FleetPlannerConfig(metric_interval_s=10, adjustment_interval_s=10,
                                state_path=str(state)),
        WorkerPool(PoolConfig(name="prefill"), CountingConnector(), PrefillLaw()),
        WorkerPool(PoolConfig(name="decode"), CountingConnector(), DecodeLaw()),
    )
    await planner.start()
    assert planner.prefill.size == 1 and planner.decode.size == 1
    await planner.stop(drain_workers=True)
    await drt.shutdown()


async def test_state_files_are_interchangeable_between_the_packages(tmp_path):
    """A v2 state file the port's fleet planner writes is the JAX
    package's layout: its fleet planner adopts the same workers."""
    from dynamo_tpu.planner import fleet as j_fleet
    from dynamo_tpu.runtime.distributed import DistributedRuntime as JDrt

    state = tmp_path / "s.json"
    drt = await DistributedRuntime.in_process()
    p = _fleet(drt, state, PidConnector(10), PidConnector(20))
    await p.start()
    await p.stop()
    await drt.shutdown()
    jdrt = await JDrt.in_process()
    jpf, jdec = PidConnector(900), PidConnector(950)
    jp = j_fleet.FleetPlanner(
        jdrt, j_fleet.FleetPlannerConfig(metric_interval_s=10, adjustment_interval_s=10,
                                         state_path=str(state)),
        j_pools.WorkerPool(j_pools.PoolConfig(name="prefill"), jpf, j_pools.PrefillLaw()),
        j_pools.WorkerPool(j_pools.PoolConfig(name="decode"), jdec, j_pools.DecodeLaw()))
    await jp.start()
    assert (jpf.adopted, jdec.adopted) == ([11], [21])
    await jp.stop()
    await jdrt.shutdown()


# -- observability ------------------------------------------------------------------


async def test_planner_observability_gauges_and_capture(tmp_path, monkeypatch):
    from dynamo_tpu_torch.utils import tracing

    cap = tmp_path / "cap.jsonl"
    monkeypatch.setenv("DYNTPU_TRACE", str(cap))
    tracing.reset_tracer(str(cap))
    try:
        drt = await DistributedRuntime.in_process()
        decision_log = tmp_path / "decisions.jsonl"
        planner = FleetPlanner(
            drt, FleetPlannerConfig(metric_interval_s=0.02, adjustment_interval_s=0.08,
                                    decision_log_path=str(decision_log)),
            WorkerPool(PoolConfig(name="prefill", min_workers=1, max_workers=2,
                                  down_consecutive=1), CountingConnector(), PrefillLaw()),
            WorkerPool(PoolConfig(name="decode", min_workers=1, max_workers=2),
                       CountingConnector(), DecodeLaw()),
        )
        await planner.start()
        queue = drt.bus.work_queue("dynamo.prefill_queue")
        for i in range(6):
            await queue.enqueue(b"j%d" % i)
        await _until(lambda: planner.prefill.size >= 2, "prefill never grew")
        await planner.stop(drain_workers=True)
        await drt.shutdown()
    finally:
        tracing.reset_tracer(None)
    g = PLANNER_OBS.gauges()
    assert g["planner_scale_up_total"] >= 1
    assert g["planner_prefill_scale_up_total"] >= 1
    assert "planner_pool_size_prefill" in g and "planner_pool_size_decode" in g
    assert g["planner_last_decision_age_s"] >= 0
    from dynamo_tpu_torch.tools.route_audit import load_records
    from dynamo_tpu_torch.tools.trace_merge import load_captures

    _routes, _actuals, planner_recs = load_records([str(cap)])
    assert {r["pool"] for r in planner_recs} == {"prefill", "decode"}
    ups = [r for r in planner_recs if r["decision"] == "up"]
    assert ups and all("queue" in r for r in ups if r["pool"] == "prefill")
    assert load_captures([str(cap)]) == {}
    # The JAX package's tools read the port's capture the same way.
    from benchmarks.route_audit import load_records as j_load_records

    assert j_load_records([str(cap)])[2] == planner_recs
    logged = [json.loads(line) for line in decision_log.read_text().splitlines()]
    assert any(r["decision"] == "up" and r["pool"] == "prefill" for r in logged)

    from dynamo_tpu_torch.llm.discovery import ModelManager
    from dynamo_tpu_torch.llm.http_client import fetch
    from dynamo_tpu_torch.llm.http_service import HealthServer, HttpService

    service = HttpService(ModelManager(), host="127.0.0.1", port=0)
    await service.start()
    health = HealthServer(lambda: {}, host="127.0.0.1", port=0)
    await health.start()
    try:
        for port in (service.port, health.port):
            text = (await fetch("127.0.0.1", port, "GET", "/metrics")).body.decode()
            assert "planner_scale_up_total" in text
            assert "planner_pool_size_prefill" in text
    finally:
        await service.stop()
        await health.stop()


def test_exporter_renders_planner_gauges():
    from dynamo_tpu_torch.llm.kv_router.metrics_aggregator import ProcessedEndpoints
    from dynamo_tpu_torch.llm.metrics_exporter import MetricsExporter

    PLANNER_OBS.note_decision("prefill", "up", 2, {"queue": 4.0})
    exp = MetricsExporter.__new__(MetricsExporter)
    exp._labels = f'namespace="dynamo",component="{COMPONENT}"'
    exp.aggregator = type("A", (), {"endpoints": ProcessedEndpoints()})()
    text = exp.render()
    assert "dyntpu_planner_scale_up_total" in text
    assert "dyntpu_planner_pool_size_prefill" in text


def test_observatory_records_match_the_reference():
    """The same decisions through both observatories give the same
    gauges and records (bar the clock)."""
    script = [("prefill", "up", 2, {"queue": 4.0, "queue_age_s": 1.25}),
              ("decode", "hold", 1, {"kv": 0.5, "waiting": 0.33333, "note": "x"}),
              ("prefill", "down", 1, {"queue": 0.0})]
    out = {}
    for name, obs in (("jax", J_OBS), ("port", PLANNER_OBS)):
        recs = [obs.note_decision(*args) for args in script]
        recs.append(obs.note_replaced_dead("decode", 2))
        obs.note_size("decode", 3, draining=1)
        g = {k: v for k, v in obs.gauges().items() if k != "planner_last_decision_age_s"}
        snap = obs.snapshot(2)
        out[name] = ([{k: v for k, v in r.items() if k != "unix"} for r in recs], g,
                     {k: v for k, v in snap.items() if k != "recent"})
    assert out["port"] == out["jax"]


def test_legacy_planner_decisions_reach_observatory():
    from dynamo_tpu_torch.planner.planner import _Window as LegacyWindow

    p = Planner.__new__(Planner)
    p.cfg = PlannerConfig(decision_log_path=None)
    p.decisions = ["up"]
    p._handles = [object()]
    p._log_decision(LegacyWindow())
    g = PLANNER_OBS.gauges()
    assert g["planner_scale_up_total"] == 1
    assert g["planner_pool_size_worker"] == 1
