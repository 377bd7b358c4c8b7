"""The port's co-location controller (dynamo_tpu_torch/engine/coloc.py)
held against the JAX package's, case for case with tests/test_coloc.py:
the same observation sequence must give the same quantum trajectory, the
same deferrals and the same counters in both packages (exact equality:
both run the same float arithmetic in Python). Then the port's seams
around it — composition, the phase-aware admission watermark, the metric
surfaces, and the mocker end to end, where every ITL sample is the cost
the mocker charged (its injected clock), so the timings asserted do not
depend on how busy the CPU running the test is."""

import asyncio

import numpy as np
import pytest

from dynamo_tpu.engine.coloc import ColocController as JColoc
from dynamo_tpu.engine.config import EngineConfig as JEngineConfig
from dynamo_tpu.engine.scheduler import compose_unified as j_compose
from dynamo_tpu.models.config import ModelConfig as JModelConfig
from dynamo_tpu_torch.engine.coloc import ColocController
from dynamo_tpu_torch.engine.config import EngineConfig
from dynamo_tpu_torch.engine.scheduler import compose_unified
from dynamo_tpu_torch.llm.admission import (
    AdmissionConfig,
    AdmissionController,
    AdmissionRejected,
)
from dynamo_tpu_torch.llm.protocols.common import (
    PreprocessedRequest,
    SamplingOptions,
    StopConditions,
)
from dynamo_tpu_torch.models.config import ModelConfig
from dynamo_tpu_torch.runtime.engine import Context

SLO = 10.0


def _kw(**kw) -> dict:
    base = dict(
        num_blocks=64, max_model_len=256, unified_token_budget=1024,
        unified_prefill_quantum=64, coloc="adaptive", itl_slo_ms=SLO,
        coloc_min_quantum=16,
    )
    base.update(kw)
    return base


def _cfg(**kw) -> EngineConfig:
    return EngineConfig(model=ModelConfig.tiny_test(), **_kw(**kw))


def _jcfg(**kw) -> JEngineConfig:
    return JEngineConfig(model=JModelConfig.tiny_test(), unified=True, **_kw(**kw))


def _pair(ctrl_kw=None, **kw):
    ctrl_kw = ctrl_kw or {}
    return ColocController(_cfg(**kw), **ctrl_kw), JColoc(_jcfg(**kw), **ctrl_kw)


def _drive(ctrl, cost_ms, steps: int) -> list[int]:
    """Closed loop: each sample is the cost of the quantum the controller
    chose for that step; returns the quantum trajectory."""
    out = []
    for _ in range(steps):
        ctrl.observe(cost_ms(ctrl.quantum), decode_lanes=8,
                     prefill_tokens=ctrl.quantum)
        out.append(ctrl.quantum)
    return out


def _drive_both(cost_ms, steps, **kw):
    port, ref = _pair(**kw)
    traj = _drive(port, cost_ms, steps)
    assert traj == _drive(ref, cost_ms, steps)
    assert port.snapshot() == ref.snapshot()
    return port


# ---------------------------------------------------------------------------
# controller convergence
# ---------------------------------------------------------------------------


def test_oversized_quantum_shrinks_until_itl_meets_slo():
    cost = lambda q: 2.0 + 0.01 * q  # noqa: E731 — 1024 -> 12.2 ms > SLO
    ctrl = _drive_both(cost, 200, unified_prefill_quantum=1024)
    assert cost(ctrl.quantum) <= SLO
    assert ctrl.itl_ema_ms <= SLO
    assert ctrl.floor < ctrl.quantum < 1024
    assert ctrl.itl_slo_violations_total >= 1


def test_undersized_quantum_grows_until_budget_limited():
    ctrl = _drive_both(lambda q: 2.0 + 0.0001 * q, 200, unified_prefill_quantum=16)
    assert ctrl.quantum == ctrl.cap == 1024
    assert ctrl.itl_slo_violations_total == 0


def test_undersized_quantum_grows_into_deadband_and_holds():
    cost = lambda q: 2.0 + 0.01 * q  # noqa: E731
    port, ref = _pair(unified_prefill_quantum=16)
    assert _drive(port, cost, 300) == _drive(ref, cost, 300)
    assert port.headroom_frac * SLO <= cost(port.quantum) <= SLO
    trace = _drive(port, cost, 100)
    assert trace == _drive(ref, cost, 100)
    assert max(trace) - min(trace) <= port.grow_tokens


def test_floor_respected_under_sustained_slo_pressure():
    port, ref = _pair(unified_prefill_quantum=512)
    assert _drive(port, lambda q: 2 * SLO, 100) == _drive(ref, lambda q: 2 * SLO, 100)
    assert port.quantum == port.floor
    assert port.itl_slo_violations_total == ref.itl_slo_violations_total == 100
    assert set(_drive(port, lambda q: 2 * SLO, 50)) == {port.floor}


def test_prefill_only_dispatches_are_not_itl_evidence():
    for ctrl in _pair():
        ctrl.observe(500.0, decode_lanes=0, prefill_tokens=256)
        assert (ctrl.steps_observed, ctrl.itl_ema_ms, ctrl.quantum) == (0, 0.0, 64)


def test_static_mode_measures_but_never_adapts():
    port, ref = _pair(coloc="static", unified_prefill_quantum=96)
    for ctrl in (port, ref):
        assert set(_drive(ctrl, lambda q: 2 * SLO, 50)) == {96}
        assert ctrl.itl_slo_violations_total == 50
        assert ctrl.itl_ema_ms > SLO
        assert ctrl.admit_prefill() is True
        assert ctrl.prefill_deferrals_total == 0
    assert port.snapshot() == ref.snapshot()


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_seeded_observation_sequences_give_identical_trajectories(seed):
    """Random samples, lane counts and prefill evidence (numpy seed),
    interleaved with admission decisions: both controllers move the
    quantum, defer and count identically at every step."""
    rng = np.random.default_rng(seed)
    port, ref = _pair(ctrl_kw={"max_defer_steps": 7},
                      unified_prefill_quantum=int(rng.integers(16, 1024)))
    samples = rng.gamma(2.0, SLO / 2.0, 400)
    lanes = rng.integers(0, 9, 400)
    prefill = rng.integers(0, 300, 400) * (rng.random(400) < 0.7)
    for ms, n, p in zip(samples, lanes, prefill):
        for ctrl in (port, ref):
            ctrl.observe(float(ms), int(n), int(p))
        assert port.quantum == ref.quantum
        assert port.admit_prefill() == ref.admit_prefill()
        assert port.snapshot() == ref.snapshot()


# ---------------------------------------------------------------------------
# per-phase admission
# ---------------------------------------------------------------------------


def test_admit_prefill_defers_under_pressure_with_bounded_streak():
    port, ref = _pair(ctrl_kw={"max_defer_steps": 5})
    for ctrl in (port, ref):
        _drive(ctrl, lambda q: 2 * SLO, 10)
        assert ctrl.under_pressure
        decisions = [ctrl.admit_prefill() for _ in range(6)]
        assert decisions == [False] * 5 + [True]
        assert ctrl.prefill_deferrals_total == 5
        _drive(ctrl, lambda q: 1.0, 50)
        assert not ctrl.under_pressure
        assert ctrl.admit_prefill() is True
        assert ctrl.prefill_deferrals_total == 5
    assert port.snapshot() == ref.snapshot()


def test_config_validation_rejects_bad_coloc_combos():
    """The JAX package's validation, less its ``unified=False`` case: the
    port has the unified step only (no phase-alternating path to refuse
    coloc on)."""
    for make in (_cfg, _jcfg):
        with pytest.raises(ValueError, match="coloc="):
            make(coloc="magic").validate()
        with pytest.raises(ValueError, match="itl_slo_ms"):
            make(itl_slo_ms=0.0).validate()
        with pytest.raises(ValueError, match="itl_slo_ms"):
            make(coloc="static", itl_slo_ms=-1.0).validate()
        with pytest.raises(ValueError, match="coloc_min_quantum"):
            make(coloc_min_quantum=4096).validate()
        make().validate()
        make(coloc="static", itl_slo_ms=0.0).validate()


# ---------------------------------------------------------------------------
# compose_unified deferral fairness (rotation)
# ---------------------------------------------------------------------------


def test_compose_rotation_round_robins_deferral():
    lanes = [f"d{i}" for i in range(8)]
    served = {lane: 0 for lane in lanes}
    rotation = 0
    for _ in range(16):
        take, _ = compose_unified(lanes, [], budget=4, quantum=2, rotation=rotation)
        assert (take, _) == j_compose(lanes, [], budget=4, quantum=2, rotation=rotation)
        assert len(take) == 4
        rotation += len(take)
        for lane in take:
            served[lane] += 1
    assert set(served.values()) == {8}


def test_compose_rotation_bounds_lane_itl_vs_population_median():
    n_lanes, budget = 10, 3
    lanes = list(range(n_lanes))
    last_served = {lane: 0 for lane in lanes}
    worst_gap = {lane: 0 for lane in lanes}
    rotation = 0
    for step in range(1, 61):
        take, _ = compose_unified(lanes, [], budget=budget, quantum=budget,
                                  rotation=rotation)
        rotation += len(take)
        for lane in take:
            worst_gap[lane] = max(worst_gap[lane], step - last_served[lane])
            last_served[lane] = step
    gaps = sorted(worst_gap.values())
    median = gaps[len(gaps) // 2]
    assert max(gaps) <= -(-n_lanes // budget) + 1
    assert max(gaps) <= 2 * median


def test_compose_rotation_default_keeps_legacy_order():
    assert compose_unified(["a", "b", "c"], [], budget=2, quantum=1)[0] == ["a", "b"]


# ---------------------------------------------------------------------------
# phase-aware HTTP admission watermark
# ---------------------------------------------------------------------------


def test_admission_prefill_backlog_watermark():
    stats = {"prefill_backlog_tokens": 0, "num_requests_waiting": 50}
    gate = AdmissionController(
        AdmissionConfig(max_prefill_backlog_tokens=4096), engine_stats=lambda: stats
    )
    with gate.admit():
        pass
    stats["prefill_backlog_tokens"] = 5000
    with pytest.raises(AdmissionRejected) as exc:
        gate.admit()
    assert exc.value.reason == "prefill_backlog"
    assert gate.rejected["prefill_backlog"] == 1


def test_metric_surfaces_carry_coloc_fields():
    """The port's metric surfaces are the engine's readiness snapshot,
    the two /metrics renderings of it (the OpenAI server's and the
    worker's HealthServer) and, since the KV router slice, the
    ``ForwardPassMetrics`` wire: every exporter gauge exists there and
    the coloc fields survive the wire round trip, as in the JAX
    package's tests/test_coloc.py, with the same bytes as its msgpack."""
    import msgpack

    from dynamo_tpu.llm.kv_router.protocols import ForwardPassMetrics as JFpm
    from dynamo_tpu_torch.llm.kv_router.protocols import ForwardPassMetrics
    from dynamo_tpu_torch.llm.metrics_exporter import _GAUGES
    from dynamo_tpu_torch.runtime.transports import wire

    m = ForwardPassMetrics()
    for key, _help in _GAUGES:
        assert hasattr(m, key), key
    coloc = dict(coloc_quantum=640, itl_ema_ms=7.5, itl_slo_violations_total=3,
                 coloc_prefill_deferrals_total=2, prefill_backlog_tokens=9000)
    wire_dict = {**m.to_wire(), **coloc}
    back = ForwardPassMetrics.from_wire(wire.unpackb(wire.packb(wire_dict)))
    assert {k: getattr(back, k) for k in coloc} == coloc
    assert wire.packb(back.to_wire()) == msgpack.packb(
        JFpm.from_wire(wire_dict).to_wire())

    from dynamo_tpu_torch.llm.discovery import ModelManager
    from dynamo_tpu_torch.llm.http_client import fetch
    from dynamo_tpu_torch.llm.http_service import HealthServer, HttpService

    snap = {"state": "ready", "coloc_quantum": 640, "itl_ema_ms": 7.5,
            "itl_slo_violations_total": 3, "coloc_prefill_deferrals_total": 2,
            "prefill_backlog_tokens": 9000, "itl_p95_ms": 9.0,
            "itl_headroom_ms": 2.5}

    async def main():
        out = []
        for server, prefix in (
            (HttpService(ModelManager(), host="127.0.0.1", port=0,
                         readiness=lambda: snap), "dyntpu_http_service"),
            (HealthServer(lambda: snap, host="127.0.0.1", port=0), "dyntpu_worker"),
        ):
            await server.start()
            try:
                text = (await fetch("127.0.0.1", server.port, "GET", "/metrics")).body.decode()
            finally:
                await server.stop()
            out.append({k: f"{prefix}_{k} {float(v)}" in text for k, v in snap.items()
                        if k != "state"})
        return out

    for seen in asyncio.run(main()):
        assert all(seen.values()), seen
    assert set(snap) - {"state"} <= set(ColocController(_cfg()).snapshot()) | {
        "prefill_backlog_tokens"}


# ---------------------------------------------------------------------------
# mocker end to end
# ---------------------------------------------------------------------------


async def _run(eng, rng, isl, osl, first=None):
    req = PreprocessedRequest(
        token_ids=rng.integers(0, 1000, isl).tolist(),
        sampling=SamplingOptions(temperature=0.0),
        stop=StopConditions(max_tokens=osl, ignore_eos=True),
    )
    n = 0
    async for out in eng.generate(Context(req.to_wire())):
        n += len(out["token_ids"])
        if n and first is not None and not first.is_set():
            first.set()
    return n


def test_mocker_prefill_burst_mid_decode_holds_itl_slo():
    """A decode population is mid-stream when a long-prompt burst
    arrives: the adaptive controller keeps the dispatch-interval p95
    within the SLO while the burst completes, and the coloc surface shows
    on readiness and on every flight record; no graph is made
    mid-traffic."""
    from dynamo_tpu_torch.mocker import MockerConfig, MockerEngine

    slo = 15.0
    cfg = EngineConfig(
        model=ModelConfig.tiny_test(), num_blocks=512, block_size=16,
        max_num_seqs=6, max_model_len=1024, prefill_batch=2, dtype="float32",
        sampling_extras=False, unified_token_budget=512,
        unified_prefill_quantum=32, coloc="adaptive", itl_slo_ms=slo,
        coloc_min_quantum=16,
    )
    sim = MockerConfig(
        prefill_time_per_token_us=10.0, decode_time_per_step_us=1000.0,
        decode_time_per_lane_us=100.0, prefill_dispatch_base_us=2000.0,
        vocab_size=cfg.model.vocab_size,
    )

    async def main():
        eng = MockerEngine(cfg, sim)
        await eng.start()
        await eng.warmup()
        rng = np.random.default_rng(3)
        first = asyncio.Event()
        decode = [asyncio.create_task(_run(eng, rng, 16, 120, first)) for _ in range(4)]
        await first.wait()
        burst = await asyncio.gather(*[_run(eng, rng, 600, 2) for _ in range(2)])
        snap = dict(eng.coloc.snapshot())
        await asyncio.gather(*decode)
        ready = eng.readiness()
        steps = eng.debug_steps()
        mid = eng.runner.compile_stats.mid_traffic_compiles
        await eng.stop()
        return burst, snap, eng.coloc.steps_observed, ready, steps, mid

    burst, snap, observed, ready, steps, mid = asyncio.run(main())
    assert burst == [2, 2]
    assert snap["itl_p95_ms"] <= slo, snap
    assert snap["itl_slo_violations_total"] <= max(1, int(0.05 * observed)), snap
    assert ready["coloc_quantum"] != 32  # headroom existed: it grew
    for key in ("coloc_quantum", "itl_ema_ms", "itl_slo_violations_total",
                "coloc_prefill_deferrals_total", "prefill_backlog_tokens"):
        assert key in ready, key
    unified = [r for r in steps if r["kind"] == "unified"]
    assert unified and all(
        {"quantum", "itl_ema_ms", "headroom_ms"} <= set(r) for r in unified)
    assert any(r["quantum"] > 0 for r in unified)
    assert mid == 0


def test_mocker_static_vs_adaptive_quantum_moves_simulated_itl():
    """With prefill priced per token, a bigger static quantum gives
    measurably longer dispatch intervals while prompts are in flight —
    the observable the controller steers. The samples are the mocker's
    charged costs, and the burst is sent once the decode stream has its
    first token (not after a sleep): the ratio does not hinge on how the
    host schedules the test. The peak of the EMA over the run is read
    from the controller's own observations, not at a moment the test
    thread happens to look."""
    from dynamo_tpu_torch.mocker import MockerConfig, MockerEngine

    async def peak_ema(quantum: int) -> float:
        cfg = EngineConfig(
            model=ModelConfig.tiny_test(), num_blocks=512, block_size=16,
            max_num_seqs=4, max_model_len=1024, prefill_batch=2, dtype="float32",
            sampling_extras=False, unified_token_budget=512,
            unified_prefill_quantum=quantum, coloc="static", itl_slo_ms=1e9,
        )
        sim = MockerConfig(prefill_time_per_token_us=20.0,
                           decode_time_per_step_us=500.0,
                           vocab_size=cfg.model.vocab_size)
        eng = MockerEngine(cfg, sim)
        emas: list[float] = []
        await eng.start()
        await eng.warmup()
        observe = eng.coloc.observe

        def recording(sample_ms, decode_lanes, prefill_tokens):
            observe(sample_ms, decode_lanes, prefill_tokens)
            emas.append(eng.coloc.itl_ema_ms)

        eng.coloc.observe = recording
        rng = np.random.default_rng(5)
        first = asyncio.Event()
        decode = asyncio.create_task(_run(eng, rng, 16, 400, first))
        await first.wait()
        await asyncio.gather(_run(eng, rng, 400, 2), _run(eng, rng, 400, 2))
        await decode
        await eng.stop()
        return max(emas)

    small = asyncio.run(peak_ema(16))
    large = asyncio.run(peak_ema(256))
    assert large > small * 1.5, (small, large)
