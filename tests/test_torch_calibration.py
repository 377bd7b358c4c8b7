"""The port's calibration law (dynamo_tpu_torch/planner/calibration.py)
and fleet simulator (planner/simulate.py), held against the JAX
package's (tests/test_calibration.py, tests/test_xpyd.py).

- The law: fed the JAX package's own artifact (BENCH_r04.json), the
  port's derivation gives back the constants the JAX package derives
  from it; fed the committed H100 record, the calibrated single-worker
  simulation reproduces the record's headline within 10%.
- No constant fitted on or for a TPU is a default of the port.
- The simulator: both packages' simulators are pure Python over the
  same logic, so under one explicit MockerConfig and one workload their
  results are equal, exactly.
"""

from __future__ import annotations

import json
import re
from pathlib import Path

import numpy as np
import pytest

import dynamo_tpu_torch
from dynamo_tpu.mocker.engine import MockerConfig as JMockerConfig
from dynamo_tpu.planner import calibration as j_cal
from dynamo_tpu.planner import simulate as j_sim
from dynamo_tpu_torch.mocker.engine import MockerConfig as TMockerConfig
from dynamo_tpu_torch.planner import calibration as t_cal
from dynamo_tpu_torch.planner import simulate as t_sim

REPO = Path(__file__).resolve().parents[1]
R04 = REPO / "BENCH_r04.json"

#: The JAX package's constants fitted on or for a TPU (BENCH_r04 and the
#: TPU's batched block channel): none may be a default of the port.
TPU_CONSTANTS = ("10670.0", "14.4", "282.8", "119.8", "8900.0", "21.7")


# -- the law on the JAX package's artifact --------------------------------------


def test_law_on_bench_r04_gives_the_reference_constants():
    got = t_cal.derive_decode(t_cal.record_from_bench(R04))
    rel = 1e-9
    assert got.decode_time_per_step_us == pytest.approx(j_cal.DECODE_TIME_PER_STEP_US, rel=rel)
    assert got.decode_hbm_gbps == pytest.approx(j_cal.DECODE_HBM_GBPS, rel=rel)
    assert got.weight_bytes_per_step == pytest.approx(j_cal.WEIGHT_BYTES_PER_STEP, rel=rel)
    assert got.prefill_dispatch_base_us == pytest.approx(j_cal.PREFILL_DISPATCH_BASE_US, rel=rel)
    # The per-lane term is the JAX package's own derivation from the
    # artifact (tests/test_xpyd.py), which it rounds to 14.4 µs and holds
    # to that constant at 2%.
    rec = j_cal.recorded_r04()
    per_lane = (rec["decode_step_ms"] - rec["decode_step_ms_b32"]) * 1000.0 / 32.0
    assert got.decode_time_per_lane_us == pytest.approx(per_lane, rel=rel)
    assert got.decode_time_per_lane_us == pytest.approx(j_cal.DECODE_TIME_PER_LANE_US, rel=0.02)
    head = got.headline
    assert (head["tok_s"], head["p50_ttft_ms"]) == (j_cal.R04_HEADLINE_TOK_S, j_cal.R04_P50_TTFT_MS)
    assert (head["num_requests"], head["isl"], head["osl"]) == (
        j_cal.R04_NUM_REQUESTS, j_cal.R04_ISL, j_cal.R04_OSL)


def test_layout_terms_equal_the_reference():
    assert t_cal.KV_BYTES_PER_TOKEN == j_cal.KV_BYTES_PER_TOKEN
    assert t_cal.kv_quant_bytes_ratio() == pytest.approx(j_cal.kv_quant_bytes_ratio(), rel=1e-12)
    assert t_cal.weight_quant_bytes_ratio() == pytest.approx(
        j_cal.weight_quant_bytes_ratio(), rel=1e-12)
    for q in (None, "int8"):
        assert t_cal.kv_bytes_per_token(q) == pytest.approx(j_cal.kv_bytes_per_token(q), rel=1e-12)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_prefill_fit_recovers_a_known_law(seed):
    """Three prefill dispatches (k prompts of n tokens each) made from a
    known (a, b >= 0) law give back a and b; a law whose free fit would
    bend below zero is held at b = 0 with the free value reported."""
    rng = np.random.default_rng(seed)
    a, b = float(rng.uniform(0.5, 5.0)), float(rng.uniform(0.0, 1e-3))
    tokens, prompts = [128, 512, 2048], [int(rng.integers(1, 16)), 4, 1]
    rec = json.loads(t_cal.ARTIFACT.read_text())
    base = t_cal.derive_decode(rec).prefill_dispatch_base_us
    rec["prefill"] = {"tokens": tokens, "prompts": prompts,
                      "device_ms": [(base + k * (a * n + b * n * n)) / 1000.0
                                    for n, k in zip(tokens, prompts)]}
    got = t_cal.derive(rec)
    assert got.prefill_time_per_token_us == pytest.approx(a, rel=1e-6)
    assert got.prefill_quadratic_us == pytest.approx(b, rel=1e-6, abs=1e-12)
    rec["prefill"]["device_ms"] = [(base + k * (a * n - 1e-4 * n * n)) / 1000.0
                                   for n, k in zip(tokens, prompts)]
    bent = t_cal.derive(rec)
    assert bent.prefill_quadratic_us == 0.0 and bent.prefill_quadratic_free_us < 0
    assert bent.prefill_time_per_token_us > 0


# -- the committed H100 record --------------------------------------------------


def test_the_artifact_is_an_h100_record_with_its_power_limit():
    rec = json.loads(t_cal.ARTIFACT.read_text())
    assert rec["schema"] == t_cal.SCHEMA
    assert "H100" in rec["card"] and re.search(r"\d+\.\d+ W", rec["card"])
    assert t_cal.CARD == rec["card"]
    for name, v in t_cal.CALIBRATION.price_list().items():
        assert np.isfinite(v) and (v > 0 or name in (
            "prefill_quadratic_us", "prefill_host_overhead_us") and v >= 0), name
    assert t_cal.PREFILL_QUADRATIC_US >= 0


def test_calibrated_sim_reproduces_the_h100_headline_within_10pct():
    """The port's twin of tests/test_xpyd.py's gate: the calibrated
    single-worker simulation of the recorded headline (its requests all
    at once on one worker of the recorded engine) against the recorded
    tok/s and TTFT p50."""
    r = t_sim.calibrated_headline()
    head = t_cal.HEADLINE
    assert r.completed == head["num_requests"] and r.dropped == 0
    assert r.tok_s == pytest.approx(head["tok_s"], rel=0.10)
    assert r.p50_ttft_ms == pytest.approx(head["p50_ttft_ms"], rel=0.10)


def test_no_tpu_constant_is_a_port_default():
    for rel in ("planner/calibration.py", "planner/simulate.py", "mocker/engine.py",
                "llm/kv_router/scheduler.py"):
        src = (Path(dynamo_tpu_torch.__file__).parent / rel).read_text()
        for lit in TPU_CONSTANTS:
            assert not re.search(rf"(?<![\d.]){re.escape(lit)}(?![\d])", src), (rel, lit)
    values = {float(x) for x in TPU_CONSTANTS}
    assert not values & set(t_cal.CALIBRATION.price_list().values())
    assert not values & {float(getattr(t_cal, k)) for k in (
        "DECODE_TIME_PER_STEP_US", "DECODE_TIME_PER_LANE_US", "DECODE_HBM_GBPS",
        "PREFILL_TIME_PER_TOKEN_US", "HOST_OVERHEAD_US", "HANDOFF_GBPS")}
    # MockerConfig's own defaults keep every calibrated term off.
    m = TMockerConfig()
    assert (m.prefill_quadratic_us, m.kv_bytes_per_token, m.decode_hbm_gbps,
            m.weight_bytes_per_step) == (0.0, 0.0, 0.0, 0.0)
    assert not values & {float(v) for v in vars(m).values() if isinstance(v, (int, float))}
    from dynamo_tpu_torch.llm.kv_router.scheduler import KvRouterConfig

    assert KvRouterConfig().default_link_gbps not in values


def test_missing_or_malformed_artifact_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        t_cal.load(tmp_path / "absent.json")
    bad = tmp_path / "bad.json"
    bad.write_text("{not json")
    with pytest.raises(ValueError):
        t_cal.load(bad)
    good = json.loads(t_cal.ARTIFACT.read_text())
    for mutate in (
        lambda r: r.pop("prefill"),
        lambda r: r.pop("handoff"),
        lambda r: r["prefill"].pop("prompts"),
        lambda r: r.__setitem__("schema", "other"),
        lambda r: r.__setitem__("card", ""),
        lambda r: r["decode"].__setitem__("device_ms", [1.0]),
        lambda r: r["decode"].__setitem__("device_ms", [2.0, 1.0]),
        lambda r: r["host"].__setitem__("wall_ms_per_dispatch", 0.0),
        lambda r: r["host"].pop("prefill_wall_ms"),
        lambda r: r["host"].__setitem__("prefill_device_ms", r["host"]["prefill_wall_ms"] * 2),
        lambda r: r["prefill"].__setitem__("device_ms", [1.0, float("nan"), 2.0]),
        lambda r: r["headline"].pop("tok_s"),
    ):
        rec = json.loads(json.dumps(good))
        mutate(rec)
        with pytest.raises(ValueError):
            t_cal.derive(rec)


# -- one source for the handoff rate (tests/test_calibration.py) ------------------


def test_router_default_link_is_the_calibrated_channel():
    from dynamo_tpu_torch.llm.kv_router.scheduler import KvRouterConfig

    assert KvRouterConfig().default_link_gbps == t_cal.HANDOFF_GBPS


def test_peer_pricing_fallback_is_the_calibrated_channel():
    """With no measured pull EMA and no peer advertisement, the G4 pricing
    law falls back to the recorded channel: in the port, the H100
    record's pinned host→device rate."""
    from types import SimpleNamespace

    from dynamo_tpu_torch.block_manager.peer import PeerBlockClient

    drt = SimpleNamespace(primary_lease_id=0xAA)
    comp = SimpleNamespace(namespace=SimpleNamespace(name="kv"), name="torch")
    client = PeerBlockClient(drt, comp, None)
    assert client.effective_bps("nobody") == t_cal.HANDOFF_GBPS * 1e9
    rec = json.loads((Path(t_cal.__file__).parent / "calibration_h100.json").read_text())
    assert t_cal.HANDOFF_GBPS == t_cal.derive(rec).handoff_gbps


def test_handoff_rate_has_exactly_one_source():
    """No module of the port but calibration.py carries the measured
    rate: every consumer reads ``HANDOFF_GBPS``."""
    root = Path(dynamo_tpu_torch.__file__).parent
    rate = t_cal.HANDOFF_GBPS
    literals = {f"{rate:.{d}f}" for d in (1, 2, 3)}
    offenders = [
        str(p.relative_to(root.parent)) for p in sorted(root.rglob("*.py"))
        if p.name != "calibration.py"
        and any(re.search(rf"(?<![\d.]){re.escape(x)}(?![\d])", p.read_text())
                for x in literals)
    ]
    assert offenders == [], offenders
    src = (root / "llm/kv_router/scheduler.py").read_text()
    assert "HANDOFF_GBPS" in src and "H2D_KV_GBPS" not in src


def test_transfer_cost_model_uses_the_symbol():
    isl = 3000
    expected = t_cal.HANDOFF_FIXED_US / 1e6 + isl * t_cal.kv_bytes_per_token(None) / (
        t_cal.HANDOFF_GBPS * 1e9)
    assert abs(t_cal.handoff_seconds(isl) - expected) < 1e-12
    # A wire-rate link makes the same prompt ~20 s: the asymmetry the
    # network-aware selection routes around.
    assert t_cal.handoff_seconds(3000, link_gbps=0.005) > 15.0
    assert t_cal.handoff_seconds(3000, kv_quant="int8") < t_cal.handoff_seconds(3000)


def test_calibrated_mocker_config_carries_constants():
    m = t_cal.calibrated_mocker_config()
    assert m.decode_time_per_lane_us == t_cal.DECODE_TIME_PER_LANE_US
    assert m.prefill_dispatch_base_us == t_cal.PREFILL_DISPATCH_BASE_US
    assert m.decode_time_per_step_us == t_cal.DECODE_TIME_PER_STEP_US
    assert m.prefill_time_per_token_us == t_cal.PREFILL_TIME_PER_TOKEN_US
    assert t_cal.calibrated_mocker_config(decode_time_per_lane_us=1.0).decode_time_per_lane_us == 1.0


# -- the simulator against the JAX package's ------------------------------------


def _mockers(seed: int):
    rng = np.random.default_rng(seed)
    kw = dict(
        prefill_time_per_token_us=float(rng.uniform(1, 150)),
        prefill_quadratic_us=float(rng.uniform(0, 1e-3)),
        decode_time_per_step_us=float(rng.uniform(500, 12000)),
        decode_time_per_lane_us=float(rng.uniform(0, 20)),
        prefill_dispatch_base_us=float(rng.uniform(0, 12000)),
    )
    return JMockerConfig(**kw), TMockerConfig(**kw), rng


def _sim_configs(seed: int, **extra):
    jm, tm, rng = _mockers(seed)
    kw = dict(host_overhead_us=float(rng.uniform(0, 9000)),
              prefill_batch=int(rng.integers(1, 17)), max_num_seqs=int(rng.integers(4, 65)),
              handoff_fixed_us=float(rng.uniform(0, 1000)),
              kv_bytes_per_token=32768, **extra)
    return (j_sim.SimConfig(mocker=jm, **kw),
            t_sim.SimConfig(mocker=tm, prefill_host_overhead_us=None, **kw), rng)


def _workloads(rng, n: int):
    """The same random requests (arrivals, prompt and output lengths)
    built in both packages."""
    arrivals = np.cumsum(rng.exponential(0.05, n)) * (rng.random() < 0.5)
    isl = rng.integers(16, 3000, n)
    osl = rng.integers(1, 200, n)
    return ([j_sim.SimRequest(float(a), int(i), int(o)) for a, i, o in zip(arrivals, isl, osl)],
            [t_sim.SimRequest(float(a), int(i), int(o)) for a, i, o in zip(arrivals, isl, osl)])


def _same(jr, tr, jwl, twl):
    assert tr.to_wire() == jr.to_wire()
    assert [(r.ttft_s, r.done_s, r.decode_worker, r.dropped) for r in twl] == [
        (r.ttft_s, r.done_s, r.decode_worker, r.dropped) for r in jwl]


@pytest.mark.parametrize("mode", ["batch", "coloc"])
@pytest.mark.parametrize("seed", range(4))
def test_simulate_aggregated_equals_the_reference(seed, mode):
    jc, tc, rng = _sim_configs(seed, weight_quant=["int8", None][seed % 2])
    jwl, twl = _workloads(rng, 40)
    n = int(rng.integers(1, 4))
    quantum = int(rng.choice([16, 64, 256]))
    _same(j_sim.simulate_aggregated(jc, jwl, n, mode=mode, quantum=quantum),
          t_sim.simulate_aggregated(tc, twl, n, mode=mode, quantum=quantum), jwl, twl)


@pytest.mark.parametrize("selector", ["plain", "netaware"])
@pytest.mark.parametrize("seed", range(4))
def test_simulate_xpyd_equals_the_reference(seed, selector):
    jc, tc, rng = _sim_configs(seed, kv_quant=["int8", None][seed % 2])
    jwl, twl = _workloads(rng, 40)
    n_p, n_d = int(rng.integers(1, 4)), int(rng.integers(1, 4))
    links = [float(x) for x in rng.choice([0.012, 5.0, 40.0], n_d)]
    drain = (float(rng.uniform(0.0, 1.0)), int(rng.integers(n_d))) if n_d > 1 else None
    _same(j_sim.simulate_xpyd(jc, jwl, n_p, n_d, links, selector, drain),
          t_sim.simulate_xpyd(tc, twl, n_p, n_d, links, selector, drain), jwl, twl)


def test_synth_workload_equals_the_reference():
    for args in ((8, 128, 16), (5, 64, 8, 2.0)):
        assert [vars(r) for r in t_sim.synth_workload(*args)] == [
            vars(r) for r in j_sim.synth_workload(*args)]


# -- simulator behaviour (tests/test_xpyd.py) ------------------------------------


def test_sim_drain_with_no_survivor_drops_late_arrivals():
    cfg = t_sim.SimConfig()
    wl = t_sim.synth_workload(8, 128, 16, rate_rps=2.0)
    r = t_sim.simulate_xpyd(cfg, wl, 1, 1, drain_decode_at=(1.0, 0))
    assert r.dropped > 0
    assert r.completed + r.dropped == 8


def test_sim_scale_down_mid_run_drops_nothing():
    cfg = t_sim.SimConfig()
    wl = t_sim.synth_workload(32, 1024, 32, rate_rps=40.0)
    r = t_sim.simulate_xpyd(cfg, wl, 2, 2, drain_decode_at=(0.2, 1))
    assert r.dropped == 0 and r.completed == 32
    assert r.per_decode_worker[0] > r.per_decode_worker[1] > 0
    assert r.decode_drained_at_s is not None and r.decode_drained_at_s <= r.elapsed_s


def test_sim_netaware_selection_avoids_slow_link():
    cfg = t_sim.SimConfig()

    def run(selector):
        wl = t_sim.synth_workload(16, 3000, 20)
        return t_sim.simulate_xpyd(cfg, wl, 2, 2,
                                   decode_links_gbps=[t_cal.HANDOFF_GBPS, 0.012],
                                   selector=selector)

    plain, net = run("plain"), run("netaware")
    assert plain.per_decode_worker[1] >= 6
    assert net.per_decode_worker[0] >= 14
    assert net.per_decode_worker[1] <= 2
    assert net.p95_ttft_ms < plain.p95_ttft_ms


def test_sim_decode_worker_balance_and_cap():
    cfg = t_sim.SimConfig(max_num_seqs=8)
    r = t_sim.simulate_xpyd(cfg, t_sim.synth_workload(32, 128, 8), 1, 2)
    assert r.completed == 32 and r.dropped == 0
    assert r.per_decode_worker == [16, 16]


def test_sim_tok_s_accounting():
    r = t_sim.simulate_aggregated(t_sim.SimConfig(), t_sim.synth_workload(4, 64, 8), 1)
    assert r.completed == 4
    assert r.tok_s == pytest.approx(4 * 8 / r.elapsed_s, rel=1e-6)


def test_sim_coloc_mode_holds_itl_while_batch_mode_stalls():
    cfg = t_sim.SimConfig()
    batch = t_sim.simulate_aggregated(cfg, t_sim.synth_workload(32, 3000, 150), 1, mode="batch")
    coloc = t_sim.simulate_aggregated(cfg, t_sim.synth_workload(32, 3000, 150), 1, mode="coloc")
    # Co-location: no dispatch exceeds a decode step plus one quantum.
    one = (cfg.decode_step_cost_s(32) + 64 * cfg.mocker.prefill_time_per_token_us / 1e6) * 1e3
    assert coloc.itl_max_ms <= one * 1.0001
    # Batch mode: a fused ISL-3000 batch stalls decode for many steps.
    assert batch.itl_max_ms > 10 * coloc.itl_max_ms
    assert coloc.tok_s < batch.tok_s


def test_sim_disagg_decode_never_sees_a_prefill_stall():
    cfg = t_sim.SimConfig()
    r = t_sim.simulate_xpyd(cfg, t_sim.synth_workload(32, 3000, 64), 2, 1)
    assert r.dropped == 0
    assert r.itl_max_ms <= cfg.decode_step_cost_s(cfg.max_num_seqs) * 1e3 * 1.0001
