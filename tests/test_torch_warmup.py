"""The port's compile lifecycle (dynamo_tpu_torch/engine/compile_cache.py,
the runner's programs and warmup, the engine's gates) against the JAX
package's (dynamo_tpu/engine/compile_cache.py), on the CPU.

- The warmup plan: for tiny-test and llama3.2-1b configs, with sampling
  extras and speculative decoding on or off, with and without a shape
  manifest, ``default_shape_grid``, ``split_plan`` and ``warmup_plan``
  give the JAX package's keys in the JAX package's order.
- ``ShapeManifest``: round trip, fingerprint guard, and the same JSON
  layout and version both ways between the packages
  (tests/test_compile_lifecycle.py:78-127).
- Warmup writes only trash block 0 and leaves the allocator untouched.
- The hold and degraded gates, ``mid_traffic_compiles_total`` and
  ``/health`` 503 "warming" with the compile gauges
  (tests/test_compile_lifecycle.py:213-275, :368), the port's server held
  to the JAX server's answers.
- The step body over static buffers, pipelined two deep with device
  feeds across budget rungs, gives the JAX engine's greedy streams
  byte for byte (tiny-test, float32, weights carried across).

On the CPU nothing is captured: a program is made by the step body's
first execution, which is what the counters count, as in the reference.
"""

import asyncio
import functools
import json
import types

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from dynamo_tpu.engine import compile_cache as jcc
from dynamo_tpu.engine.config import EngineConfig as JEngineConfig
from dynamo_tpu.engine.engine import TpuEngine
from dynamo_tpu.engine.runner import ModelRunner as JModelRunner
from dynamo_tpu.llm.discovery import ModelManager as JManager
from dynamo_tpu.llm.http_service import HttpService as JService
from dynamo_tpu.llm.protocols import common as j_proto
from dynamo_tpu.models import llama as j_llama
from dynamo_tpu.models.config import ModelConfig as JCfg
from dynamo_tpu.runtime.engine import Context as JContext
from dynamo_tpu_torch.engine import compile_cache as tcc
from dynamo_tpu_torch.engine.config import EngineConfig
from dynamo_tpu_torch.engine.engine import TorchEngine
from dynamo_tpu_torch.engine.runner import ModelRunner
from dynamo_tpu_torch.llm.discovery import ModelManager
from dynamo_tpu_torch.llm.http_client import fetch
from dynamo_tpu_torch.llm.http_service import HttpService
from dynamo_tpu_torch.llm.protocols import common as t_proto
from dynamo_tpu_torch.models import llama as t_llama
from dynamo_tpu_torch.models.config import ModelConfig
from dynamo_tpu_torch.runtime.engine import Context

JAX_CFG = JCfg.tiny_test()
PARAMS = j_llama.init_params(jax.random.PRNGKey(0), JAX_CFG, dtype=jnp.float32)
TPARAMS = t_llama.params_from_jax(jax.tree.map(np.asarray, PARAMS), device="cpu")
# tests/test_compile_lifecycle.py's _cfg, without the JAX-only decode_chunk.
LIFECYCLE_KW = dict(num_blocks=128, max_num_seqs=4, max_model_len=128,
                    prefill_chunk=128, prefill_batch=4)
ENGINE_KW = dict(
    dtype="float32", block_size=4, num_blocks=64, max_num_seqs=4,
    max_model_len=128, prefill_batch=2, unified_token_budget=32,
    unified_prefill_quantum=8,
)
MODELS = {"tiny-test": (ModelConfig.tiny_test, JCfg.tiny_test),
          "llama3.2-1b": (ModelConfig.llama32_1b, JCfg.llama32_1b)}


def _cfgs(model: str, **kw):
    t_model, j_model = MODELS[model]
    return (EngineConfig(model=t_model(), **kw), JEngineConfig(model=j_model(), **kw))


def _manifest(mod):
    m = mod.ShapeManifest()
    for _ in range(9):
        m.record("unified", t=64)
    m.record("unified", t=16)
    m.record("unified_full", t=256)
    return m


def _plan_keys(tcfg, jcfg, with_manifest: bool):
    """(port, JAX) warmup-plan keys: each package's own warmup_plan and
    _warm_op over a runner stub holding just the config (no weights)."""
    tm, jm = (_manifest(tcc), _manifest(jcc)) if with_manifest else (None, None)
    t_stub = types.SimpleNamespace(
        cfg=tcfg, unified_slots=tcfg.max_num_seqs + tcfg.prefill_batch)
    t_stub._warm_op = functools.partial(ModelRunner._warm_op, t_stub)
    j_stub = types.SimpleNamespace(
        cfg=jcfg, unified_slots=jcfg.max_num_seqs + jcfg.prefill_batch)
    j_stub._warm_op = functools.partial(JModelRunner._warm_op, j_stub)
    t_hot, t_tail = ModelRunner.warmup_plan(t_stub, tm)
    j_hot, j_tail = JModelRunner.warmup_plan(j_stub, None, None, jm)
    return ([k for k, _ in t_hot], [k for k, _ in t_tail]), \
        ([k for k, _ in j_hot], [k for k, _ in j_tail])


@pytest.mark.parametrize("model", sorted(MODELS))
@pytest.mark.parametrize("extras", [True, False], ids=["extras", "no_extras"])
@pytest.mark.parametrize("spec_k", [0, 3], ids=["plain", "spec"])
@pytest.mark.parametrize("with_manifest", [False, True], ids=["default", "manifest"])
def test_warmup_plan_keys_and_order_equal_jax(model, extras, spec_k, with_manifest):
    kw = dict(sampling_extras=extras, speculative_k=spec_k, **LIFECYCLE_KW)
    tcfg, jcfg = _cfgs(model, **kw)
    tcfg.validate()
    jcfg.validate()
    t_grid, j_grid = tcc.default_shape_grid(tcfg), jcc.default_shape_grid(jcfg)
    assert t_grid == j_grid
    tm, jm = (_manifest(tcc), _manifest(jcc)) if with_manifest else (None, None)
    assert tcc.split_plan(t_grid, tm) == jcc.split_plan(j_grid, jm)
    t_keys, j_keys = _plan_keys(tcfg, jcfg, with_manifest)
    assert t_keys == j_keys
    assert t_keys[0], "a plan with no hot program"
    if not with_manifest:
        # Extras requests are refused on a speculative engine, so its
        # default grid has no extras program.
        assert ("unified_full:t256" in t_keys[0]) == (extras and not spec_k)


@pytest.mark.parametrize("cap", [16, 100, 256, 512])
def test_budget_ladder_and_shape_keys_equal_jax(cap):
    assert tcc.budget_ladder(cap) == jcc.budget_ladder(cap)
    for n in (1, 2, 15, 16, 17, 100, 255, 256, 400):
        assert tcc.token_budget(n, cap) == jcc.token_budget(n, cap)
    for args in (("unified", 64), ("unified_full", 256), ("decode", 0, 4, 8, 2)):
        assert tcc.shape_key(*args) == jcc.shape_key(*args)


def test_manifest_roundtrip_and_fingerprint_guard(tmp_path):
    m = tcc.ShapeManifest()
    for _ in range(5):
        m.record("unified", t=128)
    m.record("unified", t=64)
    m.record("unified_full", t=128)
    path = str(tmp_path / "manifest.json")
    m.save(path, "fp-a")

    loaded = tcc.ShapeManifest.load(path, "fp-a")
    assert loaded is not None
    assert loaded.count_of(tcc.shape_key("unified", t=128)) == 5
    assert loaded.count_of(tcc.shape_key("unified_full", t=128)) == 1
    # Another engine fingerprint, a missing file and a torn file are all
    # ignored (a stale manifest would warm the wrong programs).
    assert tcc.ShapeManifest.load(path, "fp-b") is None
    assert tcc.ShapeManifest.load(str(tmp_path / "missing.json"), "fp-a") is None
    torn = tmp_path / "torn.json"
    torn.write_text('{"version": 1, "fingerp')
    assert tcc.ShapeManifest.load(str(torn), "fp-a") is None


def test_manifest_layout_is_the_jax_packages_both_ways(tmp_path):
    t_path, j_path = str(tmp_path / "t.json"), str(tmp_path / "j.json")
    _manifest(tcc).save(t_path, "fp")
    _manifest(jcc).save(j_path, "fp")
    assert json.load(open(t_path)) == json.load(open(j_path))
    from_jax = tcc.ShapeManifest.load(j_path, "fp")
    from_port = jcc.ShapeManifest.load(t_path, "fp")
    assert from_jax.shapes == from_port.shapes == _manifest(tcc).shapes


def test_fingerprint_tracks_program_relevant_config():
    base = tcc.fingerprint_key(tcc.engine_fingerprint(_cfgs("tiny-test")[0]))
    assert base == tcc.fingerprint_key(tcc.engine_fingerprint(_cfgs("tiny-test")[0]))
    for change in ({"kv_quant": "int8"}, {"speculative_k": 2},
                   {"sampling_extras": False}, {"unified_token_budget": 128}):
        other = tcc.engine_fingerprint(_cfgs("tiny-test", **change)[0])
        assert tcc.fingerprint_key(other) != base, change
    fp = tcc.engine_fingerprint(_cfgs("tiny-test")[0])
    assert "torch" in fp and "cuda" in fp and "jax" not in fp


# -- the engine on the CPU ---------------------------------------------------
def _engine(**kw):
    return TorchEngine(
        EngineConfig(model=ModelConfig.tiny_test(), **{**ENGINE_KW, **kw}),
        params=TPARAMS, device="cpu",
    )


def _req(prompt, max_tokens=4, proto=t_proto):
    return proto.PreprocessedRequest(
        token_ids=list(prompt), sampling=proto.SamplingOptions(temperature=0.0),
        stop=proto.StopConditions(max_tokens=max_tokens, ignore_eos=True),
    ).to_wire()


async def _collect(engine, prompt, max_tokens=4):
    toks = []
    async for out in engine.generate(Context(_req(prompt, max_tokens))):
        toks.extend(out["token_ids"])
    return toks


@pytest.mark.parametrize("kv_quant", [None, "int8"], ids=["bf16_layout", "int8"])
def test_warmup_writes_only_trash_block_0(kv_quant):
    async def main():
        engine = _engine(kv_quant=kv_quant)
        await engine.start()
        try:
            free = engine.allocator.num_free
            n = await engine.warmup()
            return engine, free, n
        finally:
            await engine.stop()

    engine, free, n = asyncio.run(main())
    runner, bs = engine.runner, engine.cfg.block_size
    # Every program of the plan, greedy and sampled.
    assert n == 2 * len(tcc.default_shape_grid(engine.cfg))
    touched = False
    for k, v in runner.kv_caches:
        assert not k[bs:].any() and not v[bs:].any()
        touched |= bool(k[:bs].any())
    assert touched, "the warm passes wrote nothing at all"
    if kv_quant:
        assert not runner.kv_scales[:, :, 1:].any()
    assert engine.allocator.num_free == free
    assert runner._counts is None or not runner._counts.any()
    assert not runner.compile_stats.manifest.shapes   # warm runs are not traffic
    assert engine.state == "ready" and not engine.served_unwarmed


def test_hold_gate_parks_admission_until_warm():
    async def main():
        engine = _engine(warmup_gate="hold")
        await engine.start()
        try:
            assert engine.state == "warming" and not engine.is_ready
            task = asyncio.create_task(_collect(engine, range(1, 9)))
            await asyncio.sleep(0.15)
            # Held: queued, not served, and nothing made.
            assert not task.done()
            assert engine.runner.compile_stats.seen == set()
            n = await engine.warmup()
            assert n > 0 and engine.is_ready and engine.state == "ready"
            assert len(await asyncio.wait_for(task, timeout=60)) == 4
            assert not engine.served_unwarmed
            assert engine.readiness()["mid_traffic_compiles_total"] == 0
        finally:
            await engine.stop()

    asyncio.run(main())


def test_degraded_gate_serves_and_flags():
    async def main():
        engine = _engine(warmup_gate="degraded")
        await engine.start()
        try:
            assert engine.state == "warming"
            assert len(await _collect(engine, range(1, 9))) == 4
            assert engine.state == "ready" and engine.served_unwarmed
            assert engine.runner.compile_stats.mid_traffic_compiles > 0
            ready = engine.readiness()
            assert ready["served_unwarmed"] and ready["mid_traffic_compiles_total"] > 0
        finally:
            await engine.stop()

    asyncio.run(main())


def test_mid_traffic_counter_on_unwarmed_shape():
    async def main():
        engine = _engine(**{**LIFECYCLE_KW, "unified_token_budget": 64,
                            "unified_prefill_quantum": 64})
        await engine.start()
        try:
            # Warm ONLY the bottom of the ladder (16/32); a prompt whose
            # batch snaps to the unwarmed 64 rung is made mid-traffic.
            r = engine.runner
            hot, tail = r.warmup_plan()
            small = [(key, op) for key, op in hot + tail
                     if key in ("unified:t16", "unified:t32")]
            assert len(small) == 2
            r.run_warm_ops(small)
            engine._state = "ready"
            cs = r.compile_stats
            assert cs.mid_traffic_compiles == 0
            await _collect(engine, range(1, 17))
            assert cs.mid_traffic_compiles == 0           # covered rungs: free
            await _collect(engine, range(1, 51))
            assert cs.mid_traffic_compiles >= 1
            assert any("t64" in k for k in cs.mid_traffic_keys)
            stall = cs.compile_stall_ms_total
            assert stall > 0
            await _collect(engine, range(1, 51))          # same shape: made once
            assert cs.compile_stall_ms_total == stall
            assert engine.readiness()["mid_traffic_compiles_total"] >= 1
        finally:
            await engine.stop()

    asyncio.run(main())


def test_manifest_saved_on_stop_and_drives_next_warmup(tmp_path):
    path = str(tmp_path / "manifest.json")
    kw = {**LIFECYCLE_KW, "unified_token_budget": 64, "unified_prefill_quantum": 64,
          "shape_manifest_path": path}

    async def main():
        engine = _engine(**kw)
        await engine.start()
        await engine.warmup()
        await _collect(engine, range(1, 41))
        await engine.stop()
        assert json.load(open(path))["shapes"]

        relaunch = _engine(**kw)
        await relaunch.start()
        try:
            n_hot = await relaunch.warmup()
            # Every unified rung is decode-critical, so the whole grid
            # stays hot: the manifest orders it (observed rungs first).
            assert n_hot == 2 * len(tcc.default_shape_grid(relaunch.cfg))
            assert relaunch.is_ready and relaunch.warm_tail_pending == 0
            seen = relaunch.runner.compile_stats.seen
            assert tcc.graph_key("unified", 64, True) in seen
            hot, _ = relaunch.runner.warmup_plan(relaunch._load_manifest())
            return relaunch.cfg, [key for key, _ in hot]
        finally:
            await relaunch.stop()

    cfg, hot = asyncio.run(main())
    # Observed rungs first, by count (3 decode steps at 16, the prefill
    # at 64), then the rest: the JAX plan over the same file.
    jm = jcc.ShapeManifest.load(path, tcc.fingerprint_key(tcc.engine_fingerprint(cfg)))
    j_cfg = JEngineConfig(model=JAX_CFG, **{**ENGINE_KW, **kw})
    j_cfg.validate()
    assert hot == [jcc.shape_key(*s) for s in jcc.split_plan(
        jcc.default_shape_grid(j_cfg), jm)[0]]
    assert hot[:2] == ["unified:t16", "unified:t64"]


def test_health_warming_503_and_compile_gauges_match_jax():
    """Both servers over the same readiness snapshot: /health 503
    "warming" while warming, 200 once ready; /live unaffected; /metrics
    carries the compile gauges (tests/test_compile_lifecycle.py:368)."""
    state = {"state": "warming", "mid_traffic_compiles_total": 0,
             "warm_tail_pending": 3, "warmed_programs": 12}

    async def drive(service):
        await service.start()
        try:
            out = []
            for phase in ("warming", "ready"):
                state["state"] = phase
                state["mid_traffic_compiles_total"] = 2 if phase == "ready" else 0
                health = await fetch("127.0.0.1", service.port, "GET", "/health")
                live = await fetch("127.0.0.1", service.port, "GET", "/live")
                out.append((health.status, health.json(), live.status))
            metrics = (await fetch("127.0.0.1", service.port, "GET", "/metrics")).body
            return out, metrics.decode()
        finally:
            await service.stop()

    async def main():
        j = await drive(JService(JManager(), host="127.0.0.1", port=0,
                                 readiness=lambda: dict(state)))
        t = await drive(HttpService(ModelManager(), host="127.0.0.1", port=0,
                                    readiness=lambda: dict(state)))
        return j, t

    (j_out, j_metrics), (t_out, t_metrics) = asyncio.run(main())
    assert t_out == j_out
    assert t_out[0][0] == 503 and t_out[0][1]["status"] == "warming"
    assert t_out[0][1]["engine"]["warm_tail_pending"] == 3 and t_out[0][2] == 200
    assert t_out[1][0] == 200 and t_out[1][1]["status"] == "healthy"
    for line in ("engine_ready 1.0", "mid_traffic_compiles_total 2",
                 "warmed_programs 12", "warm_tail_pending 3"):
        assert line in j_metrics and line in t_metrics, line


# -- the step body over static buffers against the JAX engine ---------------
FEED_PROMPTS = [[3, 1, 4, 1, 5], list(range(1, 41)), [2, 7, 1, 8], [9, 9, 8, 2, 6, 5, 3]]


async def _serve(engine, proto, ctx_cls, warm):
    await engine.start()
    try:
        if warm:
            await engine.warmup()

        async def one(p):
            toks = []
            async for raw in engine.generate(ctx_cls(_req(p, 10, proto))):
                toks.extend(raw["token_ids"])
            return toks

        return await asyncio.gather(*[one(p) for p in FEED_PROMPTS])
    finally:
        await engine.stop()


def test_static_buffer_step_pipelined_with_feeds_across_rungs_matches_jax(monkeypatch):
    from dynamo_tpu_torch.engine.runner import UnifiedOut

    # A CPU dispatch is done when it returns; report it pending, as a
    # card still running it would, so the engine issues the next one
    # first and feeds its decode lanes from the device.
    monkeypatch.setattr(UnifiedOut, "ready", lambda self: False)
    engine = _engine(pipeline_depth=2)
    calls = []
    step = ModelRunner.unified_step

    def recording(self, lanes, feed=None, **kw):
        total = sum(len(t) for t, *_ in lanes)
        calls.append((tcc.token_budget(total, self.cfg.unified_token_budget),
                      feed is not None and bool(np.asarray(feed[2]).any())))
        return step(self, lanes, feed=feed, **kw)

    ModelRunner.unified_step = recording
    try:
        port = asyncio.run(_serve(engine, t_proto, Context, warm=True))
    finally:
        ModelRunner.unified_step = step
    jax_engine = TpuEngine(JEngineConfig(model=JAX_CFG, **ENGINE_KW), params=PARAMS)
    want = asyncio.run(_serve(jax_engine, j_proto, JContext, warm=True))
    assert port == want
    # The run fed decode lanes from the device, across different rungs.
    crossings = [i for i in range(1, len(calls))
                 if calls[i][1] and calls[i][0] != calls[i - 1][0]]
    assert crossings, calls
    assert engine.runner.compile_stats.mid_traffic_compiles == 0
