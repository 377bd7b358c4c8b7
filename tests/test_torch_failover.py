"""The port's failover plane (dynamo_tpu_torch/runtime/failover.py) and
mocker (dynamo_tpu_torch/mocker) against the JAX package's, in process on
the CPU, mirroring tests/test_failover.py: the eligibility taxonomy,
replay of prompt + emitted tokens with shrunken budgets, error-frame
failover, bounded attempts, synthesized finishes — each case through
both packages' FailoverEngine — and the mid-stream kill between two
mocker workers, whose stream must equal the uninterrupted one byte for
byte. The mocker's streams equal the JAX mocker's for the same prompts
and config. (The reference's failover trace record waits for the
tracer, ROADMAP A4.)"""

import asyncio
from types import SimpleNamespace

import pytest

from dynamo_tpu.engine.config import EngineConfig as JEngineConfig
from dynamo_tpu.llm.protocols import common as j_common
from dynamo_tpu.mocker import MockerConfig as JMockerConfig
from dynamo_tpu.mocker import MockerEngine as JMockerEngine
from dynamo_tpu.mocker import det_next_token as j_det
from dynamo_tpu.models.config import ModelConfig as JModelConfig
from dynamo_tpu.runtime import failover as j_failover
from dynamo_tpu.runtime.engine import Context as JContext
from dynamo_tpu.runtime.transports import bus as j_bus
from dynamo_tpu.runtime.transports import tcp as j_tcp
from dynamo_tpu.utils import faults as j_faults
from dynamo_tpu_torch.engine.config import EngineConfig
from dynamo_tpu_torch.llm.protocols import common as t_common
from dynamo_tpu_torch.mocker import MockerConfig, MockerEngine, det_next_token
from dynamo_tpu_torch.models.config import ModelConfig
from dynamo_tpu_torch.runtime import failover as t_failover
from dynamo_tpu_torch.runtime.distributed import DistributedRuntime
from dynamo_tpu_torch.runtime.egress import PushRouter
from dynamo_tpu_torch.runtime.engine import Context
from dynamo_tpu_torch.runtime.transports import bus as t_bus
from dynamo_tpu_torch.runtime.transports import tcp as t_tcp
from dynamo_tpu_torch.utils import faults as t_faults

pytestmark = pytest.mark.anyio

PKGS = {
    "jax": SimpleNamespace(common=j_common, failover=j_failover, Context=JContext,
                           bus=j_bus, faults=j_faults, tcp=j_tcp),
    "torch": SimpleNamespace(common=t_common, failover=t_failover, Context=Context,
                             bus=t_bus, faults=t_faults, tcp=t_tcp),
}
BOTH = pytest.mark.parametrize("pkg", sorted(PKGS))


@pytest.fixture(autouse=True)
def _clear_faults():
    yield
    t_faults.FAULTS.clear()
    j_faults.FAULTS.clear()


def _wire(c, prompt, osl=16, **stop):
    return c.PreprocessedRequest(
        token_ids=list(prompt),
        sampling=c.SamplingOptions(temperature=0.0),
        stop=c.StopConditions(max_tokens=osl, ignore_eos=not stop, **stop),
    ).to_wire()


class _ScriptedEngine:
    """Downstream whose generate() runs a scripted stream per call."""

    def __init__(self, scripts):
        self.scripts = list(scripts)
        self.calls = 0
        self.payloads = []
        self.marked = []

    async def generate(self, request):
        self.calls += 1
        self.payloads.append(request.payload)
        for step in self.scripts[min(self.calls, len(self.scripts)) - 1]:
            if isinstance(step, BaseException):
                raise step
            yield step

    def mark_dead(self, instance_id, reason):
        self.marked.append((instance_id, reason))


async def _run(pkg, scripts, wire, annotations=None, **kw):
    m = PKGS[pkg]
    down = _ScriptedEngine(scripts)
    ctx = m.Context(wire)
    ctx.annotations.update(annotations or {})
    got = []
    async for item in m.failover.FailoverEngine(down, **kw).generate(ctx):
        got.append(item)
    return down, got


def _toks(items):
    return [t for i in items for t in i.get("token_ids", [])]


# -- taxonomy -----------------------------------------------------------------
@BOTH
def test_failover_eligibility_is_structural(pkg):
    m = PKGS[pkg]
    c = m.common
    yes = [c.WorkerDiedError("gone"), ConnectionRefusedError("refused"),
           asyncio.IncompleteReadError(b"", 4), m.bus.NoSubscriberError("dead"),
           m.faults.FaultError("injected")]
    no = [c.ShedError("overloaded"), c.DeadlineError("expired"),
          c.RequestError("bad"), RuntimeError("bug"), c.FailoverExhausted("done")]
    assert all(m.failover.failover_eligible(e) for e in yes)
    assert not any(m.failover.failover_eligible(e) for e in no)


@BOTH
@pytest.mark.parametrize("kind", ["ShedError", "DeadlineError", "RequestError"])
async def test_shed_deadline_request_errors_are_never_retried(pkg, kind):
    m = PKGS[pkg]
    exc = getattr(m.common, kind)("no")
    before = m.failover.FAILOVER.total
    with pytest.raises(type(exc)):
        await _run(pkg, [[{"token_ids": [1]}, exc]], _wire(m.common, [5, 6]))
    assert m.failover.FAILOVER.total == before


@BOTH
async def test_failover_replays_prompt_plus_emitted_and_shrinks_budgets(pkg):
    c = PKGS[pkg].common
    down, got = await _run(pkg, [
        [{"token_ids": [10], "cum_tokens": 1}, {"token_ids": [11], "cum_tokens": 2},
         c.WorkerDiedError("killed")],
        [{"token_ids": [12], "cum_tokens": 1}, {"token_ids": [13], "cum_tokens": 2},
         {"token_ids": [], "cum_tokens": 2, "finish_reason": "length"}],
    ], _wire(c, [5, 6], osl=4))
    assert _toks(got) == [10, 11, 12, 13]
    assert down.payloads[1]["token_ids"] == [5, 6, 10, 11]
    assert down.payloads[1]["stop"]["max_tokens"] == 2
    assert [i.get("cum_tokens") for i in got] == [1, 2, 3, 4, 4]
    assert PKGS[pkg].failover.FAILOVER.success_by_reason.get("WorkerDiedError", 0) >= 1


@BOTH
async def test_engine_error_finish_frame_triggers_failover(pkg):
    c = PKGS[pkg].common
    down, got = await _run(pkg, [
        [{"token_ids": [7], "cum_tokens": 1}, {"token_ids": [], "finish_reason": "error"}],
        [{"token_ids": [8], "cum_tokens": 1, "finish_reason": "stop"}],
    ], _wire(c, [1, 2], osl=8), annotations={"worker_id": 0xBEEF})
    assert down.calls == 2 and _toks(got) == [7, 8]
    assert all(i.get("finish_reason") != "error" for i in got)
    assert down.marked == [(0xBEEF, "engine_fault")]


@BOTH
async def test_bounded_attempts_end_in_typed_failover_exhausted(pkg):
    c = PKGS[pkg].common
    with pytest.raises(c.FailoverExhausted) as info:
        await _run(pkg, [[c.WorkerDiedError("dead")]] * 10, _wire(c, [1, 2]),
                   max_attempts=3)
    assert info.value.attempts == 3
    assert not isinstance(info.value, ConnectionError)


@BOTH
async def test_death_after_final_token_synthesizes_length_finish(pkg):
    c = PKGS[pkg].common
    down, got = await _run(pkg, [
        [{"token_ids": [10], "cum_tokens": 1}, {"token_ids": [11], "cum_tokens": 2},
         c.WorkerDiedError("died before the terminal frame")],
        [{"token_ids": [99], "cum_tokens": 1, "finish_reason": "length"}],
    ], _wire(c, [5, 6], osl=2))
    assert down.calls == 1 and _toks(got) == [10, 11]
    assert got[-1]["finish_reason"] == "length" and got[-1]["cum_tokens"] == 2


@BOTH
async def test_death_after_stop_token_synthesizes_stop_finish(pkg):
    c = PKGS[pkg].common
    down, got = await _run(pkg, [
        [{"token_ids": [10], "cum_tokens": 1}, {"token_ids": [11], "cum_tokens": 2},
         c.WorkerDiedError("died before the terminal frame")],
        [{"token_ids": [99], "cum_tokens": 1, "finish_reason": "stop"}],
    ], _wire(c, [5, 6], osl=16, stop_token_ids=[11]))
    assert down.calls == 1 and _toks(got) == [10, 11]
    assert got[-1]["finish_reason"] == "stop"


async def test_failover_success_counted_when_the_detokenizer_stops_at_max_tokens():
    """Behind a Detokenizer the stream is closed at ``max_tokens``, before
    the engine's terminal frame: the port counts the failover's success
    when the owed tokens are delivered (a deliberate difference: the
    reference waits for the terminal frame, which this consumer never
    reads)."""
    from dynamo_tpu_torch.llm.backend import Detokenizer
    from dynamo_tpu_torch.llm.tokenizer import ToyTokenizer
    from dynamo_tpu_torch.runtime.pipeline import Pipeline

    c = t_common
    down = _ScriptedEngine([
        [{"token_ids": [10], "cum_tokens": 1}, c.WorkerDiedError("killed")],
        [{"token_ids": [11], "cum_tokens": 1}, {"token_ids": [12], "cum_tokens": 2},
         {"token_ids": [], "cum_tokens": 2, "finish_reason": "length"}],
    ])
    pipe = Pipeline.link(Detokenizer(ToyTokenizer()),
                         engine=t_failover.FailoverEngine(down))
    before = t_failover.FAILOVER.success_by_reason.get("WorkerDiedError", 0)
    got = [i async for i in pipe.generate(Context(_wire(c, [5, 6], osl=3)))]
    assert _toks(got) == [10, 11, 12] and got[-1]["finish_reason"] == "length"
    assert t_failover.FAILOVER.success_by_reason["WorkerDiedError"] == before + 1


@BOTH
def test_stream_closed_without_terminal_frame_is_worker_death(pkg):
    m = PKGS[pkg]

    async def run():
        r = m.tcp.ResponseStreamReceiver()
        r._push("data", b"x")
        r._close()
        assert await r.__anext__() == b"x"
        with pytest.raises(m.common.WorkerDiedError) as info:
            await r.__anext__()
        assert info.value.transport_dead
        clean = m.tcp.ResponseStreamReceiver()
        clean._push("end", b"")
        clean._close()
        with pytest.raises(StopAsyncIteration):
            await clean.__anext__()

    asyncio.run(run())


# -- the mocker ----------------------------------------------------------------
MOCK_KW = dict(num_blocks=128, max_num_seqs=4, max_model_len=256, dtype="float32")


async def _mock_streams(engine_cls, cfg_cls, model, sim_cls, ctx_cls, c, det, prompts, osl):
    eng = engine_cls(cfg_cls(model=model, **MOCK_KW),
                     sim_cls(vocab_size=100, seed=3, deterministic_tokens=det,
                             decode_time_per_step_us=200.0))
    await eng.start()

    async def one(p):
        out, fin = [], None
        async for item in eng.generate(ctx_cls(_wire(c, p, osl))):
            out += item["token_ids"]
            fin = item["finish_reason"] or fin
        return out, fin

    try:
        return await asyncio.gather(*[one(p) for p in prompts])
    finally:
        await eng.stop()


@pytest.mark.parametrize("det,prompts", [
    (True, [[5, 6, 7, 8], [1, 2, 3], list(range(1, 31))]),
    # Seeded-RNG tokens follow the dispatch order, which concurrent
    # requests make timing-dependent: one request at a time.
    (False, [list(range(1, 31))]),
], ids=["deterministic", "seeded_rng"])
async def test_mocker_streams_equal_the_jax_mockers(det, prompts):
    want = await _mock_streams(JMockerEngine, JEngineConfig, JModelConfig.tiny_test(),
                               JMockerConfig, JContext, j_common, det, prompts, 12)
    got = await _mock_streams(MockerEngine, EngineConfig, ModelConfig.tiny_test(),
                              MockerConfig, Context, t_common, det, prompts, 12)
    assert got == want
    assert all(fin == "length" and len(toks) == 12 for toks, fin in got)


def test_det_next_token_is_the_jax_closed_form():
    import numpy as np

    prev = np.arange(0, 500, 7)
    pos = np.arange(3, 3 + len(prev))
    for positional in (True, False):
        assert np.array_equal(det_next_token(prev, pos, 97, positional),
                              j_det(prev, pos, 97, positional))


def test_mocker_phase_entry_points_follow_the_jax_sim():
    """The sim's prefill, prefill_batch, decode and decode_multi give the
    JAX sim's tokens (deterministic law) for the same inputs."""
    import numpy as np

    from dynamo_tpu.mocker.engine import _SimRunner as JSim
    from dynamo_tpu_torch.mocker.engine import _SimRunner as TSim

    kw = dict(vocab_size=97, deterministic_tokens=True, decode_time_per_step_us=0.0,
              prefill_time_per_token_us=0.0)
    j = JSim(JEngineConfig(model=JModelConfig.tiny_test(), **MOCK_KW),
             JMockerConfig(**kw))
    t = TSim(EngineConfig(model=ModelConfig.tiny_test(), **MOCK_KW), MockerConfig(**kw))
    samp = (0.0, 0, 1.0)
    assert t.prefill([5, 6, 7], [1], 2, samp) == j.prefill([5, 6, 7], [1], 2, samp)
    lanes = [([1, 2, 3], [1], 0, samp), ([9], [2], 4, samp)]
    assert t.prefill_batch(lanes) == j.prefill_batch(lanes)
    toks, pos = np.array([3, 8]), np.array([5, 9])
    args = (np.zeros((2, 4), np.int32), pos + 1, np.zeros(2), np.zeros(2), np.ones(2))
    assert np.array_equal(t.decode(toks, pos, args[0], args[1], np.zeros(2), *args[2:]),
                          j.decode(toks, pos, args[0], args[1], np.zeros(2), *args[2:]))
    assert np.array_equal(t.decode_multi(toks, pos, *args, num_steps=4),
                          j.decode_multi(toks, pos, *args, num_steps=4))


def test_mocker_defaults_carry_no_tpu_calibration():
    """The JAX package's TPU-fitted cost terms stay off in the port."""
    sim = MockerConfig()
    assert (sim.prefill_quadratic_us, sim.kv_bytes_per_token, sim.decode_hbm_gbps,
            sim.weight_bytes_per_step) == (0.0, 0.0, 0.0, 0.0)
    j = JMockerConfig()
    assert (sim.decode_time_per_step_us, sim.prefill_time_per_token_us,
            sim.vocab_size, sim.seed, sim.deterministic_tokens) == (
        j.decode_time_per_step_us, j.prefill_time_per_token_us, j.vocab_size,
        j.seed, j.deterministic_tokens)


async def test_mocker_warmup_and_capture_counts():
    eng = MockerEngine(EngineConfig(model=ModelConfig.tiny_test(), **MOCK_KW),
                       MockerConfig(decode_time_per_step_us=0.0))
    await eng.start()
    try:
        n = await eng.warmup()
        assert n > 0 and eng.is_ready
        got = await _collect(eng, [1, 2, 3], 4)
        assert len(got) == 4
        assert eng.readiness()["mid_traffic_compiles_total"] == 0
    finally:
        await eng.stop()


async def _collect(engine, prompt, osl):
    out = []
    async for item in engine.generate(Context(_wire(t_common, prompt, osl))):
        out += item["token_ids"]
    return out


# -- the mid-stream kill ---------------------------------------------------------
async def _mocker_fleet(drt, n, decode_us=8000.0):
    """n deterministic-token port mocker workers on one endpoint."""
    handles = []
    for i in range(n):
        eng = MockerEngine(
            EngineConfig(model=ModelConfig.tiny_test(), **MOCK_KW),
            MockerConfig(vocab_size=100, seed=i, deterministic_tokens=True,
                         decode_time_per_step_us=decode_us),
        )
        await eng.start()
        sub = drt if i == 0 else await DistributedRuntime.in_process(
            store=drt.store, bus=drt.bus, runtime=drt.runtime)
        inst = await sub.namespace("fo").component("w").endpoint("gen").serve(eng)
        handles.append((inst, eng))
    return handles


async def _teardown(handles, drt):
    for inst, eng in handles:
        try:
            await inst.stop()
        except Exception:  # noqa: BLE001 — may already be killed
            pass
        await eng.stop()
    await drt.shutdown()


async def test_mid_stream_kill_yields_byte_identical_greedy_stream():
    """Kill the serving worker mid-decode: the client's token stream
    equals the uninterrupted single-worker stream byte for byte, and
    FailoverStats counts one WorkerDiedError success."""
    prompt, osl = [5, 6, 7, 8], 30
    FAILOVER = t_failover.FAILOVER

    drt = await DistributedRuntime.in_process()
    handles = await _mocker_fleet(drt, 1)
    push = await PushRouter.create(drt, "fo.w.gen")
    ref = _toks([i async for i in t_failover.FailoverEngine(push).generate(
        Context(_wire(t_common, prompt, osl)))])
    await _teardown(handles, drt)
    assert len(ref) == osl

    drt = await DistributedRuntime.in_process()
    handles = await _mocker_fleet(drt, 2)
    push = await PushRouter.create(drt, "fo.w.gen", connect_timeout_s=2.0)
    before = FAILOVER.success_by_reason.get("WorkerDiedError", 0)
    ctx = Context(_wire(t_common, prompt, osl))
    got, killed, finish = [], None, None
    try:
        async for item in t_failover.FailoverEngine(push).generate(ctx):
            got += item.get("token_ids", [])
            finish = item.get("finish_reason") or finish
            if len(got) >= 5 and killed is None:
                killed = ctx.annotations["worker_id"]
                victim = next(h for h in handles if h[0].instance.instance_id == killed)
                await victim[0].kill()
        assert killed is not None and ctx.annotations["worker_id"] != killed
        assert got == ref, f"not byte-identical:\nref={ref}\ngot={got}"
        assert finish == "length"
        assert FAILOVER.success_by_reason.get("WorkerDiedError", 0) == before + 1
    finally:
        await _teardown(handles, drt)


async def test_error_frame_worker_died_fails_over_without_eviction():
    """A WorkerDiedError that crossed as an error frame came from a live
    worker: the request fails over, the reporter stays routable."""
    drt = await DistributedRuntime.in_process()
    handles = await _mocker_fleet(drt, 2, decode_us=100.0)
    try:
        push = await PushRouter.create(drt, "fo.w.gen", connect_timeout_s=2.0)
        before = t_failover.FAILOVER.marked_dead_total
        t_faults.FAULTS.arm("tcp.respond", "raise", times=1)
        out = _toks([i async for i in t_failover.FailoverEngine(push).generate(
            Context(_wire(t_common, [3, 4], osl=4)))])
        assert len(out) == 4
        assert len(push.client.instance_ids()) == 2
        assert t_failover.FAILOVER.marked_dead_total == before
    finally:
        await _teardown(handles, drt)
