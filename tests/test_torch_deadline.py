"""Deadlines and SLO classes in the port, held against the JAX package:
the deadline and class cases of tests/test_overload.py and
tests/test_ingress_scale.py, case for case.

Pure functions and state machines (Deadline, the admission gate, the
scheduler's shed and preemption order) run in both packages on the same
inputs, made from a numpy seed, and must decide identically: the same
admissions and rejections with the same Retry-After hints, the same
shed and preempted request ids. The engine and HTTP cases run the port's
mocker or tiny-test engine on the CPU."""

import asyncio
import time

import numpy as np
import pytest

from dynamo_tpu.engine.config import EngineConfig as JEngineConfig
from dynamo_tpu.engine.kv_cache import BlockAllocator as JAllocator
from dynamo_tpu.engine.scheduler import Scheduler as JScheduler
from dynamo_tpu.engine.sequence import Sequence as JSequence
from dynamo_tpu.llm import admission as j_adm
from dynamo_tpu.llm import slo as j_slo
from dynamo_tpu.llm.protocols import common as j_proto
from dynamo_tpu.models.config import ModelConfig as JModelConfig
from dynamo_tpu.utils import deadline as j_deadline
from dynamo_tpu_torch.engine.config import EngineConfig
from dynamo_tpu_torch.engine.engine import TorchEngine, _request_class
from dynamo_tpu_torch.engine.kv_cache import BlockAllocator
from dynamo_tpu_torch.engine.scheduler import Scheduler
from dynamo_tpu_torch.engine.sequence import Sequence
from dynamo_tpu_torch.llm import admission as t_adm
from dynamo_tpu_torch.llm import slo
from dynamo_tpu_torch.llm.protocols.common import (
    DeadlineError,
    FinishReason,
    PreprocessedRequest,
    SamplingOptions,
    ShedError,
    StopConditions,
)
from dynamo_tpu_torch.mocker import MockerConfig, MockerEngine
from dynamo_tpu_torch.models.config import ModelConfig
from dynamo_tpu_torch.runtime.engine import Context
from dynamo_tpu_torch.utils import deadline as t_deadline
from dynamo_tpu_torch.utils.deadline import OVERLOAD, Deadline

BOTH_DEADLINE = [j_deadline, t_deadline]


# ---------------------------------------------------------------------------
# Deadline primitive and the wire
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mod", BOTH_DEADLINE, ids=["jax", "port"])
def test_deadline_basics(mod):
    D = mod.Deadline
    d = D.after(10.0)
    assert not d.expired
    assert 9.0 < d.remaining_s() <= 10.0
    assert D.after(-1.0).expired
    assert D.after_ms(0.0).expired
    d2 = D.from_wire(d.to_wire())
    assert abs(d2.remaining_s() - d.remaining_s()) < 0.5
    assert D.from_wire(None) is None
    assert D.from_wire(D.after(-5).to_wire()).expired
    for header, want in (("1500", 1500.0), ("nope", None), ("-5", None),
                         (None, None), ("0.5", 0.5)):
        assert mod.parse_timeout_ms(header) == want


def test_preprocessed_request_deadline_wire():
    """Port → JAX → port: the remaining budget survives both hops and
    never grows; no deadline stays no deadline."""
    pre = PreprocessedRequest(token_ids=[1, 2, 3], deadline=Deadline.after(5))
    wire = pre.to_wire()
    assert 0 < wire["deadline_ms"] <= 5000
    via_jax = j_proto.PreprocessedRequest.from_wire(wire).to_wire()
    back = PreprocessedRequest.from_wire(via_jax)
    assert back.deadline is not None and not back.deadline.expired
    assert back.deadline.remaining_ms() <= wire["deadline_ms"]
    wire2 = PreprocessedRequest(token_ids=[1]).to_wire()
    assert "deadline_ms" not in wire2
    assert PreprocessedRequest.from_wire(wire2).deadline is None


@pytest.mark.parametrize("mod", BOTH_DEADLINE, ids=["jax", "port"])
def test_overload_counters_split_by_class(mod):
    c = mod.OverloadCounters()
    c.note_shed("engine.waiting", request_class="batch")
    c.note_shed("admission.inflight_cap", 2, request_class="interactive")
    c.note_shed("engine.draining")
    c.note_deadline("engine.queued")
    c.note_deadline("engine.decode", 3)
    assert (c.shed_total, c.deadline_total) == (4, 4)
    assert (c.shed_class_total("batch"), c.shed_class_total("interactive")) == (1, 2)
    assert c.snapshot() == {
        "shed": {"engine.waiting": 1, "admission.inflight_cap": 2, "engine.draining": 1},
        "deadline": {"engine.queued": 1, "engine.decode": 3},
        "shed_by_class": {"batch": 1, "interactive": 2},
    }


# ---------------------------------------------------------------------------
# SLO taxonomy + class-weighted admission (both packages, same inputs)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mod", [j_slo, slo], ids=["jax", "port"])
def test_slo_normalization_and_default(mod):
    assert mod.normalize_class("batch") == "batch"
    assert mod.normalize_class(" Batch ") == "batch"
    assert mod.normalize_class("INTERACTIVE") == "interactive"
    assert mod.normalize_class(None) == "interactive"
    assert mod.normalize_class("premium") == "interactive"
    assert mod.normalize_class(None, default="batch") == "batch"
    assert mod.normalize_class("junk", default="junk") == "interactive"
    assert mod.is_batch("batch") and not mod.is_batch("interactive")


def _decide(c, rejected, cls):
    try:
        return ("admitted", c.admit(cls))
    except rejected as exc:
        return ("rejected", exc.reason, exc.retry_after_s, exc.draining)


def _both(cfg_kw, stats=None):
    getter = (lambda: stats) if stats is not None else None
    return (
        j_adm.AdmissionController(j_adm.AdmissionConfig(**cfg_kw), engine_stats=getter),
        t_adm.AdmissionController(t_adm.AdmissionConfig(**cfg_kw), engine_stats=getter),
    )


def test_admission_class_weighted_inflight_cap():
    """Batch refuses at half the inflight cap while interactive admits;
    both gates decide and count identically."""
    j, t = _both({"max_inflight": 8})
    permits = []
    for cls in ["batch", "interactive", "batch", "batch", "batch"] + ["interactive"] * 5:
        a = _decide(j, j_adm.AdmissionRejected, cls)
        b = _decide(t, t_adm.AdmissionRejected, cls)
        assert b[0] == a[0] and b[1:] == a[1:] if b[0] == "rejected" else True
        permits += [x[1] for x in (a, b) if x[0] == "admitted"]
    snap = t.snapshot()
    assert snap["rejected_by_class"] == {"batch": 1, "interactive": 1}
    assert snap["inflight_by_class"]["interactive"] == 5
    assert snap == j.snapshot()
    for p in permits:
        p.release()
    assert t.inflight == j.inflight == 0
    assert t.snapshot()["inflight_by_class"] == {"interactive": 0, "batch": 0}


def test_admission_class_weighted_engine_watermark():
    j, t = _both({"max_engine_waiting": 50}, stats={"num_requests_waiting": 30})
    for c, rej in ((j, j_adm.AdmissionRejected), (t, t_adm.AdmissionRejected)):
        with pytest.raises(rej) as exc:
            c.admit("batch")
        assert exc.value.reason == "engine_waiting"
        c.admit("interactive").release()


def test_admission_engine_watermarks():
    """Waiting depth and KV usage trip their watermarks with their own
    reasons in both gates; a broken stats probe fails open."""
    stats = {"num_requests_waiting": 0, "gpu_cache_usage_perc": 0.2}
    j, t = _both({"max_inflight": 99, "max_engine_waiting": 4, "max_kv_usage": 0.9},
                 stats)
    for c, rej in ((j, j_adm.AdmissionRejected), (t, t_adm.AdmissionRejected)):
        stats.update(num_requests_waiting=0, gpu_cache_usage_perc=0.2)
        c.admit().release()
        stats["num_requests_waiting"] = 4
        with pytest.raises(rej) as exc:
            c.admit()
        assert exc.value.reason == "engine_waiting"
        stats.update(num_requests_waiting=0, gpu_cache_usage_perc=0.95)
        with pytest.raises(rej) as exc:
            c.admit()
        assert exc.value.reason == "kv_watermark"
    assert t.snapshot() == j.snapshot()
    broken = t_adm.AdmissionController(
        t_adm.AdmissionConfig(max_inflight=1, max_engine_waiting=1),
        engine_stats=lambda: (_ for _ in ()).throw(RuntimeError("probe")))
    broken.admit()


def test_retry_after_is_load_proportional_and_capped():
    stats = {"num_requests_waiting": 0}
    j, t = _both({"max_engine_waiting": 10, "retry_after_s": 1.0,
                  "retry_after_max_s": 6.0}, stats)
    for waiting, hint in ((20, 2.0), (500, 6.0)):
        stats["num_requests_waiting"] = waiting
        for c, rej in ((j, j_adm.AdmissionRejected), (t, t_adm.AdmissionRejected)):
            with pytest.raises(rej) as exc:
                c.admit()
            assert exc.value.retry_after_s == pytest.approx(hint)
    assert t.snapshot()["retry_after_by_reason"] == j.snapshot()["retry_after_by_reason"]


def test_retry_after_inflight_cap_scales_with_overshoot():
    j, t = _both({"max_inflight": 4, "retry_after_s": 1.0, "retry_after_max_s": 30.0})
    for c, rej in ((j, j_adm.AdmissionRejected), (t, t_adm.AdmissionRejected)):
        held = [c.admit("interactive") for _ in range(3)]
        with pytest.raises(rej) as exc:
            c.admit("batch")
        assert exc.value.retry_after_s == pytest.approx(1.5)
        for p in held:
            p.release()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_seeded_class_admission_decisions_match(seed):
    """Random classes, watermark scales, engine stats and releases: the
    two gates make the same decision with the same hint at every step."""
    rng = np.random.default_rng(seed)
    stats = {}
    kw = dict(max_inflight=6, max_engine_waiting=10, max_prefill_backlog_tokens=4000,
              max_kv_usage=0.9,
              default_request_class=str(rng.choice(["interactive", "batch"])),
              class_watermark_scale={"interactive": 1.0,
                                     "batch": float(rng.choice([0.25, 0.5, 1.0]))})
    j, t = _both(kw, stats)
    held: list[tuple] = []
    for _ in range(60):
        stats["num_requests_waiting"] = int(rng.integers(0, 14))
        stats["prefill_backlog_tokens"] = int(rng.integers(0, 5000))
        stats["gpu_cache_usage_perc"] = float(rng.uniform(0.0, 1.0))
        cls = [None, "interactive", "batch", "junk"][int(rng.integers(0, 4))]
        a = _decide(j, j_adm.AdmissionRejected, cls)
        b = _decide(t, t_adm.AdmissionRejected, cls)
        assert (b if b[0] == "rejected" else b[0]) == (a if a[0] == "rejected" else a[0])
        if a[0] == "admitted":
            held.append((a[1], b[1]))
        if held and rng.random() < 0.4:
            for p in held.pop(int(rng.integers(0, len(held)))):
                p.release()
    assert t.snapshot() == j.snapshot()


# ---------------------------------------------------------------------------
# Scheduler shed/preempt order (both packages, same arrivals)
# ---------------------------------------------------------------------------


def _sched_pair(**kw):
    base = dict(num_blocks=64, max_num_seqs=4, max_model_len=128, dtype="float32")
    base.update(kw)
    jc = JEngineConfig(model=JModelConfig.tiny_test(), **base)
    tc = EngineConfig(model=ModelConfig.tiny_test(), **base)
    return (JScheduler(jc, JAllocator(jc.num_blocks, jc.block_size)),
            Scheduler(tc, BlockAllocator(tc.num_blocks, tc.block_size)))


def _seq(cls_, rid, slo_class="interactive", arrival=0.0, tokens=8, deadline=None):
    emitted = []
    kw = dict(
        request_id=rid, prompt_tokens=list(range(1, tokens + 1)),
        emit=lambda t, f, lp=None: emitted.append((t, f)),
        slo_class=slo_class, deadline=deadline,
    )
    if cls_ is JSequence:
        kw.update(sampling=j_proto.SamplingOptions(),
                  stop=j_proto.StopConditions(max_tokens=4))
    else:
        kw.update(sampling=SamplingOptions(), stop=StopConditions(max_tokens=4))
    s = cls_(**kw)
    s.arrival_s = arrival
    s._emitted = emitted
    return s


def _finish_of(seq):
    f = seq._emitted[-1][1] if seq._emitted else None
    return getattr(f, "value", f)


def test_shed_order_batch_before_interactive_at_equal_age():
    t0 = time.monotonic() - 10.0
    waits = []
    for sched, cls_ in zip(_sched_pair(max_waiting=2), (JSequence, Sequence)):
        old_i = _seq(cls_, "i-old", "interactive", t0)
        old_b = _seq(cls_, "b-old", "batch", t0)
        for s in (old_i, old_b, _seq(cls_, "i-new", "interactive", t0 + 5)):
            sched.add(s)
        assert _finish_of(old_b) == "shed" and old_i.status.value == "waiting"
        waits.append([s.request_id for s in sched.waiting])
    assert waits[0] == waits[1] == ["i-old", "i-new"]


def test_shed_order_falls_back_to_oldest_without_batch():
    t0 = time.monotonic() - 10.0
    for sched, cls_ in zip(_sched_pair(max_waiting=2), (JSequence, Sequence)):
        a = _seq(cls_, "i-a", "interactive", t0)
        for s in (a, _seq(cls_, "i-b", "interactive", t0 + 1),
                  _seq(cls_, "i-c", "interactive", t0 + 2)):
            sched.add(s)
        assert a.status.value == "finished"
        assert [s.request_id for s in sched.waiting] == ["i-b", "i-c"]


def test_preempt_victim_prefers_batch():
    t0 = time.monotonic() - 10.0
    for sched, cls_ in zip(_sched_pair(), (JSequence, Sequence)):
        batch_old = _seq(cls_, "b", "batch", t0)
        inter_new = _seq(cls_, "i", "interactive", t0 + 5)
        for s in (batch_old, inter_new):
            assert sched.admit(s)
        assert sched._pick_victim(exclude=None) is batch_old
        stop = j_proto.FinishReason.STOP if cls_ is JSequence else FinishReason.STOP
        sched.finish(batch_old, stop)
        assert sched._pick_victim(exclude=None) is inter_new


def test_waiting_by_class_split():
    for sched, cls_ in zip(_sched_pair(), (JSequence, Sequence)):
        for rid, c in (("a", "interactive"), ("b", "batch"), ("c", "batch")):
            sched.add(_seq(cls_, rid, c))
        assert sched.waiting_by_class() == {"interactive": 1, "batch": 2}


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_seeded_arrivals_shed_and_preempt_the_same_ids(seed):
    """The same seeded arrivals (classes, ages, deadlines past on arrival
    or expiring while waiting) through both schedulers: the same ids are
    shed by the depth bound, expired on arrival and by the sweep,
    admitted, and chosen as preemption victims in the same order."""
    rng = np.random.default_rng(seed)
    t0 = time.monotonic() - 100.0
    n = 24
    classes = rng.choice(["interactive", "batch"], n, p=[0.6, 0.4])
    ages = np.sort(rng.uniform(0, 50, n))
    expired_on_arrival = rng.random(n) < 0.15
    expires_waiting = rng.random(n) < 0.2
    outcomes = []
    for sched, cls_, dl in zip(_sched_pair(max_waiting=6, max_num_seqs=6),
                               (JSequence, Sequence),
                               (j_deadline.Deadline, Deadline)):
        seqs = [_seq(cls_, f"r{i}", str(classes[i]), t0 + float(ages[i]),
                     deadline=dl.after(-1.0 if expired_on_arrival[i] else 3600.0))
                for i in range(n)]
        for s in seqs:
            sched.add(s)
        for s, late in zip(seqs, expires_waiting):
            if late and s.status.value == "waiting":
                s.deadline = dl.after(-1.0)
        sched.expire_waiting()
        finishes = {s.request_id: _finish_of(s) for s in seqs if _finish_of(s)}
        admitted = []
        while (s := sched.next_prefill()) is not None:
            admitted.append(s.request_id)
        victims = []
        while (v := sched._pick_victim(exclude=None)) is not None:
            victims.append(v.request_id)
            v.status = type(v.status)("finished")
        outcomes.append((finishes, admitted, victims))
    assert outcomes[0] == outcomes[1]
    finishes, admitted, victims = outcomes[1]
    assert {"shed", "deadline_exceeded"} <= set(finishes.values())
    assert admitted and victims


def test_request_class_rides_the_wire_to_the_sequence():
    pre = PreprocessedRequest(token_ids=[1, 2, 3],
                              annotations={slo.ANNOTATION_KEY: "batch"})
    via_jax = j_proto.PreprocessedRequest.from_wire(pre.to_wire()).to_wire()
    assert _request_class(PreprocessedRequest.from_wire(via_jax)) == "batch"
    assert _request_class(PreprocessedRequest(token_ids=[1])) == "interactive"
    pre.annotations[slo.ANNOTATION_KEY] = "vip"
    assert _request_class(pre) == "interactive"


# ---------------------------------------------------------------------------
# Engine: deadline hops (the port's mocker and tiny-test engine)
# ---------------------------------------------------------------------------


def _cfg(**kw) -> EngineConfig:
    base = dict(model=ModelConfig.tiny_test(), num_blocks=64, max_num_seqs=2,
                max_model_len=128, dtype="float32")
    base.update(kw)
    return EngineConfig(**base)


def _req(n=24, max_tokens=4, deadline=None, cls=None):
    return PreprocessedRequest(
        token_ids=list(range(n)), sampling=SamplingOptions(temperature=0.0),
        stop=StopConditions(max_tokens=max_tokens, ignore_eos=True),
        deadline=deadline,
        annotations={slo.ANNOTATION_KEY: cls} if cls else {},
    )


async def _collect(engine, req):
    out, finish = [], None
    async for item in engine.generate(Context(req.to_wire())):
        out.extend(item["token_ids"])
        finish = item.get("finish_reason") or finish
    return out, finish


def test_engine_expired_arrival_raises_deadline_error():
    async def main():
        eng = MockerEngine(_cfg(), MockerConfig())
        await eng.start()
        try:
            base = OVERLOAD.deadline_total
            with pytest.raises(DeadlineError):
                await _collect(eng, _req(deadline=Deadline.after(-1)))
            assert OVERLOAD.deadline_total > base
        finally:
            await eng.stop()

    asyncio.run(main())


def test_engine_queued_past_deadline_is_shed_not_executed():
    """Two slot hogs pin both slots; a queued request whose deadline
    expires while it waits finishes DEADLINE with no output and is never
    run."""
    async def main():
        eng = MockerEngine(_cfg(max_num_seqs=2), MockerConfig(decode_time_per_step_us=20000.0))
        await eng.start()
        try:
            hogs = [asyncio.ensure_future(_collect(eng, _req(max_tokens=48)))
                    for _ in range(2)]
            while len(eng.scheduler.running) < 2:
                await asyncio.sleep(0.005)
            base = OVERLOAD.deadline_total
            out, finish = await asyncio.wait_for(
                _collect(eng, _req(deadline=Deadline.after(0.05), cls="batch")), 30.0)
            assert (out, finish) == ([], FinishReason.DEADLINE.value)
            assert OVERLOAD.deadline_total == base + 1
            for h in hogs:
                toks, fin = await asyncio.wait_for(h, 60.0)
                assert len(toks) == 48 and fin == FinishReason.LENGTH.value
        finally:
            await eng.stop()

    asyncio.run(main())


def test_engine_waiting_depth_bound_sheds_batch_first():
    """max_waiting=1 with the slot full: an interactive waiter arrives
    first, a batch one second — the batch one is shed (cheapest first),
    and the per-class shed counter says so."""
    async def main():
        eng = MockerEngine(_cfg(max_num_seqs=1, max_waiting=1),
                           MockerConfig(decode_time_per_step_us=20000.0))
        await eng.start()
        try:
            hog = asyncio.ensure_future(_collect(eng, _req(max_tokens=24)))
            while not eng.scheduler.running:
                await asyncio.sleep(0.005)
            base = OVERLOAD.shed_class_total("batch")
            first = asyncio.ensure_future(_collect(eng, _req(max_tokens=2, cls="interactive")))
            while not eng.scheduler.waiting:
                await asyncio.sleep(0.005)
            second = asyncio.ensure_future(_collect(eng, _req(max_tokens=2, cls="batch")))
            assert await asyncio.wait_for(second, 30.0) == ([], FinishReason.SHED.value)
            assert OVERLOAD.shed_class_total("batch") == base + 1
            out1, fin1 = await asyncio.wait_for(first, 60.0)
            assert len(out1) == 2 and fin1 == FinishReason.LENGTH.value
            await asyncio.wait_for(hog, 60.0)
        finally:
            await eng.stop()

    asyncio.run(main())


def test_engine_mid_generation_deadline_frees_blocks_after_inflight():
    """The real tiny-test engine, dispatches pipelined two deep: a
    deadline that expires mid-generation ends the stream with DEADLINE
    and a strict prefix of the deadline-free stream, and every KV block
    comes back once no dispatch carrying the sequence is in flight."""
    async def main():
        eng = TorchEngine(_cfg(max_num_seqs=2, num_blocks=32), device="cpu")
        await eng.start()
        try:
            full, fin = await _collect(eng, _req(n=12, max_tokens=40))
            assert fin == FinishReason.LENGTH.value
            assert await eng.wait_drained(10.0)
            free0 = eng.allocator.num_free
            slow = eng.runner.unified_step

            def paced(*a, **kw):
                time.sleep(0.01)
                return slow(*a, **kw)

            eng.runner.unified_step = paced
            out, fin = await _collect(eng, _req(n=12, max_tokens=40,
                                                deadline=Deadline.after(0.15)))
            assert await eng.wait_drained(10.0)
            return full, out, fin, free0, eng.allocator.num_free, eng.scheduler.running
        finally:
            await eng.stop()

    full, out, fin, free0, free1, running = asyncio.run(main())
    assert fin == FinishReason.DEADLINE.value
    assert 0 < len(out) < len(full) and out == full[: len(out)]
    # Block 0 is the trash block: every other block is free again.
    assert free1 == free0 == 32 - 1 and not running


def test_engine_trace_spans_and_first_token_marks():
    """Every served request leaves the engine's span chain in the
    tracer: queue_wait, prefill, decode_first and decode, one each, and
    one ITL observation per token after the first."""
    from dynamo_tpu_torch.utils.tracing import reset_tracer

    async def main():
        tr = reset_tracer(None)
        eng = MockerEngine(_cfg(), MockerConfig())
        await eng.start()
        try:
            res = await asyncio.gather(*[_collect(eng, _req(max_tokens=5)) for _ in range(3)])
        finally:
            await eng.stop()
        return tr, res

    try:
        tr, res = asyncio.run(main())
        summ = tr.summary()
        for name in ("queue_wait", "prefill", "decode_first", "decode"):
            assert summ[name]["count"] == 3, name
        assert summ["itl"]["count"] == 3 * 4
        assert tr.active_count == 0
        assert all(len(r[0]) == 5 for r in res)
    finally:
        reset_tracer(None)


# ---------------------------------------------------------------------------
# HTTP boundary and preprocessor
# ---------------------------------------------------------------------------


class _SlowEcho:
    """Engine stub: records the deadline and class it was handed."""

    def __init__(self):
        self.seen: list = []

    async def generate(self, ctx):
        from dynamo_tpu_torch.llm.protocols.openai import (
            ChatCompletionChunk,
            ChatDelta,
            StreamChoice,
        )

        self.seen.append((ctx.annotations.get("deadline"),
                          ctx.annotations.get(slo.ANNOTATION_KEY)))
        yield ChatCompletionChunk(id="c0", model="m", choices=[StreamChoice(
            delta=ChatDelta(role="assistant", content="ok"), finish_reason="stop")])


BODY = {"model": "m", "messages": [{"role": "user", "content": "x"}], "stream": False}


def test_http_deadline_header_reaches_engine_and_expired_maps_504():
    from dynamo_tpu_torch.llm.discovery import ModelManager
    from dynamo_tpu_torch.llm.http_client import fetch
    from dynamo_tpu_torch.llm.http_service import HttpService

    class Expired:
        async def generate(self, ctx):
            raise DeadlineError("expired in queue")
            yield  # pragma: no cover

    class Shedding:
        async def generate(self, ctx):
            raise ShedError("bounded queue full", retry_after_s=3.0)
            yield  # pragma: no cover

    async def main():
        engine = _SlowEcho()
        manager = ModelManager()
        for name, eng in (("m", engine), ("dead", Expired()), ("shed", Shedding())):
            manager.add_model(name, eng)
        service = HttpService(
            manager, host="127.0.0.1", port=0,
            admission=t_adm.AdmissionController(t_adm.AdmissionConfig(
                default_deadline_s=7.0, default_request_class="batch")),
        )
        await service.start()
        port = service.port
        try:
            r1 = await fetch("127.0.0.1", port, "POST", "/v1/chat/completions", BODY,
                             {"X-Request-Timeout-Ms": "2000",
                              "X-Request-Class": "interactive"})
            d1, c1 = engine.seen[-1]
            r2 = await fetch("127.0.0.1", port, "POST", "/v1/chat/completions", BODY)
            d2, c2 = engine.seen[-1]
            r3 = await fetch("127.0.0.1", port, "POST", "/v1/chat/completions",
                             {**BODY, "model": "dead"})
            r4 = await fetch("127.0.0.1", port, "POST", "/v1/chat/completions",
                             {**BODY, "model": "shed"})
            metrics = (await fetch("127.0.0.1", port, "GET", "/metrics")).body.decode()
        finally:
            await service.stop()
        return r1, d1, c1, r2, d2, c2, r3, r4, metrics

    r1, d1, c1, r2, d2, c2, r3, r4, metrics = asyncio.run(main())
    assert r1.status == 200 and 0 < d1.remaining_s() <= 2.0 and c1 == "interactive"
    assert r2.status == 200 and 2.0 < d2.remaining_s() <= 7.0 and c2 == "batch"
    assert r3.status == 504 and r3.json()["error"]["type"] == "deadline_exceeded"
    assert r4.status == 429 and r4.headers.get("retry-after") == "3"
    for name in ("deadline_exceeded_total", "shed_interactive_total", "shed_batch_total",
                 "admission_admitted_batch_total", "admission_admitted_interactive_total"):
        assert f"dyntpu_http_service_{name} " in metrics, name


def test_http_one_ms_deadline_behind_a_full_prefill_set_is_504():
    """The tiny-test engine on the CPU, through the CLI's own server
    path: while prompts fill the prefilling set, a request with
    ``X-Request-Timeout-Ms: 1`` expires in the waiting list, is never
    run, and answers 504; deadline_exceeded_total grows by one."""
    from dynamo_tpu_torch import cli
    from dynamo_tpu_torch.llm.http_client import fetch

    async def main():
        import contextlib

        args = cli.build_parser().parse_args([
            "run", "--device", "cpu", "--model-path", "preset:tiny-test",
            "--http-host", "127.0.0.1", "--http-port", "0", "--max-model-len", "256",
            "--num-blocks", "96", "--max-num-seqs", "4", "--prefill-batch", "1",
            "--no-warmup", "--unified-prefill-quantum", "16"])
        cli.refuse_unserved(args)
        async with contextlib.AsyncExitStack() as stack:
            service, engine = await cli.start_http(args, stack)
            port = service.port
            body = {"model": "tiny-test", "prompt": list(range(1, 200)),
                    "max_tokens": 2, "nvext": {"ignore_eos": True}}
            long_req = asyncio.ensure_future(
                fetch("127.0.0.1", port, "POST", "/v1/completions", body))
            while not engine._prefilling:
                await asyncio.sleep(0.002)
            base = OVERLOAD.deadline_total
            quick = await fetch("127.0.0.1", port, "POST", "/v1/completions",
                                {**body, "prompt": [1, 2, 3]},
                                {"X-Request-Timeout-Ms": "1"})
            grown = OVERLOAD.deadline_total - base
            first = await long_req
        return quick, grown, first

    quick, grown, first = asyncio.run(main())
    assert quick.status == 504 and quick.json()["error"]["type"] == "deadline_exceeded"
    assert grown == 1
    assert first.status == 200


def test_preprocessor_maps_shed_finish_to_typed_error():
    from dynamo_tpu_torch.llm.model_card import ModelDeploymentCard
    from dynamo_tpu_torch.llm.preprocessor import OpenAIPreprocessor
    from dynamo_tpu_torch.llm.protocols.common import EngineOutput
    from dynamo_tpu_torch.llm.protocols.openai import ChatCompletionRequest
    from dynamo_tpu_torch.llm.tokenizer import load_tokenizer

    card = ModelDeploymentCard(name="m", model_path="toy")
    pre = OpenAIPreprocessor(card, load_tokenizer("toy"))
    oai = ChatCompletionRequest.model_validate(
        {"model": "m", "messages": [{"role": "user", "content": "hi"}]})

    class Finishing:
        def __init__(self, reason):
            self.reason = reason
            self.wire = None

        async def generate(self, ctx):
            self.wire = ctx.payload
            yield EngineOutput(finish_reason=self.reason).to_wire()

    async def run(reason, exc):
        eng = Finishing(reason)
        ctx = Context(oai)
        ctx.annotations["deadline"] = Deadline.after(5.0)
        ctx.annotations[slo.ANNOTATION_KEY] = "batch"
        with pytest.raises(exc):
            async for _ in pre.generate(ctx, eng):
                pass
        return eng.wire

    wire = asyncio.run(run(FinishReason.SHED, ShedError))
    asyncio.run(run(FinishReason.DEADLINE, DeadlineError))
    # The deadline, the class and the trace context ride the wire.
    assert 0 < wire["deadline_ms"] <= 5000
    assert wire["annotations"][slo.ANNOTATION_KEY] == "batch"
    assert wire["trace"]["parent_span"] == "tokenize" and wire["trace"]["trace_id"]
    j = j_proto.PreprocessedRequest.from_wire(wire)
    assert j.trace.trace_id == wire["trace"]["trace_id"]
