"""The port's observability plane against the JAX package's, case for
case with tests/test_trace.py: the tracer (wire context, adopt, TTL sweep, histograms), log
correlation, the flight recorder and the engine's fault dump, the debug
endpoints, the profile window's refusals and the control-plane profile
verb, the trace merge, and the disaggregated path's kv_transfer span,
remote_prefill and degraded_local marks.

Captures cross packages: a capture the port writes is read by the
reference's ``benchmarks/trace_merge.py`` and by the port's
``tools/trace_merge.py``, which must report the same decomposition and
pass ``--assert-complete`` (no orphan, full span chains)."""

import asyncio
import json
import logging

import numpy as np
import pytest

from benchmarks import trace_merge as j_merge
from dynamo_tpu.engine.flight_recorder import FlightRecorder as JFlightRecorder
from dynamo_tpu.llm.protocols import common as j_proto
from dynamo_tpu.utils import tracing as j_tracing
from dynamo_tpu.utils.recorder import Recorder as JRecorder
from dynamo_tpu_torch.engine.config import EngineConfig
from dynamo_tpu_torch.engine.flight_recorder import FlightRecorder
from dynamo_tpu_torch.llm.protocols.common import (
    PreprocessedRequest,
    SamplingOptions,
    StopConditions,
)
from dynamo_tpu_torch.mocker import MockerConfig, MockerEngine
from dynamo_tpu_torch.models.config import ModelConfig
from dynamo_tpu_torch.runtime.engine import Context
from dynamo_tpu_torch.tools import trace_merge as t_merge
from dynamo_tpu_torch.utils import tracing as t_tracing
from dynamo_tpu_torch.utils.deadline import Deadline
from dynamo_tpu_torch.utils.recorder import Recorder
from dynamo_tpu_torch.utils.tracing import Tracer, reset_tracer, tracer

BOTH = pytest.mark.parametrize("mod", [j_tracing, t_tracing], ids=["jax", "port"])


@pytest.fixture
def fresh_tracer():
    yield reset_tracer(None)
    reset_tracer(None)


# ---------------------------------------------------------------------------
# tracer units
# ---------------------------------------------------------------------------


def test_bucket_ladder_matches_llm_metrics():
    from dynamo_tpu_torch.llm.metrics import _BUCKETS

    assert t_tracing.BUCKETS_MS == tuple(1000.0 * b for b in _BUCKETS)
    assert t_tracing.BUCKETS_MS == j_tracing.BUCKETS_MS
    assert t_tracing.SPAN_NAMES == j_tracing.SPAN_NAMES
    assert t_tracing.INTERVALS == j_tracing.INTERVALS


def test_trace_context_rides_the_preprocessed_request_wire():
    tr = Tracer()
    pre = PreprocessedRequest(token_ids=[1, 2, 3])
    pre.trace = tr.context("req-1", parent_span="tokenize")
    wire = pre.to_wire()
    assert wire["trace"]["trace_id"] == tr.trace_id("req-1")
    assert wire["trace"]["parent_span"] == "tokenize"
    assert wire["trace"]["sent_unix"] > 1e9
    assert PreprocessedRequest.from_wire(wire).trace.trace_id == tr.trace_id("req-1")
    # The JAX package reads the port's context, and back.
    j = j_proto.PreprocessedRequest.from_wire(wire)
    assert j.trace.trace_id == tr.trace_id("req-1")
    assert PreprocessedRequest.from_wire(j.to_wire()).trace.parent_span == "tokenize"
    wire.pop("trace")
    assert PreprocessedRequest.from_wire(wire).trace is None


@BOTH
def test_adopt_binds_remote_trace_id_and_offset_hint(mod):
    tr = mod.Tracer()
    tr.adopt("req-9", mod.TraceContext("remote-trace-id", "queue_wait"))
    assert tr.trace_id("req-9") == "remote-trace-id"
    tr.mark("req-9", "engine_queued")
    rec = tr.finish("req-9")
    assert rec.trace_id == "remote-trace-id" and rec.parent_span == "queue_wait"
    assert rec.offset_hint_ms is not None
    tr.adopt("req-10", None)
    assert tr.trace_id("req-10") != "remote-trace-id"


@BOTH
def test_tracer_ttl_sweep_reaps_leaked_traces(mod, tmp_path):
    path = tmp_path / "cap.jsonl"
    tr = mod.Tracer(record_path=str(path), ttl_s=0.0)
    tr.mark("leaked-1", "received")
    tr.mark("leaked-2", "engine_queued")
    assert tr.active_count == 2
    assert tr.sweep(0.0) == 2
    assert (tr.active_count, tr.abandoned_total) == (0, 2)
    tr.mark("leaked-1", "first_token")
    assert tr.sweep(0.0) == 1
    assert tr.abandoned_total == 3
    # Either package's recorder reads either package's capture.
    for rec in (Recorder, JRecorder):
        kinds = [ev["kind"] for _, ev in rec.load(path)]
        assert kinds.count("abandon") == 3
    assert "dyntpu_trace_abandoned_traces_total 3" in tr.render()


@BOTH
def test_touch_keeps_live_streams_out_of_the_sweep(mod):
    tr = mod.Tracer(ttl_s=0.05)
    tr.mark("live", "first_token")
    tr._active["live"].last_touch -= 10.0
    tr.observe_itl(3.0, "live")
    assert tr.sweep() == 0 and tr.active_count == 1 and tr.abandoned_total == 0
    tr._active["live"].last_touch -= 10.0
    assert tr.sweep() == 1
    tr.touch("live")
    tr.touch("never-seen")
    assert tr.active_count == 0


@BOTH
def test_abandon_with_reason_closes_without_stats(mod, tmp_path):
    path = tmp_path / "cap.jsonl"
    tr = mod.Tracer(record_path=str(path))
    tr.mark("r1", "received")
    tr.abandon("r1", reason="requeued")
    assert (tr.active_count, tr.abandoned_total) == (0, 0)
    ab = [e for _, e in Recorder.load(path) if e["kind"] == "abandon"]
    assert ab and ab[0]["reason"] == "requeued"
    assert tr.sweep(0.0) == 0


@BOTH
def test_decode_histogram_counts_each_request_once(mod):
    tr = mod.Tracer()
    tr.mark("r1", "received")
    tr.mark("r1", "first_token")
    tr.span_begin("r1", "decode")
    tr.finish("r1")
    assert tr.summary()["decode"]["count"] == 1
    tr.mark("r2", "first_token")
    tr.finish("r2")
    assert tr.summary()["decode"]["count"] == 2


@BOTH
def test_tracer_opportunistic_sweep_caps_active_dict(mod):
    tr = mod.Tracer(ttl_s=0.0)
    for i in range(600):
        tr.mark(f"r{i}", "received")
    assert tr.active_count < 600 and tr.abandoned_total > 0


@BOTH
def test_mark_if_active_never_reopens(mod):
    tr = mod.Tracer()
    assert tr.mark_if_active("gone", "kv_landed") is False
    assert tr.active_count == 0
    tr.mark("here", "received")
    assert tr.mark_if_active("here", "kv_landed") is True


def test_histograms_and_itl_tail():
    """The same observations (a numpy-seeded ITL stream with one stall)
    give byte-identical Prometheus text and digests in both packages."""
    rng = np.random.default_rng(7)
    samples = list(rng.gamma(2.0, 2.0, 99)) + [5000.0]
    texts, summaries = [], []
    for mod in (j_tracing, t_tracing):
        tr = mod.Tracer()
        for ms in samples:
            tr.observe_itl(float(ms))
        texts.append(tr.render())
        summaries.append(tr.summary())
    assert texts[0] == texts[1]
    assert summaries[0] == summaries[1]
    s = summaries[1]["itl"]
    assert s["count"] == 100 and s["max_ms"] == 5000.0 and s["p50_ms"] <= 5.0
    assert "dyntpu_trace_itl_ms_count 100" in texts[1]


def test_log_records_carry_request_and_trace_ids():
    from dynamo_tpu.utils import logging as j_logging
    from dynamo_tpu_torch.utils import logging as t_logging

    lines = []
    for mod in (j_logging, t_logging):
        logger = logging.getLogger(f"test.trace.corr.{mod.__name__}")
        records = []
        handler = logging.Handler()
        handler.emit = records.append
        handler.addFilter(mod._ScopeFilter())
        logger.addHandler(handler)
        logger.setLevel(logging.INFO)
        # Kept off the root logger: a root handler installed by an
        # earlier test (init_logging) would stamp the shared record again
        # with its own package's scope.
        logger.propagate = False
        try:
            with mod.request_scope("req-42", "trace-abc"):
                logger.info("inside scope")
            logger.info("outside scope")
        finally:
            logger.removeHandler(handler)
        inside, outside = records
        assert inside.request_id == "req-42" and inside.trace_id == "trace-abc"
        assert inside.scope_suffix == " [rid=req-42 trace=trace-abc]"
        assert outside.request_id == "" and outside.scope_suffix == ""
        line = json.loads(mod.JsonlFormatter().format(inside))
        assert line["request_id"] == "req-42" and line["trace_id"] == "trace-abc"
        assert "trace_id" not in json.loads(mod.JsonlFormatter().format(outside))
        lines.append({k: v for k, v in line.items() if k not in ("ts", "target")})
    assert lines[0] == lines[1]


def test_port_log_filter_keeps_the_jax_packages_stamp():
    """A process hosting both packages (a worker of a mixed test run, a
    tool importing both): a record stamped by the JAX package's scope
    filter and then passed through a handler with the port's filter (its
    runtime installs one on the root logger) keeps the JAX stamp — the
    port's unscoped filter adds empty stamps only where none exist."""
    from dynamo_tpu.utils import logging as j_logging
    from dynamo_tpu_torch.utils import logging as t_logging

    parent = logging.getLogger("test.trace.mixed")
    child = logging.getLogger("test.trace.mixed.jax")
    seen: list = []
    port_handler = logging.Handler()
    port_handler.emit = lambda r: seen.append(("port", r.request_id, r.trace_id))
    port_handler.addFilter(t_logging._ScopeFilter())
    jax_handler = logging.Handler()
    jax_handler.emit = lambda r: seen.append(("jax", r.request_id, r.trace_id))
    jax_handler.addFilter(j_logging._ScopeFilter())
    parent.addHandler(port_handler)
    child.addHandler(jax_handler)
    child.setLevel(logging.INFO)
    try:
        with j_logging.request_scope("req-42", "trace-abc"):
            child.info("inside the JAX scope")
        child.info("unscoped")
    finally:
        parent.removeHandler(port_handler)
        child.removeHandler(jax_handler)
    assert seen == [("jax", "req-42", "trace-abc"), ("port", "req-42", "trace-abc"),
                    ("jax", "", ""), ("port", "", "")]


# ---------------------------------------------------------------------------
# flight recorder
# ---------------------------------------------------------------------------


def test_flight_recorder_ring_and_fault_dump(tmp_path):
    rings = []
    for cls in (JFlightRecorder, FlightRecorder):
        fr = cls(capacity=8, dump_dir=str(tmp_path / cls.__module__))
        for i in range(20):
            fr.note_step("unified", decode_tokens=i, batch_fill_ratio=0.5,
                         dispatch_ms=1.0, quantum=64 + i, itl_ema_ms=2.5)
        records = fr.snapshot()
        assert len(records) == 8 and records[-1]["decode_tokens"] == 19
        assert fr.snapshot(3)[0]["decode_tokens"] == 17
        assert fr.snapshot(0) == []
        assert fr.total_steps == 20
        path = fr.dump_fault("RuntimeError: boom")
        doc = json.loads(open(path).read())
        assert doc["reason"] == "RuntimeError: boom"
        assert doc["records"][-1]["kind"] == "fault"
        assert cls(dump_dir=None).dump_fault("x") is None
        rings.append([{k: v for k, v in r.items() if k != "t_unix"} for r in records])
    # Same fields, same values, same order.
    assert rings[0] == rings[1]


def _tiny_cfg(**kw):
    base = dict(model=ModelConfig.tiny_test(), num_blocks=32, max_num_seqs=2,
                max_model_len=128, dtype="float32")
    base.update(kw)
    return EngineConfig(**base)


def _req(prompt, max_tokens):
    return PreprocessedRequest(
        token_ids=list(prompt), sampling=SamplingOptions(temperature=0.0),
        stop=StopConditions(max_tokens=max_tokens, ignore_eos=True),
    )


def test_engine_fault_dumps_flight_record(tmp_path, fresh_tracer):
    """An engine-loop fault flushes the step ring to disk before the
    engine dies; the queued stream ends with an ERROR finish (no hang)
    and its trace carries the error mark."""
    async def main():
        engine = MockerEngine(_tiny_cfg(flight_record_dir=str(tmp_path)),
                              MockerConfig(vocab_size=100))
        await engine.start()
        await _collect(engine, _req([1, 2, 3], 3))  # some steps in the ring
        # The next dispatch faults (only our request makes one).
        engine._issue_unified = lambda: (_ := None).missing
        ctx = Context(_req([1, 2, 3], 2).to_wire())
        outs = [o async for o in engine.generate(ctx)]
        for _ in range(200):
            if engine.flight.dumped_path:
                break
            await asyncio.sleep(0.01)
        await engine.stop()
        return outs, ctx, engine.flight.dumped_path

    outs, ctx, path = asyncio.run(main())
    assert outs and outs[-1]["finish_reason"] == "error"
    done = [t for t in fresh_tracer._done if t.id == ctx.id]
    assert done and "error" in done[-1].marks
    doc = json.loads(open(path).read())
    assert "AttributeError" in doc["reason"]
    kinds = [r["kind"] for r in doc["records"]]
    assert kinds[-1] == "fault" and "unified" in kinds


async def _collect(engine, pre):
    return [o async for o in engine.generate(Context(pre.to_wire()))]


def test_engine_records_one_flight_step_per_dispatch():
    async def main():
        engine = MockerEngine(_tiny_cfg(coloc="adaptive", itl_slo_ms=50.0),
                              MockerConfig(vocab_size=100))
        await engine.start()
        await asyncio.gather(*[_collect(engine, _req(range(1, 20 + i), 6))
                               for i in range(3)])
        await engine.stop()
        return engine

    engine = asyncio.run(main())
    steps = engine.debug_steps(None)
    assert engine.flight.total_steps == engine.unified_dispatches == len(steps)
    assert sum(r["decode_tokens"] for r in steps) == engine.unified_decode_tokens
    assert sum(r["prefill_tokens"] for r in steps) == engine.unified_prefill_tokens
    assert all(0 < r["batch_fill_ratio"] <= 1 and r["quantum"] >= 16 for r in steps)


# ---------------------------------------------------------------------------
# debug endpoints + profiler
# ---------------------------------------------------------------------------


class _StubDebug:
    def debug_steps(self, n=None):
        return [
            {"seq": 1, "kind": "unified", "batch_fill_ratio": 0.75},
            {"seq": 2, "kind": "spec", "batch_fill_ratio": 0.5},
        ][-(n or 2):]


def _stub_profiler(monkeypatch, started):
    from dynamo_tpu_torch.utils.profiling import Profiler

    monkeypatch.setattr(Profiler, "_start", lambda self, out: started.append(out) or True)
    monkeypatch.setattr(Profiler, "_stop", lambda self: {"trace": "t.json"})
    return Profiler


def test_debug_endpoints(tmp_path, monkeypatch):
    from dynamo_tpu_torch.llm.discovery import ModelManager
    from dynamo_tpu_torch.llm.http_client import fetch
    from dynamo_tpu_torch.llm.http_service import HealthServer, HttpService

    started = []
    Profiler = _stub_profiler(monkeypatch, started)

    async def main():
        out = []
        for service in (
            HttpService(ModelManager(), host="127.0.0.1", port=0,
                        debug=_StubDebug(), profiler=Profiler(base_dir=str(tmp_path))),
            HealthServer(lambda: {"state": "ready"}, host="127.0.0.1", port=0,
                         debug=_StubDebug(), profiler=Profiler(base_dir=str(tmp_path))),
        ):
            await service.start()
            port = service.port
            try:
                steps = await fetch("127.0.0.1", port, "GET", "/debug/steps?n=1")
                trace = await fetch("127.0.0.1", port, "GET", "/debug/trace")
                prof = await fetch("127.0.0.1", port, "GET", "/debug/profile?seconds=0.1")
                bad = await fetch("127.0.0.1", port, "GET", "/debug/steps?n=zebra")
                routes = await fetch("127.0.0.1", port, "GET", "/debug/routes")
            finally:
                await service.stop()
            out.append((steps, trace, prof, bad, routes))
        return out

    for steps, trace, prof, bad, routes in asyncio.run(main()):
        assert steps.status == 200 and steps.json()["steps"][-1]["kind"] == "spec"
        assert "batch_fill_ratio" in steps.json()["steps"][-1]
        snap = trace.json()
        assert trace.status == 200 and {"histograms", "abandoned_traces_total"} <= set(snap)
        assert prof.status == 200 and prof.json()["path"].startswith(str(tmp_path))
        assert prof.json()["trace"] == "t.json"
        assert bad.status == 400
        # /debug/routes is served on both surfaces (refused until the KV
        # router slice): the JAX package's snapshot layout.
        from dynamo_tpu.llm.kv_router.audit import ROUTE_OBS as J_OBS

        assert routes.status == 200
        assert set(routes.json()) == set(J_OBS.snapshot(0))
        assert "kv_router_routes_total" in routes.json()["gauges"]
    assert len(started) == 2


def test_profile_endpoint_refuses_unconfigured_and_overlap(tmp_path):
    from dynamo_tpu_torch.llm.discovery import ModelManager
    from dynamo_tpu_torch.llm.http_client import fetch
    from dynamo_tpu_torch.llm.http_service import HttpService
    from dynamo_tpu_torch.utils.profiling import ProfileError, Profiler

    async def status(profiler):
        service = HttpService(ModelManager(), host="127.0.0.1", port=0, profiler=profiler)
        await service.start()
        try:
            resp = await fetch("127.0.0.1", service.port, "GET",
                               "/debug/profile?seconds=0.1")
        finally:
            await service.stop()
        return resp.status, resp.json()["error"]["type"]

    # Unconfigured: disabled. Configured, in a process without a CUDA
    # device: refused too — the window traces the card or nothing.
    assert asyncio.run(status(Profiler(base_dir=None))) == (503, "profile_error")
    assert asyncio.run(status(Profiler(base_dir=str(tmp_path)))) == (503, "profile_error")
    busy = Profiler(base_dir=str(tmp_path))
    busy._busy = True
    assert asyncio.run(status(busy)) == (409, "profile_error")
    with pytest.raises(ProfileError) as exc:
        asyncio.run(busy.capture(1.0))
    assert exc.value.busy


def test_control_plane_profile_verb(tmp_path, monkeypatch):
    from dynamo_tpu_torch.runtime.debug import request_profile, watch_profile
    from dynamo_tpu_torch.runtime.distributed import DistributedRuntime

    Profiler = _stub_profiler(monkeypatch, [])

    async def main():
        drt = await DistributedRuntime.in_process()
        prof = Profiler(base_dir=str(tmp_path), max_seconds=0.2)
        watch = await watch_profile(drt, "ns", "torch", prof)
        await request_profile(drt, "ns", "torch", seconds=0.05)
        for _ in range(200):
            if prof.captures:
                break
            await asyncio.sleep(0.01)
        first = prof.captures
        await request_profile(drt, "ns", "torch", seconds=0.05, lease_id=0xDEAD)
        await drt.bus.broadcast("ns.torch._profile", b"\xc1")  # malformed
        await asyncio.sleep(0.1)
        await request_profile(drt, "ns", "torch", seconds=0.05,
                              lease_id=drt.primary_lease_id)
        for _ in range(200):
            if prof.captures == 2:
                break
            await asyncio.sleep(0.01)
        watch.close()
        await drt.shutdown()
        return first, prof.captures, watch.fired

    assert asyncio.run(main()) == (1, 2, 2)


# ---------------------------------------------------------------------------
# trace_merge: the port's copy against the reference's
# ---------------------------------------------------------------------------


def _write_capture(path, events):
    with Recorder(path) as rec:
        for ev in events:
            rec.record(ev)


def _both_reports(paths, **kw):
    reports = [m.merge_report(m.load_captures(paths), **kw) for m in (j_merge, t_merge)]
    assert reports[0] == reports[1]
    return reports[1]


def test_trace_merge_joins_processes_and_flags_orphans(tmp_path):
    t0 = 1_000_000.0

    def span(tid, name, start, dur, pid):
        return {"kind": "span", "id": "r1", "trace": tid, "span": name,
                "start_unix": t0 + start, "dur_ms": dur, "pid": pid}

    a, b = tmp_path / "a.jsonl", tmp_path / "b.jsonl"
    _write_capture(a, [
        span("T1", "admission", 0.000, 1.0, 1),
        span("T1", "tokenize", 0.001, 1.0, 1),
        span("T1", "route", 0.002, 1.0, 1),
        span("T1", "failover", 0.040, 3.0, 1),
        {"kind": "failover", "id": "r1", "trace": "T1", "reason": "WorkerDiedError"},
        {"kind": "finish", "id": "r1", "trace": "T1", "pid": 1,
         "marks": {"received": t0, "first_token": t0 + 0.032, "finished": t0 + 0.082},
         "spans": []},
    ])
    _write_capture(b, [
        span("T1", "queue_wait", 0.003, 4.0, 2),
        span("T1", "prefill", 0.007, 20.0, 2),
        span("T1", "decode_first", 0.027, 5.0, 2),
        span("T1", "decode", 0.032, 50.0, 2),
        {"kind": "finish", "id": "r1", "trace": "T1", "pid": 2, "marks": {}, "spans": []},
        span("ORPHAN", "prefill", 0.0, 5.0, 2),
    ])
    traces = t_merge.load_captures([str(a), str(b)])
    assert set(traces) == {"T1", "ORPHAN"}
    t1 = traces["T1"]
    assert t1.completed and t1.failed_over and not t1.missing_spans()
    assert t1.max_gap_ms() < 1.0
    report = _both_reports([str(a), str(b)])
    dec = report["ttft_decomposition_ms"]
    for name in ("admission", "queue_wait", "prefill", "decode_first"):
        assert dec[name]["count"] == 1, name
    assert report["ttft_ms"]["p50_ms"] == 32.0
    failures = t_merge.assert_complete(report)
    assert failures and "orphan" in failures[0]
    del traces["ORPHAN"]
    assert t_merge.assert_complete(t_merge.merge_report(traces)) == []


def test_trace_merge_cli_exit_codes(tmp_path, capsys):
    t0 = 3_000_000.0
    good = tmp_path / "good.jsonl"
    _write_capture(good, [
        {"kind": "span", "id": "r", "trace": "T", "span": n,
         "start_unix": t0 + i * 0.001, "dur_ms": 1.0, "pid": 1}
        for i, n in enumerate(("queue_wait", "prefill", "decode_first", "decode"))
    ] + [{"kind": "finish", "id": "r", "trace": "T", "pid": 1,
          "marks": {"engine_queued": t0, "first_token": t0 + 0.003,
                    "finished": t0 + 0.005}, "spans": []}])
    bad = tmp_path / "bad.jsonl"
    _write_capture(bad, [{"kind": "span", "id": "o", "trace": "ORPH", "span": "prefill",
                          "start_unix": t0, "dur_ms": 1.0, "pid": 1}])
    for main in (j_merge.main, t_merge.main):
        assert main([str(good), "--assert-complete"]) == 0
        assert json.loads(capsys.readouterr().out)["completed_requests"] == 1
        assert main([str(good), str(bad), "--assert-complete"]) == 1
        assert main([str(tmp_path / "missing.jsonl")]) == 2
        capsys.readouterr()


def test_trace_merge_flags_gaps(tmp_path):
    """The gap half of the reference's kv_transfer case (its kv_transfer
    half is test_trace_merge_flags_missing_kv_transfer): a 900 ms hole
    before prefill is reported incomplete by both merges."""
    t0 = 2_000_000.0
    cap = tmp_path / "c.jsonl"
    _write_capture(cap, [
        {"kind": "span", "id": "r2", "trace": "T2", "span": "queue_wait",
         "start_unix": t0, "dur_ms": 1.0, "pid": 1},
        {"kind": "span", "id": "r2", "trace": "T2", "span": "prefill",
         "start_unix": t0 + 0.901, "dur_ms": 5.0, "pid": 1},
        {"kind": "span", "id": "r2", "trace": "T2", "span": "decode_first",
         "start_unix": t0 + 0.906, "dur_ms": 1.0, "pid": 1},
        {"kind": "span", "id": "r2", "trace": "T2", "span": "decode",
         "start_unix": t0 + 0.907, "dur_ms": 1.0, "pid": 1},
        {"kind": "finish", "id": "r2", "trace": "T2", "pid": 1,
         "marks": {"engine_queued": t0, "first_token": t0 + 0.907,
                   "finished": t0 + 0.91}, "spans": []},
    ])
    report = _both_reports([str(cap)], max_gap_ms=250.0)
    assert len(report["incomplete"]) == 1
    assert report["incomplete"][0]["missing_spans"] == []
    assert report["incomplete"][0]["max_gap_ms"] > 800


def test_port_capture_passes_both_trace_merges(tmp_path):
    """A capture written by the port's OpenAI server (tiny-test engine on
    the CPU, through the CLI's own path; requests with deadlines and both
    classes, streamed and aggregated, one refused at admission) passes
    the reference's ``benchmarks/trace_merge.py --assert-complete`` and
    the port's, and both report the same decomposition."""
    import contextlib

    from dynamo_tpu_torch import cli
    from dynamo_tpu_torch.llm.http_client import fetch

    capture = tmp_path / "trace.jsonl"

    async def main():
        reset_tracer(str(capture))
        args = cli.build_parser().parse_args([
            "run", "--device", "cpu", "--model-path", "preset:tiny-test",
            "--http-host", "127.0.0.1", "--http-port", "0", "--max-model-len", "64",
            "--num-blocks", "32", "--max-num-seqs", "4", "--no-warmup",
            "--coloc", "adaptive", "--itl-slo-ms", "1000", "--default-deadline-s", "60",
            "--max-inflight", "4", "--batch-watermark-scale", "0.0"])
        cli.refuse_unserved(args)
        async with contextlib.AsyncExitStack() as stack:
            service, _ = await cli.start_http(args, stack)
            port = service.port
            body = {"model": "tiny-test", "max_tokens": 4, "nvext": {"ignore_eos": True}}
            resps = await asyncio.gather(*[
                fetch("127.0.0.1", port, "POST", "/v1/chat/completions",
                      {**body, "stream": i % 2 == 0,
                       "messages": [{"role": "user", "content": f"hello {i}"}]},
                      {"X-Request-Timeout-Ms": "30000"})
                for i in range(3)])
            refused = await fetch("127.0.0.1", port, "POST", "/v1/completions",
                                  {**body, "prompt": [1, 2]}, {"X-Request-Class": "batch"})
            trace = (await fetch("127.0.0.1", port, "GET", "/debug/trace?n=8")).json()
        reset_tracer(None)
        return [r.status for r in resps], refused.status, trace

    statuses, refused, trace = asyncio.run(main())
    assert statuses == [200, 200, 200] and refused == 429
    assert len(trace["recent"]) >= 3
    reports = []
    for merge in (j_merge, t_merge):
        report = merge.merge_report(merge.load_captures([str(capture)]))
        assert merge.assert_complete(report) == [], report
        assert merge.main([str(capture), "--assert-complete"]) == 0
        reports.append(report)
    assert reports[0] == reports[1]
    report = reports[1]
    assert report["completed_requests"] == 3 and report["abandoned_traces"] == 1
    for name in ("admission", "tokenize", "queue_wait", "prefill", "decode_first"):
        assert report["ttft_decomposition_ms"][name]["count"] == 3, name


def test_trace_ids_survive_bus_envelope_without_preprocessor(fresh_tracer):
    from dynamo_tpu_torch.runtime.distributed import DistributedRuntime
    from dynamo_tpu_torch.runtime.egress import PushRouter

    seen = {}

    class Echo:
        async def generate(self, request):
            seen["worker_trace"] = tracer().trace_id(request.id)
            yield {"ok": True}

    async def main():
        drt = await DistributedRuntime.in_process()
        ep = drt.namespace("tr").component("echo").endpoint("generate")
        await ep.serve(Echo())
        router = await PushRouter.create(drt, "tr.echo.generate")
        ctx = Context({"payload": 1})
        frontend_trace = tracer().trace_id(ctx.id)
        out = [item async for item in router.generate(ctx)]
        tracer().finish(ctx.id)
        # In one process the worker's ingress finished the shared trace:
        # the route span is in the completed capture.
        route = any(n == "route" for t in fresh_tracer._done if t.id == ctx.id
                    for n, _, _ in t.spans)
        await drt.shutdown()
        return out, frontend_trace, route

    out, frontend_trace, route = asyncio.run(main())
    assert out == [{"ok": True}]
    assert seen["worker_trace"] == frontend_trace
    assert route


MOCK_KW = dict(num_blocks=64, max_num_seqs=4, max_model_len=128, dtype="float32")


def test_failover_span_and_record_join_one_timeline(tmp_path):
    """A mid-stream kill between two mocker workers: the replay keeps the
    original trace id, the capture holds the failover span and the
    ``kind="failover"`` record, and both merges see one completed,
    failed-over request with the engine's full span chain."""
    from dynamo_tpu_torch.llm.protocols import common as t_common
    from dynamo_tpu_torch.runtime.distributed import DistributedRuntime
    from dynamo_tpu_torch.runtime.egress import PushRouter
    from dynamo_tpu_torch.runtime.failover import FailoverEngine

    capture = tmp_path / "fo.jsonl"

    async def main():
        tr = reset_tracer(str(capture))
        drt = await DistributedRuntime.in_process()
        handles = []
        for i in range(2):
            eng = MockerEngine(EngineConfig(model=ModelConfig.tiny_test(), **MOCK_KW),
                               MockerConfig(vocab_size=100, seed=i, deterministic_tokens=True,
                                            decode_time_per_step_us=8000.0))
            await eng.start()
            sub = drt if i == 0 else await DistributedRuntime.in_process(
                store=drt.store, bus=drt.bus, runtime=drt.runtime)
            inst = await sub.namespace("fo").component("w").endpoint("gen").serve(eng)
            handles.append((inst, eng))
        push = await PushRouter.create(drt, "fo.w.gen", connect_timeout_s=2.0)
        wire = t_common.PreprocessedRequest(
            token_ids=[5, 6, 7, 8], sampling=t_common.SamplingOptions(temperature=0.0),
            stop=t_common.StopConditions(max_tokens=20, ignore_eos=True),
            deadline=Deadline.after(60.0)).to_wire()
        ctx = Context(wire)
        trace_id = tr.trace_id(ctx.id)
        tr.mark(ctx.id, "received")
        got, killed = [], None
        async for item in FailoverEngine(push).generate(ctx):
            got += item.get("token_ids", [])
            if len(got) >= 5 and killed is None:
                killed = ctx.annotations["worker_id"]
                victim = next(h for h in handles if h[0].instance.instance_id == killed)
                await victim[0].kill()
        tr.finish(ctx.id)
        for inst, eng in handles:
            try:
                await inst.stop()
            except Exception:  # noqa: BLE001 — the victim is already dead
                pass
            await eng.stop()
        await drt.shutdown()
        reset_tracer(None)
        return got, trace_id

    got, trace_id = asyncio.run(main())
    assert len(got) == 20
    records = [ev for _, ev in Recorder.load(capture)]
    fo = [r for r in records if r["kind"] == "failover"]
    assert len(fo) == 1 and fo[0]["reason"] == "WorkerDiedError" and fo[0]["attempt"] == 1
    assert fo[0]["trace"] == trace_id and fo[0]["new_worker"] != fo[0]["old_worker"]
    spans = {r["span"] for r in records if r["kind"] == "span" and r["trace"] == trace_id}
    assert {"route", "failover", "queue_wait", "prefill", "decode_first"} <= spans
    for merge in (j_merge, t_merge):
        traces = merge.load_captures([str(capture)])
        assert traces[trace_id].failed_over and traces[trace_id].completed
        assert not [t for t in traces.values() if t.orphan]


# ---------------------------------------------------------------------------
# disaggregation: the kv_transfer span, the remote_prefill and
# degraded_local marks
# ---------------------------------------------------------------------------


def test_trace_merge_flags_missing_kv_transfer(tmp_path):
    """The kv_transfer half of the reference's case: a remote request
    (``remote_prefill`` mark) without a ``kv_transfer`` span is incomplete
    in both merges; marked ``degraded_local`` it completes without one."""
    t0 = 2_000_000.0
    spans = [
        {"kind": "span", "id": "r2", "trace": "T2", "span": name,
         "start_unix": t0 + start, "dur_ms": dur, "pid": 1}
        for name, start, dur in (("queue_wait", 0.0, 1.0), ("prefill", 0.001, 5.0),
                                 ("decode_first", 0.006, 1.0), ("decode", 0.007, 1.0))
    ]
    marks = {"received": t0, "remote_prefill": t0, "first_token": t0 + 0.007,
             "finished": t0 + 0.01}
    cap = tmp_path / "c.jsonl"
    _write_capture(cap, spans + [
        {"kind": "finish", "id": "r2", "trace": "T2", "pid": 1, "marks": marks,
         "spans": []}])
    report = _both_reports([str(cap)], max_gap_ms=250.0)
    assert len(report["incomplete"]) == 1
    assert "kv_transfer" in report["incomplete"][0]["missing_spans"]

    cap2 = tmp_path / "d.jsonl"
    _write_capture(cap2, spans + [
        {"kind": "span", "id": "r2", "trace": "T2", "span": "admission",
         "start_unix": t0, "dur_ms": 0.5, "pid": 1},
        {"kind": "finish", "id": "r2", "trace": "T2", "pid": 1,
         "marks": {**marks, "degraded_local": t0 + 0.002}, "spans": []}])
    assert _both_reports([str(cap2)], max_gap_ms=250.0)["incomplete"] == []


def _disagg_mockers(trace_path, transport="tcp"):
    """A decode and a prefill mocker, every prefill forced remote."""
    from dynamo_tpu_torch.disagg import (
        DecodeOperator,
        DisaggConfig,
        DisaggRouter,
        PrefillQueue,
        PrefillWorker,
    )
    from dynamo_tpu_torch.runtime.distributed import DistributedRuntime

    async def start():
        reset_tracer(str(trace_path))
        cfg = EngineConfig(model=ModelConfig.tiny_test(), num_blocks=64, max_num_seqs=4,
                           max_model_len=256, dtype="float32")
        decode = MockerEngine(cfg, MockerConfig(vocab_size=100))
        prefill = MockerEngine(cfg, MockerConfig(vocab_size=100))
        await decode.start()
        await prefill.start()
        drt = await DistributedRuntime.in_process()
        queue = PrefillQueue(drt, "trace-e2e")
        dis = DisaggRouter.__new__(DisaggRouter)
        dis.cfg = DisaggConfig(max_local_prefill_length=1, max_prefill_queue_size=64)
        op = await DecodeOperator(decode, queue, dis, transport=transport).start()
        pw = PrefillWorker(prefill, queue).start()

        async def stop():
            await pw.stop()
            await op.stop()
            await decode.stop()
            await prefill.stop()
            await drt.shutdown()

        return drt, decode, op, stop

    return start()


def test_disagg_trace_e2e_mocker(tmp_path):
    """Frontend → prefill queue → decode over the real wire planes (HTTP,
    bus envelope, TCP response plane, KV tcp transfer) with mocker
    engines: the merged timeline is gapless in both merges, kv_transfer
    lands between prefill and the first decode, trace ids survive the
    TCP error plane, and /debug/steps serves the step ring."""
    from dynamo_tpu_torch.llm.discovery import ModelManager, ModelWatcher, register_llm
    from dynamo_tpu_torch.llm.http_client import fetch
    from dynamo_tpu_torch.llm.http_service import HttpService
    from dynamo_tpu_torch.llm.model_card import ModelDeploymentCard

    capture = tmp_path / "trace.jsonl"

    async def main():
        try:
            drt, decode, op, stop = await _disagg_mockers(capture)
            ep = drt.namespace("trace").component("mock").endpoint("generate")
            await ep.serve(op)
            await register_llm(drt, ep, ModelDeploymentCard(name="mock", model_path=None))
            manager = ModelManager()
            await ModelWatcher(drt, manager).start()
            service = HttpService(manager, host="127.0.0.1", port=0, debug=decode)
            await service.start()
            end = asyncio.get_running_loop().time() + 30
            while not manager.models():  # discovery, bounded
                assert asyncio.get_running_loop().time() < end, "model never discovered"
                await asyncio.sleep(0.02)
            body = {"model": "mock", "stream": False, "max_tokens": 8,
                    "messages": [{"role": "user",
                                  "content": "trace this request across every process hop"}]}
            r = await fetch("127.0.0.1", service.port, "POST", "/v1/chat/completions", body)
            assert r.status == 200, r.body
            assert op.remote_count == 1 and op.local_count == 0
            steps = (await fetch("127.0.0.1", service.port, "GET",
                                 "/debug/steps?n=16")).json()["steps"]
            assert steps and all("batch_fill_ratio" in st for st in steps)
            decode.begin_drain()
            r = await fetch("127.0.0.1", service.port, "POST", "/v1/chat/completions", body)
            assert r.status == 503 and "retry-after" in {k.lower() for k in r.headers}
            await service.stop()
            await stop()
        finally:
            reset_tracer(None)

    asyncio.run(main())
    for merge in (j_merge, t_merge):
        traces = merge.load_captures([str(capture)])
        completed = [t for t in traces.values() if t.completed]
        assert len(completed) == 1
        t = completed[0]
        assert t.missing_spans() == []
        have = {s["name"] for s in t.spans}
        assert {"admission", "tokenize", "route", "queue_wait", "prefill",
                "kv_transfer", "decode_first", "decode"} <= have
        assert "remote_prefill" in t.marks
        assert t.max_gap_ms() < 250.0
        prefill_end = max(s["start_unix"] + s["dur_ms"] / 1000.0
                          for s in t.spans if s["name"] == "prefill")
        kvt = next(s for s in t.spans if s["name"] == "kv_transfer")
        dfirst = next(s for s in t.spans if s["name"] == "decode_first")
        assert kvt["start_unix"] >= prefill_end - 1e-3
        assert dfirst["start_unix"] >= kvt["start_unix"]
        report = merge.merge_report(traces)
        for name in ("admission", "queue_wait", "prefill", "kv_transfer", "decode_first"):
            assert name in report["ttft_decomposition_ms"], name
        assert merge.assert_complete(report) == []
        shed = [t for t in traces.values()
                if t.finishes and "error" in t.marks and not t.completed]
        assert len(shed) == 1
        assert {"admission"} <= {s["name"] for s in shed[0].spans}


def test_degraded_remote_request_is_marked_and_completes(tmp_path):
    """A remote request whose block frame is lost degrades to local
    recompute: its capture carries ``remote_prefill`` and
    ``degraded_local`` and no ``kv_transfer`` span needs to complete it;
    both merges pass it."""
    from dynamo_tpu_torch.utils.faults import FAULTS

    capture = tmp_path / "trace.jsonl"

    async def main():
        try:
            _drt, decode, op, stop = await _disagg_mockers(capture)
            FAULTS.arm("disagg.recv", "drop", times=1)
            pre = PreprocessedRequest(token_ids=list(range(40)),
                                      sampling=SamplingOptions(temperature=0.0),
                                      stop=StopConditions(max_tokens=4, ignore_eos=True))
            toks = [t async for item in op.generate(Context(pre.to_wire()))
                    for t in item["token_ids"]]
            assert len(toks) == 4 and decode.degraded_requests == 1
            await stop()
        finally:
            FAULTS.clear()
            reset_tracer(None)

    asyncio.run(main())
    for merge in (j_merge, t_merge):
        traces = merge.load_captures([str(capture)])
        (t,) = [t for t in traces.values() if t.completed]
        assert {"remote_prefill", "degraded_local"} <= set(t.marks)
        assert t.missing_spans() == []
