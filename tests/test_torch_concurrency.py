"""The port's runtime concurrency checker (dynamo_tpu_torch/utils/
concurrency.py) and object pool (utils/pool.py), case for case with
tests/test_concurrency.py, the Pool cases of tests/test_utils.py and the
two checker drills of tests/test_chaos.py.

The checker units run the same seeded races through both packages'
checkers (each detector is shown to fire, not assumed); the wiring cases
drive the port's own named locks (tracer, recorder, flight ring,
compile stats and manifest, the KVBM pool) and thread bindings (the
engine thread, the event loop, offload workers)."""

from __future__ import annotations

import asyncio
import os
import threading
import time

import pytest

from dynamo_tpu.utils import concurrency as j_ck
from dynamo_tpu_torch.utils import concurrency as ck
from dynamo_tpu_torch.utils.pool import Pool

BOTH = pytest.mark.parametrize("mod", [j_ck, ck], ids=["jax", "port"])


def _refresh_all() -> None:
    for m in (j_ck, ck):
        m.refresh_enabled()
        m.reset_tracking()


@pytest.fixture
def checker_on(monkeypatch):
    # Teardown restores the OUTER env value and refreshes after the
    # restore, so a whole run with the checker armed stays armed.
    prev = os.environ.get("DYNTPU_CHECK_THREADS")
    monkeypatch.setenv("DYNTPU_CHECK_THREADS", "1")
    _refresh_all()
    for m in (j_ck, ck):
        m.bind_thread("main-test")
    yield
    if prev is None:
        monkeypatch.delenv("DYNTPU_CHECK_THREADS", raising=False)
    else:
        monkeypatch.setenv("DYNTPU_CHECK_THREADS", prev)
    _refresh_all()


@pytest.fixture
def checker_off(monkeypatch):
    prev = os.environ.get("DYNTPU_CHECK_THREADS")
    monkeypatch.delenv("DYNTPU_CHECK_THREADS", raising=False)
    _refresh_all()
    yield
    if prev is not None:
        monkeypatch.setenv("DYNTPU_CHECK_THREADS", prev)
    _refresh_all()


def _in_thread(fn, name="t"):
    """Run fn() in a fresh thread; re-raise its exception here."""
    box: dict = {}

    def run():
        try:
            box["ret"] = fn()
        except BaseException as exc:  # noqa: BLE001 — ferried to the caller
            box["exc"] = exc

    t = threading.Thread(target=run, name=name)
    t.start()
    t.join(10)
    assert not t.is_alive(), "seeded-race thread hung"
    if "exc" in box:
        raise box["exc"]
    return box.get("ret")


def test_port_exports_the_reference_surface():
    assert ck.__all__ == j_ck.__all__


# -- thread affinity ----------------------------------------------------------


@BOTH
def test_affinity_assertion_fires_cross_thread(checker_on, mod):
    class EngineOwned:
        def __init__(self):
            self.steps = 0

        def step(self):
            mod.assert_context("engine", what="EngineOwned.step")
            self.steps += 1

    obj = EngineOwned()

    def engine_thread():
        mod.bind_thread("engine")
        obj.step()

    _in_thread(engine_thread, name="engine")
    assert obj.steps == 1

    def wrong_thread():
        mod.bind_thread("loop")
        obj.step()

    with pytest.raises(mod.ThreadAffinityError, match="owned by 'engine'"):
        _in_thread(wrong_thread, name="loop")
    assert obj.steps == 1


@BOTH
def test_owned_by_decorator_fires_and_unbound_threads_pass(checker_on, mod):
    calls = []

    @mod.owned_by("engine")
    def hot():
        calls.append(1)

    def bound_wrong():
        mod.bind_thread("worker")
        hot()

    with pytest.raises(mod.ThreadAffinityError):
        _in_thread(bound_wrong)
    _in_thread(hot, name="unbound")
    assert calls == [1]


@BOTH
def test_bound_scope_restores_previous_binding(checker_on, mod):
    mod.bind_thread("loop")
    with mod.bound("worker"):
        assert mod.current_context() == "worker"
        with mod.bound("engine"):
            assert mod.current_context() == "engine"
        assert mod.current_context() == "worker"
    assert mod.current_context() == "loop"


# -- lock order ---------------------------------------------------------------


@BOTH
def test_lock_order_inversion_detected(checker_on, mod):
    a = mod.TrackedLock("A")
    b = mod.TrackedLock("B")

    def order_ab():
        with a:
            with b:
                pass

    _in_thread(order_ab, name="ab")

    def order_ba():
        with b:
            with a:
                pass

    with pytest.raises(mod.LockOrderError, match="inversion"):
        _in_thread(order_ba, name="ba")


@BOTH
def test_lock_order_consistent_and_reacquisition(checker_on, mod):
    a = mod.TrackedLock("A2")
    b = mod.TrackedLock("B2")
    for _ in range(3):
        with a, b:
            pass
    with pytest.raises(mod.LockOrderError, match="reacquisition"):
        with a:
            a.acquire()
    assert not a.locked()


@BOTH
def test_make_lock_tracked_when_on(checker_on, mod):
    lock = mod.make_lock("test.lock")
    assert isinstance(lock, mod.TrackedLock)
    with lock:
        assert lock.locked()
    assert not lock.locked()


def test_the_two_checkers_keep_separate_graphs(checker_on):
    """Each package's tracker holds its own edges: an order seen through
    one never trips the other (a mixed process runs two checkers)."""
    with j_ck.TrackedLock("X"), j_ck.TrackedLock("Y"):
        pass
    with ck.TrackedLock("Y"), ck.TrackedLock("X"):
        pass
    with pytest.raises(ck.LockOrderError):
        with ck.TrackedLock("X"), ck.TrackedLock("Y"):
            pass


# -- off: a structural no-op --------------------------------------------------


@BOTH
def test_env_off_is_structural_noop(checker_off, mod):
    lock = mod.make_lock("off.lock")
    assert type(lock) is type(threading.Lock())

    def fn():
        return 42

    assert mod.owned_by("engine")(fn) is fn
    mod.bind_thread("engine")
    mod.assert_context("loop", what="anything")
    a, b = mod.make_lock("offA"), mod.make_lock("offB")
    with a:
        with b:
            pass
    with b:
        with a:
            pass


def test_env_off_no_measurable_overhead_on_step_shaped_loop(checker_off):
    """10k lock cycles and affinity checks stay far under a dispatch's
    budget: the checker costs nothing measurable when off."""
    lock = ck.make_lock("bench.lock")
    t0 = time.perf_counter()
    for _ in range(10_000):
        with lock:
            pass
        ck.assert_context("engine", what="bench")
    dt = time.perf_counter() - t0
    assert dt < 0.5, f"checker-off hot loop took {dt:.3f}s for 10k iters"


def test_refresh_enabled_flips_make_lock(monkeypatch):
    prev = os.environ.get("DYNTPU_CHECK_THREADS")
    monkeypatch.setenv("DYNTPU_CHECK_THREADS", "1")
    assert ck.refresh_enabled() is True
    assert isinstance(ck.make_lock("x"), ck.TrackedLock)
    monkeypatch.setenv("DYNTPU_CHECK_THREADS", "0")
    assert ck.refresh_enabled() is False
    assert type(ck.make_lock("x")) is type(threading.Lock())
    if prev is None:
        monkeypatch.delenv("DYNTPU_CHECK_THREADS", raising=False)
    else:
        monkeypatch.setenv("DYNTPU_CHECK_THREADS", prev)
    _refresh_all()


# -- the port's wiring --------------------------------------------------------


def test_named_locks_are_tracked_when_on(checker_on):
    """Every serving lock of the port is built through make_lock under
    the reference's name."""
    from dynamo_tpu_torch.engine.compile_cache import CompileStats
    from dynamo_tpu_torch.engine.flight_recorder import FlightRecorder
    from dynamo_tpu_torch.llm.kv_router.audit import RouteObservatory
    from dynamo_tpu_torch.planner.obs import PlannerObservatory
    from dynamo_tpu_torch.utils.tracing import Tracer

    cs = CompileStats()
    names = {
        "compile.stats": cs._lock,
        "compile.manifest": cs.manifest._lock,
        "flight.ring": FlightRecorder(capacity=4)._lock,
        "tracer": Tracer()._lock,
        "route_obs": RouteObservatory()._lock,
        "planner_obs": PlannerObservatory()._lock,
    }
    for name, lock in names.items():
        assert isinstance(lock, ck.TrackedLock), name
        assert lock.name == name


def test_recorder_cross_thread_writes_stay_clean_under_checker(checker_on, tmp_path):
    from dynamo_tpu_torch.utils.recorder import Recorder

    rec = Recorder(tmp_path / "cap.jsonl", max_bytes=4096, max_files=3)
    assert isinstance(rec._write_lock, ck.TrackedLock)

    def writer(ctx, n):
        def run():
            ck.bind_thread(ctx)
            for i in range(n):
                rec.record({"ctx": ctx, "i": i})
        return run

    threads = [threading.Thread(target=writer("engine", 200)),
               threading.Thread(target=writer("loop", 200))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(20)
        assert not t.is_alive()
    rec.close()
    events = [e for _, e in Recorder.load(tmp_path / "cap.jsonl")]
    assert len(events) > 0 and events[-1]["i"] == 199


def test_compile_stats_concurrent_programs_are_exact(checker_on):
    """CompileStats is written by the engine thread and read from the
    loop: under a two-thread hammer of first executions every program
    counts once and the manifest records every serving execution."""
    from dynamo_tpu_torch.engine.compile_cache import CompileStats

    cs = CompileStats()
    N = 300

    def hammer(ctx):
        def run():
            ck.bind_thread(ctx)
            for i in range(N):
                with cs.program(f"unified:t{i}:greedy"):
                    pass
                cs.record_serving("unified", i)
        return run

    threads = [threading.Thread(target=hammer("engine")),
               threading.Thread(target=hammer("worker"))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(30)
        assert not t.is_alive()
    snap = cs.snapshot()
    assert snap["mid_traffic_compiles_total"] == N
    assert len(cs.seen) == N
    assert sum(e["count"] for e in cs.manifest.shapes.values()) == 2 * N


def test_engine_thread_binding_via_flush_side_channels(checker_on):
    """TorchEngine._flush_side_channels asserts engine affinity: from a
    thread bound elsewhere it raises; from an unbound one it runs."""
    from dynamo_tpu_torch.engine.engine import TorchEngine

    eng = TorchEngine.__new__(TorchEngine)
    eng._remote = {}
    eng._onboard_timings = []
    eng._external_kv_event = None
    eng._kv_events_buffer = []
    eng._kv_actuals_buffer = []
    eng.scheduler = type("S", (), {"waiting": [], "waiting_by_class": lambda self: {}})()
    eng._prefilling = []
    eng._on_metrics = None

    def wrong():
        ck.bind_thread("loop")
        eng._flush_side_channels()

    with pytest.raises(ck.ThreadAffinityError, match="_flush_side_channels"):
        _in_thread(wrong)
    _in_thread(eng._flush_side_channels, name="unbound")


@pytest.mark.anyio
async def test_engine_threads_bind_loop_and_engine(checker_on):
    """A started engine binds its event loop "loop" and its dispatch
    thread "engine", so the side channels run in the right context and
    a serve passes under the checker."""
    from dynamo_tpu_torch.engine.config import EngineConfig
    from dynamo_tpu_torch.llm.protocols.common import (
        PreprocessedRequest,
        SamplingOptions,
        StopConditions,
    )
    from dynamo_tpu_torch.mocker import MockerConfig, MockerEngine
    from dynamo_tpu_torch.models.config import ModelConfig
    from dynamo_tpu_torch.runtime.engine import Context

    seen = []
    eng = MockerEngine(
        EngineConfig(model=ModelConfig.tiny_test(), num_blocks=32, max_num_seqs=2,
                     max_model_len=64, dtype="float32"),
        MockerConfig(vocab_size=100, decode_time_per_step_us=100.0))
    eng._on_metrics = lambda m: seen.append(ck.current_context())
    await eng.start()
    try:
        assert ck.current_context() == "loop"
        pre = PreprocessedRequest(token_ids=[1, 2, 3], sampling=SamplingOptions(),
                                  stop=StopConditions(max_tokens=4, ignore_eos=True))
        out = [t async for item in eng.generate(Context(pre.to_wire()))
               for t in item["token_ids"]]
        assert len(out) == 4
    finally:
        await eng.stop()
    assert seen and set(seen) == {"engine"}


@pytest.mark.anyio
async def test_kvbm_offload_pipeline_clean_under_checker(checker_on, tmp_path):
    """The KVBM seam under the checker: engine-shaped stores and
    loop-side onboards share the tracked pool lock with no inversion and
    no affinity violation (offload workers bind "worker")."""
    import numpy as np

    from dynamo_tpu_torch.block_manager.config import KvLayoutConfig
    from dynamo_tpu_torch.block_manager.offload import OffloadManager
    from dynamo_tpu_torch.block_manager.pool import BlockPool
    from dynamo_tpu_torch.block_manager.storage import DiskStorage, HostStorage

    layout = KvLayoutConfig(num_layers=2, page_size=16, num_kv_heads=2, head_dim=16,
                            dtype="float32")
    lock = ck.make_lock("kvbm.pool")
    assert isinstance(lock, ck.TrackedLock)
    host = BlockPool(HostStorage(4, layout))
    disk = BlockPool(DiskStorage(4, layout, tmp_path / "kv.bin"))
    mgr = OffloadManager(host, disk, lock=lock)
    data = np.zeros(layout.block_elems, np.float32)
    blocks = host.allocate_blocks(2)
    for b in blocks:
        host.storage.write_block(b.idx, data)
    regs = [host.release(host.register_block(b, 10 + i, None, range(16)))
            or host.get_by_hash(10 + i) for i, b in enumerate(blocks)]
    for b in regs:
        mgr.offload(b)
    await mgr.drain()
    assert disk.num_registered == 2
    host2 = BlockPool(HostStorage(4, layout))
    mgr2 = OffloadManager(host2, disk, lock=lock)
    up = await mgr2.onboard([10, 11])
    assert [b.sequence_hash for b in up] == [10, 11]
    assert mgr.stats()["offloaded_blocks_total"] == 2


def test_tracer_and_flight_ring_clean_under_checker(checker_on, tmp_path):
    """A span storm across engine- and loop-bound threads through the
    tracked tracer, recorder and flight-ring locks: no inversion."""
    from dynamo_tpu_torch.engine.flight_recorder import FlightRecorder
    from dynamo_tpu_torch.utils.tracing import Tracer

    tr = Tracer(record_path=str(tmp_path / "spans.jsonl"))
    fr = FlightRecorder(capacity=64)
    assert isinstance(tr._lock, ck.TrackedLock)
    assert isinstance(fr._lock, ck.TrackedLock)

    def engine_side():
        ck.bind_thread("engine")
        for i in range(100):
            rid = f"r{i}"
            tr.mark(rid, "received")
            with tr.span(rid, "dispatch"):
                fr.note_step("unified", decode_tokens=1)
            tr.finish(rid)

    def loop_side():
        ck.bind_thread("loop")
        for _ in range(100):
            fr.snapshot(8)
            tr.snapshot(4)
            tr.render()

    threads = [threading.Thread(target=engine_side), threading.Thread(target=loop_side)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(30)
        assert not t.is_alive()
    assert fr.total_steps == 100


# -- the object pool (tests/test_utils.py) -------------------------------------


@pytest.mark.anyio
async def test_pool_reuse_and_capacity():
    built = []

    def factory():
        built.append(object())
        return built[-1]

    pool = Pool(factory, capacity=2)
    g1 = await pool.acquire()
    g2 = await pool.acquire()
    assert pool.size == 2 and pool.idle == 0
    third = asyncio.ensure_future(pool.acquire())
    await asyncio.sleep(0.01)
    assert not third.done()
    g1.release()
    g3 = await asyncio.wait_for(third, 1.0)
    assert g3.item is g1.item
    assert len(built) == 2
    g3.release()
    g2.release()
    async with await pool.acquire() as item:
        assert item in built
    assert pool.idle == 2


@pytest.mark.anyio
async def test_pool_detach_frees_slot():
    n = [0]

    def factory():
        n[0] += 1
        return n[0]

    pool = Pool(factory, capacity=1)
    g = await pool.acquire()
    assert g.detach() == 1
    g2 = await pool.acquire()
    assert g2.item == 2
    g2.release()
    assert pool.idle == 1


@pytest.mark.anyio
async def test_pool_async_factory_and_failure():
    calls = [0]

    async def factory():
        calls[0] += 1
        if calls[0] == 1:
            raise RuntimeError("first build fails")
        return "ok"

    pool = Pool(factory, capacity=1)
    with pytest.raises(RuntimeError):
        await pool.acquire()
    g = await pool.acquire()
    assert g.item == "ok"
    g.release()


@pytest.mark.anyio
async def test_pool_reset_failure_discards_without_leaking_slot():
    builds = [0]

    def factory():
        builds[0] += 1
        return builds[0]

    def reset(item):
        if item == 1:
            raise RuntimeError("stale connection")

    pool = Pool(factory, capacity=1, reset=reset)
    g = await pool.acquire()
    g.release()
    g2 = await pool.acquire()
    assert g2.item == 2
    assert pool.size == 1
    g2.release()


@pytest.mark.anyio
async def test_pool_reset_hook():
    resets = []
    pool = Pool(lambda: "x", capacity=1, reset=resets.append)
    g = await pool.acquire()
    g.release()
    g2 = await pool.acquire()
    assert resets == ["x"]
    g2.release()


@pytest.mark.anyio
async def test_pool_drain_matches_the_reference_pool():
    """The same acquire/release/detach/drain script through both
    packages' pools leaves the same sizes at every step."""
    from dynamo_tpu.utils.pool import Pool as JPool

    async def script(cls):
        n = [0]

        def factory():
            n[0] += 1
            return n[0]

        pool = cls(factory, capacity=3)
        trail = []
        gs = [await pool.acquire() for _ in range(3)]
        trail.append((pool.size, pool.idle))
        gs[0].release()
        gs[1].detach()
        trail.append((pool.size, pool.idle))
        g = await pool.acquire()
        trail.append((g.item, pool.size, pool.idle))
        g.release()
        gs[2].release()
        drained = pool.drain()
        trail.append((sorted(drained), pool.size, pool.idle))
        await asyncio.sleep(0)
        return trail

    assert await script(Pool) == await script(JPool)
