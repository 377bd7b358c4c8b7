"""The port's runtime plane (dynamo_tpu_torch/runtime, utils/task,
utils/retry, utils/faults) against the JAX package's, in process on the
CPU: the standard-library wire codec against ``msgpack`` byte for byte,
the frame codec, the store and bus semantics, the control plane (auth
included) over real TCP, the JAX package's client against the port's
server and the port's client against the JAX package's server, and the
runtime cases of tests/test_runtime.py run through both packages (serve
and route, round robin, worker death, engine errors). Also the bounded
waiting list of the engine, held to the JAX scheduler on the same
arrivals."""

import asyncio
import functools
import os
import pathlib
import time
from dataclasses import dataclass
from types import SimpleNamespace

import msgpack
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from dynamo_tpu.engine import scheduler as j_sched
from dynamo_tpu.engine.config import EngineConfig as JEngineConfig
from dynamo_tpu.engine.kv_cache import BlockAllocator as JAllocator
from dynamo_tpu.engine.sequence import Sequence as JSequence
from dynamo_tpu.llm.protocols import common as j_common
from dynamo_tpu.mocker import MockerConfig as JMockerConfig
from dynamo_tpu.mocker import MockerEngine as JMockerEngine
from dynamo_tpu.models.config import ModelConfig as JModelConfig
from dynamo_tpu.runtime import distributed as j_distributed
from dynamo_tpu.runtime import egress as j_egress
from dynamo_tpu.runtime import ingress as j_ingress
from dynamo_tpu.runtime import runtime as j_runtime
from dynamo_tpu.runtime.engine import Context as JContext
from dynamo_tpu.runtime.transports import bus as j_bus
from dynamo_tpu.runtime.transports import codec as j_codec
from dynamo_tpu.runtime.transports import control_client as j_client
from dynamo_tpu.runtime.transports import control_plane as j_plane
from dynamo_tpu.runtime.transports import store as j_store
from dynamo_tpu.utils import task as j_task
from dynamo_tpu_torch.engine import scheduler as t_sched
from dynamo_tpu_torch.engine.config import EngineConfig
from dynamo_tpu_torch.engine.kv_cache import BlockAllocator
from dynamo_tpu_torch.engine.sequence import Sequence
from dynamo_tpu_torch.llm.protocols import common as t_common
from dynamo_tpu_torch.mocker import MockerConfig, MockerEngine
from dynamo_tpu_torch.models.config import ModelConfig
from dynamo_tpu_torch.runtime import distributed as t_distributed
from dynamo_tpu_torch.runtime import egress as t_egress
from dynamo_tpu_torch.runtime import engine as t_engine
from dynamo_tpu_torch.runtime import ingress as t_ingress
from dynamo_tpu_torch.runtime import runtime as t_runtime
from dynamo_tpu_torch.runtime.engine import Context
from dynamo_tpu_torch.runtime.transports import bus as t_bus
from dynamo_tpu_torch.runtime.transports import codec as t_codec
from dynamo_tpu_torch.runtime.transports import control_client as t_client
from dynamo_tpu_torch.runtime.transports import control_plane as t_plane
from dynamo_tpu_torch.runtime.transports import store as t_store
from dynamo_tpu_torch.runtime.transports import wire
from dynamo_tpu_torch.utils import faults as t_faults
from dynamo_tpu_torch.utils import retry as t_retry
from dynamo_tpu_torch.utils import task as t_task

pytestmark = pytest.mark.anyio

REPO = pathlib.Path(__file__).resolve().parents[1]

PKGS = {
    "jax": SimpleNamespace(
        store=j_store, bus=j_bus, plane=j_plane, client=j_client,
        distributed=j_distributed, egress=j_egress, ingress=j_ingress,
        runtime=j_runtime, common=j_common, Context=JContext, task=j_task,
    ),
    "torch": SimpleNamespace(
        store=t_store, bus=t_bus, plane=t_plane, client=t_client,
        distributed=t_distributed, egress=t_egress, ingress=t_ingress,
        runtime=t_runtime, common=t_common, Context=Context, task=t_task,
    ),
}
BOTH = pytest.mark.parametrize("pkg", sorted(PKGS))


# -- wire codec ---------------------------------------------------------------
KEYS = st.one_of(st.text(max_size=40), st.binary(max_size=40))
SCALARS = st.one_of(
    st.none(), st.booleans(),
    st.integers(min_value=-(2**63), max_value=2**64 - 1),
    st.floats(allow_nan=False),
    st.text(max_size=300), st.binary(max_size=300),
)
VALUES = st.recursive(
    SCALARS,
    lambda inner: st.one_of(
        st.lists(inner, max_size=20),
        st.tuples(inner, inner),
        st.dictionaries(KEYS, inner, max_size=20),
    ),
    max_leaves=60,
)


@settings(max_examples=300, deadline=None,
          suppress_health_check=[HealthCheck.too_slow])
@given(VALUES)
def test_wire_matches_msgpack_byte_for_byte(value):
    """packb gives msgpack.packb's bytes (the JAX package's arguments:
    msgpack 1.x defaults); unpackb gives msgpack.unpackb's value, tuples
    as lists."""
    got = wire.packb(value)
    assert got == msgpack.packb(value)
    assert wire.unpackb(got) == msgpack.unpackb(got)


@pytest.mark.parametrize("n", [
    0, 1, 127, 128, 255, 256, 65535, 65536, 2**32 - 1, 2**32, 2**64 - 1,
    -1, -32, -33, -128, -129, -32768, -32769, -(2**31), -(2**31) - 1, -(2**63),
])
def test_wire_int_widths_match_msgpack(n):
    assert wire.packb(n) == msgpack.packb(n)
    assert wire.unpackb(wire.packb(n)) == n


@pytest.mark.parametrize("size", [0, 15, 16, 31, 32, 255, 256, 65535, 65536])
def test_wire_length_forms_match_msgpack(size):
    """fix/8/16/32-bit headers of str, bin, array and map at each edge."""
    for value in ("x" * size, b"y" * size, list(range(size)),
                  {f"k{i}": i for i in range(size)}):
        assert wire.packb(value) == msgpack.packb(value)
        assert wire.unpackb(wire.packb(value)) == value


def test_wire_dataclass_default_matches_ingress_packing():
    """The ingress packs response items through ``_default``; a dataclass
    payload and a str enum cross as the JAX package packs them."""
    @dataclass
    class Item:
        token_ids: list
        finish_reason: object

    item = Item([1, 2], t_common.FinishReason.LENGTH)
    want = msgpack.packb(item, default=j_ingress._default)
    assert wire.packb(item, default=t_ingress._default) == want
    assert wire.unpackb(want) == {"token_ids": [1, 2], "finish_reason": "length"}
    out = t_common.EngineOutput(token_ids=[3], finish_reason=t_common.FinishReason.STOP)
    assert wire.packb(out, default=t_ingress._default) == msgpack.packb(
        out, default=j_ingress._default)


def test_wire_refuses_values_outside_the_subset():
    for value, exc in ((2**64, OverflowError), (-(2**63) - 1, OverflowError),
                       ({1, 2}, TypeError), (object(), TypeError)):
        with pytest.raises(exc):
            msgpack.packb(value)
        with pytest.raises(exc):
            wire.packb(value)
    # default is called once: a result that is still outside raises.
    with pytest.raises(TypeError):
        wire.packb(object(), default=lambda o: object())
    for raw in (msgpack.packb({1: 2}),           # strict_map_key
                msgpack.packb([1, 2])[:-1],       # incomplete
                msgpack.packb(1) + b"\x01",       # extra data
                b"\xc1",                          # reserved
                msgpack.packb(msgpack.ExtType(1, b"x")),
                b"\xca\x3f\x80\x00\x00"):         # float32: never sent
        with pytest.raises(ValueError):
            wire.unpackb(raw)
    nan = wire.packb(float("nan"))
    assert nan == msgpack.packb(float("nan"))


# -- frame codec --------------------------------------------------------------
@pytest.mark.parametrize("header,payload", [
    (b"", b""), (b"h", b""), (b"head", b"payload" * 1000),
])
async def test_frame_codec_matches_and_round_trips(header, payload):
    frame = t_codec.encode_frame(header, payload)
    assert frame == j_codec.encode_frame(header, payload)
    reader = asyncio.StreamReader()
    reader.feed_data(frame * 2)
    reader.feed_eof()
    assert await t_codec.read_frame(reader) == (header, payload)
    assert await j_codec.read_frame(reader) == (header, payload)


async def test_frame_codec_refuses_oversized_frames():
    reader = asyncio.StreamReader()
    reader.feed_data((t_codec.MAX_FRAME + 1).to_bytes(4, "little") + b"\0" * 4)
    with pytest.raises(ValueError):
        await t_codec.read_frame(reader)


# -- store and bus ------------------------------------------------------------
@BOTH
async def test_memory_store_lease_expiry_notifies_watch(pkg):
    m = PKGS[pkg].store
    store = m.MemoryStore()
    watch = await store.watch_prefix("instances/")
    lease = await store.grant_lease(0.1)
    await store.put("instances/a", b"x", lease_id=lease)
    ev = await asyncio.wait_for(watch.__anext__(), 1)
    assert (ev.kind.value, ev.key) == ("put", "instances/a")
    ev = await asyncio.wait_for(watch.__anext__(), 2)
    assert (ev.kind.value, ev.key) == ("delete", "instances/a")
    assert await store.get("instances/a") is None


@BOTH
async def test_store_create_exclusive_and_kv_cache(pkg):
    m = PKGS[pkg].store
    store = m.MemoryStore()
    assert await store.create("k", b"1") is True
    assert await store.create("k", b"2") is False
    assert await store.get("k") == b"1"
    cache = m.KvCache(store, "cfg/")
    await cache.start()
    await store.put("cfg/x", b"7")
    await asyncio.sleep(0.01)
    assert cache.get("x") == b"7"
    await store.delete_prefix("cfg/")
    await asyncio.sleep(0.01)
    assert cache.snapshot() == {}
    cache.stop()


@BOTH
async def test_bus_queue_group_and_broadcast(pkg):
    m = PKGS[pkg].bus
    bus = m.InProcBus()
    a, b = await bus.subscribe("s"), await bus.subscribe("s")
    for i in range(4):
        await bus.publish("s", bytes([i]))
    got_a = [await a.__anext__() for _ in range(2)]
    got_b = [await b.__anext__() for _ in range(2)]
    assert got_a == [b"\x00", b"\x02"] and got_b == [b"\x01", b"\x03"]
    await bus.broadcast("s", b"all")
    assert await a.__anext__() == b"all" and await b.__anext__() == b"all"
    a.close()
    b.close()
    with pytest.raises(m.NoSubscriberError):
        await bus.publish("s", b"x", require_subscriber=True)
    await bus.publish("s", b"x")  # fire and forget: a silent drop


@BOTH
async def test_queue_leased_dequeue_redelivers_and_nacks_to_front(pkg):
    q = PKGS[pkg].bus.InProcBus().work_queue("jobs")
    await q.enqueue(b"a")
    item, payload = await q.dequeue_leased(timeout_s=1, lease_s=0.1)
    assert payload == b"a"
    item2, payload2 = await asyncio.wait_for(q.dequeue_leased(lease_s=5), 2)
    assert payload2 == b"a" and item2 != item
    assert await q.ack(item) is False and await q.ack(item2) is True
    await q.enqueue(b"x")
    await q.enqueue(b"y")
    ix, _ = await q.dequeue_leased(timeout_s=1, lease_s=5)
    assert await q.nack(ix) is True
    assert (await q.dequeue_leased(timeout_s=1, lease_s=5))[1] == b"x"
    assert q.redelivered == 2


# -- the control plane ----------------------------------------------------------
async def _plane_scenario(server_mod, client_mod):
    """Every op family of the control-plane protocol through one client:
    store, watch with lease expiry, keepalive, pub/sub (queue group and
    broadcast), work queue (long poll, lease, ack, consumer death) and
    the object store."""
    server = await server_mod.ControlPlaneServer().start()
    c = await client_mod.ControlPlaneClient.connect(server.address)
    c2 = await client_mod.ControlPlaneClient.connect(server.address)
    try:
        await c.put("a/1", b"one")
        await c.put("a/2", b"two")
        assert await c.get("a/1") == b"one" and await c.get("nope") is None
        assert await c.get_prefix("a/") == {"a/1": b"one", "a/2": b"two"}
        assert await c.create("a/1", b"x") is False
        assert await c.create("a/3", b"3") is True
        await c.delete("a/1")
        await c.delete_prefix("a/")
        assert await c.get_prefix("a/") == {}

        watch = await c.watch_prefix("w/")
        lease = await c.grant_lease(0.3)
        await c.put("w/leased", b"v", lease_id=lease)
        ev = await asyncio.wait_for(watch.__anext__(), 2)
        assert (ev.kind.value, ev.key, ev.value) == ("put", "w/leased", b"v")
        ev = await asyncio.wait_for(watch.__anext__(), 3)
        assert (ev.kind.value, ev.key) == ("delete", "w/leased")
        watch.cancel()
        kept = await c.grant_lease(0.4)
        for _ in range(4):
            await asyncio.sleep(0.15)
            assert await c.keep_alive(kept) is True
        await c.revoke_lease(kept)
        assert await c.keep_alive(kept) is False

        s1, s2 = await c.subscribe("subj"), await c2.subscribe("subj")
        await c.publish("subj", b"m1")
        await c.publish("subj", b"m2")
        got = {await asyncio.wait_for(s.__anext__(), 2) for s in (s1, s2)}
        assert got == {b"m1", b"m2"}
        await c2.broadcast("subj", b"all")
        assert await asyncio.wait_for(s1.__anext__(), 2) == b"all"
        assert await asyncio.wait_for(s2.__anext__(), 2) == b"all"
        s1.close()
        s2.close()
        await asyncio.sleep(0.05)

        q = c.work_queue("jobs")
        poll = asyncio.ensure_future(c2.work_queue("jobs").dequeue(timeout_s=2))
        await asyncio.sleep(0.05)
        await q.enqueue(b"job")
        assert await poll == b"job"
        await q.enqueue(b"leased")
        dying = await client_mod.ControlPlaneClient.connect(server.address)
        got = await dying.work_queue("jobs").dequeue_leased(timeout_s=1, lease_s=60)
        assert got[1] == b"leased"
        await dying.close()  # dies holding the lease: redelivered at once
        item, payload = await asyncio.wait_for(q.dequeue_leased(lease_s=5), 2)
        assert payload == b"leased" and await q.ack(item) is True
        assert await q.depth() == 0

        blob = bytes(range(256)) * 64
        await c.put_object("mdc", "card", blob)
        assert await c.get_object("mdc", "card") == blob
        assert await c.get_object("mdc", "missing") is None
        assert await c.list_objects("mdc") == ["card"]
        assert await c.delete_object("mdc", "card") is True
    finally:
        await c.close()
        await c2.close()
        await server.stop()


@pytest.mark.parametrize("server,client", [
    ("torch", "torch"), ("torch", "jax"), ("jax", "torch"),
])
async def test_control_plane_protocol(server, client):
    """The port's server with its own client, the JAX package's client
    against the port's server, and the port's client against the JAX
    package's server: one protocol."""
    await _plane_scenario(PKGS[server].plane, PKGS[client].client)


@pytest.mark.parametrize("server,client", [
    ("torch", "torch"), ("torch", "jax"), ("jax", "torch"),
])
async def test_control_plane_auth_rejected_and_accepted(server, client):
    srv = await PKGS[server].plane.ControlPlaneServer(token="sekret").start()
    cm = PKGS[client].client.ControlPlaneClient
    bad = await cm.connect(srv.address)
    with pytest.raises((RuntimeError, ConnectionError, asyncio.TimeoutError)):
        await bad.put("k", b"v")
    await bad.close()
    wrong = cm.connect(srv.address, token="guess")
    with pytest.raises((RuntimeError, ConnectionError, asyncio.TimeoutError)):
        await (await wrong).put("k", b"v")
    good = await cm.connect(srv.address, token="sekret")
    await good.put("k", b"v")
    assert await good.get("k") == b"v"
    await good.close()
    await srv.stop()


class _Echo:
    async def generate(self, ctx):
        for x in ctx.payload["xs"]:
            yield {"x": x}


@pytest.mark.parametrize("plane,worker,front", [
    ("torch", "torch", "torch"), ("torch", "torch", "jax"),
    ("jax", "jax", "torch"), ("jax", "torch", "jax"),
])
async def test_endpoint_served_and_routed_across_packages(plane, worker, front):
    """A DistributedRuntime of one package serves an endpoint on a
    control plane; a PushRouter of the other discovers it and streams
    from it over the TCP response plane."""
    server = await PKGS[plane].plane.ControlPlaneServer().start()
    w = await PKGS[worker].distributed.DistributedRuntime.connect(server.address)
    f = await PKGS[front].distributed.DistributedRuntime.connect(server.address)
    try:
        await w.namespace("ns").component("comp").endpoint("gen").serve(_Echo())
        router = await PKGS[front].egress.PushRouter.create(f, "ns.comp.gen")
        ctx = PKGS[front].Context({"xs": [1, "two", b"3", None]})
        out = [item async for item in router.generate(ctx)]
        assert out == [{"x": 1}, {"x": "two"}, {"x": b"3"}, {"x": None}]
        assert ctx.annotations["worker_id"] == w.primary_lease_id
    finally:
        await f.shutdown()
        await w.shutdown()
        await server.stop()


# -- runtime (tests/test_runtime.py through both packages) ----------------------
async def _worker(pkg, drt_from=None, engine=None):
    m = PKGS[pkg]
    if drt_from is None:
        drt = await m.distributed.DistributedRuntime.in_process()
    else:
        drt = await m.distributed.DistributedRuntime.in_process(
            store=drt_from.store, bus=drt_from.bus)
    served = await drt.namespace("ns").component("c").endpoint("gen").serve(
        engine or _Echo())
    return drt, served


@BOTH
async def test_endpoint_serve_and_route(pkg):
    m = PKGS[pkg]
    drt, _ = await _worker(pkg)
    router = await m.egress.PushRouter.create(drt, "dyn://ns.c.gen")
    out = [i async for i in router.generate(m.Context({"xs": [1, 2, 3]}))]
    assert out == [{"x": 1}, {"x": 2}, {"x": 3}]
    await drt.shutdown()


class _Who:
    def __init__(self, name):
        self.name = name

    async def generate(self, ctx):
        yield {"who": self.name}


@BOTH
async def test_two_workers_round_robin(pkg):
    m = PKGS[pkg]
    drt_a, _ = await _worker(pkg, engine=_Who("a"))
    drt_b, _ = await _worker(pkg, drt_a, engine=_Who("b"))
    router = await m.egress.PushRouter.create(drt_a, "ns.c.gen")
    assert len(await router.client.wait_for_instances()) == 2
    seen = [(await router.generate(m.Context({})).__anext__())["who"]
            for _ in range(4)]
    assert sorted(seen) == ["a", "a", "b", "b"]
    await drt_b.shutdown()
    await drt_a.shutdown()


@BOTH
async def test_worker_death_removes_instance(pkg):
    m = PKGS[pkg]
    front = await m.distributed.DistributedRuntime.in_process()
    drt, _ = await _worker(pkg, front)
    router = await m.egress.PushRouter.create(front, "ns.c.gen")
    assert len(await router.client.wait_for_instances()) == 1
    await drt.store.revoke_lease(drt.primary_lease_id)   # the lease dies
    t0 = time.monotonic()
    while router.client.instances() and time.monotonic() - t0 < 2:
        await asyncio.sleep(0.01)
    assert router.client.instances() == []
    # No live instance: a typed retryable ShedError (after the wait for
    # one, cut to 0.1 s here).
    router.client.wait_for_instances = functools.partial(
        router.client.wait_for_instances, 0.1)
    with pytest.raises(m.common.ShedError):
        await router.generate(m.Context({})).__anext__()
    await front.shutdown()


class _Failing:
    def __init__(self, exc):
        self.exc = exc

    async def generate(self, ctx):
        yield {"first": True}
        raise self.exc


@BOTH
@pytest.mark.parametrize("case", ["runtime", "shed", "request", "died"])
async def test_engine_error_propagates_typed(pkg, case):
    """A worker's error crosses the wire and is raised typed at the
    caller, ShedError with its retry hints."""
    m = PKGS[pkg]
    c = m.common
    exc = {
        "runtime": RuntimeError("boom"),
        "shed": c.ShedError("full", retry_after_s=3.5, draining=True),
        "request": c.RequestError("bad param"),
        "died": ConnectionResetError("engine gone"),
    }[case]
    want = {"runtime": RuntimeError, "shed": c.ShedError,
            "request": c.RequestError, "died": c.WorkerDiedError}[case]
    drt, _ = await _worker(pkg, engine=_Failing(exc))
    router = await m.egress.PushRouter.create(drt, "ns.c.gen")
    got = []
    with pytest.raises(want) as info:
        async for item in router.generate(m.Context({})):
            got.append(item)
    assert got == [{"first": True}]
    if case == "shed":
        assert (info.value.retry_after_s, info.value.draining) == (3.5, True)
    if case == "died":
        assert not info.value.transport_dead  # an error frame, not a dead socket
    await drt.shutdown()


async def test_tcp_error_frames_retype_as_the_jax_package_does():
    from dynamo_tpu.runtime.transports import tcp as j_tcp
    from dynamo_tpu_torch.runtime.transports import tcp as t_tcp

    for msg in ("ShedError[2.5,1]: go away", "ShedError: plain",
                "DeadlineError: late", "RequestError: bad",
                "WorkerDiedError: gone", "KeyError: 'x'", "no prefix"):
        j, t = j_tcp._typed_stream_error(msg), t_tcp._typed_stream_error(msg)
        assert type(t).__name__ == type(j).__name__ and str(t) == str(j)
        assert getattr(t, "retry_after_s", None) == getattr(j, "retry_after_s", None)
        assert getattr(t, "draining", None) == getattr(j, "draining", None)
    for exc in (t_common.ShedError("s", retry_after_s=1.5, draining=True),
                ConnectionResetError("r"), ValueError("v")):
        j_exc = (j_common.ShedError("s", retry_after_s=1.5, draining=True)
                 if isinstance(exc, t_common.ShedError) else exc)
        assert t_ingress._wire_error(exc) == j_ingress._wire_error(j_exc)


@BOTH
async def test_router_modes_and_direct(pkg):
    m = PKGS[pkg]
    drt_a, _ = await _worker(pkg, engine=_Who("a"))
    drt_b, _ = await _worker(pkg, drt_a, engine=_Who("b"))
    rnd = await m.egress.PushRouter.create(drt_a, "ns.c.gen", m.egress.RouterMode.RANDOM)
    seen = {(await rnd.generate(m.Context({})).__anext__())["who"] for _ in range(30)}
    assert seen == {"a", "b"}
    direct = await m.egress.PushRouter.create(drt_a, "ns.c.gen", m.egress.RouterMode.DIRECT)
    got = [i async for i in direct.direct(m.Context({}), drt_b.primary_lease_id)]
    assert got == [{"who": "b"}]
    await drt_b.shutdown()
    await drt_a.shutdown()


async def test_router_mode_kv_is_refused_naming_a5():
    drt = await t_distributed.DistributedRuntime.in_process()
    with pytest.raises(SystemExit, match="A5"):
        await t_egress.PushRouter.create(drt, "ns.c.gen", t_egress.RouterMode.KV)
    await drt.shutdown()


@BOTH
async def test_cancellation_tree_and_critical_task(pkg):
    token_cls = (t_engine.CancellationToken if pkg == "torch" else
                 __import__("dynamo_tpu.utils.cancellation",
                            fromlist=["x"]).CancellationToken)
    root = token_cls()
    child = root.child_token()
    fired = []
    child.on_cancel(lambda: fired.append("child"))
    child.cancel()
    assert child.is_cancelled() and not root.is_cancelled() and fired == ["child"]

    async def boom(_token):
        raise RuntimeError("keepalive died")

    task = PKGS[pkg].task.CriticalTask(boom, root, name="t")
    await task.join()
    assert root.is_cancelled()
    late = []
    root.on_cancel(lambda: late.append(1))
    assert late == [1]


@BOTH
def test_worker_harness_runs_main_and_shuts_down(pkg):
    """Worker.execute runs the entrypoint under a Runtime whose token is
    cancelled when it returns (the signal handlers' same path)."""
    seen = {}

    async def main(rt):
        child = rt.child_token()
        assert not rt.is_shutdown
        seen["rt"], seen["child"] = rt, child

    PKGS[pkg].runtime.Worker().execute(main)
    assert seen["rt"].is_shutdown and seen["child"].is_cancelled()


# -- faults and retries --------------------------------------------------------
async def test_fault_registry_actions_and_env_arming():
    reg = t_faults.FaultRegistry()
    reg.arm("bus.publish", "raise", times=2)
    for _ in range(2):
        with pytest.raises(t_faults.FaultError):
            await reg.maybe_fail_async("bus.publish")
    assert await reg.maybe_fail_async("bus.publish") is True
    reg.arm("tcp.respond", "drop")
    assert await reg.maybe_fail_async("tcp.respond") is True  # inert: cannot drop
    assert await reg.maybe_fail_async("tcp.respond", can_drop=True) is False
    reg.arm("control.call", "partition")
    for _ in range(3):
        with pytest.raises(ConnectionError):
            await reg.maybe_fail_async("control.call")
    reg.clear()
    assert not reg.active and reg.snapshot() == {"bus.publish": 2, "tcp.respond": 1,
                                                 "control.call": 3}
    t_faults.arm_from_env(reg, "fleet.worker_kill:raise:1, bus.broadcast:delay:0.01,bad:nope")
    assert reg.armed("fleet.worker_kill") and reg.armed("bus.broadcast")
    assert not reg.armed("bad")


def test_every_known_fault_point_is_instrumented_in_the_port():
    sources = "".join(p.read_text() for p in (REPO / "dynamo_tpu_torch").rglob("*.py")
                      if p.name != "faults.py")
    for point in t_faults.KNOWN_FAULT_POINTS:
        assert f'"{point}"' in sources, point


async def test_injected_dispatch_fault_takes_the_mark_dead_path():
    """``fleet.worker_kill`` armed: the router marks the picked worker dead
    and re-picks the sibling; the stream comes once, from the sibling. (A
    refresh from the store later restores the falsely evicted worker.)"""
    from dynamo_tpu_torch.runtime.failover import FAILOVER

    drt_a, _ = await _worker("torch", engine=_Who("a"))
    drt_b, _ = await _worker("torch", drt_a, engine=_Who("b"))
    router = await t_egress.PushRouter.create(drt_a, "ns.c.gen")
    await router.client.wait_for_instances()
    before = FAILOVER.marked_dead_total
    t_faults.FAULTS.arm("fleet.worker_kill", "raise", times=1)
    try:
        out = [i async for i in router.generate(Context({}))]
    finally:
        t_faults.FAULTS.clear()
    assert out == [{"who": "b"}] and FAILOVER.marked_dead_total == before + 1
    await drt_b.shutdown()
    await drt_a.shutdown()


async def test_retry_policy_counts_retries_and_respects_budgets():
    calls = []

    async def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise ConnectionRefusedError("not yet")
        return "ok"

    before = t_retry.RETRIES.snapshot().get("test.seam", 0)
    policy = t_retry.RetryPolicy(attempts=4, base_delay_s=0.001, jitter=0)
    assert await t_retry.retry_async(flaky, policy, seam="test.seam") == "ok"
    assert t_retry.RETRIES.snapshot()["test.seam"] == before + 2

    async def bug():
        raise KeyError("not transport")

    with pytest.raises(KeyError):
        await t_retry.retry_async(bug, policy, seam="test.seam")

    async def down():
        raise ConnectionRefusedError("never")

    with pytest.raises(ConnectionRefusedError):
        await t_retry.retry_async(down, t_retry.RetryPolicy(attempts=1), seam="test.seam")
    assert t_retry.RETRIES.snapshot()["test.seam"] == before + 2


async def test_connect_retries_until_the_control_plane_binds():
    """A worker dialling before the plane has bound its port keeps
    retrying under CONTROL_CONNECT."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]

    async def late_plane():
        await asyncio.sleep(0.5)
        return await t_plane.ControlPlaneServer(port=port).start()

    plane_task = asyncio.ensure_future(late_plane())
    drt = await t_distributed.DistributedRuntime.connect(f"127.0.0.1:{port}")
    server = await plane_task
    assert await drt.store.get("nothing") is None
    await drt.shutdown()
    await server.stop()


# -- the bounded waiting list ----------------------------------------------------
def _seq(seq_cls, proto, rid, emit, prompt=(1, 2, 3)):
    return seq_cls(request_id=rid, prompt_tokens=list(prompt),
                   sampling=proto.SamplingOptions(temperature=0.0),
                   stop=proto.StopConditions(max_tokens=2), emit=emit)


def _sched(mod_sched, cfg_cls, alloc_cls, model, **kw):
    cfg = cfg_cls(model=model, dtype="float32", num_blocks=64, max_model_len=64,
                  max_num_seqs=2, **kw)
    return mod_sched.Scheduler(cfg, alloc_cls(cfg.num_blocks, cfg.block_size))


@pytest.mark.parametrize("max_waiting,arrivals", [(128, 129), (4, 9), (0, 20)])
def test_waiting_bound_sheds_the_oldest_like_the_jax_scheduler(max_waiting, arrivals):
    """N arrivals over a bound of B shed the N - B oldest with SHED, the
    same sequences on both schedulers; 0 = unbounded."""
    finishes = {}
    for pkg, sched, seq_cls, proto in (
        ("jax", _sched(j_sched, JEngineConfig, JAllocator, JModelConfig.tiny_test(),
                       max_waiting=max_waiting), JSequence, j_common),
        ("torch", _sched(t_sched, EngineConfig, BlockAllocator,
                         ModelConfig.tiny_test(), max_waiting=max_waiting),
         Sequence, t_common),
    ):
        got = []
        for i in range(arrivals):
            sched.add(_seq(seq_cls, proto, f"r{i}",
                           lambda tok, fin, *_a, rid=f"r{i}": got.append(
                               (rid, fin.value if fin else None))))
        finishes[pkg] = (got, [s.request_id for s in sched.waiting])
    assert finishes["torch"] == finishes["jax"]
    shed = max(0, arrivals - max_waiting) if max_waiting else 0
    assert finishes["torch"][0] == [(f"r{i}", "shed") for i in range(shed)]


def test_waiting_age_bound_sheds_like_the_jax_scheduler():
    out = {}
    for pkg, sched, seq_cls, proto in (
        ("jax", _sched(j_sched, JEngineConfig, JAllocator, JModelConfig.tiny_test(),
                       max_queue_delay_s=0.05), JSequence, j_common),
        ("torch", _sched(t_sched, EngineConfig, BlockAllocator,
                         ModelConfig.tiny_test(), max_queue_delay_s=0.05),
         Sequence, t_common),
    ):
        got = []
        old = _seq(seq_cls, proto, "old", lambda t, f, *_a: got.append(("old", f)))
        old.arrival_s -= 1.0
        new = _seq(seq_cls, proto, "new", lambda t, f, *_a: got.append(("new", f)))
        sched.add(old)
        sched.add(new)
        out[pkg] = (sched.expire_waiting(), [(r, f.value) for r, f in got],
                    [s.request_id for s in sched.waiting])
    assert out["torch"] == out["jax"] == (1, [("old", "shed")], ["new"])


def test_waiting_bounds_are_validated():
    for kw in ({"max_waiting": -1}, {"max_queue_delay_s": -0.5}):
        with pytest.raises(ValueError, match="max_waiting"):
            EngineConfig(model=ModelConfig.tiny_test(), dtype="float32", **kw).validate()


async def _flood(engine_cls, cfg_cls, model, sim, ctx_cls, proto, n):
    """n requests into an engine whose admission is held (warmup_gate
    "hold", never warmed): every one waits; returns each finish."""
    cfg = cfg_cls(model=model, dtype="float32", num_blocks=64, max_num_seqs=4,
                  max_model_len=128, max_waiting=128, warmup_gate="hold")
    eng = engine_cls(cfg, sim)
    await eng.start()

    async def one(i):
        pre = proto.PreprocessedRequest(
            token_ids=[1 + i % 50, 2, 3],
            sampling=proto.SamplingOptions(temperature=0.0),
            stop=proto.StopConditions(max_tokens=2, ignore_eos=True))
        async for item in eng.generate(ctx_cls(pre.to_wire(), id=f"r{i}")):
            if item["finish_reason"]:
                return item["finish_reason"]

    tasks = [asyncio.ensure_future(one(i)) for i in range(n)]
    await asyncio.sleep(0.3)
    done = {i: t.result() for i, t in enumerate(tasks) if t.done()}
    for t in tasks:
        t.cancel()
    await asyncio.gather(*tasks, return_exceptions=True)
    await eng.stop()
    return done


async def test_engine_sheds_the_oldest_of_129_waiting_like_the_jax_engine():
    """129 requests queue behind held admission: the oldest finishes with
    FinishReason.SHED on both engines (the same mocker runner above),
    the other 128 keep waiting."""
    got_j = await _flood(JMockerEngine, JEngineConfig, JModelConfig.tiny_test(),
                         JMockerConfig(), JContext, j_common, 129)
    got_t = await _flood(MockerEngine, EngineConfig, ModelConfig.tiny_test(),
                         MockerConfig(), Context, t_common, 129)
    assert got_t == got_j == {0: "shed"}


def test_port_modules_import_no_msgpack():
    """The runtime plane runs where msgpack is absent: no port module
    names it (the import scan of tests/test_torch_engine.py holds the
    rest)."""
    hits = [str(p) for p in (REPO / "dynamo_tpu_torch").rglob("*.py")
            if "import msgpack" in p.read_text()]
    assert not hits, hits
    assert os.path.exists(REPO / "dynamo_tpu_torch" / "runtime" / "transports" / "wire.py")
