"""The port's G4 peer tier (dynamo_tpu_torch/block_manager/peer.py and
remote.py, the engine's park and resume path) on the CPU.

The fourteen cases of tests/test_peer.py under their own names, on the
port's mocker and in-process runtime; then the port held to the JAX
package: with both packages' calibration constants set equal, the
pricing law's ``price`` agrees to 1e-12 relative and ``plan`` decides
the same over a seeded grid; ``layout_fingerprint``, ``_parents_first``
and ``PrefixHeat.hottest`` agree exactly; the blockset record and f32
block records are msgpack's bytes exactly (a bf16 record's ``dtype``
names the port's ``uint16`` host view — the one pinned difference); a
JAX and a port mocker pair park, pull and stream identically, with the
same kv_actual record and G4 counters. Two tiny-test TorchEngines keep
a greedy stream identical through a park, a pull and an onboard. And
tools/g4_bench.py's gates at a small size."""

import asyncio
import importlib
from types import SimpleNamespace

import msgpack
import numpy as np
import pytest
import torch

from dynamo_tpu.block_manager import KvLayoutConfig as JKvLayoutConfig
from dynamo_tpu.block_manager import peer as j_peer
from dynamo_tpu_torch.block_manager import (
    KvbmConfig,
    KvBlockManager,
    KvLayoutConfig,
)
from dynamo_tpu_torch.block_manager import peer as t_peer
from dynamo_tpu_torch.block_manager.peer import (
    PeerBlockClient,
    PeerBlockServer,
    PrefixHeat,
    Reannouncer,
    _parents_first,
    layout_fingerprint,
    preplace,
    request_reannounce,
)
from dynamo_tpu_torch.block_manager.quant import pack_block
from dynamo_tpu_torch.engine.config import EngineConfig
from dynamo_tpu_torch.llm.kv_router.protocols import KvCacheEventData
from dynamo_tpu_torch.models.config import ModelConfig
from dynamo_tpu_torch.planner import calibration
from dynamo_tpu_torch.runtime.distributed import DistributedRuntime
from dynamo_tpu_torch.runtime.transports import wire
from dynamo_tpu_torch.utils.faults import FAULTS

pytestmark = pytest.mark.anyio

LAYOUT_F32 = KvLayoutConfig(
    num_layers=2, page_size=16, num_kv_heads=2, head_dim=16, dtype="float32"
)
LAYOUT_INT8 = KvLayoutConfig(
    num_layers=2, page_size=16, num_kv_heads=2, head_dim=16,
    dtype="bfloat16", quant="int8",
)


def _row_f32(seed: float) -> np.ndarray:
    return np.full((LAYOUT_F32.block_elems,), seed, np.float32)


def _packed_row(seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    q = rng.integers(
        -127, 128,
        (LAYOUT_INT8.num_layers, 2, LAYOUT_INT8.page_size,
         LAYOUT_INT8.num_kv_heads, LAYOUT_INT8.head_dim),
        dtype=np.int8,
    )
    scales = np.float32(rng.uniform(
        0.01, 1.0, (LAYOUT_INT8.num_layers, 2, LAYOUT_INT8.num_kv_heads)
    ))
    return pack_block(q, scales, LAYOUT_INT8)


async def _settle(mgr, n, timeout=5.0):
    deadline = asyncio.get_running_loop().time() + timeout
    while mgr.stats()["host_registered"] < n:
        assert asyncio.get_running_loop().time() < deadline, (
            f"host tier never reached {n} blocks: {mgr.stats()}"
        )
        await asyncio.sleep(0.02)


def _stub_client(layout=LAYOUT_F32, cls=PeerBlockClient):
    """A PeerBlockClient with stubbed transports — enough for the pricing
    law, which reads only _blocksets/_peer_bps."""
    drt = SimpleNamespace(primary_lease_id=0xAA)
    comp = SimpleNamespace(namespace=SimpleNamespace(name="kv"), name="torch")
    return cls(drt, comp, layout, layout_cfg=layout)


# ---------------------------------------------------------------------------
# pricing law
# ---------------------------------------------------------------------------


def test_slow_link_loses_to_recompute():
    """A peer behind a slow advertised link LOSES the pricing race: plan()
    returns None and the request recomputes locally."""
    client = _stub_client()
    hashes = [1, 2, 3, 4]
    client._blocksets["bb"] = set(hashes)

    # The calibrated channel: the pull wins easily.
    pull_s, recompute_s = client.price(4, "bb")
    assert pull_s < recompute_s
    assert client.plan(hashes) == ("bb", 4)

    # The same peer advertising a crawling 1 MB/s link reprices every pull
    # above local recompute.
    client._peer_bps["bb"] = 1e6
    pull_s, recompute_s = client.price(4, "bb")
    assert pull_s > recompute_s
    assert client.plan(hashes) is None

    # A measured pull EMA (ground truth) overrides the advertisement.
    client._pull_rate.note(int(20e9), 1.0)
    assert client.effective_bps("bb") > 1e9
    assert client.plan(hashes) == ("bb", 4)


def test_price_fallback_is_the_calibrated_channel():
    """With no measured EMA and no advertisement, pricing uses the one
    calibrated constant (the H100 record's pinned host→device rate)."""
    client = _stub_client()
    assert client.effective_bps("nobody") == calibration.HANDOFF_GBPS * 1e9


def test_prefill_tps_moves_the_recompute_side():
    """A very fast live prefill EMA flips the decision to recompute even
    over the calibrated link."""
    client = _stub_client()
    client._blocksets["bb"] = {1, 2}
    assert client.plan([1, 2]) is not None
    assert client.plan([1, 2], prefill_tps=1e9) is None


# ---------------------------------------------------------------------------
# pull chain: byte identity + layout refusal
# ---------------------------------------------------------------------------


async def _peer_pair(main, layout, rows):
    """Worker A (seeded with `rows`) serving worker B; returns
    (mgr_a, mgr_b, server, client, drts)."""
    drt_a = await DistributedRuntime.in_process(store=main.store, bus=main.bus)
    drt_b = await DistributedRuntime.in_process(store=main.store, bus=main.bus)
    mgr_a = await KvBlockManager(KvbmConfig(layout=layout, host_blocks=16)).start()
    mgr_b = await KvBlockManager(KvbmConfig(layout=layout, host_blocks=16)).start()
    parent = None
    for i, (h, data) in enumerate(rows):
        mgr_a.offer(h, parent, [i] * 4, data)
        parent = h
    await _settle(mgr_a, len(rows))
    comp_a = drt_a.namespace("kv").component("torch")
    server = await PeerBlockServer(
        drt_a, comp_a, mgr_a, layout=layout, refresh_s=0.05
    ).start()
    comp_b = drt_b.namespace("kv").component("torch")
    client = await PeerBlockClient(drt_b, comp_b, layout, layout_cfg=layout).start()
    return mgr_a, mgr_b, server, client, (drt_a, drt_b)


async def _teardown(main, client, server, mgrs, drts):
    await client.stop()
    await server.stop()
    for m in mgrs:
        await m.stop()
    for d in drts:
        await d.shutdown()
    await main.shutdown()


async def _await_discovery(client, hashes, n, timeout=5.0):
    deadline = asyncio.get_running_loop().time() + timeout
    while client.best_peer(hashes)[1] < n:
        assert asyncio.get_running_loop().time() < deadline, (
            f"blockset never discovered: {client._blocksets}"
        )
        await asyncio.sleep(0.05)


async def test_pull_chain_byte_identity_int8_packed():
    """Packed int8 rows arrive in B's host tier BIT-EXACT — the pull chain
    is a byte mover, never a repack."""
    main = await DistributedRuntime.in_process()
    rows = [(100, _packed_row(1)), (200, _packed_row(2)), (300, _packed_row(3))]
    mgr_a, mgr_b, server, client, drts = await _peer_pair(main, LAYOUT_INT8, rows)
    try:
        hashes = [100, 200, 300]
        await _await_discovery(client, hashes, 3)
        assert await client.pull_into(mgr_b, hashes) == 3
        got = {h: d for h, _p, _t, d in mgr_b.match_host(hashes)}
        for h, want in rows:
            np.testing.assert_array_equal(
                np.asarray(got[h]).view(np.uint8), np.asarray(want).view(np.uint8)
            )
        # G4-origin attribution + telemetry.
        assert mgr_b.count_peer_origin(hashes) == 3
        st = client.stats()
        assert st["g4_pulls_total"] == 1
        assert st["g4_pull_bytes_total"] == 3 * LAYOUT_INT8.block_bytes
        assert st["link_peer_bps"] > 0
        # A re-pull is a no-op (already host-resident).
        assert await client.pull_into(mgr_b, hashes) == 0
    finally:
        await _teardown(main, client, server, (mgr_a, mgr_b), drts)


async def test_pull_chain_byte_identity_f32():
    """Full-precision rows transfer raw and land byte-identical."""
    main = await DistributedRuntime.in_process()
    rows = [(10, _row_f32(1.5)), (20, _row_f32(2.5))]
    mgr_a, mgr_b, server, client, drts = await _peer_pair(main, LAYOUT_F32, rows)
    try:
        await _await_discovery(client, [10, 20], 2)
        assert await client.pull_into(mgr_b, [10, 20]) == 2
        got = {h: d for h, _p, _t, d in mgr_b.match_host([10, 20])}
        np.testing.assert_array_equal(np.asarray(got[10]).view(np.float32), _row_f32(1.5))
        np.testing.assert_array_equal(np.asarray(got[20]).view(np.float32), _row_f32(2.5))
    finally:
        await _teardown(main, client, server, (mgr_a, mgr_b), drts)


async def test_mixed_precision_peer_refused():
    """An int8-packing peer is REFUSED by an f32 client — blocks are never
    silently reinterpreted across precisions."""
    main = await DistributedRuntime.in_process()
    drt_a = await DistributedRuntime.in_process(store=main.store, bus=main.bus)
    drt_b = await DistributedRuntime.in_process(store=main.store, bus=main.bus)
    mgr_a = await KvBlockManager(KvbmConfig(layout=LAYOUT_INT8, host_blocks=8)).start()
    mgr_a.offer(100, None, [0] * 4, _packed_row(1))
    await _settle(mgr_a, 1)
    server = await PeerBlockServer(
        drt_a, drt_a.namespace("kv").component("torch"), mgr_a,
        layout=LAYOUT_INT8, refresh_s=0.05,
    ).start()
    client = await PeerBlockClient(
        drt_b, drt_b.namespace("kv").component("torch"), LAYOUT_F32,
        layout_cfg=LAYOUT_F32,
    ).start()
    try:
        assert layout_fingerprint(LAYOUT_INT8) != layout_fingerprint(LAYOUT_F32)
        # Give the watch time to deliver the (refused) blockset.
        await asyncio.sleep(0.3)
        assert client.best_peer([100]) == (None, 0)
        assert client.plan([100]) is None
        # A refused peer does not linger in the pricing table either.
        assert client._peer_bps == {}
    finally:
        await _teardown(main, client, server, (mgr_a,), (drt_a, drt_b))


async def test_peer_death_mid_pull_degrades_to_recompute():
    """An armed kvbm.peer_pull partition (the peer dying mid-transfer,
    past the retry budget) costs the pull — counted in
    g4_pull_fallbacks_total — and returns 0, never hangs or raises."""
    main = await DistributedRuntime.in_process()
    rows = [(100, _row_f32(1.0)), (200, _row_f32(2.0))]
    mgr_a, mgr_b, server, client, drts = await _peer_pair(main, LAYOUT_F32, rows)
    try:
        await _await_discovery(client, [100, 200], 2)
        FAULTS.arm("kvbm.peer_pull", "partition")
        try:
            n = await asyncio.wait_for(client.pull_into(mgr_b, [100, 200]), timeout=30)
        finally:
            FAULTS.disarm("kvbm.peer_pull")
        assert n == 0
        assert client.stats()["g4_pull_fallbacks_total"] == 1
        assert mgr_b.stats()["host_registered"] == 0
        # The tier heals: with the fault gone the same pull lands.
        assert await client.pull_into(mgr_b, [100, 200]) == 2
    finally:
        await _teardown(main, client, server, (mgr_a, mgr_b), drts)


# ---------------------------------------------------------------------------
# re-announce protocol
# ---------------------------------------------------------------------------


def test_parents_first_orders_chains():
    entries = [(300, 200, (3,)), (100, None, (1,)), (200, 100, (2,)),
               (500, 999, (5,))]  # 500's parent was evicted -> root
    out = _parents_first(entries)
    assert len(out) == 4
    pos = {h: i for i, (h, _p, _t) in enumerate(out)}
    assert pos[100] < pos[200] < pos[300]
    assert 500 in pos


async def test_reannounce_trigger_and_event_order():
    """A broadcast on the re-announce plane makes the worker republish
    every resident block as idempotent stored events, parents first."""
    main = await DistributedRuntime.in_process()
    comp = main.namespace("kv").component("torch")
    published: list[KvCacheEventData] = []
    publisher = SimpleNamespace(publish=published.append)
    entries = [(300, 200, (3,)), (100, None, (1,)), (200, 100, (2,))]
    ann = await Reannouncer(
        main, comp, publisher, lambda: list(entries), interval_s=3600
    ).start()
    try:
        await request_reannounce(main, comp)
        deadline = asyncio.get_running_loop().time() + 5
        while ann.announces_total < 1:
            assert asyncio.get_running_loop().time() < deadline
            await asyncio.sleep(0.02)
        assert [e.block_hashes[0] for e in published] == [100, 200, 300]
        assert all(e.kind == "stored" for e in published)
        assert published[1].parent_hash == 100
    finally:
        await ann.stop()
        await main.shutdown()


async def test_reannounce_rebuilds_rejoined_radix_view():
    """A radix view that missed the original stored events (a replica
    that rejoined afterwards) converges after one announce round: the
    per-block events, parents first, link the whole chain under the
    worker."""
    from dynamo_tpu_torch.llm.kv_router.indexer import RadixTree

    tree = RadixTree()
    published: list[KvCacheEventData] = []
    publisher = SimpleNamespace(publish=published.append)
    entries = [(300, 200, (3,)), (100, None, (1,)), (200, 100, (2,))]
    ann = Reannouncer(
        SimpleNamespace(), SimpleNamespace(event_subject=lambda s: s),
        publisher, lambda: list(entries),
    )
    ann.announce()
    for ev in published:
        tree.apply_event(7, ev)
    assert tree.find_matches([100, 200, 300]).get(7) == 3
    # Idempotent: a second full announce changes nothing.
    published.clear()
    ann.announce()
    for ev in published:
        tree.apply_event(7, ev)
    assert tree.find_matches([100, 200, 300]).get(7) == 3


# ---------------------------------------------------------------------------
# prefix heat + pre-placement
# ---------------------------------------------------------------------------


def test_prefix_heat_ranks_and_decays():
    heat = PrefixHeat(max_prefixes=4, decay=0.9)
    for _ in range(5):
        heat.note([1, 2, 3])
    heat.note([9])
    top = heat.hottest(2)
    assert top[0] == [1, 2, 3]
    # The longest chain per prefix wins; heat accumulates on the leading hash.
    heat.note([1, 2, 3, 4])
    assert heat.hottest(1)[0] == [1, 2, 3, 4]
    # Bounded: the coldest prefixes are evicted once the table is full.
    for h in (20, 30, 40, 50):
        heat.note([h], weight=10.0)
    assert len(heat.hottest(10)) <= 4


async def test_preplace_pushes_hottest_chains():
    """Pre-placement force-pulls the hottest chains into a joining
    worker's host tier BEFORE it takes traffic — no pricing gate."""
    main = await DistributedRuntime.in_process()
    rows = [(100, _row_f32(1.0)), (200, _row_f32(2.0)), (300, _row_f32(3.0))]
    mgr_a, mgr_b, server, client, drts = await _peer_pair(main, LAYOUT_F32, rows)
    try:
        await _await_discovery(client, [100, 200, 300], 3)
        heat = PrefixHeat()
        heat.note([100, 200, 300])
        heat.note([100, 200, 300])
        heat.note([777])  # nobody holds this one; preplace skips it
        assert await preplace(client, mgr_b, heat) == 3
        assert mgr_b.count_peer_origin([100, 200, 300]) == 3
    finally:
        await _teardown(main, client, server, (mgr_a, mgr_b), drts)


# ---------------------------------------------------------------------------
# engine park/resume: the admission hook (run on either package's mocker)
# ---------------------------------------------------------------------------

_PORT = "dynamo_tpu_torch"
_JAX = "dynamo_tpu"


def _pkg(root: str) -> SimpleNamespace:
    """The modules a mocker G4 scenario needs, from one package."""
    def mod(name):
        return importlib.import_module(f"{root}.{name}")

    return SimpleNamespace(
        bm=mod("block_manager"), peer=mod("block_manager.peer"),
        ecfg=mod("engine.config"), proto=mod("llm.protocols.common"),
        mocker=mod("mocker.engine"), models=mod("models.config"),
        drt=mod("runtime.distributed"), ctx=mod("runtime.engine"),
        faults=mod("utils.faults"),
    )


def _layout8(p):
    # block_elems == 8: the mocker runner's 8-float block rows.
    return p.bm.KvLayoutConfig(
        num_layers=1, page_size=1, num_kv_heads=1, head_dim=4, dtype="float32"
    )


def _ecfg(p, **kw):
    return p.ecfg.EngineConfig(
        model=p.models.ModelConfig.tiny_test(), num_blocks=64, max_num_seqs=4,
        max_model_len=256, dtype="float32", **kw,
    )


async def _generate(p, engine, prompt, n=4):
    req = p.proto.PreprocessedRequest(
        token_ids=list(prompt),
        sampling=p.proto.SamplingOptions(temperature=0.0),
        stop=p.proto.StopConditions(max_tokens=n, ignore_eos=True),
    )
    out = []
    async for item in engine.generate(p.ctx.Context(req.to_wire())):
        out += item.get("token_ids", [])
    return out


async def _warm_worker(p, main, prompt, seed=1):
    """A mocker worker that computed `prompt` and offloaded its blocks to
    the host tier, exported as a G4 peer."""
    drt = await p.drt.DistributedRuntime.in_process(store=main.store, bus=main.bus)
    kvbm = await p.bm.KvBlockManager(
        p.bm.KvbmConfig(layout=_layout8(p), host_blocks=32)
    ).start()
    eng = p.mocker.MockerEngine(
        _ecfg(p), p.mocker.MockerConfig(seed=seed, deterministic_tokens=True),
        block_manager=kvbm,
    )
    await eng.start()
    toks = await _generate(p, eng, prompt)
    deadline = asyncio.get_running_loop().time() + 5
    while kvbm.stats()["host_registered"] < 2:
        assert asyncio.get_running_loop().time() < deadline
        await asyncio.sleep(0.05)
    server = await p.peer.PeerBlockServer(
        drt, drt.namespace("kv").component("torch"), kvbm,
        layout=_layout8(p), refresh_s=0.05,
    ).start()
    return drt, kvbm, eng, server, toks


async def _park_scenario(p, timeout_s=None, fault=None) -> dict:
    """Warm worker A, cold worker B with a peer client (handshake on the
    mocker layout, priced at the calibrated default geometry: the 8-float
    sim rows are not real KV bytes); B serves the prompt A holds. With
    ``fault`` armed during B's request."""
    main = await p.drt.DistributedRuntime.in_process()
    prompt = list(range(40))  # 2 full blocks + tail
    drt_a, kvbm_a, eng_a, server, cold = await _warm_worker(p, main, prompt)
    drt_b = await p.drt.DistributedRuntime.in_process(store=main.store, bus=main.bus)
    kvbm_b = await p.bm.KvBlockManager(
        p.bm.KvbmConfig(layout=_layout8(p), host_blocks=32)
    ).start()
    client = await p.peer.PeerBlockClient(
        drt_b, drt_b.namespace("kv").component("torch"),
        p.peer.layout_fingerprint(_layout8(p)),
    ).start()
    await _await_discovery(client, list(kvbm_a.registered_hashes()), 1)
    kvbm_b.attach_peer_client(client)
    actuals: list[dict] = []
    kw = {} if timeout_s is None else {"kvbm_peer_timeout_s": timeout_s}
    eng_b = p.mocker.MockerEngine(
        _ecfg(p, **kw), p.mocker.MockerConfig(seed=2, deterministic_tokens=True),
        block_manager=kvbm_b, on_kv_actual=actuals.append,
    )
    await eng_b.start()
    if fault is not None:
        p.faults.FAULTS.arm("kvbm.peer_pull", **fault)
    try:
        warm = await asyncio.wait_for(_generate(p, eng_b, prompt), timeout=30)
        rd = eng_b.readiness()
        return {"cold": cold, "warm": warm, "actuals": actuals, "readiness": rd,
                "degraded": eng_b.degraded_requests}
    finally:
        p.faults.FAULTS.disarm("kvbm.peer_pull")
        await eng_b.stop()
        try:
            await kvbm_b.drain_pulls(timeout_s=10)
        except TimeoutError:
            pass
        await client.stop()
        await kvbm_b.stop()
        await server.stop()
        await eng_a.stop()
        await kvbm_a.stop()
        for d in (drt_a, drt_b):
            await d.shutdown()
        await main.shutdown()


async def test_engine_parks_for_peer_pull_and_reuses_g4():
    """Cold engine B misses G1/G2/G3 but a fleet peer announced the
    prompt's blocks: admission parks the request on the pull, the rows
    land in G2, and the actual-reuse split attributes them to the PEER
    tier on every metric surface."""
    r = await _park_scenario(_pkg(_PORT))
    # Determinism across the tier: the same greedy stream either way.
    assert r["warm"] == r["cold"]
    assert len(r["actuals"]) == 1
    rec = r["actuals"][0]
    assert rec["peer_blocks"] == 2, rec
    assert rec["host_blocks"] == 0 and rec["disk_blocks"] == 0
    rd = r["readiness"]
    assert rd["kv_reused_peer_blocks_total"] == 2
    assert rd["kvbm_g4_pulls_total"] == 1
    assert rd["kvbm_g4_pull_bytes_total"] > 0
    assert rd["kvbm_g4_pull_fallbacks_total"] == 0
    assert rd["kvbm_link_peer_bps"] > 0
    assert r["degraded"] == 0


async def test_engine_peer_timeout_degrades_not_hangs():
    """A pull stuck past kvbm_peer_timeout_s (the delay-armed peer seam)
    does NOT stall the request: it resumes by local recompute, counted
    degraded, with the fallback on the G4 counters."""
    r = await _park_scenario(
        _pkg(_PORT), timeout_s=0.2,
        fault={"action": "delay", "times": None, "delay_s": 2.0},
    )
    assert r["warm"] == r["cold"]  # recompute produced the same stream
    assert r["degraded"] == 1
    assert r["readiness"]["kvbm_g4_pull_fallbacks_total"] >= 1
    assert r["readiness"]["kv_reused_peer_blocks_total"] == 0


# ---------------------------------------------------------------------------
# parity with the JAX package
# ---------------------------------------------------------------------------

_CAL = {"HANDOFF_GBPS": 37.5, "HANDOFF_FIXED_US": 250.0,
        "KV_BYTES_PER_TOKEN": 32768, "PREFILL_TIME_PER_TOKEN_US": 20.0}


@pytest.fixture
def equal_constants(monkeypatch):
    """Both packages' pricing constants set to the same values."""
    for name, value in _CAL.items():
        # The port's constants resolve through the module's __getattr__:
        # a dict entry shadows it and goes again on undo.
        monkeypatch.setitem(vars(calibration), name, value)
        monkeypatch.setattr(j_peer, name, value)


def _pair_clients(layout_args):
    t_layout = KvLayoutConfig(**layout_args) if layout_args else None
    j_layout = JKvLayoutConfig(**layout_args) if layout_args else None
    return (_stub_client(t_layout, t_peer.PeerBlockClient),
            _stub_client(j_layout, j_peer.PeerBlockClient))


@pytest.mark.parametrize("layout_args", [
    None,
    dict(num_layers=16, page_size=16, num_kv_heads=8, head_dim=64, dtype="bfloat16"),
    dict(num_layers=2, page_size=16, num_kv_heads=2, head_dim=16, dtype="bfloat16",
         quant="int8"),
], ids=["bare", "llama3.2-1b-bf16", "tiny-int8"])
def test_price_and_plan_match_the_jax_package(equal_constants, layout_args):
    """Over a seeded grid of (n_blocks, advertised bps, measured EMA,
    prefill_tps): ``price`` equal to 1e-12 relative, ``plan`` equal."""
    rng = np.random.default_rng(12)
    chain = list(range(1, 257))
    decisions = set()
    for _ in range(200):
        t, j = _pair_clients(layout_args)
        n = int(rng.integers(1, 257))
        held = set(chain[:n])
        t._blocksets["bb"] = set(held)
        j._blocksets["bb"] = set(held)
        adv = 0.0 if rng.random() < 0.3 else float(10 ** rng.uniform(6, 11))
        t._peer_bps["bb"] = j._peer_bps["bb"] = adv
        for _k in range(int(rng.integers(0, 3))):
            nbytes, dt = int(rng.integers(1, 10 ** 9)), float(10 ** rng.uniform(-4, 0))
            t._pull_rate.note(nbytes, dt)
            j._pull_rate.note(nbytes, dt)
        tps = None if rng.random() < 0.3 else float(10 ** rng.uniform(3, 7))
        tp, jp = t.price(n, "bb", tps), j.price(n, "bb", tps)
        for a, b in zip(tp, jp):
            assert a == pytest.approx(b, rel=1e-12, abs=0.0)
        assert t.effective_bps("bb") == j.effective_bps("bb")
        plan = t.plan(chain, tps)
        assert plan == j.plan(chain, tps)
        decisions.add(plan is None)
    assert decisions == {True, False}  # the grid crosses the break-even


def test_layout_fingerprint_matches_the_jax_package():
    for args in (
        dict(num_layers=16, page_size=16, num_kv_heads=8, head_dim=64, dtype="bfloat16"),
        dict(num_layers=2, page_size=16, num_kv_heads=2, head_dim=16, dtype="float32"),
        dict(num_layers=2, page_size=4, num_kv_heads=2, head_dim=16, dtype="bfloat16",
             quant="int8"),
    ):
        assert layout_fingerprint(KvLayoutConfig(**args)) == j_peer.layout_fingerprint(
            JKvLayoutConfig(**args))


def _seeded_chains(seed: int) -> list[list[int]]:
    rng = np.random.default_rng(seed)
    return [[int(h) for h in rng.integers(1, 2 ** 63, int(rng.integers(1, 9)),
                                          dtype=np.int64)]
            for _ in range(12)]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_parents_first_and_prefix_heat_match_the_jax_package(seed):
    rng = np.random.default_rng(100 + seed)
    entries = []
    for chain in _seeded_chains(seed):
        parent = None if rng.random() < 0.7 else int(rng.integers(1, 2 ** 63))
        for h in chain:
            entries.append((h, parent, tuple(int(x) for x in rng.integers(0, 384, 4))))
            parent = h
    order = [int(i) for i in rng.permutation(len(entries))]
    shuffled = [entries[i] for i in order]
    assert _parents_first(shuffled) == j_peer._parents_first(shuffled)

    t_heat, j_heat = PrefixHeat(max_prefixes=6, decay=0.9), j_peer.PrefixHeat(
        max_prefixes=6, decay=0.9)
    chains = _seeded_chains(seed)
    for _ in range(60):
        chain = chains[int(rng.integers(0, len(chains)))]
        cut = chain[: int(rng.integers(1, len(chain) + 1))]
        w = float(rng.uniform(0.1, 3.0))
        t_heat.note(cut, weight=w)
        j_heat.note(cut, weight=w)
    for k in (1, 3, 6, 10):
        assert t_heat.hottest(k) == j_heat.hottest(k)


class _Store:
    def __init__(self):
        self.puts = []

    async def put(self, key, value, lease_id=None):
        self.puts.append((key, value))


def _stub_server(cls, layout, hashes, rows=()):
    drt = SimpleNamespace(primary_lease_id=0xAB, store=_Store())
    comp = SimpleNamespace(namespace=SimpleNamespace(name="kv"), name="torch")
    mgr = SimpleNamespace(registered_hashes=lambda: frozenset(hashes),
                          match_host=lambda hs: list(rows))
    return cls(drt, comp, mgr, layout=layout, refresh_s=1.0), drt


async def _served(server) -> list[dict]:
    return [rec async for rec in server.generate(SimpleNamespace(payload={"hashes": [1]}))]


async def test_blockset_and_block_records_are_msgpacks_bytes():
    """The blockset record and f32 block records: the port's wire.packb
    bytes equal msgpack.packb of the JAX package's records."""
    rng = np.random.default_rng(7)
    hashes = [int(h) for h in rng.integers(1, 2 ** 63, 40, dtype=np.int64)]
    args = dict(num_layers=2, page_size=16, num_kv_heads=2, head_dim=16, dtype="float32")
    t_srv, t_drt = _stub_server(t_peer.PeerBlockServer, KvLayoutConfig(**args), hashes)
    j_srv, j_drt = _stub_server(j_peer.PeerBlockServer, JKvLayoutConfig(**args), hashes)
    for srv in (t_srv, j_srv):
        srv._serve_rate.note(123_456_789, 0.0371)
    await t_srv._publish()
    await j_srv._publish()
    assert t_drt.store.puts == j_drt.store.puts and len(t_drt.store.puts) == 1
    assert wire.unpackb(t_drt.store.puts[0][1])["serve_bps"] > 0

    rows = []
    parent = None
    for i, h in enumerate(hashes[:4]):
        data = rng.standard_normal(LAYOUT_F32.block_elems).astype(np.float32)
        rows.append((h, parent, tuple(int(x) for x in rng.integers(0, 384, 16)), data))
        parent = h
    t_recs = await _served(_stub_server(t_peer.PeerBlockServer, None, [], rows)[0])
    j_recs = await _served(_stub_server(j_peer.PeerBlockServer, None, [], rows)[0])
    assert len(t_recs) == 4
    assert [wire.packb(r) for r in t_recs] == [msgpack.packb(r) for r in j_recs]


async def test_bf16_record_names_the_uint16_host_view():
    """The one pinned wire difference: the port's host arena holds bf16 as
    uint16 bits, so its record says ``uint16`` where the JAX package's
    says ``bfloat16``; every other byte is msgpack's."""
    import ml_dtypes

    rng = np.random.default_rng(8)
    bits = rng.integers(0, 2 ** 16, LAYOUT_F32.block_elems, dtype=np.uint16)
    row = (5, None, (1, 2, 3), bits)
    t_rec = (await _served(_stub_server(t_peer.PeerBlockServer, None, [], [row])[0]))[0]
    j_rec = (await _served(_stub_server(
        j_peer.PeerBlockServer, None, [], [(5, None, (1, 2, 3), bits.view(ml_dtypes.bfloat16))]
    )[0]))[0]
    assert t_rec["dtype"] == "uint16" and j_rec["dtype"] == "bfloat16"
    assert wire.packb({**t_rec, "dtype": "bfloat16"}) == msgpack.packb(j_rec)


_G4_KEYS = ("kv_reused_peer_blocks_total", "kvbm_g4_pulls_total",
            "kvbm_g4_pull_bytes_total", "kvbm_g4_pull_fallbacks_total")


@pytest.mark.parametrize("case", ["pull", "timeout"])
async def test_mocker_pairs_match_the_jax_package(equal_constants, case):
    """A JAX and a port mocker pair on the same prompt: the same streams,
    the same kv_actual record, the same G4 readiness counters (the pull
    rate is a timing: > 0 in both after a pull)."""
    kw = {} if case == "pull" else {
        "timeout_s": 0.2, "fault": {"action": "delay", "times": None, "delay_s": 1.0}}
    t = await _park_scenario(_pkg(_PORT), **kw)
    j = await _park_scenario(_pkg(_JAX), **kw)
    assert t["cold"] == j["cold"] and t["warm"] == j["warm"] == t["cold"]
    fields = ("isl_blocks", "device_blocks", "host_blocks", "disk_blocks", "peer_blocks")
    assert [{k: a[k] for k in fields} for a in t["actuals"]] == [
        {k: a[k] for k in fields} for a in j["actuals"]]
    assert {k: t["readiness"][k] for k in _G4_KEYS} == {k: j["readiness"][k] for k in _G4_KEYS}
    assert t["degraded"] == j["degraded"] == (0 if case == "pull" else 1)
    pulled = case == "pull"
    assert (t["readiness"]["kvbm_link_peer_bps"] > 0) == pulled
    assert (j["readiness"]["kvbm_link_peer_bps"] > 0) == pulled


# ---------------------------------------------------------------------------
# a real engine pair on the CPU
# ---------------------------------------------------------------------------


async def test_torch_engine_pair_streams_through_park_pull_onboard():
    """Two tiny-test TorchEngines on the CPU: A serves a prompt and offers
    it to G2, exported as a peer; cold B parks on the pull, onboards the
    rows and streams exactly A's greedy tokens — and a cold engine of B's
    configuration recomputing the prompt streams them too."""
    from dynamo_tpu_torch.engine.engine import TorchEngine
    from dynamo_tpu_torch.models import llama

    cfg = ModelConfig.tiny_test()
    params = llama.init_params(cfg, torch.Generator().manual_seed(3), dtype=torch.float32,
                               device="cpu")

    def ecfg():
        return EngineConfig(model=cfg, num_blocks=32, max_num_seqs=2, max_model_len=128,
                            dtype="float32", kvbm_adaptive_gate=False)

    layout = KvLayoutConfig.for_engine(ecfg(), quant=None)
    prompt = [int(t) for t in np.random.default_rng(4).integers(0, cfg.vocab_size, 56)]
    main = await DistributedRuntime.in_process()
    drt_a = await DistributedRuntime.in_process(store=main.store, bus=main.bus)
    drt_b = await DistributedRuntime.in_process(store=main.store, bus=main.bus)
    kvbm_a = await KvBlockManager(KvbmConfig(layout=layout, host_blocks=16)).start()
    kvbm_b = await KvBlockManager(KvbmConfig(layout=layout, host_blocks=16)).start()
    eng_a = TorchEngine(ecfg(), params=params, device="cpu", block_manager=kvbm_a)
    actuals: list[dict] = []
    eng_b = TorchEngine(ecfg(), params=params, device="cpu", block_manager=kvbm_b,
                        on_kv_actual=actuals.append)
    eng_c = TorchEngine(ecfg(), params=params, device="cpu")
    server = client = None
    try:
        for e in (eng_a, eng_b, eng_c):
            await e.start()
        a_stream = await _generate(_pkg(_PORT), eng_a, prompt, n=8)
        await kvbm_a.drain_offers()
        server = await PeerBlockServer(
            drt_a, drt_a.namespace("kv").component("torch"), kvbm_a, layout=layout,
            refresh_s=0.05).start()
        client = await PeerBlockClient(
            drt_b, drt_b.namespace("kv").component("torch"), layout).start()
        hashes = sorted(kvbm_a.registered_hashes())
        await _await_discovery(client, hashes, 1)
        kvbm_b.attach_peer_client(client)
        b_stream = await _generate(_pkg(_PORT), eng_b, prompt, n=8)
        c_stream = await _generate(_pkg(_PORT), eng_c, prompt, n=8)
        assert b_stream == a_stream == c_stream
        want = (len(prompt) - 1) // 16
        assert actuals[0]["peer_blocks"] == want
        rd = eng_b.readiness()
        assert rd["kv_reused_peer_blocks_total"] == want
        assert rd["kvbm_g4_pulls_total"] == 1 and rd["kvbm_g4_pull_fallbacks_total"] == 0
        assert rd["kvbm_g4_pull_bytes_total"] == want * layout.block_bytes
        assert eng_b.degraded_requests == 0
    finally:
        for e in (eng_a, eng_b, eng_c):
            await e.stop()
        if client is not None:
            await client.stop()
        if server is not None:
            await server.stop()
        for k in (kvbm_a, kvbm_b):
            await k.stop()
        for d in (drt_a, drt_b):
            await d.shutdown()
        await main.shutdown()


# ---------------------------------------------------------------------------
# tools/g4_bench.py
# ---------------------------------------------------------------------------


async def test_g4_bench_gates_at_a_small_seed():
    """The tool's three legs at a small seed, under a time limit of their
    own: every gate of run_gates holds."""
    from dynamo_tpu_torch.tools import g4_bench

    report = await asyncio.wait_for(g4_bench.run_g4(seed=7), timeout=60)
    assert g4_bench.run_gates(report) == [], report
