"""The port's KVBM (dynamo_tpu_torch/block_manager) and block IO
(dynamo_tpu_torch/ops/kv_copy.py, the runner's gather/scatter) on the
CPU: the cases of tests/test_block_manager.py on port objects, held against
the JAX package where both have the piece — the block gather bit for
bit, the packed int8 rows byte for byte, and the G2 rows two engines
offer for the same prompts byte for byte with equal CRCs. Tiny-test in
float32, weights carried across with ``params_from_jax``. Block bytes
are compared exactly; streams token for token."""

import asyncio
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.block_manager import KvBlockManager as JKvBlockManager
from dynamo_tpu.block_manager import KvbmConfig as JKvbmConfig
from dynamo_tpu.block_manager import KvLayoutConfig as JKvLayoutConfig
from dynamo_tpu.block_manager import quant as j_bq
from dynamo_tpu.engine.config import EngineConfig as JEngineConfig
from dynamo_tpu.engine.engine import TpuEngine
from dynamo_tpu.llm.protocols import common as j_proto
from dynamo_tpu.models import llama as j_llama
from dynamo_tpu.models.config import ModelConfig as JCfg
from dynamo_tpu.ops import kv_copy as j_kv_copy
from dynamo_tpu.runtime.engine import Context as JContext
from dynamo_tpu_torch.block_manager import (
    BlockPool,
    HostStorage,
    KvbmConfig,
    KvBlockManager,
    KvLayoutConfig,
)
from dynamo_tpu_torch.block_manager import quant as bq
from dynamo_tpu_torch.block_manager.integrity import block_checksum
from dynamo_tpu_torch.block_manager.offload import OffloadManager
from dynamo_tpu_torch.block_manager.pool import BlockState
from dynamo_tpu_torch.block_manager.storage import DiskStorage
from dynamo_tpu_torch.engine.config import EngineConfig
from dynamo_tpu_torch.engine.engine import TorchEngine
from dynamo_tpu_torch.engine.runner import ModelRunner
from dynamo_tpu_torch.llm.protocols import common as t_proto
from dynamo_tpu_torch.models import llama as t_llama
from dynamo_tpu_torch.models.config import ModelConfig
from dynamo_tpu_torch.ops import kv_copy
from dynamo_tpu_torch.runtime.engine import Context

pytestmark = pytest.mark.anyio

LAYOUT = KvLayoutConfig(
    num_layers=2, page_size=16, num_kv_heads=2, head_dim=16, dtype="float32"
)
JAX_CFG = JCfg.tiny_test()
PARAMS = j_llama.init_params(jax.random.PRNGKey(0), JAX_CFG, dtype=jnp.float32)
TPARAMS = t_llama.params_from_jax(jax.tree.map(np.asarray, PARAMS), device="cpu")
MCFG = ModelConfig.tiny_test()


def _data(seed: float) -> np.ndarray:
    return np.full((LAYOUT.block_elems,), seed, np.float32)


def _ecfg(**kw) -> EngineConfig:
    return EngineConfig(model=MCFG, num_blocks=32, max_num_seqs=2,
                        max_model_len=128, dtype="float32", **kw)


def _layout(quant=None) -> KvLayoutConfig:
    return KvLayoutConfig.for_engine(_ecfg(), quant=quant)


def _engine(kvbm, **kw) -> TorchEngine:
    return TorchEngine(_ecfg(**kw), params=TPARAMS, device="cpu", block_manager=kvbm)


async def _generate(engine, prompt, max_tokens=6, proto=t_proto, ctx=Context):
    req = proto.PreprocessedRequest(
        token_ids=prompt,
        sampling=proto.SamplingOptions(temperature=0.0),
        stop=proto.StopConditions(max_tokens=max_tokens, ignore_eos=True),
    )
    toks = []
    async for item in engine.generate(ctx(req.to_wire())):
        toks += item["token_ids"]
    return toks


class TestBlockPool:
    def test_lifecycle(self):
        events = []
        pool = BlockPool(HostStorage(4, LAYOUT), on_event=events.append)
        blocks = pool.allocate_blocks(2)
        assert all(b.state is BlockState.PARTIAL for b in blocks)
        pool.storage.write_block(blocks[0].idx, _data(1.0))
        b0 = pool.register_block(blocks[0], sequence_hash=100, tokens=range(16))
        assert b0.state is BlockState.REGISTERED
        assert events[-1].kind == "stored" and events[-1].block_hashes == [100]

        pool.release(b0)        # registered -> inactive, still discoverable
        assert pool.num_free == 3
        hit = pool.match_sequence_hashes([100])
        assert len(hit) == 1 and hit[0].idx == b0.idx
        assert np.array_equal(pool.storage.read_block(hit[0].idx), _data(1.0))
        pool.release(hit[0])

        pool.release(blocks[1])  # unregistered -> free
        assert pool.num_free == 4

    def test_register_dedup(self):
        pool = BlockPool(HostStorage(4, LAYOUT))
        a, b = pool.allocate_blocks(2)
        a = pool.register_block(a, 7)
        b2 = pool.register_block(b, 7)
        assert b2.idx == a.idx and b2.ref == 2  # duplicate released, canon ref'd

    def test_lru_eviction_emits_removed(self):
        events = []
        pool = BlockPool(HostStorage(2, LAYOUT), on_event=events.append)
        a, b = pool.allocate_blocks(2)
        pool.release(pool.register_block(a, 1))
        pool.release(pool.register_block(b, 2))
        c = pool.allocate_blocks(1)[0]  # evicts LRU (hash 1)
        assert c.idx == a.idx
        removed = [e for e in events if e.kind == "removed"]
        assert removed and removed[-1].block_hashes == [1]
        assert pool.get_by_hash(1) is None and pool.get_by_hash(2) is not None

    def test_allocate_overflow(self):
        pool = BlockPool(HostStorage(2, LAYOUT))
        pool.allocate_blocks(2)
        with pytest.raises(MemoryError):
            pool.allocate_blocks(1)


async def test_offload_onboard_roundtrip(tmp_path):
    host = BlockPool(HostStorage(4, LAYOUT))
    disk = BlockPool(DiskStorage(4, LAYOUT, tmp_path / "kv.bin"))
    mgr = OffloadManager(host, disk)

    blocks = host.allocate_blocks(2)
    host.storage.write_block(blocks[0].idx, _data(3.0))
    host.storage.write_block(blocks[1].idx, _data(4.0))
    b0 = host.register_block(blocks[0], 10, None, range(16))
    b1 = host.register_block(blocks[1], 11, 10, range(16, 32))
    mgr.offload(b0)
    mgr.offload(b1)
    await mgr.drain()
    assert disk.num_registered == 2
    assert np.array_equal(
        disk.storage.read_block(disk.get_by_hash(10).idx).view(np.float32),
        _data(3.0),
    )

    host.release(b0)
    host.release(b1)
    host.allocate_blocks(4)  # forces eviction of both registered blocks
    assert host.num_registered == 0
    host2 = BlockPool(HostStorage(4, LAYOUT))
    mgr2 = OffloadManager(host2, disk)
    up = await mgr2.onboard([10, 11])
    assert [b.sequence_hash for b in up] == [10, 11]
    assert np.array_equal(
        host2.storage.read_block(up[0].idx).view(np.float32), _data(3.0)
    )


async def test_offload_drain_is_bounded():
    """A store wedged in its thread makes ``drain`` raise after its bound
    instead of waiting forever; a finished task whose done callback never
    ran (its loop stopped) leaves the set at the next drain."""
    host = BlockPool(HostStorage(4, LAYOUT))
    dst = BlockPool(HostStorage(4, LAYOUT))
    mgr = OffloadManager(host, dst)
    gate = asyncio.Event()

    async def wedged():
        await gate.wait()

    task = asyncio.ensure_future(wedged())
    mgr._tasks.add(task)
    with pytest.raises(TimeoutError):
        await mgr.drain(timeout_s=0.05)
    gate.set()
    await task
    stale = asyncio.get_running_loop().create_future()
    stale.set_result(None)
    mgr._tasks.add(stale)  # done, never discarded by a callback
    await asyncio.wait_for(mgr.drain(timeout_s=1.0), 2.0)
    assert not mgr._tasks


async def test_g4_remote_blockset_export_import():
    """Two workers (own runtimes, one shared control plane): worker A
    exports its host-tier blockset; worker B discovers it, fetches the
    blocks over the request plane byte for byte, and lands them in its
    own host tier; a dead exporter's blockset vanishes with its lease."""
    from dynamo_tpu_torch.block_manager.remote import (
        RemoteBlockClient,
        RemoteBlockServer,
    )
    from dynamo_tpu_torch.runtime.distributed import DistributedRuntime

    main = await DistributedRuntime.in_process()
    drt_a = await DistributedRuntime.in_process(store=main.store, bus=main.bus)
    drt_b = await DistributedRuntime.in_process(store=main.store, bus=main.bus)
    layout = {"head_dim": 16, "dtype": "float32"}
    mgr_a = await KvBlockManager(KvbmConfig(layout=LAYOUT, host_blocks=8)).start()
    mgr_b = await KvBlockManager(KvbmConfig(layout=LAYOUT, host_blocks=8)).start()

    # A holds a 3-block chain.
    for i, (h, parent) in enumerate([(100, None), (200, 100), (300, 200)]):
        mgr_a.offer(h, parent, [i] * 4, _data(float(i + 1)))
    await mgr_a.drain_offers()
    assert mgr_a.stats()["host_registered"] == 3

    server = await RemoteBlockServer(
        drt_a, drt_a.namespace("kv").component("torch"), mgr_a, layout=layout,
        refresh_s=0.05).start()
    client = await RemoteBlockClient(
        drt_b, drt_b.namespace("kv").component("torch"), layout=layout).start()

    hashes = [100, 200, 300, 999]
    deadline = asyncio.get_running_loop().time() + 5
    while client.best_peer(hashes)[1] < 3:
        assert asyncio.get_running_loop().time() < deadline, client._blocksets
        await asyncio.sleep(0.05)

    # A direct fetch: byte fidelity.
    wid, n = client.best_peer(hashes)
    assert n == 3
    blocks = await client.fetch(wid, hashes[:n])
    assert [b[0] for b in blocks] == [100, 200, 300]
    assert [b[1] for b in blocks] == [None, 100, 200]
    np.testing.assert_array_equal(blocks[1][3], _data(2.0))

    # The import path: B's host tier gains the prefix; a re-import is a no-op.
    assert await client.onboard_into(mgr_b, hashes) == 3
    await mgr_b.drain_offers()
    got = mgr_b.match_host([100, 200, 300])
    assert [g[0] for g in got] == [100, 200, 300]
    np.testing.assert_array_equal(got[2][3], _data(3.0))
    assert await client.onboard_into(mgr_b, [100, 200, 300]) == 0

    # A dead exporter's blockset vanishes with its lease.
    await server.stop()
    await drt_a.shutdown()
    deadline = asyncio.get_running_loop().time() + 10
    while client.best_peer([100])[0] is not None:
        assert asyncio.get_running_loop().time() < deadline, (
            "dead worker's blockset never expired")
        await asyncio.sleep(0.1)

    await client.stop()
    await mgr_a.stop()
    await mgr_b.stop()
    await drt_b.shutdown()
    await main.shutdown()


async def test_cross_engine_prefix_restore_via_host_tier():
    """Engine A prefilling a prompt offloads its blocks to the host tier;
    a FRESH engine B (cold cache, same weights) must onboard them, report
    a prefix hit, and produce the identical greedy continuation — which
    is the JAX engine's too."""
    kvbm = await KvBlockManager(KvbmConfig(layout=_layout(), host_blocks=16)).start()
    eng_a = _engine(kvbm)
    await eng_a.start()
    prompt = list(range(40))  # 2 full blocks + tail
    cold = await _generate(eng_a, prompt)
    await kvbm.drain_offers()
    assert kvbm.stats()["host_registered"] == 2
    await eng_a.stop()

    eng_b = _engine(kvbm)
    await eng_b.start()
    warm = await _generate(eng_b, prompt)
    assert warm == cold
    assert eng_b.prefix_hit_rate > 0.0
    await eng_b.stop()
    await kvbm.stop()

    jeng = TpuEngine(JEngineConfig(model=JAX_CFG, num_blocks=32, max_num_seqs=2,
                                   max_model_len=128, dtype="float32"), params=PARAMS)
    await jeng.start()
    assert await _generate(jeng, prompt, proto=j_proto, ctx=JContext) == cold
    await jeng.stop()


def test_batched_gather_scatter_matches_per_block_and_the_jax_gather():
    """The port's batched gather equals the JAX package's
    ``gather_blocks`` on the same cache contents bit for bit (float32 and
    bfloat16, the latter as its uint16 bits); a batched scatter equals
    per-block scatters and leaves every other block untouched."""
    rng = np.random.default_rng(0)
    L, blocks, bs, H, D = 2, 8, 4, 2, 8
    host = [(rng.standard_normal((blocks * bs, H, D)).astype(np.float32),
             rng.standard_normal((blocks * bs, H, D)).astype(np.float32))
            for _ in range(L)]
    idxs = [3, 5, 1]
    for tdt, jdt in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        caches = [(torch.from_numpy(k).to(tdt), torch.from_numpy(v).to(tdt))
                  for k, v in host]
        jcaches = [(jnp.asarray(k, jdt), jnp.asarray(v, jdt)) for k, v in host]
        got = kv_copy.gather_blocks(caches, idxs, bs)
        want = np.asarray(j_kv_copy.gather_blocks(jcaches, idxs, bs))
        assert got.shape == want.shape == (3, L, 2, bs, H, D)
        assert got.dtype == kv_copy.host_dtype(tdt)
        np.testing.assert_array_equal(got, want.view(got.dtype))

    caches = [(torch.from_numpy(k.copy()), torch.from_numpy(v.copy())) for k, v in host]
    data = rng.standard_normal((3, L, 2, bs, H, D)).astype(np.float32)
    kv_copy.scatter_blocks(caches, idxs, bs, data)
    seq = [(torch.from_numpy(k.copy()), torch.from_numpy(v.copy())) for k, v in host]
    for i, b in enumerate(idxs):
        kv_copy.scatter_blocks(seq, [b], bs, data[i : i + 1])
    for li in range(L):
        for j in range(2):
            assert torch.equal(caches[li][j], seq[li][j])
    np.testing.assert_array_equal(kv_copy.gather_blocks(caches, idxs, bs), data)
    for b in (b for b in range(blocks) if b not in idxs):
        np.testing.assert_array_equal(
            caches[0][0][b * bs : (b + 1) * bs].numpy(), host[0][0][b * bs : (b + 1) * bs])


@pytest.mark.parametrize("kv_quant", [None, "int8"])
def test_runner_scatters_write_in_place(kv_quant):
    """Scatters (blocks, device snapshots, scale rows) write IN PLACE: the
    captured step programs read the cache through the storage they were
    captured over, so ``kv_caches`` and ``kv_scales`` keep their
    ``data_ptr()``s; and a gather reads back what a scatter wrote."""
    r = ModelRunner(_ecfg(kv_quant=kv_quant), params=TPARAMS, device="cpu")
    ptrs = [(k.data_ptr(), v.data_ptr()) for k, v in r.kv_caches]
    sptr = r.kv_scales.data_ptr() if kv_quant else None
    rng = np.random.default_rng(1)
    shape = r._block_shape(2)
    if kv_quant:
        q = rng.integers(-127, 128, shape).astype(np.int8)
        s = rng.random((2, MCFG.num_layers, 2, MCFG.num_kv_heads)).astype(np.float32)
        rows = [bq.pack_block(q[i], s[i], r._quant_layout()) for i in range(2)]
        data, scales = r.import_host_rows(rows, r._quant_layout())
        r.scatter_many_prepared([3, 5], data)
        r.set_block_scales([3, 5], scales)
        assert [np.array_equal(a, b) for a, b in zip(r.export_block_rows([3, 5]), rows)] \
            == [True, True]
        snap = r.gather_many_device([3, 5])
        r.scatter_many_device([7, 9], snap)
        r.set_block_scales([7, 9], r.gather_scales_device([3, 5]))
        np.testing.assert_array_equal(r.gather_many([7, 9]), q)
        r.scatter_block(11, rows[0])
        np.testing.assert_array_equal(r.export_block_rows([11])[0], rows[0])
    else:
        data = rng.standard_normal(shape).astype(np.float32)
        r.scatter_many([3, 5], list(data))
        np.testing.assert_array_equal(r.gather_many([3, 5]), data)
        r.scatter_many_device([7, 9], r.gather_many_device([3, 5]))
        np.testing.assert_array_equal(np.asarray(r.gather_many_async([7, 9])), data)
        r.scatter_block(11, data[1].reshape(-1))
        np.testing.assert_array_equal(r.gather_many([11])[0], data[1])
        assert r.kv_bytes_ratio == 1.0
    assert [(k.data_ptr(), v.data_ptr()) for k, v in r.kv_caches] == ptrs
    if kv_quant:
        assert r.kv_scales.data_ptr() == sptr
        lay = r._quant_layout()  # float32 compute: int8 data + f32 scales
        assert r.kv_bytes_ratio == (lay.block_elems + 4 * lay.scale_elems) / (
            4 * lay.block_elems)


def test_bf16_host_bytes_are_uint16_bits_and_convert_by_value():
    """bfloat16 blocks travel as their uint16 bit pattern (numpy has no
    bfloat16), reinterpreted on the way in; float32 values bound for a
    bfloat16 cache convert by value, rounding to nearest even."""
    r = ModelRunner(_ecfg(), params=TPARAMS, device="cpu")
    r.kv_dtype = torch.bfloat16
    vals = np.random.default_rng(2).standard_normal(r._block_shape()).astype(np.float32)
    bits = torch.from_numpy(vals).to(torch.bfloat16).view(torch.int16).numpy().view(np.uint16)
    np.testing.assert_array_equal(r._normalize_block_host(bits), bits)
    np.testing.assert_array_equal(r._normalize_block_host(vals), bits)
    np.testing.assert_array_equal(
        r._normalize_block_host(bits.view(np.int16)), bits)


@pytest.mark.parametrize("seed", [0, 1])
def test_pack_unpack_equal_the_jax_package(seed):
    """pack_block/unpack_block and the host quantize/dequantize law equal
    the JAX package's on the same data, byte for byte."""
    lay = KvLayoutConfig(num_layers=2, page_size=4, num_kv_heads=2, head_dim=8,
                         dtype="bfloat16", quant="int8")
    jlay = JKvLayoutConfig(num_layers=2, page_size=4, num_kv_heads=2, head_dim=8,
                           dtype="bfloat16", quant="int8")
    rng = np.random.default_rng(seed)
    q = rng.integers(-127, 128, (2, 2, 4, 2, 8)).astype(np.int8)
    s = rng.random((2, 2, 2)).astype(np.float32)
    row = bq.pack_block(q, s, lay)
    np.testing.assert_array_equal(row, j_bq.pack_block(q, s, jlay))
    for got, want in zip(bq.unpack_block(row, lay), j_bq.unpack_block(row, jlay)):
        np.testing.assert_array_equal(got, want)
    vals = rng.standard_normal(lay.block_elems).astype(np.float32)
    np.testing.assert_array_equal(bq.quantize_block(vals, lay), j_bq.quantize_block(vals, jlay))
    packed = bq.quantize_block(vals, lay)
    np.testing.assert_array_equal(bq.dequantize_block(packed, lay),
                                  np.asarray(j_bq.dequantize_block(packed, jlay)).view(np.uint16))
    assert bq.is_packed_row(row, lay) and not bq.is_packed_row(vals, lay)


def test_layout_for_engine_is_the_unpadded_port_layout():
    """``for_engine`` takes the model's own head dim and numpy dtype names;
    a JAX engine on the CPU describes the same block (its cache is not
    lane-padded there)."""
    lay = KvLayoutConfig.for_engine(_ecfg())
    assert (lay.num_layers, lay.page_size, lay.num_kv_heads, lay.head_dim, lay.dtype,
            lay.quant) == (MCFG.num_layers, 16, MCFG.num_kv_heads, MCFG.head_dim,
                           "float32", "int8")
    jcfg = JEngineConfig(model=JAX_CFG, num_blocks=32, max_num_seqs=2,
                         max_model_len=128, dtype="float32")
    jeng = TpuEngine(jcfg, params=PARAMS)
    jeng._build_runner()
    jlay = JKvLayoutConfig.for_engine(jcfg, jeng.runner.cache_head_dim)
    assert dataclasses.asdict(jlay) == dataclasses.asdict(lay)
    assert lay.block_bytes == jlay.block_bytes


async def _remote_then_offer(engine, proto, ctx_cls, prompt, rows, first_token):
    """Admit ``prompt`` with remote KV, land ``rows`` as its blocks, finish
    the stream: the decode engine then offers the landed blocks to G2."""
    pre = proto.PreprocessedRequest(
        token_ids=prompt, sampling=proto.SamplingOptions(temperature=0.0),
        stop=proto.StopConditions(max_tokens=2, ignore_eos=True))
    ctx = ctx_cls(pre.to_wire())
    info, stream = await engine.begin_remote(ctx, pre)
    assert info == {"num_blocks": len(rows), "start_block": 0}
    for i, row in enumerate(rows):
        engine.on_remote_block(ctx.id, i, row)
    engine.on_remote_finish(ctx.id, first_token)
    return [t async for item in stream for t in item["token_ids"]]


@pytest.mark.parametrize("quant", [None, "int8"])
async def test_port_and_jax_engines_offer_identical_g2_rows(quant):
    """The same prompts into a port decode engine and a JAX decode engine,
    each with its own KvBlockManager, their KV landed from the same bytes
    (random rows, int8-packed for the int8 pair) as a remote prefill
    lands it: every G2 row the two engines offer is byte-identical, with
    equal CRCs. (Two prefills computed by the two packages differ in the
    last bits of float32 — XLA's and torch's kernels round differently —
    so the rows come from one source, and what is held is the path from
    landed bytes through the cache, the gather and the store law.)"""
    rng = np.random.default_rng(7)
    prompts = [list(range(1, 41)), list(range(50, 83))]
    lay = _layout(quant)
    jlay = JKvLayoutConfig(**dataclasses.asdict(lay))
    kvbm = await KvBlockManager(KvbmConfig(layout=lay, host_blocks=16)).start()
    jkvbm = await JKvBlockManager(JKvbmConfig(layout=jlay, host_blocks=16)).start()
    eng = _engine(kvbm, kv_quant=quant)
    jeng = TpuEngine(JEngineConfig(model=JAX_CFG, num_blocks=32, max_num_seqs=2,
                                   max_model_len=128, dtype="float32", kv_quant=quant),
                     params=PARAMS, block_manager=jkvbm)
    await eng.start()
    await jeng.start()
    shape = (MCFG.num_layers, 2, 16, MCFG.num_kv_heads, MCFG.head_dim)
    try:
        for p in prompts:
            n = (len(p) + 15) // 16
            if quant:
                rows = [bq.pack_block(
                    rng.integers(-127, 128, shape).astype(np.int8),
                    rng.random(shape[:2] + shape[3:4]).astype(np.float32) + 0.01, lay)
                    for _ in range(n)]
            else:
                rows = [rng.standard_normal(shape).astype(np.float32) for _ in range(n)]
            got = await _remote_then_offer(eng, t_proto, Context, p, rows, 5)
            jgot = await _remote_then_offer(jeng, j_proto, JContext, p, rows, 5)
            assert got[0] == jgot[0] == 5 and len(got) == len(jgot) == 2
        await kvbm.drain_offers()
        await jkvbm.drain_offers()

        # The packages hash blocks differently (BLAKE2b vs xxh3, ROADMAP
        # C3): rows are matched by the block's tokens (distinct here).
        def stored(mgr):
            pool = mgr.host_pool
            out = {}
            for h in pool.registered_hashes():
                b = pool.get_by_hash(h)
                out[tuple(b.tokens)] = (
                    np.asarray(pool.storage.read_block(b.idx)).tobytes(), b.checksum)
            return out

        mine, theirs = stored(kvbm), stored(jkvbm)
        assert len(mine) == 4 and mine.keys() == theirs.keys()
        for toks, (row, crc) in mine.items():
            assert row == theirs[toks][0]
            assert crc == theirs[toks][1] == block_checksum(np.frombuffer(row, np.uint8))
    finally:
        await eng.stop()
        await jeng.stop()
        await kvbm.stop()
        await jkvbm.stop()


async def test_int8_engine_over_int8_tier_round_trips_exactly():
    """An int8 G1 offers (int8 data, scales) and a quantized tier packs
    them bit-exactly: a fresh int8 engine onboards those rows and streams
    what the first one streamed; an unquantized tier is refused."""
    lay = _layout("int8")
    kvbm = await KvBlockManager(KvbmConfig(layout=lay, host_blocks=16)).start()
    prompt = list(range(3, 43))
    eng = _engine(kvbm, kv_quant="int8")
    await eng.start()
    cold = await _generate(eng, prompt)
    await kvbm.drain_offers()
    await eng.stop()
    eng_b = _engine(kvbm, kv_quant="int8", kvbm_adaptive_gate=False)
    await eng_b.start()
    assert await _generate(eng_b, prompt) == cold
    assert eng_b.readiness()["kv_reused_host_blocks_total"] == 2
    await eng_b.stop()
    await kvbm.stop()
    with pytest.raises(ValueError, match="quant='int8'"):
        _engine(KvBlockManager(KvbmConfig(layout=_layout(None), host_blocks=4)),
                kv_quant="int8")


async def test_adaptive_onboard_gate_skips_when_recompute_wins():
    """With a measured-slow onboard link and fast prefill, the engine must
    SKIP host-tier onboarding (treating the hit as a miss) and still
    produce the correct tokens; with the gate off it must onboard."""
    kvbm = await KvBlockManager(KvbmConfig(layout=_layout(), host_blocks=16)).start()
    eng_a = _engine(kvbm)
    await eng_a.start()
    prompt = list(range(40))
    cold = await _generate(eng_a, prompt)
    await kvbm.drain_offers()
    await eng_a.stop()

    eng_b = _engine(kvbm)
    await eng_b.start()
    eng_b._onboard_bps = 1.0
    eng_b._prefill_tps = 1e9
    warm = await _generate(eng_b, prompt)
    assert warm == cold
    assert eng_b._onboard_skips == 1
    assert eng_b.prefix_hit_rate == 0.0  # host hit was treated as a miss
    await eng_b.stop()

    eng_c = _engine(kvbm, kvbm_adaptive_gate=False)
    await eng_c.start()
    eng_c._onboard_bps = 1.0
    eng_c._prefill_tps = 1e9
    warm_c = await _generate(eng_c, prompt)
    assert warm_c == cold
    assert eng_c._onboard_skips == 0
    assert eng_c.prefix_hit_rate > 0.0
    await eng_c.stop()
    await kvbm.stop()


async def test_disk_promotion_two_touch(tmp_path):
    """G3→G2: a host-tier miss on a disk-resident prefix promotes it
    asynchronously so the next lookup hits host (two-touch promotion)."""
    layout = KvLayoutConfig(num_layers=1, page_size=4, num_kv_heads=1, head_dim=4,
                            dtype="float32")
    kvbm = await KvBlockManager(KvbmConfig(
        layout=layout, host_blocks=2, disk_blocks=8, disk_path=str(tmp_path / "g3"),
    )).start()
    rng = np.random.default_rng(3)
    blocks_a = [np.float32(rng.standard_normal(layout.block_elems)) for _ in range(2)]
    kvbm.offer(101, None, (1,) * 4, blocks_a[0])
    kvbm.offer(102, 101, (2,) * 4, blocks_a[1])
    await kvbm.drain_offers()
    kvbm.offer(201, None, (3,) * 4, np.zeros(layout.block_elems, np.float32))
    kvbm.offer(202, 201, (4,) * 4, np.zeros(layout.block_elems, np.float32))
    await kvbm.drain_offers()
    assert kvbm.count_host_match([101, 102]) == 0
    assert kvbm.stats()["disk_registered"] >= 2

    kvbm.request_disk_promotion([101, 102])
    await kvbm.drain_offers()
    assert kvbm.count_host_match([101, 102]) == 2
    got = kvbm.match_host([101, 102])
    for (_h, _p, _t, data), want in zip(got, blocks_a):
        np.testing.assert_array_equal(np.asarray(data).view(np.float32).reshape(-1), want)
    await kvbm.stop()


async def test_engine_host_miss_requests_disk_promotion(monkeypatch):
    """The engine's host-tier lookup hands the unmatched prefix tail to
    request_disk_promotion."""
    kvbm = await KvBlockManager(KvbmConfig(layout=_layout(), host_blocks=16)).start()
    asked = []
    monkeypatch.setattr(kvbm, "request_disk_promotion",
                        lambda hashes: asked.append(list(hashes)))
    eng = _engine(kvbm)
    await eng.start()
    await _generate(eng, list(range(40)))  # cold: full host miss
    assert asked and len(asked[0]) == 2  # both full prompt blocks missed
    await eng.stop()
    await kvbm.stop()


async def test_cleared_device_cache_onboards_g2_and_g3_rows(tmp_path):
    """The chip smoke's kvbm leg at tiny size: prompts with a shared
    prefix, the device cache cleared, the prompts again — the onboarded
    rows are the offered ones (CRC), the streams the cold ones; the host
    tier then spills to disk and a two-touch promotion brings the prefix
    back through G3 with its envelope verified."""
    lay = _layout()
    kvbm = await KvBlockManager(KvbmConfig(
        layout=lay, host_blocks=6, disk_blocks=32, disk_path=str(tmp_path / "g3"),
    )).start()
    eng = _engine(kvbm, kvbm_adaptive_gate=False)
    await eng.start()
    prefix = list(range(100, 132))
    prompts = [prefix + [i, i + 1, i + 2] for i in (1, 7)]
    cold = [await _generate(eng, p) for p in prompts]
    await kvbm.drain_offers()
    await kvbm._g2_to_g3.drain()
    offered = {h: kvbm.host_pool.get_by_hash(h).checksum
               for h in kvbm.host_pool.registered_hashes()}
    assert await eng.wait_drained(10)  # the last dispatch has retired
    eng.allocator.clear_reusable()
    warm = [await _generate(eng, p) for p in prompts]
    assert warm == cold
    rd = eng.readiness()
    assert rd["kv_reused_host_blocks_total"] == 2  # the first re-run onboards 2
    assert rd["kvbm_integrity_failures_total"] == 0
    got = kvbm.match_host(list(offered))
    assert {h: block_checksum(d) for h, _p, _t, d in got} == offered
    # Spill the host tier: the prefix is now on disk only.
    for b in kvbm.host_pool.allocate_blocks(6):
        kvbm.host_pool.release(b)
    assert kvbm.count_host_match(list(offered)) == 0
    assert await eng.wait_drained(10)
    eng.allocator.clear_reusable()
    assert await _generate(eng, prompts[0]) == cold[0]  # touch 1: promotion
    await kvbm.drain_offers()
    assert kvbm.stats()["promoted_blocks_total"] == 2
    assert await eng.wait_drained(10)
    eng.allocator.clear_reusable()
    assert await _generate(eng, prompts[0]) == cold[0]  # touch 2: from G3 via G2
    assert eng.readiness()["kv_reused_disk_blocks_total"] == 2
    await eng.stop()
    await kvbm.stop()


async def test_match_host_copies_into_the_callers_staging():
    """``match_host(out=...)`` (the engine's pinned staging on the card)
    copies each matched row into ``out[i]`` under the tier lock and
    returns views of it, the bytes and the envelope check as without."""
    kvbm = await KvBlockManager(KvbmConfig(layout=LAYOUT, host_blocks=4)).start()
    try:
        for i, h in enumerate((10, 11, 12)):
            kvbm.offer(h, h - 1 if i else None, tuple(range(16)), _data(float(i + 1)))
        await kvbm.drain_offers()
        out = np.zeros((4, LAYOUT.block_elems), np.float32)
        got = kvbm.match_host([10, 11, 99], out=out)
        assert [g[0] for g in got] == [10, 11]
        for i, g in enumerate(got):
            assert np.shares_memory(g[3], out) and np.array_equal(out[i], _data(i + 1.0))
        assert not out[2:].any()
        # Rot caught with the staging path too: the prefix stops there.
        kvbm.host_pool.storage.read_block(kvbm.host_pool.get_by_hash(11).idx)[0] += 1.0
        assert [g[0] for g in kvbm.match_host([10, 11, 12], out=out)] == [10]
    finally:
        await kvbm.stop()
