"""The port's KV-aware router (dynamo_tpu_torch/llm/kv_router,
llm/router_service.py, the KV seams of engine/kv_cache.py, scheduler.py
and engine.py) against the JAX package's, on the CPU: the same seeded
event scripts through both radix indexers, the same endpoints and
overlaps through both selectors, the same allocator scripts through both
block pools, the same prompts through both tiny-test engines, the same
wire dicts through the port's codec and ``msgpack``, and the same
prefix-sharing traffic through two mocker workers of each package under
each package's router. Also the cases of tests/test_kv_router.py and the
KV cases of tests/test_failover.py on port workers."""

import asyncio
import time

import msgpack
import numpy as np
import pytest

import jax
import jax.numpy as jnp

from dynamo_tpu.engine.config import EngineConfig as JEngineConfig
from dynamo_tpu.engine.engine import TpuEngine
from dynamo_tpu.engine.kv_cache import BlockAllocator as JAllocator
from dynamo_tpu.llm.kv_router import indexer as j_indexer
from dynamo_tpu.llm.kv_router import metrics_aggregator as j_agg
from dynamo_tpu.llm.kv_router import protocols as j_proto
from dynamo_tpu.llm.kv_router import publisher as j_pub
from dynamo_tpu.llm.kv_router import router as j_router
from dynamo_tpu.llm.kv_router import scheduler as j_sched
from dynamo_tpu.llm.protocols import common as j_common
from dynamo_tpu.llm.router_service import RouterService as JRouterService
from dynamo_tpu.mocker import MockerConfig as JMockerConfig
from dynamo_tpu.mocker import MockerEngine as JMockerEngine
from dynamo_tpu.models import llama as j_llama
from dynamo_tpu.models.config import ModelConfig as JModelConfig
from dynamo_tpu.runtime import distributed as j_distributed
from dynamo_tpu.runtime import egress as j_egress
from dynamo_tpu.runtime.engine import Context as JContext
from dynamo_tpu_torch.engine.config import EngineConfig
from dynamo_tpu_torch.engine.engine import TorchEngine
from dynamo_tpu_torch.engine.kv_cache import BlockAllocator
from dynamo_tpu_torch.llm.kv_router import indexer as t_indexer
from dynamo_tpu_torch.llm.kv_router import metrics_aggregator as t_agg
from dynamo_tpu_torch.llm.kv_router import protocols as t_proto
from dynamo_tpu_torch.llm.kv_router import publisher as t_pub
from dynamo_tpu_torch.llm.kv_router import router as t_router
from dynamo_tpu_torch.llm.kv_router import scheduler as t_sched
from dynamo_tpu_torch.llm.kv_router.recorder import KvRecorder
from dynamo_tpu_torch.llm.protocols import common as t_common
from dynamo_tpu_torch.llm.router_service import RouterService
from dynamo_tpu_torch.llm.tokens import TokenBlockSequence
from dynamo_tpu_torch.mocker import MockerConfig, MockerEngine
from dynamo_tpu_torch.models import llama as t_llama
from dynamo_tpu_torch.models.config import ModelConfig
from dynamo_tpu_torch.runtime import distributed as t_distributed
from dynamo_tpu_torch.runtime import egress as t_egress
from dynamo_tpu_torch.runtime.engine import Context
from dynamo_tpu_torch.runtime.transports import wire

pytestmark = pytest.mark.anyio

PKG = {
    "jax": dict(indexer=j_indexer, agg=j_agg, proto=j_proto, pub=j_pub,
                router=j_router, sched=j_sched, common=j_common,
                distributed=j_distributed, egress=j_egress, Context=JContext,
                EngineConfig=JEngineConfig, ModelConfig=JModelConfig,
                RouterService=JRouterService),
    "torch": dict(indexer=t_indexer, agg=t_agg, proto=t_proto, pub=t_pub,
                  router=t_router, sched=t_sched, common=t_common,
                  distributed=t_distributed, egress=t_egress, Context=Context,
                  EngineConfig=EngineConfig, ModelConfig=ModelConfig,
                  RouterService=RouterService),
}
SEEDS = [0, 1, 2, 3]
LINK_GBPS = 37.5   # one rate for both selectors' network-aware term


# ---------------------------------------------------------------------------
# radix tree and indexers: seeded event scripts through both packages
# ---------------------------------------------------------------------------


def _event_script(seed: int, n_workers: int = 4, n_events: int = 120):
    """(worker, kind, hashes, parent) events over a small hash forest:
    chains of stored blocks that share prefixes, removals, clears and
    worker deaths, drawn from ``seed``."""
    rng = np.random.default_rng(seed)
    chains = [[int(b) for b in rng.integers(1, 40, rng.integers(2, 8))]
              for _ in range(6)]
    # Hashes are chain-scoped so a shared prefix is a shared hash run.
    chains = [[1000 * c + 10 * i + h for i, h in enumerate(ch)]
              for c, ch in enumerate(chains)]
    for c in range(1, 6, 2):
        cut = min(2, len(chains[c - 1]))
        chains[c] = chains[c - 1][:cut] + chains[c]
    script = []
    for _ in range(n_events):
        w = int(rng.integers(1, n_workers + 1))
        r = rng.random()
        ch = chains[int(rng.integers(len(chains)))]
        if r < 0.6:
            a = int(rng.integers(0, len(ch)))
            b = int(rng.integers(a + 1, len(ch) + 1))
            script.append((w, "stored", ch[a:b], ch[a - 1] if a else None))
        elif r < 0.85:
            script.append((w, "removed", [int(rng.choice(ch))], None))
        elif r < 0.93:
            script.append((w, "cleared", [], None))
        else:
            script.append((w, "worker_dead", [], None))
    queries = [ch[:k] for ch in chains for k in (1, len(ch))] + [[99999]]
    return script, queries


def _tree_view(tree, queries):
    return (
        [tree.find_matches(q) for q in queries],
        sorted(tree.workers()),
        tree.num_blocks,
        tree.evicted_blocks_total,
    )


@pytest.mark.parametrize("seed", SEEDS)
def test_radix_tree_matches_the_jax_tree_on_event_scripts(seed):
    script, queries = _event_script(seed)
    trees = {k: PKG[k]["indexer"].RadixTree() for k in PKG}
    for w, kind, hashes, parent in script:
        for k, tree in trees.items():
            tree.apply_event(w, PKG[k]["proto"].KvCacheEventData(
                kind=kind, block_hashes=list(hashes), parent_hash=parent))
        views = {k: _tree_view(t, queries) for k, t in trees.items()}
        assert views["torch"] == views["jax"]
    for w in (1, 3):
        for tree in trees.values():
            tree.remove_worker(w)
    assert _tree_view(trees["torch"], queries) == _tree_view(trees["jax"], queries)


@pytest.mark.parametrize("seed", SEEDS)
async def test_indexers_match_the_jax_indexers_with_stats_and_watermarks(seed):
    """KvIndexer and KvIndexerSharded of both packages fed the same
    script: the same answers, stats and watermarks (lag fields aside:
    wall-clock)."""
    script, queries = _event_script(seed)
    now = time.time()
    built = {}
    for k, m in PKG.items():
        built[k] = [m["indexer"].KvIndexer().start(),
                    m["indexer"].KvIndexerSharded(3).start()]
        for w, kind, hashes, parent in script:
            ev = m["proto"].RouterEvent(w, m["proto"].KvCacheEventData(
                kind=kind, block_hashes=list(hashes), parent_hash=parent),
                published_unix=now)
            for idx in built[k]:
                idx.apply(ev)
        built[k][0].remove_worker(2)
        built[k][1].remove_worker(2)

    def strip(d):
        return {k: v for k, v in d.items() if "lag" not in k}

    views = {}
    for k, idxs in built.items():
        views[k] = []
        for idx in idxs:
            answers = [await idx.find_matches(q) for q in queries]
            views[k].append((answers, strip(idx.stats()), strip(idx.watermark())))
            await idx.stop()
    assert views["torch"] == views["jax"]
    assert views["torch"][0][0] == views["torch"][1][0]  # sharded == flat


class TestRadixTree:
    def _stored(self, hashes, parent=None):
        return t_proto.KvCacheEventData(kind="stored", block_hashes=hashes,
                                        parent_hash=parent)

    def test_overlap_and_contiguity(self):
        t = t_indexer.RadixTree()
        t.apply_event(1, self._stored([10, 11, 12]))
        t.apply_event(2, self._stored([10, 11]))
        t.apply_event(2, self._stored([13], parent=12))
        assert t.find_matches([10, 11, 12, 13]) == {1: 3, 2: 2}
        assert t.find_matches([99]) == {}

    def test_removed_and_prune(self):
        t = t_indexer.RadixTree()
        t.apply_event(1, self._stored([10, 11]))
        t.apply_event(1, t_proto.KvCacheEventData(kind="removed", block_hashes=[11]))
        assert t.find_matches([10, 11]) == {1: 1}
        t.apply_event(1, t_proto.KvCacheEventData(kind="removed", block_hashes=[10]))
        assert t.num_blocks == 0

    def test_remove_worker(self):
        t = t_indexer.RadixTree()
        t.apply_event(1, self._stored([10, 11]))
        t.apply_event(2, self._stored([10]))
        t.remove_worker(1)
        assert t.find_matches([10, 11]) == {2: 1}
        assert t.workers() == [2]


async def test_kv_indexer_async():
    idx = t_indexer.KvIndexer().start()
    idx.apply(t_proto.RouterEvent(7, t_proto.KvCacheEventData(
        kind="stored", block_hashes=[1, 2])))
    assert await idx.find_matches([1, 2, 3]) == {7: 2}
    idx.remove_worker(7)
    assert await idx.find_matches([1, 2]) == {}
    await idx.stop()


def test_recorder_roundtrip_replays_into_both_trees(tmp_path):
    """A recording written by the port replays into the port's tree and,
    decoded by the JAX package's recorder, into the JAX tree alike."""
    from dynamo_tpu.llm.kv_router.recorder import KvRecorder as JRecorder

    path = tmp_path / "events.jsonl"
    rec = KvRecorder(path)
    rec.record(t_proto.RouterEvent(1, t_proto.KvCacheEventData(
        kind="stored", block_hashes=[5, 6])))
    rec.record(t_proto.RouterEvent(1, t_proto.KvCacheEventData(
        kind="removed", block_hashes=[6])))
    rec.close()
    trees = {"torch": t_indexer.RadixTree(), "jax": j_indexer.RadixTree()}
    n = asyncio.run(KvRecorder.send_events(
        path, lambda ev: trees["torch"].apply_event(ev.worker_id, ev.event)))
    m = asyncio.run(JRecorder.send_events(
        path, lambda ev: trees["jax"].apply_event(ev.worker_id, ev.event)))
    assert n == m == 2
    assert trees["torch"].find_matches([5, 6]) == trees["jax"].find_matches([5, 6]) \
        == {1: 1}


# ---------------------------------------------------------------------------
# selector
# ---------------------------------------------------------------------------


def _selector_inputs(seed: int):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(2, 6))
    metrics = []
    for wid in range(1, n + 1):
        metrics.append(dict(
            kv_active_blocks=int(rng.integers(0, 90)), kv_total_blocks=100,
            num_requests_waiting=int(rng.integers(0, 5)),
            kvbm_link_g2g1_bps=float(rng.choice([0.0, 2e9, 2e10])),
            kvbm_kv_quant_ratio=float(rng.choice([1.0, 0.53])),
        ))
    overlaps = {wid: int(rng.integers(0, 12)) for wid in range(1, n + 1)
                if rng.random() < 0.7}
    isl = int(rng.integers(16, 400))
    return metrics, overlaps, isl


@pytest.mark.parametrize("network_aware", [False, True])
@pytest.mark.parametrize("seed", SEEDS)
def test_selector_matches_the_jax_selector(seed, network_aware):
    """Same endpoints, overlaps, ISL and seed: the same worker, logit and
    candidate list, decision after decision (the predicted-load bump
    carries between them)."""
    metrics, overlaps, isl = _selector_inputs(seed)
    out = {}
    for k, m in PKG.items():
        cfg = m["sched"].KvRouterConfig(network_aware=network_aware,
                                        default_link_gbps=LINK_GBPS)
        sel = m["sched"].DefaultWorkerSelector(cfg, seed=seed)
        eps = m["agg"].ProcessedEndpoints(metrics={
            wid: m["proto"].ForwardPassMetrics(**kw)
            for wid, kw in enumerate(metrics, start=1)})
        decisions = []
        for i in range(4):
            d = sel.select(eps, overlaps, isl + 16 * i)
            decisions.append((d.worker_id, d.overlap_blocks, d.logit, d.candidates))
        sel.on_metrics()
        d = sel.select(eps, overlaps, isl)
        decisions.append((d.worker_id, d.logit))
        out[k] = decisions
    assert out["torch"] == out["jax"]


class TestSelector:
    def _endpoints(self, workers):
        return t_agg.ProcessedEndpoints(metrics={
            wid: t_proto.ForwardPassMetrics(kv_active_blocks=active,
                                            kv_total_blocks=100,
                                            num_requests_waiting=waiting)
            for wid, (active, waiting) in workers.items()})

    def test_overlap_wins(self):
        sel = t_sched.DefaultWorkerSelector(t_sched.KvRouterConfig(), seed=0)
        d = sel.select(self._endpoints({1: (0, 0), 2: (0, 0)}), {2: 4}, isl=64)
        assert d.worker_id == 2 and d.overlap_blocks == 4

    def test_load_penalty(self):
        sel = t_sched.DefaultWorkerSelector(t_sched.KvRouterConfig(), seed=0)
        assert sel.select(self._endpoints({1: (90, 5), 2: (10, 0)}), {},
                          isl=64).worker_id == 2

    def test_predicted_load_spreads_burst(self):
        sel = t_sched.DefaultWorkerSelector(t_sched.KvRouterConfig(), seed=0)
        eps = self._endpoints({1: (0, 0), 2: (0, 0)})
        chosen = {sel.select(eps, {}, isl=640).worker_id for _ in range(8)}
        assert chosen == {1, 2}

    def test_link_rate_is_measured_not_carried_over(self):
        """``default_link_gbps`` is the card's measured host→device rate,
        not the JAX package's TPU-fitted handoff constant; ``block_bytes``
        is the same layout arithmetic in both."""
        t, j = t_sched.KvRouterConfig(), j_sched.KvRouterConfig()
        assert t.block_bytes == j.block_bytes == 16 * 2 * 16 * 8 * 64 * 2
        assert t.default_link_gbps > 0 and t.default_link_gbps != j.default_link_gbps


# ---------------------------------------------------------------------------
# block pool events
# ---------------------------------------------------------------------------


def _allocator_script(seed: int):
    rng = np.random.default_rng(seed)
    return [(rng.random(), int(rng.integers(1, 4)), int(rng.integers(0, 6)))
            for _ in range(200)]


@pytest.mark.parametrize("seed", SEEDS)
def test_block_allocator_events_match_the_jax_allocator(seed):
    """The same allocate / register / release / evict script through both
    pools: the same ``stored`` and ``removed`` events, one ``stored`` per
    hash, none for a duplicate or a repeated register."""
    out = {}
    for k, cls in (("torch", BlockAllocator), ("jax", JAllocator)):
        events = []
        alloc = cls(12, 4, on_event=events.append)
        held: list[tuple[int, int]] = []   # (block, hash)
        for r, n, h in _allocator_script(seed):
            if r < 0.45 and alloc.num_free >= n:
                for b in alloc.allocate_many(n):
                    held.append((b, h * 10 + len(held) % 3))
            elif r < 0.75 and held:
                b, hh = held[int(r * 1000) % len(held)]
                alloc.register(b, hh, parent_hash=hh - 1, token_ids=[hh] * 4)
                alloc.register(b, hh, parent_hash=hh - 1, token_ids=[hh] * 4)
            elif held:
                b, _ = held.pop(int(r * 1000) % len(held))
                alloc.release(b)
        for b, _ in held:
            alloc.release(b)
        alloc.clear_reusable()
        out[k] = [(e.kind, list(e.block_hashes), e.parent_hash, e.token_ids)
                  for e in events]
    assert out["torch"] == out["jax"]
    stored = [e[1][0] for e in out["torch"] if e[0] == "stored"]
    assert stored and {e[0] for e in out["torch"]} == {"stored", "removed"}


# ---------------------------------------------------------------------------
# engine events and kv_actual records against the JAX engine
# ---------------------------------------------------------------------------

JAX_CFG = JModelConfig.tiny_test()
PARAMS = j_llama.init_params(jax.random.PRNGKey(0), JAX_CFG, dtype=jnp.float32)
TPARAMS = t_llama.params_from_jax(jax.tree.map(np.asarray, PARAMS), device="cpu")
# pipeline_depth=1: each dispatch retires (registering its blocks) before
# the next is composed (allocating, maybe evicting), so the event order
# does not depend on when either package's device result is ready.
ENGINE_KW = dict(dtype="float32", block_size=4, num_blocks=24, max_num_seqs=4,
                 max_model_len=64, prefill_batch=2, unified_token_budget=32,
                 unified_prefill_quantum=8, pipeline_depth=1)
BASE = list(range(1, 21))
PROMPTS = [BASE, BASE[:12] + [30, 31, 32, 33, 34], BASE + [40, 41],
           [50 + i for i in range(23)], [60 + i for i in range(19)], BASE]


async def _engine_events(pkg):
    events, actuals = [], []
    if pkg == "jax":
        engine = TpuEngine(JEngineConfig(model=JAX_CFG, **ENGINE_KW), params=PARAMS,
                           on_kv_event=events.append, on_kv_actual=actuals.append)
    else:
        engine = TorchEngine(EngineConfig(model=ModelConfig.tiny_test(), **ENGINE_KW),
                             params=TPARAMS, device="cpu",
                             on_kv_event=events.append, on_kv_actual=actuals.append)
    common = PKG[pkg]["common"]
    await engine.start()
    streams = []
    try:
        for prompt in PROMPTS:
            pre = common.PreprocessedRequest(
                token_ids=prompt, sampling=common.SamplingOptions(temperature=0.0),
                stop=common.StopConditions(max_tokens=6, ignore_eos=True))
            toks = []
            async for raw in engine.generate(PKG[pkg]["Context"](pre.to_wire())):
                toks.extend(raw["token_ids"])
            streams.append(toks)
            await asyncio.sleep(0.05)  # the side channels flush between requests
    finally:
        await engine.stop()
    # Hash spaces differ by design (BLAKE2b vs xxh3): compare by tokens.
    tokens_of: dict[int, tuple] = {}
    view = []
    for ev in events:
        if ev.kind == "stored":
            for h, toks in zip(ev.block_hashes, ev.token_ids):
                tokens_of[h] = tuple(toks)
            view.append(("stored", tuple(ev.token_ids[0]),
                         tokens_of.get(ev.parent_hash)))
        else:
            view.append((ev.kind, tokens_of[ev.block_hashes[0]], None))
    return view, [a["device_blocks"] for a in actuals], streams, events


@pytest.fixture(scope="module")
def engine_runs():
    return {pkg: asyncio.run(_engine_events(pkg)) for pkg in ("jax", "torch")}


def test_engine_kv_events_match_the_jax_engine(engine_runs):
    (jv, ja, js, _), (tv, ta, ts, _) = engine_runs["jax"], engine_runs["torch"]
    assert ts == js
    assert tv == jv
    assert {kind for kind, _, _ in tv} == {"stored", "removed"}
    assert ta == ja and ta[0] == 0 and ta[2] == 5 and ta[5] > 0


def test_router_hashes_are_the_engines_stored_hashes(engine_runs):
    """The router hashes a prompt with the port's TokenBlockSequence:
    exactly the sequence hashes the port's block pool registered for
    that prompt's full blocks."""
    *_, events = engine_runs["torch"]
    stored = [h for ev in events if ev.kind == "stored" for h in ev.block_hashes]
    for prompt in PROMPTS[:3]:
        hashes = TokenBlockSequence.from_tokens(prompt, block_size=4).sequence_hashes()
        assert hashes and set(hashes) <= set(stored)
    first = TokenBlockSequence.from_tokens(PROMPTS[0], block_size=4).sequence_hashes()
    assert stored[:len(first)] == first


# ---------------------------------------------------------------------------
# wire
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", SEEDS)
def test_router_event_and_metrics_wire_match_msgpack(seed):
    script, _ = _event_script(seed, n_events=20)
    rng = np.random.default_rng(seed)
    for w, kind, hashes, parent in script:
        toks = [[int(t) for t in rng.integers(0, 2**31, 4)] for _ in hashes] or None
        t = t_proto.RouterEvent(w << 40, t_proto.KvCacheEventData(
            kind, hashes, parent, toks), published_unix=1e9 + rng.random())
        j = j_proto.RouterEvent(w << 40, j_proto.KvCacheEventData(
            kind, hashes, parent, toks), published_unix=t.published_unix)
        assert wire.packb(t.to_wire()) == msgpack.packb(j.to_wire())
        back = t_proto.RouterEvent.from_wire(wire.unpackb(msgpack.packb(j.to_wire())))
        assert back == t
    tm, jm = t_proto.ForwardPassMetrics(), j_proto.ForwardPassMetrics()
    assert list(tm.to_wire()) == list(jm.to_wire())
    for key in tm.to_wire():
        v = getattr(jm, key)
        val = (float(rng.random()) if isinstance(v, float)
               else int(rng.integers(0, 2**40)))
        setattr(tm, key, val)
        setattr(jm, key, val)
    assert wire.packb(tm.to_wire()) == msgpack.packb(jm.to_wire())
    assert t_proto.ForwardPassMetrics.from_wire(
        wire.unpackb(msgpack.packb(jm.to_wire()))) == tm


def test_planes_and_exports_match():
    import dynamo_tpu.llm.kv_router as j_pkg
    import dynamo_tpu_torch.llm.kv_router as t_pkg

    for name in ("KV_EVENT_PLANE", "KV_METRICS_ENDPOINT", "KV_HIT_RATE_PLANE",
                 "KV_REANNOUNCE_PLANE"):
        assert getattr(t_proto, name) == getattr(j_proto, name)
    assert sorted(t_pkg.__all__) == sorted(j_pkg.__all__)


# ---------------------------------------------------------------------------
# routed mocker fleets: the port's against the JAX package's
# ---------------------------------------------------------------------------


class _Counting:
    def __init__(self, inner):
        self.inner = inner
        self.count = 0

    def generate(self, request):
        self.count += 1
        return self.inner.generate(request)


async def _spawn_worker(pkg, drt, component, seed):
    m = PKG[pkg]
    cfg = m["EngineConfig"](model=m["ModelConfig"].tiny_test(), num_blocks=64,
                            max_num_seqs=4, max_model_len=256)
    wm = m["pub"].WorkerMetricsPublisher()
    pub = m["pub"].KvEventPublisher(drt, component, drt.primary_lease_id)
    if pkg == "torch":
        engine = MockerEngine(cfg, MockerConfig(seed=seed),
                              on_kv_event=pub.publish_engine_event,
                              on_metrics=wm.publish)
    else:
        engine = JMockerEngine(cfg, JMockerConfig(seed=seed))
        engine._external_kv_event = pub.publish_engine_event
        engine._on_metrics = wm.publish
    await engine.start()
    counting = _Counting(engine)
    await component.endpoint("generate").serve(counting)
    await wm.create_endpoint(component)
    return engine, counting


async def _fleet(pkg, ns):
    m = PKG[pkg]
    drt_a = await m["distributed"].DistributedRuntime.in_process()
    drt_b = await m["distributed"].DistributedRuntime.in_process(
        store=drt_a.store, bus=drt_a.bus, runtime=drt_a.runtime)
    comp_a = drt_a.namespace(ns).component("worker")
    comp_b = drt_b.namespace(ns).component("worker")
    a = await _spawn_worker(pkg, drt_a, comp_a, seed=1)
    b = await _spawn_worker(pkg, drt_b, comp_b, seed=2)
    return drt_a, drt_b, comp_a, a, b


async def _send(m, push, prompt, n=4):
    req = m["common"].PreprocessedRequest(
        token_ids=prompt, sampling=m["common"].SamplingOptions(temperature=0.0),
        stop=m["common"].StopConditions(max_tokens=n, ignore_eos=True))
    out = []
    async for item in push.generate(m["Context"](req.to_wire())):
        out.append(item)
    return out


async def _settled(router):
    for _ in range(200):
        await asyncio.sleep(0.01)
        if router.indexer.pending_events == 0:
            return


GROUPS = [[list(range(100 * g, 100 * g + 48)) + [7000 + 10 * g + r] * 5
           for r in range(3)] for g in range(3)]


async def _route_groups(pkg, via_service: bool):
    """Each group's first request, then (indexer settled) its later
    ones: per request, whether it landed on its group's first worker,
    and the router's predicted overlap."""
    m = PKG[pkg]
    ns = f"grp{pkg}{int(via_service)}"
    drt_a, drt_b, comp_a, (eng_a, cnt_a), (eng_b, cnt_b) = await _fleet(pkg, ns)
    if via_service:
        service = await m["RouterService"](drt_a, f"{ns}.worker.generate").start()
        router = service.kv_router
        push = await m["egress"].PushRouter.create(drt_a, service.endpoint_path)
    else:
        router = await m["router"].KvRouter(drt_a, comp_a).start()
        push = await m["egress"].PushRouter.create(
            drt_a, f"{ns}.worker.generate", mode=m["egress"].RouterMode.KV,
            selector=router.selector_fn)
    audit = []
    real = router.find_best_match

    async def spy(token_ids, request_id=None):
        d = await real(token_ids, request_id=request_id)
        audit.append(d.overlap_blocks)
        return d

    router.find_best_match = spy
    same = []
    try:
        for group in GROUPS:
            before = (cnt_a.count, cnt_b.count)
            await _send(m, push, group[0])
            first = cnt_a if cnt_a.count > before[0] else cnt_b
            await _settled(router)
            for prompt in group[1:]:
                n = first.count
                await _send(m, push, prompt)
                same.append(first.count == n + 1)
            await _settled(router)
    finally:
        if via_service:
            await service.stop()
        else:
            await router.stop()
        await eng_a.stop()
        await eng_b.stop()
        await drt_a.shutdown()
    return same, audit


@pytest.mark.parametrize("via_service", [False, True])
async def test_mocker_fleets_split_prefix_groups_as_the_jax_fleet(via_service):
    """Two port mocker workers under the port's KvRouter (or its
    RouterService) and two JAX mocker workers under the JAX router: the
    same prefix-sharing traffic lands in the same groups, with the same
    predicted overlaps (3 full 16-token blocks for every later request)."""
    port = await _route_groups("torch", via_service)
    jax_ = await _route_groups("jax", via_service)
    assert port == jax_
    assert port[0] == [True] * 6
    assert port[1] == [0, 3, 3] * 3


async def test_routed_two_worker_prefix_affinity():
    m = PKG["torch"]
    drt_a, _drt_b, comp_a, (eng_a, cnt_a), (eng_b, cnt_b) = await _fleet("torch", "aff")
    router = await t_router.KvRouter(drt_a, comp_a).start()
    push = await t_egress.PushRouter.create(
        drt_a, "aff.worker.generate", mode=t_egress.RouterMode.KV,
        selector=router.selector_fn)
    prompt = list(range(64))
    await _send(m, push, prompt)
    await asyncio.sleep(0.2)
    first = (cnt_a.count, cnt_b.count)
    assert sum(first) == 1
    hashes = TokenBlockSequence.from_tokens(prompt, block_size=16).sequence_hashes()
    overlaps = await router.indexer.find_matches(hashes)
    assert len(overlaps) == 1 and list(overlaps.values()) == [4]
    winner = cnt_a if first[0] else cnt_b
    await _send(m, push, prompt)
    assert winner.count == 2
    await eng_a.stop()
    await eng_b.stop()
    await router.stop()
    await drt_a.shutdown()


async def test_router_service_standalone():
    """Clients address the router component; affinity holds through the
    extra hop; stop() deregisters; a custom selector replaces the cost
    function."""
    m = PKG["torch"]
    drt_a, drt_b, _comp, (eng_a, cnt_a), (eng_b, cnt_b) = await _fleet("torch", "svc")
    service = await RouterService(drt_a, "svc.worker.generate").start()
    push = await t_egress.PushRouter.create(drt_a, service.endpoint_path)
    prompt = list(range(64))
    out = await _send(m, push, prompt)
    assert out and sum(len(o.get("token_ids", [])) for o in out) == 4
    await asyncio.sleep(0.2)
    assert cnt_a.count + cnt_b.count == 1
    winner = cnt_a if cnt_a.count else cnt_b
    await _send(m, push, prompt)
    assert winner.count == 2
    await service.stop()
    client = await t_egress.Client.create(
        drt_a, t_egress.EndpointId.parse(service.endpoint_path))
    assert client.instances() == []

    pinned = drt_b.primary_lease_id

    class PinSelector(t_sched.DefaultWorkerSelector):
        def select(self, endpoints, overlaps, isl):
            if pinned not in endpoints.metrics:
                return None
            return t_sched.SchedulingDecision(worker_id=pinned, overlap_blocks=0,
                                              logit=0.0)

    service2 = await RouterService(drt_a, "svc.worker.generate",
                                   component_name="router2",
                                   selector=PinSelector()).start()
    push2 = await t_egress.PushRouter.create(drt_a, service2.endpoint_path)
    before = cnt_b.count
    for _ in range(3):
        await _send(m, push2, list(range(32)), n=2)
    assert cnt_b.count == before + 3
    await service2.stop()
    await eng_a.stop()
    await eng_b.stop()
    await drt_a.shutdown()


async def test_kv_selector_factory_builds_one_router_per_component():
    drt = await t_distributed.DistributedRuntime.in_process()
    factory = t_router.kv_selector_factory(drt)
    eid = t_egress.EndpointId.parse("fac.worker.generate")
    s1, s2 = await asyncio.gather(factory(None, eid), factory(None, eid))
    assert s1.__self__ is s2.__self__
    await s1.__self__.stop()
    await drt.shutdown()


# ---------------------------------------------------------------------------
# the mark-dead fast path (KV cases of tests/test_failover.py)
# ---------------------------------------------------------------------------


async def test_dispatch_error_evicts_router_and_aggregator_in_one_step():
    """A dispatch-time connection error drops the corpse from the router's
    live view and from the metrics aggregator (and radix index) in the
    same step, and the request completes on the sibling."""
    from dynamo_tpu_torch.runtime.failover import FAILOVER, FailoverEngine
    from dynamo_tpu_torch.utils.faults import FAULTS

    m = PKG["torch"]
    drt_a, _drt_b, comp_a, (eng_a, _), (eng_b, _) = await _fleet("torch", "fo")
    try:
        kvr = t_router.KvRouter(drt_a, comp_a)  # not started: no pumps
        push = await t_egress.PushRouter.create(drt_a, "fo.worker.generate",
                                                connect_timeout_s=2.0)
        await push.client.wait_for_instances()
        wids = push.client.instance_ids()
        for wid in wids:
            kvr.aggregator.endpoints.metrics[wid] = t_proto.ForwardPassMetrics()
        push.on_dead.append(kvr.note_worker_dead)
        push.mark_dead(wids[0], "test:unit")
        assert wids[0] not in push.client._instances
        assert wids[0] not in kvr.aggregator.endpoints.metrics
        kvr.aggregator.endpoints.metrics[wids[0]] = t_proto.ForwardPassMetrics()

        FAULTS.arm("fleet.worker_kill", "raise", times=1)
        before = FAILOVER.marked_dead_total
        req = m["common"].PreprocessedRequest(
            token_ids=[3, 4], sampling=m["common"].SamplingOptions(temperature=0.0),
            stop=m["common"].StopConditions(max_tokens=4, ignore_eos=True))
        out = []
        async for item in FailoverEngine(push).generate(Context(req.to_wire())):
            out += item.get("token_ids", [])
        assert len(out) == 4
        dead = [w for w in wids if w not in kvr.aggregator.endpoints.metrics]
        assert len(dead) == 1
        assert FAILOVER.marked_dead_total >= before + 1
    finally:
        FAULTS.clear()
        await eng_a.stop()
        await eng_b.stop()
        await drt_a.shutdown()


async def test_selector_owner_auto_wired_to_on_dead():
    drt = await t_distributed.DistributedRuntime.in_process()
    try:
        kvr = t_router.KvRouter(drt, drt.namespace("fo").component("w"))
        push = await t_egress.PushRouter.create(
            drt, "fo.w.gen", mode=t_egress.RouterMode.KV, selector=kvr.selector_fn)
        assert kvr.note_worker_dead in push.on_dead
    finally:
        await drt.shutdown()


async def test_note_worker_dead_broadcasts_to_sibling_routers():
    """The observing router drops the corpse and broadcasts
    ``worker_dead``; a sibling router's pump drops its load snapshot and
    radix blocks within one apply — as the JAX routers do."""
    out = {}
    for pkg, m in PKG.items():
        drt = await m["distributed"].DistributedRuntime.in_process()
        comp = drt.namespace(f"wd{pkg}").component("w")
        a = await m["router"].KvRouter(drt, comp).start()
        b = await m["router"].KvRouter(drt, comp).start()
        for r in (a, b):
            r.indexer.apply(m["proto"].RouterEvent(9, m["proto"].KvCacheEventData(
                kind="stored", block_hashes=[1, 2])))
            r.aggregator.endpoints.metrics[9] = m["proto"].ForwardPassMetrics()
        a.note_worker_dead(9)
        for _ in range(100):
            await asyncio.sleep(0.01)
            if 9 not in b.aggregator.endpoints.metrics:
                break
        out[pkg] = (await a.indexer.find_matches([1, 2]),
                    await b.indexer.find_matches([1, 2]),
                    9 in b.aggregator.endpoints.metrics)
        await a.stop()
        await b.stop()
        await drt.shutdown()
    assert out["torch"] == out["jax"] == ({}, {}, False)


async def test_aggregator_mark_dead_drops_snapshot():
    agg = t_agg.KvMetricsAggregator.__new__(t_agg.KvMetricsAggregator)
    agg.endpoints = t_agg.ProcessedEndpoints(
        metrics={7: t_proto.ForwardPassMetrics(), 9: t_proto.ForwardPassMetrics()})
    agg._last_seen = {7: 1.0, 9: 1.0}
    agg.stale_endpoint_drops_total = 0
    agg.mark_dead(7)
    assert 7 not in agg.endpoints.metrics and 9 in agg.endpoints.metrics
    assert agg.stale_endpoint_drops_total == 1
    agg.mark_dead(7)
    assert agg.stale_endpoint_drops_total == 1
