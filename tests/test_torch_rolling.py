"""The port's rolling buffer (Mistral-style sliding window on every
layer): ``Scheduler.evict_behind_window`` and its callers against the JAX
engine on the CPU, float32, tiny-test with ``sliding_window=8`` and the
JAX weights carried across by ``params_from_jax``.

Mirrors ``tests/test_engine.py::test_rolling_buffer_eviction_plateaus_and_is_exact``
and adds the port-side checks: the KVBM offload never offers the trash
block under a valid hash, a preempted rolling sequence is re-admitted
with ``evicted_pages`` reset and finishes with the same stream, and the
scheduler's bookkeeping around the 0 sentinel."""

import asyncio
import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from dynamo_tpu.engine.config import EngineConfig as JEngineConfig
from dynamo_tpu.engine.engine import TpuEngine
from dynamo_tpu.engine.kv_cache import BlockAllocator as JBlockAllocator
from dynamo_tpu.engine.scheduler import Scheduler as JScheduler
from dynamo_tpu.engine.sequence import Sequence as JSequence
from dynamo_tpu.llm.protocols import common as j_proto
from dynamo_tpu.models import llama as j_llama
from dynamo_tpu.models.config import ModelConfig as JCfg
from dynamo_tpu.runtime.engine import Context as JContext
from dynamo_tpu_torch.block_manager import KvbmConfig, KvBlockManager, KvLayoutConfig
from dynamo_tpu_torch.engine.config import EngineConfig
from dynamo_tpu_torch.engine.engine import TorchEngine
from dynamo_tpu_torch.engine.kv_cache import BlockAllocator
from dynamo_tpu_torch.engine.scheduler import Scheduler
from dynamo_tpu_torch.engine.sequence import Sequence
from dynamo_tpu_torch.llm.protocols import common as t_proto
from dynamo_tpu_torch.models import llama as t_llama
from dynamo_tpu_torch.models.config import ModelConfig
from dynamo_tpu_torch.runtime.engine import Context

WINDOW = 8
JCFG = dataclasses.replace(JCfg.tiny_test(), name="tiny-swa", sliding_window=WINDOW)
TCFG = ModelConfig.tiny_test().scaled(name="tiny-swa", sliding_window=WINDOW)
PARAMS = j_llama.init_params(jax.random.PRNGKey(6), JCFG, dtype=jnp.float32)
TPARAMS = t_llama.params_from_jax(jax.tree.map(np.asarray, PARAMS), device="cpu")
ENGINE_KW = dict(dtype="float32", block_size=4, num_blocks=64, max_num_seqs=4,
                 max_model_len=128)
PROMPT = [int(t) for t in np.random.default_rng(4).integers(1, 384, 20)]
OUT = 60  # final length 80 >> window 8


async def _stream(engine, proto, ctx_cls, prompt, n, on_token=None):
    pre = proto.PreprocessedRequest(
        token_ids=prompt, sampling=proto.SamplingOptions(temperature=0.0),
        stop=proto.StopConditions(max_tokens=n, ignore_eos=True),
    )
    toks = []
    async for raw in engine.generate(ctx_cls(pre.to_wire())):
        toks += proto.EngineOutput.from_wire(raw).token_ids
        if on_token is not None:
            on_token()
    return toks


async def _port_run(evict: bool, **kw):
    engine = TorchEngine(EngineConfig(model=TCFG, **{**ENGINE_KW, **kw}),
                         params=TPARAMS, device="cpu")
    await engine.start()
    if not evict:
        engine.scheduler.evict_behind_window = lambda *a, **k: 0
    peaks = []
    try:
        toks = await _stream(
            engine, t_proto, Context, PROMPT, OUT,
            lambda: peaks.append(engine.scheduler.metrics()["kv_active_blocks"]))
    finally:
        await engine.stop()
    return toks, peaks


@pytest.fixture(scope="module")
def jax_stream():
    async def run():
        engine = TpuEngine(JEngineConfig(model=JCFG, **ENGINE_KW), params=PARAMS)
        await engine.start()
        try:
            return await _stream(engine, j_proto, JContext, PROMPT, OUT)
        finally:
            await engine.stop()

    return asyncio.run(run())


def test_rolling_buffer_eviction_plateaus_and_is_exact(jax_stream):
    """(a) The live block count plateaus at O(window / bs) while decoding
    advances, where without eviction it grows with the context; (b) the
    streams with and without eviction are identical, and the JAX
    engine's."""
    toks_off, peaks_off = asyncio.run(_port_run(evict=False))
    toks_on, peaks_on = asyncio.run(_port_run(evict=True))
    assert toks_on == toks_off == jax_stream, "eviction changed generated tokens"
    bs, depth = ENGINE_KW["block_size"], EngineConfig(model=TCFG).pipeline_depth
    # In-window pages, the page being filled, and the pages the dispatches
    # in flight write ahead into.
    bound = (WINDOW + bs - 1) // bs + 1 + (2 * depth) // bs + 1
    assert max(peaks_off) >= (len(PROMPT) + OUT - 8) // bs   # grew with ctx
    assert max(peaks_on[len(peaks_on) // 2:]) <= bound, (peaks_on, bound)


def test_chunked_prompt_evicts_before_its_last_chunk():
    """A prompt fed in quanta releases the pages behind the window after
    each chunk (the JAX engine's retire rule), and the stream still equals
    the no-eviction stream."""
    kw = dict(unified_token_budget=16, unified_prefill_quantum=8)
    prompt = [int(t) for t in np.random.default_rng(9).integers(1, 384, 40)]

    async def run(evict):
        engine = TorchEngine(EngineConfig(model=TCFG, **{**ENGINE_KW, **kw}),
                             params=TPARAMS, device="cpu")
        await engine.start()
        released = []
        real = engine.scheduler.evict_behind_window

        def spy(seq, covered):
            n = real(seq, covered) if evict else 0
            released.append((covered, n))
            return n

        engine.scheduler.evict_behind_window = spy
        try:
            return await _stream(engine, t_proto, Context, prompt, 6), released
        finally:
            await engine.stop()

    on, released = asyncio.run(run(True))
    off, _ = asyncio.run(run(False))
    assert on == off
    # A chunk's retire at covered = 16 frees the pages wholly below 8.
    assert (16, (16 - WINDOW) // 4) in released


def test_offload_never_offers_the_trash_block():
    """A rolling-buffer engine with a KVBM host tier: the prompt's pages
    evicted before it completes are 0 sentinels, and the G1→G2 offer
    skips them instead of gathering block 0 under their hashes."""
    ecfg = EngineConfig(model=TCFG, **{**ENGINE_KW, "unified_token_budget": 16,
                                       "unified_prefill_quantum": 8})
    prompt = [int(t) for t in np.random.default_rng(5).integers(1, 384, 40)]

    async def run():
        kvbm = await KvBlockManager(KvbmConfig(
            layout=KvLayoutConfig.for_engine(ecfg), host_blocks=32)).start()
        engine = TorchEngine(ecfg, params=TPARAMS, device="cpu", block_manager=kvbm)
        await engine.start()
        gathered = []
        real = engine.runner.gather_many_async

        def spy(ids):
            gathered.append(list(ids))
            return real(ids)

        engine.runner.gather_many_async = spy
        try:
            toks = await _stream(engine, t_proto, Context, prompt, 4)
            await kvbm.drain_offers()
            return toks, gathered, kvbm.stats()["host_registered"]
        finally:
            await engine.stop()
            await kvbm.stop()

    toks, gathered, registered = asyncio.run(run())
    offered = [b for ids in gathered for b in ids]
    assert offered and 0 not in offered
    # 10 full prompt blocks; those wholly behind the window when the prompt
    # completed (covered 40: pages below 32, 8 of them) were not offered.
    assert len(offered) == registered == 10 - (40 - WINDOW) // 4
    assert len(toks) == 4


def test_preempted_rolling_sequence_readmits_reset_and_same_stream(jax_stream):
    """Preempt the sequence once it has evicted pages: it is re-queued
    with ``evicted_pages`` 0, re-admitted with a full block table (no
    sentinel), and finishes with the stream it had without preemption."""
    seen = {}

    async def run():
        engine = TorchEngine(EngineConfig(model=TCFG, **ENGINE_KW), params=TPARAMS,
                             device="cpu")
        await engine.start()
        sched = engine.scheduler
        real_batch, real_admit = sched.decode_batch, sched.admit

        def decode_batch(lookahead=1):
            for seq in list(sched.running.values()):
                if (not seen and seq.evicted_pages > 2 and seq.inflight_chunks == 0):
                    free = sched.allocator.num_free
                    sched._preempt(seq)
                    seen.update(evicted_after=seq.evicted_pages,
                                freed=sched.allocator.num_free - free,
                                blocks=list(seq.block_ids))
            return real_batch(lookahead)

        def admit(seq):
            ok = real_admit(seq)
            if ok and seen and "readmitted" not in seen:
                seen["readmitted"] = list(seq.block_ids)
            return ok

        sched.decode_batch, sched.admit = decode_batch, admit
        try:
            return await _stream(engine, t_proto, Context, PROMPT, OUT)
        finally:
            await engine.stop()

    toks = asyncio.run(run())
    assert seen["evicted_after"] == 0 and seen["blocks"] == []
    assert seen["freed"] > 0
    assert seen["readmitted"] and 0 not in seen["readmitted"]
    assert toks == jax_stream


def _seq(cls, proto, n):
    return cls(request_id="r", prompt_tokens=list(range(1, n + 1)),
               sampling=proto.SamplingOptions(), stop=proto.StopConditions(),
               emit=lambda *a: None)


@pytest.mark.parametrize("window,pattern,max_window", [
    (8, 0, 0), (8, 2, 0), (8, 0, 1), (0, 0, 0)],
    ids=["rolling", "gemma-pattern", "qwen2-gate", "no-window"])
def test_evict_behind_window_matches_the_jax_scheduler(window, pattern, max_window):
    """The scheduler laws side by side: the same admissions and retire
    points release the same pages in both packages, only for a model
    whose every layer is windowed; ``_release`` skips the sentinels and
    re-registering a covered prefix skips them too."""
    change = dict(sliding_window=window, window_pattern=pattern,
                  max_window_layers=max_window)
    kw = dict(dtype="float32", block_size=4, num_blocks=32, max_num_seqs=2,
              max_model_len=64)
    t_cfg = EngineConfig(model=TCFG.scaled(**change), **kw)
    j_cfg = JEngineConfig(model=dataclasses.replace(JCFG, **change), **kw)
    t_s = Scheduler(t_cfg, BlockAllocator(32, 4))
    j_s = JScheduler(j_cfg, JBlockAllocator(32, 4))
    t_seq, j_seq = _seq(Sequence, t_proto, 30), _seq(JSequence, j_proto, 30)
    assert t_s.admit(t_seq) and j_s.admit(j_seq)
    for covered in (9, 16, 17, 30, 30):
        t_s.register_filled_blocks(t_seq, covered)
        j_s.register_filled_blocks(j_seq, covered)
        assert t_s.evict_behind_window(t_seq, covered) == j_s.evict_behind_window(
            j_seq, covered)
        assert t_seq.block_ids == j_seq.block_ids
        assert t_seq.evicted_pages == j_seq.evicted_pages
        assert t_s.allocator.num_free == j_s.allocator.num_free
    rolling = TCFG.scaled(**change).rolling_buffer
    assert (0 in t_seq.block_ids) == rolling
    t_s.requeue_for_recompute(t_seq)
    j_s.requeue_for_recompute(j_seq)
    assert t_seq.evicted_pages == j_seq.evicted_pages == 0
    assert t_s.allocator.num_free == j_s.allocator.num_free == 31
