"""The port's int8 KV cache against the JAX package on the CPU: the write
law (ops/quant.py quantize_kv_write), the plain attention with
per-(block, kv head) scales against the JAX XLA oracles on the case set
of tests/test_kv_quant.py (not against the JAX Pallas int8 path, which
fails under jax 0.9.0), ``llama.unified`` with ``kv_scales``, the int8
engine's greedy streams against the JAX int8 engine with shared weights,
and config validation.

Tolerances: float32 attention within 1e-5 of JAX (the north star's
kernel-vs-oracle bound); int8 cache bytes equal outside trash block 0
(whose padding writes land in any order) and scales within rtol 1e-6;
model logits within 1e-4 (tests/test_torch_model.py's bound)."""

import asyncio

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from dynamo_tpu.engine.config import EngineConfig as JEngineConfig
from dynamo_tpu.engine.engine import TpuEngine
from dynamo_tpu.llm.protocols import common as j_proto
from dynamo_tpu.models import llama as j_llama
from dynamo_tpu.models.config import ModelConfig as JCfg
from dynamo_tpu.ops import attention as j_attn
from dynamo_tpu.ops.attention import AttnDispatch
from dynamo_tpu.ops.quant import quantize_kv_write as j_quantize_kv_write
from dynamo_tpu.runtime.engine import Context as JContext
from dynamo_tpu_torch.engine.config import EngineConfig
from dynamo_tpu_torch.engine.engine import TorchEngine
from dynamo_tpu_torch.llm.protocols import common as t_proto
from dynamo_tpu_torch.models import llama as t_llama
from dynamo_tpu_torch.models.config import ModelConfig
from dynamo_tpu_torch.ops import attention as t_attn
from dynamo_tpu_torch.ops.kernels import ragged_attention as t_kernel
from dynamo_tpu_torch.ops.quant import quantize_kv_write
from dynamo_tpu_torch.runtime.engine import Context

BS = 16
F32_TOL = 1e-5
LOGIT_TOL = 1e-4


# -- the write law -----------------------------------------------------------
def _write_both(cache, scales, slots, vals, bs=BS):
    """One write through both laws from the same numpy state."""
    jc, js = j_quantize_kv_write(
        jnp.asarray(cache), jnp.asarray(scales), jnp.asarray(slots, jnp.int32),
        jnp.asarray(vals), bs,
    )
    tc = torch.from_numpy(cache.copy())
    ts = quantize_kv_write(
        tc, torch.from_numpy(scales), torch.from_numpy(np.asarray(slots, np.int32)),
        torch.from_numpy(vals), bs,
    )
    return (np.asarray(jc), np.asarray(js)), (tc.numpy(), ts.numpy())


def _assert_same(j, t, bs=BS):
    (jc, js), (tc, ts) = j, t
    np.testing.assert_array_equal(tc[bs:], jc[bs:])        # outside block 0
    np.testing.assert_allclose(ts[1:], js[1:], rtol=1e-6, atol=0)


def test_write_law_fresh_block_resets_stale_scale_like_jax():
    kvH, D = 2, 8
    cache = np.zeros((4 * BS, kvH, D), np.int8)
    scales = np.full((4, kvH), 100.0, np.float32)          # stale, huge
    vals = np.random.default_rng(0).standard_normal((BS, kvH, D)).astype(np.float32)
    slots = np.arange(BS) + 2 * BS                         # block 2
    j, t = _write_both(cache, scales, slots, vals)
    _assert_same(j, t)
    assert (t[1][2] < 1.0).all() and (t[1][[0, 1, 3]] == 100.0).all()


def test_write_law_scale_growth_requants_existing_entries_like_jax():
    kvH, D = 1, 4
    rng = np.random.default_rng(1)
    cache = np.zeros((2 * BS, kvH, D), np.int8)
    scales = np.zeros((2, kvH), np.float32)
    small = rng.standard_normal((1, kvH, D)).astype(np.float32)
    j, t = _write_both(cache, scales, [BS], small)
    _assert_same(j, t)
    big = (rng.standard_normal((1, kvH, D)) * 40).astype(np.float32)
    j2, t2 = _write_both(t[0], t[1], [BS + 1], big)
    _assert_same(j2, t2)
    assert t2[1][1, 0] > t[1][1, 0]                        # the scale grew
    assert (t2[0][BS] != t[0][BS]).any()                   # old entry requantized


def test_write_law_mixed_batch_with_duplicates_and_padding_like_jax():
    """A unified-step-shaped write: spans straddling blocks, several
    tokens per block (duplicate touched blocks), padding rows at slot 0,
    over a cache that already holds entries."""
    kvH, D, nb = 2, 16, 8
    rng = np.random.default_rng(2)
    cache = rng.integers(-127, 128, (nb * BS, kvH, D)).astype(np.int8)
    scales = rng.uniform(0.002, 0.02, (nb, kvH)).astype(np.float32)
    slots = np.array([3 * BS + 14, 3 * BS + 15, 4 * BS, 4 * BS + 1,
                      6 * BS + 5, 1 * BS, 0, 0, 0], np.int32)
    vals = (rng.standard_normal((len(slots), kvH, D)) * 3).astype(np.float32)
    j, t = _write_both(cache, scales, slots, vals)
    _assert_same(j, t)


# -- plain attention with scales (tests/test_kv_quant.py's case set) --------
def _quant_case(seed, spans, T, H, kvH, D, num_blocks=64, max_blocks=4):
    rng = np.random.default_rng(seed)
    shape = (num_blocks * BS, kvH, D)
    k = rng.integers(-127, 128, shape).astype(np.int8)
    v = rng.integers(-127, 128, shape).astype(np.int8)
    ks = rng.uniform(0.002, 0.02, (num_blocks, kvH)).astype(np.float32)
    vs = rng.uniform(0.002, 0.02, (num_blocks, kvH)).astype(np.float32)
    S = len(spans)
    ids = rng.permutation(np.arange(1, num_blocks))[: S * max_blocks]
    tables = ids.reshape(S, max_blocks).astype(np.int32)
    q_start, q_len, row_start = (np.zeros(S, np.int32) for _ in range(3))
    token_seq = np.zeros(T, np.int32)
    token_pos = np.full(T, -1, np.int32)
    cursor = 0
    for s, (qs, ql) in enumerate(spans):
        q_start[s], q_len[s], row_start[s] = qs, ql, cursor
        token_seq[cursor:cursor + ql] = s
        token_pos[cursor:cursor + ql] = np.arange(qs, qs + ql)
        cursor += ql
    q = rng.standard_normal((T, H, D)).astype(np.float32)
    return dict(q=q, k=k, v=v, ks=ks, vs=vs, tables=tables, q_start=q_start,
                q_len=q_len, kv_len=q_start + q_len, row_start=row_start,
                token_seq=token_seq, token_pos=token_pos)


def _jax_ragged(c, window=0):
    return np.asarray(j_attn.ragged_paged_attention(
        *(jnp.asarray(c[n]) for n in ("q", "k", "v", "tables", "token_seq",
                                      "token_pos")),
        BS, window, k_scales=jnp.asarray(c["ks"]), v_scales=jnp.asarray(c["vs"]),
    ))


def _port_ragged(c, window=0):
    t = {n: torch.from_numpy(a) for n, a in c.items()}
    return t_attn.ragged_paged_attention(
        t["q"], t["k"], t["v"], t["tables"], t["token_seq"], t["token_pos"],
        BS, window, k_scales=t["ks"], v_scales=t["vs"],
    ).numpy()


CASES = {
    "mixed_8_8_128": (0, [(36, 1), (0, 1), (0, 20), (16, 13), (0, 0)], 40, 8, 8, 128, 0),
    "mixed_8_2_128": (0, [(36, 1), (0, 1), (0, 20), (16, 13), (0, 0)], 40, 8, 2, 128, 0),
    "mixed_4_1_128": (0, [(36, 1), (0, 1), (0, 20), (16, 13), (0, 0)], 40, 4, 1, 128, 0),
    "mixed_8_2_64": (0, [(36, 1), (0, 1), (0, 20), (16, 13), (0, 0)], 40, 8, 2, 64, 0),
    "prefill_prefix_hit": (2, [(0, 24), (16, 13)], 40, 8, 2, 128, 0),
    "sliding_window": (3, [(60, 1), (0, 30), (30, 10)], 48, 8, 2, 128, 24),
    "spec_verify": (7, [(35, 4), (0, 3), (21, 1), (0, 10), (0, 0)], 32, 8, 2, 128, 0),
    "spec_verify_windowed": (7, [(35, 4), (0, 3), (21, 1), (0, 10), (0, 0)], 32, 8, 2, 128, 16),
}


@pytest.mark.parametrize("name", list(CASES))
def test_ragged_with_scales_matches_jax_oracle(name):
    seed, spans, T, H, kvH, D, window = CASES[name]
    c = _quant_case(seed, spans, T, H, kvH, D)
    got = _port_ragged(c, window)
    np.testing.assert_allclose(got, _jax_ragged(c, window), rtol=F32_TOL, atol=F32_TOL)
    owned = sum(ql for _, ql in spans)
    assert not got[owned:].any()                           # padding rows zero


def test_decode_with_scales_matches_jax_oracle():
    c = _quant_case(1, [(c - 1, 1) for c in (64, 37, 1, 16)], 16, 8, 2, 128)
    ctx = np.asarray([64, 37, 1, 16, 0], np.int32)
    tables = np.concatenate([c["tables"], c["tables"][:1]])
    q = c["q"][:5]
    want = j_attn.paged_decode_attention(
        jnp.asarray(q), jnp.asarray(c["k"]), jnp.asarray(c["v"]),
        jnp.asarray(tables), jnp.asarray(ctx), BS,
        k_scales=jnp.asarray(c["ks"]), v_scales=jnp.asarray(c["vs"]),
    )
    got = t_attn.paged_decode_attention(
        torch.from_numpy(q), torch.from_numpy(c["k"]), torch.from_numpy(c["v"]),
        torch.from_numpy(tables), torch.from_numpy(ctx), BS,
        k_scales=torch.from_numpy(c["ks"]), v_scales=torch.from_numpy(c["vs"]),
    ).numpy()
    np.testing.assert_allclose(got, np.asarray(want), rtol=F32_TOL, atol=F32_TOL)
    assert not got[-1].any()                               # idle lane


def test_int8_wrapper_runs_the_plain_version_on_cpu():
    c = _quant_case(4, [(10, 1), (0, 12), (0, 1)], 16, 8, 2, 64)
    t = {n: torch.from_numpy(a) for n, a in c.items()}
    before = t_kernel.ragged_paged_attention_cuda.launches
    got = t_kernel.ragged_paged_attention_cuda(
        t["q"], t["k"], t["v"], t["tables"], t["q_start"], t["q_len"],
        t["kv_len"], t["row_start"], BS, k_scales=t["ks"], v_scales=t["vs"],
    )
    np.testing.assert_array_equal(got.numpy(), _port_ragged(c))
    assert t_kernel.ragged_paged_attention_cuda.launches == before


def _int8_args(**over):
    c = _quant_case(5, [(3, 1), (0, 4)], 16, 8, 2, 64)
    t = {n: torch.from_numpy(a) for n, a in c.items()}
    args = dict(q=t["q"].bfloat16(), k_cache=t["k"], v_cache=t["v"],
                block_tables=t["tables"], q_start=t["q_start"], q_len=t["q_len"],
                kv_len=t["kv_len"], row_start=t["row_start"], block_size=BS,
                window=0, k_scales=t["ks"], v_scales=t["vs"])
    args.update(over)
    return args


def test_kernel_args_accept_int8_caches_with_scales():
    t_kernel.check_kernel_args(**_int8_args())
    t_kernel.check_kernel_args(**_int8_args(q=_int8_args()["q"].float()))


@pytest.mark.parametrize("over", [
    lambda a: {"k_scales": None, "v_scales": None},
    lambda a: {"v_scales": None},
    lambda a: {"k_scales": a["k_scales"][:-1].contiguous()},
    lambda a: {"v_scales": a["v_scales"].double()},
    lambda a: {"k_cache": a["k_cache"].bfloat16(), "v_cache": a["v_cache"].bfloat16()},
], ids=["no_scales", "one_scale", "scale_shape", "scale_dtype", "scales_on_bf16"])
def test_kernel_args_refuse_int8_without_matching_scales(over):
    args = _int8_args()
    args.update(over(args))
    with pytest.raises((TypeError, ValueError)):
        t_kernel.check_kernel_args(**args)


# -- the model's unified step with kv_scales --------------------------------
MBS, NUM_BLOCKS, MAX_BLOCKS = 4, 32, 8
A = [5, 17, 3, 99, 42, 7, 250, 11, 2, 64]
B = [8, 1, 200, 33, 9, 14, 77, 5, 6, 120, 31, 4, 90]
STEPS = [
    [(A, [1, 2, 3], 0), (B[:6], [4, 5, 6, 7], 0)],
    [([12], [1, 2, 3], 10), (B[6:], [4, 5, 6, 7], 6), ([3, 3, 101, 45], [8, 9], 0)],
]


def _flat_batch(lanes, S, T):
    """The runner's flat-batch build for lanes [(tokens, blocks, prefix)]."""
    token_ids, slot_mapping, token_seq = (np.zeros(T, np.int32) for _ in range(3))
    token_pos = np.full(T, -1, np.int32)
    tables = np.zeros((S, MAX_BLOCKS), np.int32)
    q_start, q_len, kv_len, row_start = (np.zeros(S, np.int32) for _ in range(4))
    cursor = 0
    for s, (toks, blocks, prefix) in enumerate(lanes):
        n = len(toks)
        row_start[s], q_start[s], q_len[s], kv_len[s] = cursor, prefix, n, prefix + n
        tables[s, :len(blocks)] = blocks
        pos = np.arange(prefix, prefix + n)
        token_ids[cursor:cursor + n] = toks
        token_pos[cursor:cursor + n] = pos
        token_seq[cursor:cursor + n] = s
        slot_mapping[cursor:cursor + n] = tables[s, pos // MBS] * MBS + pos % MBS
        cursor += n
    return (token_ids, token_pos, slot_mapping, token_seq, tables, q_start,
            q_len, kv_len, row_start)


def test_unified_with_kv_scales_matches_jax():
    """Two consecutive mixed batches over one int8 cache: logits within
    1e-4 of JAX ``llama.unified(kv_scales=...)``, and the scales and
    cache bytes it leaves behind agree (bytes within one int8 step: the
    K/V values differ by float32 ulps between the frameworks)."""
    jcfg, tcfg = JCfg.tiny_test(), ModelConfig.tiny_test()
    jparams = j_llama.init_params(jax.random.PRNGKey(3), jcfg, dtype=jnp.float32)
    tparams = t_llama.params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    shape = (NUM_BLOCKS * MBS, tcfg.num_kv_heads, tcfg.head_dim)
    L = tcfg.num_layers
    jcaches = [(jnp.zeros(shape, jnp.int8),) * 2 for _ in range(L)]
    tcaches = [(torch.zeros(shape, dtype=torch.int8), torch.zeros(shape, dtype=torch.int8))
               for _ in range(L)]
    jsc = jnp.zeros((L, 2, NUM_BLOCKS, tcfg.num_kv_heads), jnp.float32)
    tsc = torch.zeros(tuple(jsc.shape))
    attn = AttnDispatch(use_pallas=False)
    j_unified = jax.jit(lambda p, kv, sc, *meta: j_llama.unified(
        jcfg, p, kv, *meta, MBS, attn=attn, kv_scales=sc))
    for step, lanes in enumerate(STEPS):
        meta = _flat_batch(lanes, S=4, T=32)
        jl, jcaches, jsc = j_unified(jparams, jcaches, jsc, *map(jnp.asarray, meta))
        tl, tsc = t_llama.unified(
            tcfg, tparams, tcaches, *(torch.from_numpy(m) for m in meta), MBS,
            kv_scales=tsc,
        )
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=LOGIT_TOL,
                                   atol=LOGIT_TOL, err_msg=f"step {step}")
    np.testing.assert_allclose(tsc.numpy()[:, :, 1:], np.asarray(jsc)[:, :, 1:],
                               rtol=1e-5, atol=0)
    for (jk, jv), (tk, tv) in zip(jcaches, tcaches):
        for j, t in ((jk, tk), (jv, tv)):
            diff = np.abs(t.numpy()[MBS:].astype(int) - np.asarray(j)[MBS:].astype(int))
            assert diff.max() <= 1


# -- the engine ----------------------------------------------------------------
JAX_CFG = JCfg.tiny_test()
PARAMS = j_llama.init_params(jax.random.PRNGKey(0), JAX_CFG, dtype=jnp.float32)
ENGINE_KW = dict(
    dtype="float32", block_size=4, num_blocks=64, max_num_seqs=4,
    max_model_len=128, prefill_batch=2, unified_token_budget=32,
    unified_prefill_quantum=8, kv_quant="int8",
)
SCENARIOS = [
    ("concurrent", [[3, 1, 4, 1, 5], [2, 7, 1, 8], [9, 9, 8, 2, 6, 5, 3]], 8),
    ("chunked_prefill", [list(range(1, 41)), [2, 7, 1]], 8),
    ("prefix_first", [list(range(1, 18))], 6),
    ("prefix_again", [list(range(1, 18))], 6),
]


async def _serve(engine, proto, ctx_cls):
    async def one(prompt, n):
        pre = proto.PreprocessedRequest(
            token_ids=prompt, sampling=proto.SamplingOptions(temperature=0.0),
            stop=proto.StopConditions(max_tokens=n, ignore_eos=True),
        )
        toks = []
        async for raw in engine.generate(ctx_cls(pre.to_wire())):
            toks.extend(raw["token_ids"])
        return toks

    await engine.start()
    try:
        return {
            name: await asyncio.gather(*[one(p, n) for p in prompts])
            for name, prompts, n in SCENARIOS
        }
    finally:
        await engine.stop()


@pytest.fixture(scope="module")
def int8_streams():
    jax_eng = TpuEngine(JEngineConfig(model=JAX_CFG, **ENGINE_KW), params=PARAMS)
    port_eng = TorchEngine(
        EngineConfig(model=ModelConfig.tiny_test(), **ENGINE_KW),
        params=t_llama.params_from_jax(jax.tree.map(np.asarray, PARAMS), device="cpu"),
        device="cpu",
    )
    return (asyncio.run(_serve(jax_eng, j_proto, JContext)),
            asyncio.run(_serve(port_eng, t_proto, Context)), port_eng)


@pytest.mark.parametrize("name", [s[0] for s in SCENARIOS])
def test_int8_engine_streams_match_jax_int8_engine(name, int8_streams):
    jax_streams, port_streams, _ = int8_streams
    assert port_streams[name] == jax_streams[name]


def test_int8_engine_keeps_int8_state(int8_streams):
    *_, engine = int8_streams
    runner = engine.runner
    assert all(k.dtype == torch.int8 for k, _ in runner.kv_caches)
    assert runner.kv_scales.shape == (2, 2, 64, 2)
    assert runner.kv_scales[:, :, 1:].abs().sum() > 0      # blocks were written
    assert engine.prefix_hit_rate > 0


# -- config -------------------------------------------------------------------
def test_kv_quant_config_validation():
    EngineConfig(model=ModelConfig.tiny_test(), kv_quant="int8").validate()
    with pytest.raises(ValueError, match="kv_quant='fp4'"):
        EngineConfig(model=ModelConfig.tiny_test(), kv_quant="fp4").validate()
    with pytest.raises(ValueError, match="kv_quant \\+ kv_sp"):
        EngineConfig(model=ModelConfig.tiny_test(), kv_quant="int8",
                     kv_sp=True).validate()
