"""The port's DeepSeek MLA (dynamo_tpu_torch/models/llama.py ``_qkv_mla``,
``_mla_out``) and yarn rope (ops/rope.py) against the JAX package on the
CPU, mirroring tests/test_deepseek.py: the cache geometry, yarn
frequencies and both mscales, the absorbed projections, the absorbed
formulation against the standard one, tiny-mla-test's unified logits and
latent K/V, its engine streams against the JAX engine's and the no-cache
oracle, its blocks through the G2 host tier byte-exact, and the plain
ragged attention at a ``[slots, 1, 576]`` cache against the JAX
package's attention (its XLA reference, and the Pallas kernel in
interpret mode at the cache lane-padded to 640, as the JAX runner pads
it).

Inputs come from numpy seeds; weights from the JAX params tree through
``params_from_jax``. float32 within 1e-5; bf16 within 1e-2."""

import asyncio
import dataclasses

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
from dynamo_tpu.ops import rope as j_rope
from dynamo_tpu.ops.attention import AttnDispatch
from dynamo_tpu.ops.pallas.ragged_attention import ragged_paged_attention_pallas
from dynamo_tpu.runtime.engine import Context as JContext
from dynamo_tpu_torch.block_manager import KvbmConfig, KvBlockManager, KvLayoutConfig
from dynamo_tpu_torch.engine.config import EngineConfig
from dynamo_tpu_torch.engine.engine import TorchEngine
from dynamo_tpu_torch.engine.runner import ModelRunner
from dynamo_tpu_torch.llm.protocols import common as t_proto
from dynamo_tpu_torch.models import llama as t_llama
from dynamo_tpu_torch.models.config import ModelConfig
from dynamo_tpu_torch.ops import attention as t_attn
from dynamo_tpu_torch.ops import rope as t_rope
from dynamo_tpu_torch.runtime.engine import Context

TOL = 1e-5
BS = 4
NUM_BLOCKS = 48
MAX_BLOCKS = 16
ATTN = AttnDispatch(use_pallas=False)
JCFG, TCFG = JCfg.tiny_mla_test(), ModelConfig.tiny_mla_test()


def _model(seed=0, jcfg=JCFG):
    """JAX params with the norm gains and the router bias redrawn from
    numpy (so each is live), and the port's copy of them."""
    tree = jax.tree.map(np.asarray, j_llama.init_params(
        jax.random.PRNGKey(seed), jcfg, dtype=jnp.float32))
    rng = np.random.default_rng(seed)
    for layer in tree["layers"]:
        for k in ("ln_attn", "ln_mlp", "ln_kv", "ln_q", "router_bias"):
            if k in layer:
                layer[k] = (layer[k] + rng.normal(0, 0.1, layer[k].shape)).astype(np.float32)
    return jax.tree.map(jnp.asarray, tree), t_llama.params_from_jax(tree, device="cpu")


JP, TP = _model()


def _tokens(seed, n, vocab=384):
    return [int(t) for t in np.random.default_rng(seed).integers(1, vocab, n)]


def test_mla_cache_geometry():
    assert TCFG.is_mla and TCFG.num_cache_heads == 1
    assert TCFG.kv_cache_head_dim == TCFG.kv_lora_rank + TCFG.qk_rope_head_dim == 40
    assert ModelConfig.deepseek_v2_lite().kv_cache_head_dim == 576
    for quant in (None, "int8"):
        ecfg = EngineConfig(model=TCFG, dtype="float32", block_size=BS, num_blocks=32,
                            max_num_seqs=2, max_model_len=64, kv_quant=quant)
        r = ModelRunner(ecfg, params=TP, device="cpu")
        k_cache, v_cache = r.kv_caches[0]
        assert tuple(k_cache.shape) == tuple(v_cache.shape) == (32 * BS, 1, 40)
        if quant:
            assert tuple(r.kv_scales.shape) == (TCFG.num_layers, 2, 32, 1)
        assert r._block_shape() == (TCFG.num_layers, 2, BS, 1, 40)
        lay = KvLayoutConfig.for_engine(ecfg, quant=quant)
        assert (lay.num_kv_heads, lay.head_dim) == (1, 40)
        assert lay.scale_elems == (TCFG.num_layers * 2 if quant else 0)


@pytest.mark.parametrize("mscale,mscale_all_dim", [(0.707, 0.707), (1.0, 0.707), (1.0, 0.0)])
def test_yarn_frequencies_and_mscales_match_jax(mscale, mscale_all_dim):
    kw = dict(kind="yarn", factor=40.0, original_max_position=4096, beta_fast=32.0,
              beta_slow=1.0, mscale=mscale, mscale_all_dim=mscale_all_dim)
    js, ts = j_rope.RopeScaling(**kw), t_rope.RopeScaling(**kw)
    assert ts.attn_mscale() == pytest.approx(js.attn_mscale(), abs=1e-12)
    assert ts.embed_mscale() == pytest.approx(js.embed_mscale(), abs=1e-12)
    for dim in (8, 64):
        half = dim // 2
        freqs = np.exp(-np.log(np.float32(10000.0)) * (np.arange(half, dtype=np.float32) / half))
        want = np.asarray(j_rope._yarn_freqs(jnp.asarray(freqs), js))
        got = t_rope._yarn_freqs(torch.from_numpy(freqs), ts).numpy()
        np.testing.assert_allclose(got, want, rtol=TOL, atol=1e-9)
    x = np.random.default_rng(1).standard_normal((6, 3, 64)).astype(np.float32)
    pos = np.array([0, 1, 7, 100, 1000, 4000])
    want = np.asarray(j_rope.apply_rope(jnp.asarray(x), jnp.asarray(pos), 10000.0, js))
    got = t_rope.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 10000.0, ts).numpy()
    # Compared at unit magnitude: embed_mscale multiplies cos and sin.
    m = ts.embed_mscale()
    np.testing.assert_allclose(got / m, want / m, rtol=TOL, atol=TOL)
    # Long positions rotate differently from unscaled; the first
    # (high-frequency) dims extrapolate unchanged.
    far, near = torch.tensor([50000]), torch.tensor([1])
    ones = torch.ones(1, 1, 64)
    assert (t_rope.apply_rope(ones, far, 10000.0, ts) / m
            - t_rope.apply_rope(ones, far, 10000.0, None)).abs().max() > 1e-3
    assert (t_rope.apply_rope(ones, near, 10000.0, ts)[..., 0] / m
            - t_rope.apply_rope(ones, near, 10000.0, None)[..., 0]).abs().max() < 1e-5


@pytest.mark.parametrize("q_lora", [True, False], ids=["q_lora", "direct_q"])
def test_qkv_mla_and_mla_out_match_jax(q_lora):
    """The absorbed projections of one layer (q-lora or V2-Lite's direct
    q, yarn on) and the latent up-projection, on the same weights."""
    jcfg = JCFG if q_lora else JCFG.scaled(q_lora_rank=0)
    jcfg = jcfg.scaled(rope_scaling=JCfg._deepseek_yarn(0.9))
    tcfg = (TCFG if q_lora else TCFG.scaled(q_lora_rank=0)).scaled(
        rope_scaling=ModelConfig._deepseek_yarn(0.9))
    jp, tp = _model(2, jcfg)
    x = np.random.default_rng(3).standard_normal((9, 64)).astype(np.float32)
    pos = np.arange(5, 14)
    want = j_llama._qkv_mla(jp["layers"][0], jnp.asarray(x), jcfg, jnp.asarray(pos))
    cos, sin = t_rope.rope_angles(torch.from_numpy(pos), tcfg.qk_rope_head_dim,
                                  tcfg.rope_theta, tcfg.rope_scaling)
    got = t_llama._qkv_mla(tp["layers"][0], torch.from_numpy(x), tcfg, cos, sin)
    for name, g, w in zip(("q", "k_entry", "v_entry"), got, want):
        assert tuple(g.shape) == w.shape, name
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=TOL, atol=TOL, err_msg=name)
    attn = np.random.default_rng(4).standard_normal((9, 4, 40)).astype(np.float32)
    np.testing.assert_allclose(
        t_llama._mla_out(tp["layers"][0], torch.from_numpy(attn), tcfg).numpy(),
        np.asarray(j_llama._mla_out(jp["layers"][0], jnp.asarray(attn), jcfg)),
        rtol=TOL, atol=TOL)


def test_mla_ops_match_jax_in_bf16():
    """The projections on bf16 weights and activations within 1e-2."""
    jb = jax.tree.map(lambda a: a.astype(jnp.bfloat16), JP)
    tb = t_llama.params_from_jax(jax.tree.map(np.asarray, jb), device="cpu")
    assert tb["layers"][1]["router_bias"].dtype == torch.float32
    x = np.random.default_rng(5).standard_normal((7, 64)).astype(np.float32)
    pos = np.arange(7)
    want = j_llama._qkv_mla(jb["layers"][0], jnp.asarray(x, jnp.bfloat16), JCFG,
                            jnp.asarray(pos))
    cos, sin = t_rope.rope_angles(torch.from_numpy(pos), 8, TCFG.rope_theta, None)
    got = t_llama._qkv_mla(tb["layers"][0], torch.from_numpy(x).to(torch.bfloat16),
                           TCFG, cos, sin)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.float().numpy(), np.asarray(w, np.float32),
                                   rtol=1e-2, atol=1e-2)


def test_mla_absorbed_matches_standard_formulation():
    """An independent oracle for the absorbed algebra: the standard MLA
    (per-head K/V materialized from w_uk/w_uv, softmax at
    1/sqrt(dn+dr) × mscale²) written here in torch reproduces the port's
    reference_forward."""
    cfg = TCFG.scaled(rope_scaling=ModelConfig._deepseek_yarn(0.9))
    params = TP
    H = cfg.num_heads
    dn, dr, dc = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.kv_lora_rank
    toks = torch.tensor([1, 5, 9, 2, 7, 3, 3, 8, 11, 4])
    T = toks.shape[0]
    cos, sin = t_rope.rope_angles(torch.arange(T), dr, cfg.rope_theta, cfg.rope_scaling)

    def standard(layer, h):
        cq = t_llama.rms_norm(h @ layer["w_dq"], layer["ln_q"], cfg.rms_eps)
        q = (cq @ layer["w_uq"]).reshape(T, H, dn + dr)
        q_pe = t_rope.rotate(q[..., dn:], cos, sin)
        ckr = h @ layer["w_dkv"]
        c = t_llama.rms_norm(ckr[:, :dc], layer["ln_kv"], cfg.rms_eps)
        k_pe = t_rope.rotate(ckr[:, None, dc:], cos, sin)[:, 0]
        k_nope = torch.einsum("tc,hnc->thn", c, layer["w_uk"])
        v = torch.einsum("tc,hvc->thv", c, layer["w_uv"])
        k = torch.cat([k_nope, k_pe[:, None].expand(T, H, dr)], -1)
        qh = torch.cat([q[..., :dn], q_pe], -1)
        scale = (dn + dr) ** -0.5 * cfg.rope_scaling.attn_mscale() ** 2
        scores = torch.einsum("thd,shd->hts", qh, k) * scale
        scores = scores.masked_fill(~torch.tril(torch.ones(T, T, dtype=torch.bool)), -1e30)
        o = torch.einsum("hts,shv->thv", torch.softmax(scores, -1), v)
        return o.reshape(T, -1) @ layer["wo"]

    x = params["embed"][toks]
    for layer in params["layers"]:
        x = x + standard(layer, t_llama.rms_norm(x, layer["ln_attn"], cfg.rms_eps))
        x = x + t_llama._mlp(layer, t_llama.rms_norm(x, layer["ln_mlp"], cfg.rms_eps), cfg)
    standard_logits = t_llama._logits(params, cfg, x)
    absorbed = t_llama.reference_forward(cfg, params, toks)
    np.testing.assert_allclose(standard_logits.numpy(), absorbed.numpy(), rtol=2e-4, atol=2e-4)
    assert (standard_logits.argmax(-1) == absorbed.argmax(-1)).all()


def test_reference_forward_matches_jax():
    toks = np.asarray(_tokens(11, 48))
    want = np.asarray(j_llama.reference_forward(JCFG, JP, jnp.asarray(toks)))
    got = t_llama.reference_forward(TCFG, TP, torch.from_numpy(toks)).numpy()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def _flat_batch(lanes, S, T):
    """The runner's flat-batch build for lanes [(tokens, block_ids,
    prefix_len)], as numpy arrays."""
    token_ids = np.zeros(T, np.int32)
    token_pos = np.full(T, -1, np.int32)
    slot_mapping = np.zeros(T, np.int32)
    token_seq = np.zeros(T, np.int32)
    tables = np.zeros((S, MAX_BLOCKS), np.int32)
    q_start, q_len, kv_len, row_start = (np.zeros(S, np.int32) for _ in range(4))
    cursor = 0
    for s, (toks, blocks, prefix) in enumerate(lanes):
        n = len(toks)
        row_start[s], q_start[s], q_len[s], kv_len[s] = cursor, prefix, n, prefix + n
        tables[s, :len(blocks)] = blocks
        token_ids[cursor:cursor + n] = toks
        token_pos[cursor:cursor + n] = np.arange(prefix, prefix + n)
        token_seq[cursor:cursor + n] = s
        for j in range(n):
            p = prefix + j
            slot_mapping[cursor + j] = blocks[p // BS] * BS + p % BS
        cursor += n
    return (token_ids, token_pos, slot_mapping, token_seq, tables, q_start,
            q_len, kv_len, row_start)


A, B, C = _tokens(1, 40), _tokens(2, 44), _tokens(3, 6)
BLOCKS = {"A": list(range(1, 12)), "B": list(range(12, 24)), "C": [24, 25, 26]}
STEPS = [
    [(A[:36], BLOCKS["A"], 0), (B[:20], BLOCKS["B"], 0)],
    [(A[36:37], BLOCKS["A"], 36), (B[20:], BLOCKS["B"], 20), (C, BLOCKS["C"], 0)],
    [(A[37:38], BLOCKS["A"], 37), (C[:1], BLOCKS["C"], 6)],
]


def test_unified_logits_and_latent_kv_match_jax():
    """Three mixed dispatches over one [slots, 1, 40] latent cache: the
    logits and every layer's cached entries equal the JAX package's."""
    shape = (NUM_BLOCKS * BS, 1, TCFG.kv_cache_head_dim)
    jc = [(jnp.zeros(shape), jnp.zeros(shape)) for _ in range(TCFG.num_layers)]
    tc = [(torch.zeros(shape), torch.zeros(shape)) for _ in range(TCFG.num_layers)]
    j_unified = jax.jit(lambda p, kv, *meta: j_llama.unified(JCFG, p, kv, *meta, BS, attn=ATTN))
    for step, lanes in enumerate(STEPS):
        meta = _flat_batch(lanes, S=4, T=96)
        want, jc = j_unified(JP, jc, *map(jnp.asarray, meta))
        got = t_llama.unified(TCFG, TP, tc, *(torch.from_numpy(m) for m in meta), BS)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL,
                                   err_msg=f"step {step}")
    for li, ((jk, jv), (tk, tv)) in enumerate(zip(jc, tc)):
        np.testing.assert_allclose(tk.numpy()[BS:], np.asarray(jk)[BS:], rtol=TOL, atol=TOL,
                                   err_msg=f"layer {li} k")
        np.testing.assert_allclose(tv.numpy()[BS:], np.asarray(jv)[BS:], rtol=TOL, atol=TOL,
                                   err_msg=f"layer {li} v")
        # The value entry is the latent, zero past kv_lora_rank.
        assert not tv[:, :, TCFG.kv_lora_rank:].any()


async def _collect(engine, proto, ctx_cls, prompt, n):
    pre = proto.PreprocessedRequest(
        token_ids=prompt, sampling=proto.SamplingOptions(temperature=0.0),
        stop=proto.StopConditions(max_tokens=n, ignore_eos=True),
    )
    out = []
    async for raw in engine.generate(ctx_cls(pre.to_wire())):
        out += proto.EngineOutput.from_wire(raw).token_ids
    return out


async def _serve(engine, proto, ctx_cls, prompts, n):
    await engine.start()
    try:
        return await asyncio.gather(*[_collect(engine, proto, ctx_cls, p, n) for p in prompts])
    finally:
        await engine.stop()


def _oracle(cfg, params, prompt, n):
    toks, out = list(prompt), []
    for _ in range(n):
        logits = t_llama.reference_forward(cfg, params, torch.tensor(toks))
        out.append(int(torch.argmax(logits[-1])))
        toks.append(out[-1])
    return out


@pytest.mark.parametrize("kv_quant", [None, "int8"])
def test_tiny_mla_engine_streams_match_the_jax_engine_and_the_oracle(kv_quant):
    """tiny-mla-test (MLA, sigmoid-routed and shared experts, a dense
    first layer) served by both engines gives byte-identical greedy
    streams; unquantized they equal the no-cache oracle."""
    prompts = [[1, 5, 9, 2, 7], _tokens(12, 23)]
    kw = dict(dtype="float32", block_size=BS, num_blocks=64, max_num_seqs=2,
              max_model_len=128, kv_quant=kv_quant, unified_token_budget=32,
              unified_prefill_quantum=16)
    j = asyncio.run(_serve(TpuEngine(JEngineConfig(model=JCFG, **kw), params=JP),
                           j_proto, JContext, prompts, 10))
    t = asyncio.run(_serve(TorchEngine(EngineConfig(model=TCFG, **kw), params=TP,
                                       device="cpu"), t_proto, Context, prompts, 10))
    assert t == j
    if kv_quant is None:
        assert t == [_oracle(TCFG, TP, p, 10) for p in prompts]


@pytest.mark.anyio
async def test_tiny_mla_blocks_round_trip_through_the_host_tier():
    """A tiny-mla-test engine offloads its prompt's full blocks to G2 at
    the latent layout; a fresh engine onboards them, its device blocks
    byte-equal the first engine's, and it streams the same tokens."""
    ecfg = EngineConfig(model=TCFG, dtype="float32", block_size=16, num_blocks=32,
                        max_num_seqs=2, max_model_len=128)
    lay = KvLayoutConfig.for_engine(ecfg, quant=None)
    kvbm = await KvBlockManager(KvbmConfig(layout=lay, host_blocks=16)).start()
    prompt = _tokens(21, 40)                       # 2 full blocks + a tail
    eng_a = TorchEngine(ecfg, params=TP, device="cpu", block_manager=kvbm)
    await eng_a.start()
    cold = await _collect(eng_a, t_proto, Context, prompt, 6)
    await kvbm.drain_offers()
    entries = {h: parent for h, parent, _ in kvbm.host_entries()}
    assert len(entries) == 2
    chain = [h for h, parent in entries.items() if parent not in entries]
    chain += [h for h, parent in entries.items() if parent == chain[0]]
    rows_a = eng_a.runner.gather_many(eng_a.allocator.match_prefix(chain))
    await eng_a.stop()

    eng_b = TorchEngine(dataclasses.replace(ecfg, kvbm_adaptive_gate=False),
                        params=TP, device="cpu", block_manager=kvbm)
    await eng_b.start()
    warm = await _collect(eng_b, t_proto, Context, prompt, 6)
    assert warm == cold
    assert eng_b.readiness()["kv_reused_host_blocks_total"] == 2
    rows_b = eng_b.runner.gather_many(eng_b.allocator.match_prefix(chain))
    await eng_b.stop()
    await kvbm.stop()
    assert rows_a.shape == (2, TCFG.num_layers, 2, 16, 1, 40)
    np.testing.assert_array_equal(rows_b, rows_a)


def _latent_case(seed, spans, T, H=16, D=576, num_blocks=56, max_blocks=8):
    """Numpy inputs at MLA's entry: one shared cache head of D dims for
    H query heads; spans [(q_start, q_len)] packed from row 0."""
    rng = np.random.default_rng(seed)
    S = len(spans)
    k = rng.standard_normal((num_blocks * 16, 1, D)).astype(np.float32)
    v = rng.standard_normal((num_blocks * 16, 1, D)).astype(np.float32)
    tables = rng.permutation(np.arange(1, num_blocks))[: S * max_blocks]
    tables = tables.reshape(S, max_blocks).astype(np.int32)
    q_start = np.array([a for a, _ in spans], np.int32)
    q_len = np.array([b for _, b in spans], np.int32)
    row_start = np.zeros(S, np.int32)
    token_seq = np.zeros(T, np.int32)
    token_pos = np.full(T, -1, np.int32)
    cursor = 0
    for s, (qs, ql) in enumerate(spans):
        row_start[s] = cursor
        token_seq[cursor:cursor + ql] = s
        token_pos[cursor:cursor + ql] = np.arange(qs, qs + ql)
        cursor += ql
    q = rng.standard_normal((T, H, D)).astype(np.float32)
    return dict(q=q, k=k, v=v, tables=tables, q_start=q_start, q_len=q_len,
                kv_len=q_start + q_len, row_start=row_start, token_seq=token_seq,
                token_pos=token_pos)


def _port_ragged(c, dtype=torch.float32, scales=None):
    t = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    k, v = t(c["k"]), t(c["v"])
    if scales is None:
        k, v = k.to(dtype), v.to(dtype)
    return t_attn.ragged_paged_attention(
        t(c["q"]).to(dtype), k, v, t(c["tables"]), t(c["token_seq"]),
        t(c["token_pos"]), 16, 0,
        **({} if scales is None else {"k_scales": t(scales[0]), "v_scales": t(scales[1])}),
    ).float().numpy()


SPANS = [(97, 1), (0, 1), (40, 3), (0, 20), (60, 13), (0, 0)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_ragged_at_the_latent_entry_matches_jax(dtype):
    """The port's plain ragged attention at [slots, 1, 576] (16 heads, a
    decode span, a verify span, prefills behind a prefix, an idle row)
    against the JAX package's XLA reference; padding rows zero."""
    c = _latent_case(20, SPANS, 48)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    want = np.asarray(j_attn.ragged_paged_attention(
        jnp.asarray(c["q"], jdt), jnp.asarray(c["k"], jdt), jnp.asarray(c["v"], jdt),
        jnp.asarray(c["tables"]), jnp.asarray(c["token_seq"]),
        jnp.asarray(c["token_pos"]), 16, 0).astype(jnp.float32))
    got = _port_ragged(c, getattr(torch, dtype))
    tol = TOL if dtype == "float32" else 1e-2
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)
    assert not got[int(c["q_len"].sum()):].any()


def test_plain_ragged_at_the_latent_entry_int8_matches_jax():
    """int8 latent pages under one f32 scale per (block, head) for the
    whole 576-wide entry, against the JAX reference's dequantizing read."""
    c = _latent_case(21, SPANS, 48)
    rng = np.random.default_rng(22)
    k8, v8 = (np.clip(np.round(x * 40), -127, 127).astype(np.int8) for x in (c["k"], c["v"]))
    ks, vs = (rng.uniform(0.002, 0.05, (56, 1)).astype(np.float32) for _ in range(2))
    want = np.asarray(j_attn.ragged_paged_attention(
        jnp.asarray(c["q"]), jnp.asarray(k8), jnp.asarray(v8), jnp.asarray(c["tables"]),
        jnp.asarray(c["token_seq"]), jnp.asarray(c["token_pos"]), 16, 0,
        k_scales=jnp.asarray(ks), v_scales=jnp.asarray(vs)))
    got = _port_ragged(dict(c, k=k8, v=v8), scales=(ks, vs))
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def test_plain_ragged_at_the_latent_entry_matches_the_pallas_kernel():
    """Against the TPU kernel itself in interpret mode, its cache and q
    lane-padded 576 → 640 as the JAX runner pads them (zero lanes add
    nothing to a score; the kernel's scale is the unpadded width's, so
    q carries the ratio)."""
    c = _latent_case(23, [(40, 1), (0, 9), (20, 5)], 16, num_blocks=16, max_blocks=4)
    pad = ((0, 0), (0, 0), (0, 64))
    qp = np.pad(c["q"], pad) * np.float32((640 / 576) ** 0.5)
    want = np.asarray(ragged_paged_attention_pallas(
        jnp.asarray(qp), jnp.asarray(np.pad(c["k"], pad)), jnp.asarray(np.pad(c["v"], pad)),
        jnp.asarray(c["tables"]), jnp.asarray(c["q_start"]), jnp.asarray(c["q_len"]),
        jnp.asarray(c["kv_len"]), jnp.asarray(c["row_start"]), 16))[..., :576]
    np.testing.assert_allclose(_port_ragged(c), want, rtol=1e-4, atol=1e-4)


def test_int8_write_law_at_the_latent_entry_matches_jax():
    """quantize_kv_write at kvH = 1, D = 576 equals the JAX law: int8
    entries and scales."""
    from dynamo_tpu.ops.quant import quantize_kv_write as j_write
    from dynamo_tpu_torch.ops.quant import quantize_kv_write as t_write

    rng = np.random.default_rng(24)
    cache = np.zeros((8 * 16, 1, 576), np.int8)
    scales = np.zeros((8, 1), np.float32)
    jc, js = jnp.asarray(cache), jnp.asarray(scales)
    tc, ts = torch.from_numpy(cache.copy()), torch.from_numpy(scales.copy())
    for step, slots in enumerate([np.arange(16, 40), np.array([40, 41, 0, 0]),
                                  np.array([42, 56, 57])]):
        vals = (rng.standard_normal((len(slots), 1, 576)) * (1 + step)).astype(np.float32)
        jc, js = j_write(jc, js, jnp.asarray(slots, jnp.int32), jnp.asarray(vals), 16)
        ts = t_write(tc, ts, torch.from_numpy(slots), torch.from_numpy(vals), 16)
        np.testing.assert_array_equal(tc.numpy()[16:], np.asarray(jc)[16:])
        np.testing.assert_allclose(ts.numpy()[1:], np.asarray(js)[1:], rtol=1e-7)


def test_phase_split_entry_points_serve_mla_on_the_cpu():
    """prefill_batch and decode (the decode and prefill kernels' plain
    versions on the CPU) equal the JAX package's at the latent cache."""
    shape = (NUM_BLOCKS * BS, 1, TCFG.kv_cache_head_dim)
    jc = [(jnp.zeros(shape), jnp.zeros(shape)) for _ in range(TCFG.num_layers)]
    tc = [(torch.zeros(shape), torch.zeros(shape)) for _ in range(TCFG.num_layers)]
    prompts, lanes = [A[:20], C], [BLOCKS["A"], BLOCKS["C"]]
    N, T = 2, 24
    tokens = np.zeros((N, T), np.int32)
    slots = np.zeros((N, T), np.int32)
    for i, (p, blocks) in enumerate(zip(prompts, lanes)):
        tokens[i, :len(p)] = p
        for j in range(len(p)):
            slots[i, j] = blocks[j // BS] * BS + j % BS
    tables = np.zeros((N, MAX_BLOCKS), np.int32)
    for i, blocks in enumerate(lanes):
        tables[i, :len(blocks)] = blocks
    prefix = np.zeros(N, np.int32)
    total = np.asarray([len(p) for p in prompts], np.int32)
    # Jitted: op-by-op JAX dispatch of the MLA trunk is what took this
    # test's time.
    j_prefill = jax.jit(lambda p, kv, *a: j_llama.prefill_batch(JCFG, p, kv, *a, BS, attn=ATTN))
    j_decode = jax.jit(lambda p, kv, *a: j_llama.decode(JCFG, p, kv, *a, BS, attn=ATTN))
    want, jc = j_prefill(JP, jc, jnp.asarray(tokens), jnp.asarray(tables), jnp.asarray(slots),
                         jnp.asarray(prefix), jnp.asarray(total))
    got = t_llama.prefill_batch(
        TCFG, TP, tc, *(torch.from_numpy(a) for a in (tokens, tables, slots, prefix, total)), BS)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)
    nxt = np.argmax(np.asarray(want), -1).astype(np.int32)
    pos = total.copy()
    slot = np.array([lanes[i][p // BS] * BS + p % BS for i, p in enumerate(pos)], np.int32)
    want, jc = j_decode(JP, jc, jnp.asarray(nxt), jnp.asarray(pos), jnp.asarray(tables),
                        jnp.asarray(pos + 1), jnp.asarray(slot))
    got = t_llama.decode(TCFG, TP, tc, torch.from_numpy(nxt), torch.from_numpy(pos),
                         torch.from_numpy(tables), torch.from_numpy(pos + 1),
                         torch.from_numpy(slot), BS)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)


def test_decode_and_prefill_kernels_refuse_the_latent_entry_by_name():
    """On a CUDA tensor the decode and prefill kernels stop at 256 and
    name the ROADMAP item; the ragged kernel's checks take 576."""
    from dynamo_tpu_torch.ops.kernels import _checks
    from dynamo_tpu_torch.ops.kernels import ragged_attention as t_kernel

    with pytest.raises(ValueError, match="ROADMAP B8"):
        _checks.check_head_dim(576, wide=False)
    _checks.check_head_dim(576, wide=True)
    for bad in (592, 640, 320 + 16):
        with pytest.raises(ValueError):
            _checks.check_head_dim(bad, wide=True)
    c = _latent_case(25, [(5, 1), (0, 9)], 16, num_blocks=8, max_blocks=2)
    t = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    t_kernel.check_kernel_args(
        t(c["q"]).to(torch.bfloat16), t(c["k"]).to(torch.bfloat16),
        t(c["v"]).to(torch.bfloat16), t(c["tables"]), t(c["q_start"]), t(c["q_len"]),
        t(c["kv_len"]), t(c["row_start"]), 16, 0)


MOE_PRESETS = ["tiny-moe-test", "tiny-mla-test", "deepseek-v2-lite", "deepseek-r1",
               "mixtral-8x7b"]


@pytest.mark.parametrize("name", MOE_PRESETS)
def test_moe_and_mla_presets_match_jax(name):
    from dynamo_tpu.models.config import PRESETS as J_PRESETS
    from dynamo_tpu_torch.models.config import PRESETS

    got, want = PRESETS[name](), J_PRESETS[name]()
    a, b = dataclasses.asdict(got), dataclasses.asdict(want)
    assert a.pop("rope_scaling") == b.pop("rope_scaling")
    assert a == b
    assert got.kv_cache_head_dim == want.kv_cache_head_dim
    assert got.num_cache_heads == want.num_cache_heads
    assert [got.moe_layer(i) for i in range(got.num_layers)] == [
        want.moe_layer(i) for i in range(want.num_layers)]


@pytest.mark.parametrize("name", MOE_PRESETS)
def test_init_params_shapes_match_jax_at_narrowed_widths(name):
    """The MLA and MoE key sets and shapes of each preset at its own
    heads, latent and expert counts (hidden, MLP, vocabulary and depth
    narrowed), against the JAX package's init; param_count counts them."""
    from dynamo_tpu.models.config import PRESETS as J_PRESETS
    from dynamo_tpu_torch.models.config import PRESETS

    narrow = dict(hidden_size=64, intermediate_size=96, num_layers=3, vocab_size=256,
                  moe_intermediate_size=32 if PRESETS[name]().moe_intermediate_size else 0,
                  num_experts=min(PRESETS[name]().num_experts, 16))
    jcfg = J_PRESETS[name]().scaled(**narrow)
    jshapes = jax.tree.map(lambda a: tuple(a.shape), jax.eval_shape(
        lambda: j_llama.init_params(jax.random.PRNGKey(0), jcfg)))
    tcfg = PRESETS[name]().scaled(**narrow)
    tparams = t_llama.init_params(tcfg, torch.Generator().manual_seed(0), device="cpu")
    assert set(tparams) == set(jshapes)
    for tl, jl in zip(tparams["layers"], jshapes["layers"]):
        assert {k: tuple(v.shape) for k, v in tl.items()} == jl
    assert tcfg.param_count() == sum(t.numel() for t in jax.tree.leaves(tparams))


def test_param_count_admits_deepseek_v2_lite_and_refuses_the_larger_moes():
    """deepseek-v2-lite counts 15.7B weights (31.4 GB in bf16) and
    validates; mixtral-8x7b (~93 GB) and deepseek-r1 (671B) are refused
    as over one card, the parallel slice's (A4)."""
    lite = ModelConfig.deepseek_v2_lite()
    assert lite.param_count() == pytest.approx(15.7e9, rel=0.01)
    EngineConfig(model=lite, max_model_len=4096, num_blocks=512).validate()
    assert ModelConfig.mixtral_8x7b().param_count() == pytest.approx(46.7e9, rel=0.01)
    for model in (ModelConfig.mixtral_8x7b(), ModelConfig.deepseek_r1()):
        with pytest.raises(ValueError, match="A4"):
            EngineConfig(model=model).validate()


def test_local_model_prepares_deepseek_v2_lite():
    from dynamo_tpu_torch.llm.local_model import LocalModel

    assert LocalModel.prepare("preset:deepseek-v2-lite").config == ModelConfig.deepseek_v2_lite()


def _teacher_forced(ref, prompts, streams):
    """(argmax agreement, largest log-prob gap at a disagreement) of
    streams against ``ref(tokens) -> logits``."""
    hits = n = 0
    gaps = []
    for p, s in zip(prompts, streams):
        lp = torch.log_softmax(torch.from_numpy(np.array(ref(p + s), np.float32)), -1)
        rows = lp[len(p) - 1:-1]
        for i, tok in enumerate(s):
            n += 1
            best = int(rows[i].argmax())
            if best == tok:
                hits += 1
            else:
                gaps.append(float(rows[i, best] - rows[i, tok]))
    return hits / n, max(gaps, default=0.0)


def _jax_reference(cfg, params, T: int = 256):
    """JAX's ``reference_forward`` jitted once at T rows: the trunk is
    causal, so the padding after a sequence leaves its rows' logits as
    they are (op-by-op dispatch of the unjitted trunk took most of the
    serve test's time)."""
    fn = jax.jit(lambda t: j_llama.reference_forward(cfg, params, t))

    def ref(toks):
        padded = np.zeros(T, np.int32)
        padded[:len(toks)] = toks
        return np.asarray(fn(jnp.asarray(padded)))[:len(toks)]

    return ref


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_mla_serve_against_its_reference_in_both_packages(dtype):
    """A DeepSeek-shaped model at reduced width (hidden 128, 8 layers, 16
    experts top-6, drop-free), random weights, each package's engine
    against its own no-cache reference, teacher-forced. float32: both
    exact, and the two packages' streams equal. bfloat16: random-weight
    top-k routing turns rounding into other experts, so neither engine
    matches its reference exactly (read: JAX 0.938 / 0.172 nats, the
    port 0.958 / 0.045 since its experts keep ``h`` in float32 as JAX's
    do, 0.917 / 0.176 before); the port's agreement is held to at most
    0.05 below the JAX engine's, and its largest gap to at most 0.05
    nats above (printed for both packages with -s). The float32 case
    jits JAX's reference once (``_jax_reference``); the bf16 case keeps
    the op-by-op evaluation these readings were taken with (XLA's fused
    program rounds bf16 elsewhere and reads 0.979 / 0.024)."""
    kw = dict(hidden_size=128, intermediate_size=256, num_layers=8, moe_intermediate_size=32,
              num_experts=16, vocab_size=1024, moe_dispatch="dense", max_position=4096,
              kv_lora_rank=128, num_heads=4, num_kv_heads=4)
    jc, tc = JCfg.deepseek_v2_lite().scaled(**kw), ModelConfig.deepseek_v2_lite().scaled(**kw)
    jparams = j_llama.init_params(jax.random.PRNGKey(0), jc, dtype=getattr(jnp, dtype))
    tparams = t_llama.params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, 1024, n).tolist() for n in rng.integers(64, 160, 3)]
    ek = dict(dtype=dtype, block_size=16, num_blocks=128, max_num_seqs=4, max_model_len=512,
              unified_token_budget=64, unified_prefill_quantum=16)
    js = asyncio.run(_serve(TpuEngine(JEngineConfig(model=jc, **ek), params=jparams),
                            j_proto, JContext, prompts, 16))
    ts = asyncio.run(_serve(TorchEngine(EngineConfig(model=tc, **ek), params=tparams,
                                        device="cpu"), t_proto, Context, prompts, 16))
    j_ref = (_jax_reference(jc, jparams) if dtype == "float32"
             else lambda t: j_llama.reference_forward(jc, jparams, jnp.asarray(t)))
    j_agree, j_gap = _teacher_forced(j_ref, prompts, js)
    t_agree, t_gap = _teacher_forced(
        lambda t: t_llama.reference_forward(tc, tparams, torch.tensor(t)).numpy(), prompts, ts)
    print(f"{dtype}: jax {j_agree:.3f} / {j_gap:.4f} nats, port {t_agree:.3f} / {t_gap:.4f}")
    if dtype == "float32":
        assert (j_agree, t_agree) == (1.0, 1.0) and ts == js
    else:
        assert all(len(s) == 16 for s in ts)
        assert t_agree >= j_agree - 0.05 and t_gap <= j_gap + 0.05


def test_layer_divergence_tool_reads_no_divergence_in_float32_on_the_cpu():
    """tools/layer_divergence.py at tiny-mla-test in float32 on the CPU,
    where the chunked cached prefill and the no-cache trunk run the same
    plain code: every layer's residual within 1e-5 after attention and
    after the MLP, no routing set differs, the greedy streams agree with
    the no-cache reference on every token with both attentions, and the
    reference agrees with itself when rows are appended."""
    from dynamo_tpu_torch.tools import layer_divergence as ld

    cfg = ModelConfig.tiny_mla_test().scaled(moe_dispatch="dense")
    g = torch.Generator()
    g.manual_seed(2)
    params = t_llama.init_params(cfg, g, dtype=torch.float32, device="cpu")
    rng = np.random.default_rng(15)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist() for n in (40, 57)]
    rows = ld.divergence(cfg, params, prompts[1], 16, 16, "cpu", plain=False)
    assert len(rows) == cfg.num_layers
    for li, *errs in rows:
        assert max(errs[:4]) <= 1e-5
        assert len(errs) == (5 if cfg.moe_layer(li) else 4)
        assert not cfg.moe_layer(li) or errs[4] == 0.0
    streams = {plain: ld.greedy(cfg, params, prompts, 6, 16, 16, "cpu", plain)
               for plain in (False, True)}
    assert streams[False] == streams[True] and all(len(s) == 6 for s in streams[False])
    assert ld.agreement(cfg, params, prompts, streams[False]) == {"agreement": 1.0,
                                                                   "max_gap": 0.0}
    floor = ld.noise_floor(cfg, params, prompts, streams[False], pad=32)
    assert floor["self_agreement"] == 1.0
