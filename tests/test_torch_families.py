"""The port's dense model families (dynamo_tpu_torch/models/) against the
JAX package on the CPU: Gemma-3 (tiny-gemma-test: GeGLU, (1+w) and
sandwich norms, scaled embeddings, QK-norm, local/global windows with a
local rope base, the query scale fold), Qwen3's QK-norm, Qwen2's qkv bias
and its max_window_layers gate, and Mistral's sliding window.

The same weights go through both packages: a JAX params tree whose norm
gains and biases are redrawn from a numpy seed (so every family weight is
live, not an identity), carried across by ``params_from_jax``. JAX
attention runs as its own tests run it on the CPU (the plain XLA
versions, ``AttnDispatch(use_pallas=False)``). float32; logits and K/V
within 1e-5, and greedy engine streams byte-identical."""

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
from dynamo_tpu.models.config import PRESETS as J_PRESETS
from dynamo_tpu.models.config import ModelConfig as JCfg
from dynamo_tpu.ops.attention import AttnDispatch
from dynamo_tpu.runtime.engine import Context as JContext
from dynamo_tpu_torch.engine.config import EngineConfig
from dynamo_tpu_torch.engine.engine import TorchEngine
from dynamo_tpu_torch.llm.local_model import LocalModel
from dynamo_tpu_torch.llm.protocols import common as t_proto
from dynamo_tpu_torch.models import llama as t_llama
from dynamo_tpu_torch.models.config import PRESETS, ModelConfig
from dynamo_tpu_torch.runtime.engine import Context

TOL = 1e-5
BS = 4
NUM_BLOCKS = 48
MAX_BLOCKS = 16
ATTN = AttnDispatch(use_pallas=False)


def _family(name):
    """(JAX config, port config) of one family at test size."""
    if name == "gemma":
        return JCfg.tiny_gemma_test(), ModelConfig.tiny_gemma_test()
    change = {
        "qk_norm": dict(qk_norm=True),
        "qkv_bias": dict(qkv_bias=True),
        "sliding_window": dict(sliding_window=8),
        "qwen2_window": dict(qkv_bias=True, sliding_window=8, max_window_layers=1),
    }[name]
    return (dataclasses.replace(JCfg.tiny_test(), name=f"tiny-{name}", **change),
            ModelConfig.tiny_test().scaled(name=f"tiny-{name}", **change))


FAMILIES = ["gemma", "qk_norm", "qkv_bias", "sliding_window", "qwen2_window"]
_NOISY = ("ln_attn", "ln_mlp", "ln_post_attn", "ln_post_mlp", "ln_q_head",
          "ln_k_head", "bq", "bk", "bv")


def _params(jcfg, seed=3):
    """JAX init, then every norm gain and bias redrawn from numpy: the
    JAX params (jnp) and the port's (params_from_jax)."""
    tree = jax.tree.map(np.asarray, j_llama.init_params(
        jax.random.PRNGKey(seed), jcfg, dtype=jnp.float32))
    rng = np.random.default_rng(seed)
    for layer in tree["layers"]:
        for k in _NOISY:
            if k in layer:
                layer[k] = (layer[k] + rng.normal(0, 0.2, layer[k].shape)).astype(np.float32)
    tree["ln_f"] = (tree["ln_f"] + rng.normal(0, 0.2, tree["ln_f"].shape)).astype(np.float32)
    return jax.tree.map(jnp.asarray, tree), t_llama.params_from_jax(tree, device="cpu")


@pytest.fixture(scope="module", params=FAMILIES)
def family(request):
    jcfg, tcfg = _family(request.param)
    return (request.param, jcfg, tcfg, *_params(jcfg))


def _tokens(seed, n, vocab=384):
    return [int(t) for t in np.random.default_rng(seed).integers(1, vocab, n)]


def test_reference_forward_matches_jax(family):
    _, jcfg, tcfg, jp, tp = family
    toks = np.asarray(_tokens(11, 48))
    want = np.asarray(j_llama.reference_forward(jcfg, jp, jnp.asarray(toks)))
    got = t_llama.reference_forward(tcfg, tp, torch.from_numpy(toks)).numpy()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def test_family_ops_match_jax_in_bf16(family):
    """The family's pieces on bf16 weights and activations, one layer
    against the JAX package's within the bf16 tolerance: the embedding
    (with its scale), the family's norm, q/k/v (bias, QK-norm, the query
    scale fold), the attention residual (post-norm) and the gated MLP
    branch (GeGLU, post-norm). (Whole-trunk bf16 logits part by more:
    XLA keeps fused intermediates in f32, torch rounds each op.)"""
    _, jcfg, tcfg, jp, _ = family
    jb = jax.tree.map(lambda a: a.astype(jnp.bfloat16), jp)
    tb = t_llama.params_from_jax(jax.tree.map(np.asarray, jb), device="cpu")
    jl, tl = jb["layers"][0], tb["layers"][0]
    toks = np.asarray(_tokens(11, 24))
    x = np.random.default_rng(1).normal(0, 1, (24, tcfg.hidden_size)).astype(np.float32)
    jx, tx = jnp.asarray(x, jnp.bfloat16), torch.from_numpy(x).to(torch.bfloat16)

    def close(got, want, what):
        np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                                   rtol=1e-2, atol=1e-2, err_msg=what)

    close(t_llama._embed(tb, tcfg, torch.from_numpy(toks).long()),
          j_llama._embed(jb, jcfg, jnp.asarray(toks)), "embed")
    close(t_llama._ln(tx, tl["ln_attn"], tcfg), j_llama._ln(jx, jl["ln_attn"], jcfg), "norm")
    for name, t, j in zip("qkv", t_llama._qkv(tl, tx, tcfg), j_llama._qkv(jl, jx, jcfg)):
        close(t, j, name)
    close(t_llama._residual_attn(tx, tl, tx, tcfg),
          j_llama._residual_attn(jx, jl, jx, jcfg), "attention residual")
    # The MLP branch before its residual add (the add of two bf16 values
    # of magnitude ~2 rounds at their ulp, 0.0156, whatever the branch).
    t_m = t_llama._swiglu(tl, t_llama._ln(tx, tl["ln_mlp"], tcfg), tcfg.hidden_act)
    j_m = j_llama._swiglu(jl, j_llama._ln(jx, jl["ln_mlp"], jcfg), act=jcfg.hidden_act)
    if tcfg.post_norms:
        t_m = t_llama._ln(t_m, tl["ln_post_mlp"], tcfg)
        j_m = j_llama._ln(j_m, jl["ln_post_mlp"], jcfg)
    close(t_m, j_m, "mlp branch")


def test_residual_stream_and_logits_stay_float32_under_bf16_weights(family):
    """A deliberate difference from the JAX package (which rounds both to
    bf16): with bf16 weights the residual stream and the head's output
    are float32 (logits off the bf16 grid), and the logits sit nearer a
    wider evaluation of the same bf16 weights (float64 weights and
    residual stream) than the JAX package's bf16-rounded ones do."""
    _, jcfg, tcfg, jp, _ = family
    jb = jax.tree.map(lambda a: a.astype(jnp.bfloat16), jp)
    tree = jax.tree.map(np.asarray, jb)
    tb = t_llama.params_from_jax(tree, device="cpu")
    t64 = t_llama.params_from_jax(tree, dtype=torch.float64, device="cpu")
    toks = torch.tensor(_tokens(11, 40))
    assert t_llama.hidden_states(tcfg, tb, toks).dtype == torch.float32
    got = t_llama.reference_forward(tcfg, tb, toks)
    assert got.dtype == torch.float32
    assert (got != got.to(torch.bfloat16).float()).any()
    exact = t_llama.reference_forward(tcfg, t64, toks).double()
    jax_bf16 = torch.from_numpy(np.array(
        j_llama.reference_forward(jcfg, jb, jnp.asarray(toks.numpy())))).double()
    assert (got.double() - exact).abs().mean() < (jax_bf16 - exact).abs().mean()


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
# Three mixed batches over one paged cache. A and B reach past every
# window of the families (8, and tiny-gemma's 32): A's later decode and
# B's second quantum attend across it.
STEPS = [
    [(A[:36], BLOCKS["A"], 0), (B[:20], BLOCKS["B"], 0)],
    [(A[36:37], BLOCKS["A"], 36), (B[20:], BLOCKS["B"], 20), (C, BLOCKS["C"], 0)],
    [(A[37:38], BLOCKS["A"], 37), (C[:1], BLOCKS["C"], 6)],
]


def _caches(cfg, n, make):
    shape = (NUM_BLOCKS * BS, cfg.num_kv_heads, cfg.head_dim)
    return [(make(shape), make(shape)) for _ in range(n)]


def test_unified_logits_and_kv_match_jax(family):
    _, jcfg, tcfg, jp, tp = family
    jc = _caches(tcfg, tcfg.num_layers, jnp.zeros)
    tc = _caches(tcfg, tcfg.num_layers, torch.zeros)
    j_unified = jax.jit(
        lambda p, kv, *meta: j_llama.unified(jcfg, p, kv, *meta, BS, attn=ATTN))
    for step, lanes in enumerate(STEPS):
        meta = _flat_batch(lanes, S=4, T=96)
        want, jc = j_unified(jp, jc, *map(jnp.asarray, meta))
        got = t_llama.unified(tcfg, tp, tc, *(torch.from_numpy(m) for m in meta), BS)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                                   atol=TOL, err_msg=f"step {step}")
    for li, ((jk, jv), (tk, tv)) in enumerate(zip(jc, tc)):
        for name, j, t in (("k", jk, tk), ("v", jv, tv)):
            np.testing.assert_allclose(  # trash block 0 takes padding writes
                t.numpy()[BS:], np.asarray(j)[BS:], rtol=TOL, atol=TOL,
                err_msg=f"layer {li} {name}")


def _lane_tables(lanes):
    tables = np.zeros((len(lanes), MAX_BLOCKS), np.int32)
    for i, blocks in enumerate(lanes):
        tables[i, :len(blocks)] = blocks
    return tables


def test_prefill_batch_and_decode_match_jax(family):
    _, jcfg, tcfg, jp, tp = family
    prompts = [A, B[:30], C]
    lanes = [BLOCKS["A"], BLOCKS["B"], BLOCKS["C"]]
    N, T = len(prompts), 48
    tokens = np.zeros((N, T), np.int32)
    slots = np.zeros((N, T), np.int32)
    for i, (p, blocks) in enumerate(zip(prompts, lanes)):
        tokens[i, :len(p)] = p
        for j in range(len(p)):
            slots[i, j] = blocks[j // BS] * BS + j % BS
    tables = _lane_tables(lanes)
    prefix = np.zeros(N, np.int32)
    total = np.asarray([len(p) for p in prompts], np.int32)
    jc = _caches(tcfg, tcfg.num_layers, jnp.zeros)
    tc = _caches(tcfg, tcfg.num_layers, torch.zeros)
    want, jc = j_llama.prefill_batch(
        jcfg, jp, jc, jnp.asarray(tokens), jnp.asarray(tables), jnp.asarray(slots),
        jnp.asarray(prefix), jnp.asarray(total), BS, attn=ATTN)
    got = t_llama.prefill_batch(
        tcfg, tp, tc, torch.from_numpy(tokens), torch.from_numpy(tables),
        torch.from_numpy(slots), torch.from_numpy(prefix), torch.from_numpy(total), BS)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)

    # Three decode steps on every lane, each fed the reference's argmax.
    nxt = np.argmax(np.asarray(want), axis=-1).astype(np.int32)
    ctx = total.copy()
    for step in range(3):
        pos = ctx.copy()
        ctx = ctx + 1
        slot = np.asarray([lanes[i][p // BS] * BS + p % BS for i, p in enumerate(pos)],
                          np.int32)
        want, jc = j_llama.decode(
            jcfg, jp, jc, jnp.asarray(nxt), jnp.asarray(pos), jnp.asarray(tables),
            jnp.asarray(ctx), jnp.asarray(slot), BS, attn=ATTN)
        got = t_llama.decode(
            tcfg, tp, tc, torch.from_numpy(nxt), torch.from_numpy(pos),
            torch.from_numpy(tables), torch.from_numpy(ctx), torch.from_numpy(slot), BS)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL,
                                   err_msg=f"decode step {step}")
        nxt = np.argmax(np.asarray(want), axis=-1).astype(np.int32)
    for (jk, jv), (tk, tv) in zip(jc, tc):
        np.testing.assert_allclose(tk.numpy()[BS:], np.asarray(jk)[BS:], rtol=TOL, atol=TOL)
        np.testing.assert_allclose(tv.numpy()[BS:], np.asarray(jv)[BS:], rtol=TOL, atol=TOL)


def test_every_family_weight_is_live(family):
    """Each optional weight changes the logits: zeroing its noise-free
    part (the gain or bias itself) moves them."""
    name, _, tcfg, _, tp = family
    toks = torch.tensor(_tokens(5, 40))
    base = t_llama.reference_forward(tcfg, tp, toks)
    keys = [k for k in t_llama.OPTIONAL_LAYER_KEYS if k in tp["layers"][0]]
    assert keys or name == "sliding_window"
    for k in keys:
        changed = dict(tp, layers=[dict(tp["layers"][0]), *tp["layers"][1:]])
        changed["layers"][0][k] = torch.zeros_like(tp["layers"][0][k])
        moved = (t_llama.reference_forward(tcfg, changed, toks) - base).abs().max()
        assert moved > 1e-4, k


# -- presets, configs, init ----------------------------------------------------

NEW_PRESETS = ["tiny-gemma-test", "gemma3-1b", "qwen2.5-0.5b", "qwen3-0.6b",
               "mistral-7b", "llama3-8b", "llama3.1-8b", "llama3-70b"]


@pytest.mark.parametrize("name", NEW_PRESETS)
def test_preset_matches_jax(name):
    got, want = dataclasses.asdict(PRESETS[name]()), dataclasses.asdict(J_PRESETS[name]())
    assert got.pop("rope_scaling") == want.pop("rope_scaling")
    assert got == want


@pytest.mark.parametrize("name", NEW_PRESETS)
def test_preset_properties_match_jax(name):
    got, want = PRESETS[name](), J_PRESETS[name]()
    assert got.rolling_buffer == want.rolling_buffer
    assert got.kv_cache_head_dim == want.kv_cache_head_dim
    assert got.num_cache_heads == want.num_cache_heads
    assert [got.layer_window(i) for i in range(got.num_layers)] == [
        want.layer_window(i) for i in range(want.num_layers)]
    assert [t_llama._layer_rope(got, i)[0] for i in range(got.num_layers)] == [
        j_llama._layer_rope(want, i)[0] for i in range(want.num_layers)]


SHAPE_NAMES = ["tiny-gemma-test", "gemma3-1b", "qwen2.5-0.5b", "qwen3-0.6b",
               "mistral-7b", "llama3.1-8b"]


@pytest.mark.parametrize("name", SHAPE_NAMES)
def test_init_params_key_set_and_shapes_match_jax(name):
    """Each family's layer keys and shapes at its own heads and head dim
    (narrowed hidden, MLP, vocabulary and depth)."""
    narrow = dict(hidden_size=64, intermediate_size=96, num_layers=2, vocab_size=256)
    jshapes = jax.tree.map(lambda a: tuple(a.shape), jax.eval_shape(
        lambda: j_llama.init_params(jax.random.PRNGKey(0),
                                    J_PRESETS[name]().scaled(**narrow))))
    tparams = t_llama.init_params(PRESETS[name]().scaled(**narrow),
                                  torch.Generator().manual_seed(0), device="cpu")
    assert set(tparams) == set(jshapes)
    assert tparams["embed"].shape == jshapes["embed"]
    assert tuple(tparams["ln_f"].shape) == jshapes["ln_f"]
    for tl, jl in zip(tparams["layers"], jshapes["layers"]):
        assert {k: tuple(v.shape) for k, v in tl.items()} == jl
    # Gemma's (1+w) norms start at zero, every other norm at one.
    offset = PRESETS[name]().norm_offset
    assert float(tparams["layers"][0]["ln_attn"][0]) == (0.0 if offset else 1.0)


@pytest.mark.parametrize("name", ["gemma3-1b", "qwen3-0.6b", "qwen2.5-0.5b",
                                  "mistral-7b", "llama3-8b", "llama3.1-8b"])
def test_engine_config_validates_the_dense_families(name):
    EngineConfig(model=PRESETS[name](), max_model_len=4096, num_blocks=512).validate()
    assert LocalModel.prepare(f"preset:{name}").config == PRESETS[name]()


@pytest.mark.parametrize("model,match", [
    (ModelConfig.tiny_test().scaled(num_experts=4), None),
    (ModelConfig.tiny_test().scaled(kv_lora_rank=32), None),
    (ModelConfig.llama3_70b(), "A4"),
], ids=["moe", "mla", "llama3-70b"])
def test_engine_config_refuses_moe_mla_and_a_model_over_one_card(model, match):
    """MoE and MLA configurations validate (they are served since the
    DeepSeek slice); a model over one card is still refused."""
    if match is None:
        EngineConfig(model=model).validate()
        return
    with pytest.raises(ValueError, match=match):
        EngineConfig(model=model).validate()


# -- engines: the JAX package's family tests, mirrored -------------------------

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
        return await asyncio.gather(*[
            _collect(engine, proto, ctx_cls, p, n) for p in prompts])
    finally:
        await engine.stop()


def _streams(jcfg, tcfg, jp, tp, prompts, n, **kw):
    """The same greedy requests through the JAX engine and the port's."""
    kw = dict(dtype="float32", block_size=4, num_blocks=64, max_num_seqs=2,
              max_model_len=128, **kw)
    j = asyncio.run(_serve(TpuEngine(JEngineConfig(model=jcfg, **kw), params=jp),
                           j_proto, JContext, prompts, n))
    t = asyncio.run(_serve(TorchEngine(EngineConfig(model=tcfg, **kw), params=tp,
                                       device="cpu"), t_proto, Context, prompts, n))
    return j, t


def _oracle(cfg, params, prompt, n):
    toks, out = list(prompt), []
    for _ in range(n):
        logits = t_llama.reference_forward(cfg, params, torch.tensor(toks))
        out.append(int(torch.argmax(logits[-1])))
        toks.append(out[-1])
    return out


def test_gemma3_engine_matches_oracle():
    """Paged serving of tiny-gemma-test (chunked prefill, per-layer
    windows and rope) equals the JAX engine and the no-cache oracle; the
    window pattern is live: an all-global variant diverges."""
    jcfg, tcfg = _family("gemma")
    jp, tp = _params(jcfg, seed=7)
    prompts = [_tokens(9, 40), _tokens(10, 21)]
    j, t = _streams(jcfg, tcfg, jp, tp, prompts, 10, unified_token_budget=32,
                    unified_prefill_quantum=16)
    assert t == j
    assert t == [_oracle(tcfg, tp, p, 10) for p in prompts]
    all_global = tcfg.scaled(sliding_window=0, window_pattern=0)
    assert t[0] != _oracle(all_global, tp, prompts[0], 10)


def test_qwen3_qk_norm_engine_matches_oracle():
    """QK-norm served equals the JAX engine and the oracle; zeroing the
    norm gains changes the logits."""
    jcfg, tcfg = _family("qk_norm")
    jp, tp = _params(jcfg, seed=4)
    prompts = [[1, 5, 9, 2, 7], _tokens(12, 17)]
    j, t = _streams(jcfg, tcfg, jp, tp, prompts, 8)
    assert t == j and t == [_oracle(tcfg, tp, p, 8) for p in prompts]
    zeroed = dict(tp, layers=[dict(tp["layers"][0]), *tp["layers"][1:]])
    zeroed["layers"][0]["ln_q_head"] = torch.zeros_like(tp["layers"][0]["ln_q_head"])
    toks = torch.tensor(prompts[0])
    a = t_llama.reference_forward(tcfg, tp, toks)
    b = t_llama.reference_forward(tcfg, zeroed, toks)
    assert (a - b).abs().max() > 1e-3


@pytest.mark.parametrize("name", ["sliding_window", "qwen2_window"])
def test_sliding_window_engine_matches_oracle(name):
    """Windowed attention served (every layer, or Qwen2's gate leaving
    the first layer full) equals the JAX engine and the oracle with the
    same window; the window is live once the context exceeds it."""
    jcfg, tcfg = _family(name)
    jp, tp = _params(jcfg, seed=6)
    prompts = [_tokens(3, 24), _tokens(13, 9)]
    j, t = _streams(jcfg, tcfg, jp, tp, prompts, 10)
    assert t == j and t == [_oracle(tcfg, tp, p, 10) for p in prompts]
    assert t[0] != _oracle(tcfg.scaled(sliding_window=0), tp, prompts[0], 10)


def test_cli_serves_a_family_preset_on_the_cpu(tmp_path):
    """``run --model-path preset:tiny-gemma-test`` through the CLI's batch
    input on the CPU."""
    import json
    import os
    import pathlib
    import subprocess
    import sys

    prompts = tmp_path / "prompts.txt"
    prompts.write_text("hello\n")
    proc = subprocess.run(
        [sys.executable, "-m", "dynamo_tpu_torch", "run", "--in", f"batch:{prompts}",
         "--model-path", "preset:tiny-gemma-test", "--device", "cpu",
         "--max-model-len", "64", "--num-blocks", "32", "--max-num-seqs", "4",
         "--max-tokens", "4", "--no-warmup"],
        cwd=pathlib.Path(__file__).resolve().parents[1],
        env=dict(os.environ, JAX_PLATFORMS="cpu"), capture_output=True, text=True,
        timeout=240,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    report = json.loads([ln for ln in proc.stdout.splitlines() if ln.startswith("{")][-1])
    assert report["requests"] == 1
