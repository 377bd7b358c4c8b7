"""The port's routed experts (dynamo_tpu_torch/models/moe.py) against the
JAX package on the CPU, mirroring tests/test_moe_dispatch.py and the
router tests of tests/test_deepseek.py: capacity against dense when
capacity is ample (softmax; sigmoid with group-limited routing), the
exact (token, expert) pairs an overflow drops, the ``auto`` crossover and
its fallback to dense at decode token counts, the sigmoid router's
selection bias against its weights, group-limited routing, DeepSeek's
layer plan and shared experts, and tiny-moe-test engine streams equal to
the JAX engine's.

Inputs come from numpy seeds; weights from the JAX params tree through
``params_from_jax``. float32 within 1e-5; bf16 within 1e-2."""

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
from dynamo_tpu.models import moe as j_moe
from dynamo_tpu.models.config import ModelConfig as JCfg
from dynamo_tpu.runtime.engine import Context as JContext
from dynamo_tpu_torch.engine.config import EngineConfig
from dynamo_tpu_torch.engine.engine import TorchEngine
from dynamo_tpu_torch.llm.protocols import common as t_proto
from dynamo_tpu_torch.models import llama as t_llama
from dynamo_tpu_torch.models import moe as t_moe
from dynamo_tpu_torch.models.config import ModelConfig
from dynamo_tpu_torch.runtime.engine import Context

TOL = 1e-5


def _cfgs(**kw):
    """(JAX, port) MoeConfig pairs with the same fields."""
    base = dict(hidden_size=32, intermediate_size=48, num_experts=4,
                num_experts_per_tok=2)
    base.update(kw)
    return j_moe.MoeConfig(**base), t_moe.MoeConfig(**base)


def _params(jcfg, seed, bias=None):
    """JAX expert params (numpy) and the port's copy of them."""
    tree = jax.tree.map(np.asarray, j_moe.init_moe_params(jax.random.PRNGKey(seed), jcfg))
    if bias is not None:
        tree["router_bias"] = np.asarray(bias, np.float32)
    return tree, {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


def _x(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _both(jtree, tp, x, jcfg, tcfg):
    want = np.asarray(j_moe.moe_mlp(jax.tree.map(jnp.asarray, jtree), jnp.asarray(x), jcfg))
    got = t_moe.moe_mlp(tp, torch.from_numpy(x), tcfg).numpy()
    return got, want


@pytest.mark.parametrize("dispatch", ["dense", "capacity"])
def test_moe_mlp_matches_jax(dispatch):
    jcfg, tcfg = _cfgs(dispatch=dispatch, capacity_factor=4.0)
    jtree, tp = _params(jcfg, 0)
    got, want = _both(jtree, tp, _x(1, (16, 32)), jcfg, tcfg)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def test_capacity_matches_dense_when_ample():
    _, dense = _cfgs(dispatch="dense")
    _, cap = _cfgs(dispatch="capacity", capacity_factor=4.0)
    jtree, tp = _params(j_moe.MoeConfig(hidden_size=32, intermediate_size=48,
                                        num_experts=4), 0)
    x = torch.from_numpy(_x(1, (16, 32)))
    np.testing.assert_allclose(t_moe.moe_mlp(tp, x, dense).numpy(),
                               t_moe.moe_mlp(tp, x, cap).numpy(), atol=2e-5)


def test_capacity_matches_dense_sigmoid_grouped():
    kw = dict(gating="sigmoid", n_group=2, topk_group=1, routed_scaling_factor=2.5)
    jd, td = _cfgs(dispatch="dense", **kw)
    jc, tc = _cfgs(dispatch="capacity", capacity_factor=4.0, **kw)
    jtree, tp = _params(jd, 2, bias=[0.1, 0.0, 0.4, 0.0])
    x = _x(3, (12, 32))
    got_d, want_d = _both(jtree, tp, x, jd, td)
    got_c, want_c = _both(jtree, tp, x, jc, tc)
    np.testing.assert_allclose(got_d, want_d, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got_c, want_c, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got_d, got_c, atol=2e-5)


@pytest.mark.parametrize("identical", [True, False], ids=["identical_tokens", "random_tokens"])
def test_capacity_overflow_drops_the_pairs_jax_drops(identical):
    """With the capacity factor below fair share, the port drops exactly
    the (token, expert) pairs the JAX package drops: the outputs agree
    row by row, each row equal to dense where it kept both experts and
    not where it lost one. The first token keeps both slots."""
    jd, td = _cfgs(dispatch="dense")
    jt, tt = _cfgs(dispatch="capacity", capacity_factor=0.25)
    jtree, tp = _params(jd, 0)
    x = (np.tile(_x(4, (1, 32)), (16, 1)) if identical else _x(5, (16, 32)))
    got, want = _both(jtree, tp, x, jt, tt)
    dense, _ = _both(jtree, tp, x, jd, td)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got[0], dense[0], atol=2e-5)
    assert np.isfinite(got).all()
    assert np.abs(dense[-1] - got[-1]).max() > 1e-6
    # Each pair's rank within its expert, in arrival order, against C.
    gates = t_moe.moe_router(tp, torch.from_numpy(x), tt)
    _, idx = t_moe._top_k(gates, tt.num_experts_per_tok)
    flat = idx.reshape(-1).numpy()
    C = tt.capacity(x.shape[0])
    ranks = np.array([(flat[:i] == e).sum() for i, e in enumerate(flat)])
    kept_rows = (ranks < C).reshape(x.shape[0], -1).all(-1)
    np.testing.assert_allclose(got[kept_rows], dense[kept_rows], atol=2e-5)
    assert (np.abs(got[~kept_rows] - dense[~kept_rows]).max(-1) > 1e-6).all()


def test_pad_rows_last_only_drop_themselves():
    """Rows appended after the real ones (a budget-padded batch) rank
    after every real pair, so the real rows' outputs do not depend on
    them."""
    _, tt = _cfgs(dispatch="capacity", capacity_factor=1.0)
    jtree, tp = _params(j_moe.MoeConfig(hidden_size=32, intermediate_size=48,
                                        num_experts=4), 6)
    real = _x(7, (10, 32))
    pads = np.tile(_x(8, (1, 32)), (6, 1))
    x = torch.from_numpy(np.concatenate([real, pads]))
    cap = tt.capacity(x.shape[0])
    alone = t_moe.MoeConfig(**{**tt.__dict__, "capacity_factor": cap * 4 / (10 * 2)})
    assert alone.capacity(10) == cap
    np.testing.assert_allclose(t_moe.moe_mlp(tp, x, tt)[:10].numpy(),
                               t_moe.moe_mlp(tp, x[:10], alone).numpy(), atol=TOL)


def test_auto_dispatch_crossover():
    assert t_moe.MoeConfig(num_experts=8).resolved_dispatch == "dense"
    assert t_moe.MoeConfig(num_experts=16).resolved_dispatch == "capacity"
    assert t_moe.MoeConfig(num_experts=256).resolved_dispatch == "capacity"
    assert t_moe.MoeConfig(num_experts=256, dispatch="dense").resolved_dispatch == "dense"
    assert t_moe.AUTO_CAPACITY_MIN_EXPERTS == j_moe.AUTO_CAPACITY_MIN_EXPERTS
    assert ModelConfig.tiny_moe_test().moe_dispatch == "auto"
    # deepseek-v2-lite's 64 experts top-6: capacity from 22 rows up.
    cfg = t_llama.moe_config(ModelConfig.deepseek_v2_lite())
    assert [cfg.uses_capacity(t) for t in (16, 21, 22, 256)] == [False, False, True, True]


def test_auto_falls_back_to_dense_at_decode_token_counts():
    kw = dict(hidden_size=32, intermediate_size=16, num_experts=32, num_experts_per_tok=2)
    jcfg, tcfg = j_moe.MoeConfig(**kw), t_moe.MoeConfig(**kw)
    assert tcfg.resolved_dispatch == "capacity"
    assert not tcfg.auto_capacity_ok(8) and tcfg.auto_capacity_ok(64)
    jtree, tp = _params(jcfg, 0)
    x = torch.from_numpy(_x(2, (8, 32)))
    dense = t_moe.MoeConfig(**kw, dispatch="dense")
    np.testing.assert_array_equal(t_moe.moe_mlp(tp, x, tcfg).numpy(),
                                  t_moe.moe_mlp(tp, x, dense).numpy())
    got, want = _both(jtree, tp, x.numpy(), jcfg, tcfg)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def test_sigmoid_router_selection_bias_vs_weights():
    """V3 gating: the bias steers SELECTION only; the weights are the raw
    sigmoid probs of the selected experts, renormalized."""
    tcfg = t_moe.MoeConfig(hidden_size=8, num_experts=4, num_experts_per_tok=2,
                           gating="sigmoid", norm_topk_prob=True)
    x = torch.ones((1, 8))
    w = torch.zeros((8, 4))
    bias = torch.tensor([0.0, 0.0, 1.0, 1.0])
    gates = t_moe.moe_router({"w_router": w, "router_bias": bias}, x, tcfg)
    np.testing.assert_allclose(gates[0].numpy(), [0, 0, 0.5, 0.5], atol=1e-6)
    softmax = t_moe.MoeConfig(hidden_size=8, num_experts=4, num_experts_per_tok=2)
    gates = t_moe.moe_router({"w_router": w}, x, softmax)
    assert float(gates.sum()) == pytest.approx(1.0, abs=1e-5)
    # Tied probs pick the lower expert ids, as jax.lax.top_k does.
    want = j_moe.moe_router({"w_router": jnp.zeros((8, 4))}, jnp.ones((1, 8)),
                            j_moe.MoeConfig(hidden_size=8, num_experts=4))
    np.testing.assert_allclose(gates.numpy(), np.asarray(want), atol=1e-7)


def test_group_limited_routing():
    """noaux_tc: only experts of the topk_group best groups are eligible;
    and a random router agrees with JAX's gate for gate."""
    tcfg = t_moe.MoeConfig(hidden_size=4, num_experts=4, num_experts_per_tok=2,
                           gating="sigmoid", n_group=2, topk_group=1)
    x = torch.ones((1, 4))
    bias = torch.tensor([0.0, 0.0, 0.6, 0.6])
    gates = t_moe.moe_router({"w_router": torch.zeros((4, 4)), "router_bias": bias}, x, tcfg)
    assert float(gates[0, 0]) == 0.0 and float(gates[0, 1]) == 0.0
    assert float(gates[0, 2]) > 0 and float(gates[0, 3]) > 0
    for gating in ("sigmoid", "softmax"):
        kw = dict(hidden_size=16, num_experts=8, num_experts_per_tok=3, gating=gating,
                  n_group=4, topk_group=2, routed_scaling_factor=2.5)
        jcfg, tcfg = j_moe.MoeConfig(**kw), t_moe.MoeConfig(**kw)
        w, b, xs = _x(9, (16, 8)), _x(10, (8,)) * 0.1, _x(11, (20, 16))
        want = j_moe.moe_router({"w_router": jnp.asarray(w), "router_bias": jnp.asarray(b)},
                                jnp.asarray(xs), jcfg)
        got = t_moe.moe_router({"w_router": torch.from_numpy(w),
                                "router_bias": torch.from_numpy(b)}, torch.from_numpy(xs), tcfg)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)


def test_first_k_dense_replace_layer_plan():
    """tiny-mla-test: layer 0 dense (no router), later layers a router
    with its selection bias, stacked experts and shared experts, in both
    packages' inits, with the same shapes."""
    cfg = ModelConfig.tiny_mla_test()
    assert [cfg.moe_layer(i) for i in range(3)] == [False, True, True]
    tp = t_llama.init_params(cfg, torch.Generator().manual_seed(0), torch.float32, "cpu")
    jp = j_llama.init_params(jax.random.PRNGKey(0), JCfg.tiny_mla_test(), dtype=jnp.float32)
    assert "w_router" not in tp["layers"][0] and tp["layers"][0]["w_gate"].dim() == 2
    layer1 = tp["layers"][1]
    assert layer1["w_gate"].dim() == 3 and "w_shared_gate" in layer1
    assert layer1["router_bias"].dtype == torch.float32
    for tl, jl in zip(tp["layers"], jp["layers"]):
        assert {k: tuple(v.shape) for k, v in tl.items()} == {
            k: tuple(v.shape) for k, v in jl.items()}


def _model(jcfg, seed):
    tree = jax.tree.map(np.asarray, j_llama.init_params(
        jax.random.PRNGKey(seed), jcfg, dtype=jnp.float32))
    return jax.tree.map(jnp.asarray, tree), t_llama.params_from_jax(tree, device="cpu")


def test_shared_experts_add_to_the_routed_ones():
    """A DeepSeekMoE layer's output is the routed mixture plus the
    always-on shared SwiGLU, as in the JAX package's _moe_mlp."""
    jcfg, tcfg = JCfg.tiny_mla_test(), ModelConfig.tiny_mla_test()
    jp, tp = _model(jcfg, 1)
    x = _x(12, (7, 64))
    want = np.asarray(j_llama._moe_mlp(jp["layers"][1], jnp.asarray(x), jcfg))
    got = t_llama._mlp(tp["layers"][1], torch.from_numpy(x), tcfg).numpy()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    routed = t_moe.moe_mlp(tp["layers"][1], torch.from_numpy(x), t_llama.moe_config(tcfg))
    assert np.abs(got - routed.numpy()).max() > 1e-3


@pytest.mark.parametrize("dispatch", ["dense", "capacity"])
def test_moe_reference_forward_matches_jax(dispatch):
    """tiny-moe-test's no-cache logits, with each formulation (a tight
    capacity factor, so pairs drop), equal the JAX package's."""
    jcfg = JCfg.tiny_moe_test().scaled(moe_dispatch=dispatch, moe_capacity_factor=0.5)
    tcfg = ModelConfig.tiny_moe_test().scaled(moe_dispatch=dispatch, moe_capacity_factor=0.5)
    jp, tp = _model(jcfg, 2)
    toks = np.random.default_rng(13).integers(0, jcfg.vocab_size, 21)
    want = np.asarray(j_llama.reference_forward(jcfg, jp, jnp.asarray(toks)))
    got = t_llama.reference_forward(tcfg, tp, torch.from_numpy(toks)).numpy()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def test_moe_bf16_matches_float32_within_tolerance():
    """bf16 expert weights (bf16 operands, float32 sums and outputs)
    stay within 1e-2 of the float32 formulation on the same weights."""
    jcfg, tcfg = _cfgs(dispatch="dense")
    _, tp = _params(jcfg, 3)
    x = torch.from_numpy(_x(14, (9, 32)))
    want = t_moe.moe_mlp(tp, x, tcfg)
    tb = {k: v.to(torch.bfloat16) for k, v in tp.items()}
    got = t_moe.moe_mlp(tb, x.to(torch.bfloat16), tcfg)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-2)


def _j_experts(jtree, buf):
    """The reference's expert SwiGLUs (``_expert_einsum``: the weights
    widened to float32, ``h`` kept in float32 into ``w_down``)."""
    w = {k: jnp.asarray(jtree[k]) for k in ("w_gate", "w_up", "w_down")}
    buf = jnp.asarray(buf)
    h = (jax.nn.silu(j_moe._expert_einsum("end,edi->eni", buf, w["w_gate"]))
         * j_moe._expert_einsum("end,edi->eni", buf, w["w_up"]))
    return np.asarray(j_moe._expert_einsum("eni,eid->end", h, w["w_down"]))


@pytest.mark.parametrize("dispatch", ["experts", "dense", "capacity"])
def test_bf16_experts_keep_h_in_float32_as_jax_does(dispatch):
    """At bf16 expert weights the port's SwiGLU keeps ``h`` in float32
    into ``w_down``, as the reference's ``_expert_einsum`` path does:
    ``_experts`` and both formulations of ``moe_mlp`` lie within 1e-5 of
    JAX's on the same bf16 weights and bf16-valued rows (the bf16
    engine's old law, ``h`` rounded to bf16 first, misses by more than
    1e-3, printed with -s). The card's form of the down product
    (``split_bmm``: ``h`` as two bf16 terms against the unwidened weights,
    one float32-sum product) lies within 1e-4 of it."""
    from dynamo_tpu_torch.ops import quant

    jcfg, tcfg = _cfgs(dispatch="dense" if dispatch == "experts" else dispatch,
                       capacity_factor=4.0)
    jtree, tp = _params(jcfg, 5)
    jb = {k: v.astype(jnp.bfloat16) if k.startswith("w_") and k != "w_router" else v
          for k, v in jtree.items()}
    tb = {k: torch.from_numpy(np.asarray(v, np.float32)).to(torch.bfloat16)
          if k.startswith("w_") and k != "w_router" else torch.from_numpy(np.array(v))
          for k, v in jb.items()}
    if dispatch == "experts":
        x = torch.from_numpy(_x(21, (4, 11, 32))).bfloat16().float()
        want = _j_experts(jb, x.numpy())
        got = t_moe._experts(tb, x)
        w_down = tb["w_down"]
        h = (torch.nn.functional.silu(quant.expert_mm(x, tb["w_gate"]))
             * quant.expert_mm(x, tb["w_up"]))
        old = quant.expert_mm(h.to(torch.bfloat16), w_down).numpy()
        split = quant.split_bmm(h, w_down).numpy()
        print(f"old law {np.abs(old - want).max():.2e}, split {np.abs(split - want).max():.2e}, "
              f"new {np.abs(got.numpy() - want).max():.2e}")
        assert np.abs(old - want).max() > 1e-3
        np.testing.assert_allclose(split, want, rtol=1e-4, atol=1e-4)
    else:
        x = _x(22, (16, 32))
        x = torch.from_numpy(x).bfloat16().float().numpy()
        want = np.asarray(j_moe.moe_mlp(jax.tree.map(jnp.asarray, jb), jnp.asarray(x), jcfg))
        got = t_moe.moe_mlp(tb, torch.from_numpy(x), tcfg)
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)


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


@pytest.mark.parametrize("dispatch", ["auto", "capacity"])
def test_tiny_moe_engine_streams_match_the_jax_engine(dispatch):
    """tiny-moe-test served by both engines (float32, the same weights)
    gives byte-identical greedy streams, equal to the no-cache oracle
    under the drop-free ``auto`` (dense at 4 experts)."""
    jcfg = JCfg.tiny_moe_test().scaled(moe_dispatch=dispatch, moe_capacity_factor=4.0)
    tcfg = ModelConfig.tiny_moe_test().scaled(moe_dispatch=dispatch, moe_capacity_factor=4.0)
    jp, tp = _model(jcfg, 0)
    prompts = [[1, 5, 9, 2, 7], np.random.default_rng(15).integers(0, 384, 19).tolist()]
    kw = dict(dtype="float32", block_size=4, num_blocks=64, max_num_seqs=2, max_model_len=128)
    j = asyncio.run(_serve(TpuEngine(JEngineConfig(model=jcfg, **kw), params=jp),
                           j_proto, JContext, prompts, 8))
    t = asyncio.run(_serve(TorchEngine(EngineConfig(model=tcfg, **kw), params=tp,
                                       device="cpu"), t_proto, Context, prompts, 8))
    assert t == j
    if dispatch == "auto":
        for p, stream in zip(prompts, t):
            toks = list(p)
            for tok in stream:
                logits = t_llama.reference_forward(tcfg, tp, torch.tensor(toks))
                assert int(torch.argmax(logits[-1])) == tok
                toks.append(tok)
