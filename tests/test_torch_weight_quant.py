"""The port's weight quantization against the JAX package on the CPU
(dynamo_tpu_torch/ops/quant.py, models/llama.py ``WeightQuantPolicy``,
``init_params(policy=)`` and ``load_hf_weights(policy=)``, the runner's
quantized tree and gauges, ``EngineConfig``'s law and one-card check, the
CLI's flags, the mocker's gauges, and the kernel wrapper's CPU path and
split plan); mirrors tests/test_weight_quant.py.

Inputs come from numpy seeds; quantized trees from the JAX package
through ``params_from_jax``. Tolerances, relative to the output's largest
magnitude:
- float32: 1e-5. The same products and float32 sums, summed in another
  order by the two CPU backends.
- bf16: 1e-2. Both round ``x @ q`` and the scaled product to bf16
  (2^-8 relative each), but in other places: the port's head and expert
  products keep float32 where the reference rounds (PR 14's float32
  head, C3).
int8 ``q`` and every scale equal the JAX package's bit for bit; fp8 ``q``
differs in 0 bytes on these inputs (counted, not toleranced)."""

import asyncio
import dataclasses
import json

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
from dynamo_tpu.ops import quant as jq
from dynamo_tpu.runtime.engine import Context as JContext
from dynamo_tpu_torch import cli as t_cli
from dynamo_tpu_torch.engine.config import EngineConfig
from dynamo_tpu_torch.engine.engine import TorchEngine
from dynamo_tpu_torch.llm.discovery import ModelManager, build_serving_pipeline
from dynamo_tpu_torch.llm.http_client import fetch
from dynamo_tpu_torch.llm.http_service import HttpService
from dynamo_tpu_torch.llm.model_card import ModelDeploymentCard
from dynamo_tpu_torch.llm.protocols import common as t_proto
from dynamo_tpu_torch.models import llama as t_llama
from dynamo_tpu_torch.models.config import PRESETS, ModelConfig
from dynamo_tpu_torch.ops import quant as tq
from dynamo_tpu_torch.ops.kernels import wq_gemm as wk
from dynamo_tpu_torch.runtime.engine import Context
from dynamo_tpu_torch.tools import write_checkout as wc
from dynamo_tpu_torch.utils.tracing import reset_tracer

F32_TOL = 1e-5
BF16_TOL = 1e-2
FP8_DIFFERING_BYTES = 0   # fp8 q bytes that differ from ml_dtypes' cast


@pytest.fixture(autouse=True)
def _fresh_tracer():
    """The served requests fold into the process's tracer histograms;
    leave a fresh one for the next test file in this process."""
    yield
    reset_tracer(None)


def _t(a) -> torch.Tensor:
    """A JAX/numpy array (bf16 and e4m3 included) as a CPU tensor."""
    return t_llama._to_torch(np.asarray(a), None, "cpu")


def _tq(w) -> dict:
    """A JAX quantized leaf as the port's."""
    return {"q": _t(w["q"]), "s": _t(w["s"])}


def _bytes(t: torch.Tensor) -> np.ndarray:
    return t.contiguous().view(torch.uint8).numpy()


def _rel(got: torch.Tensor, want) -> float:
    want = _t(want).float() if not isinstance(want, torch.Tensor) else want.float()
    return ((got.float() - want).abs().max() / want.abs().max().clamp(min=1e-6)).item()


def _weight(rng, shape, axis, dtype) -> jnp.ndarray:
    """Random weights with per-column spreads and one all-zero channel
    (the 1e-8 clamp of its scale)."""
    w = rng.standard_normal(shape) * rng.uniform(0.01, 3.0, shape[-1])
    w = np.moveaxis(w, axis, -1)
    w[..., 0] = 0.0
    return jnp.asarray(np.moveaxis(w, -1, axis).astype(np.float32), dtype)


# -- the policy grammar ------------------------------------------------------
SPECS = [None, "", "int8", "fp8", " fp8 ", "attn=int8", "attn=int8,mlp=fp8",
         "embedding=fp8, unembed=int8,", "int4", "attn", "attn=int4",
         "router=int8", "mlp=fp8,bogus=int8"]


@pytest.mark.parametrize("spec", SPECS)
def test_policy_from_string_matches_jax(spec):
    def parse(cls):
        try:
            return cls.from_string(spec), None
        except ValueError as exc:
            return None, str(exc)

    (want, werr), (got, gerr) = parse(j_llama.WeightQuantPolicy), parse(
        t_llama.WeightQuantPolicy)
    assert gerr == werr
    if want is not None:
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert (got.active, got.describe()) == (want.active, want.describe())


def test_site_key_groups_match_jax():
    for name in ("QUANT_KEYS", "ATTN_KEYS", "MLP_KEYS", "WEIGHT_FORMATS", "FP8_MAX",
                 "QUANT_AXES", "CONTRACT_AXIS"):
        assert getattr(tq, name) == getattr(jq, name), name
    assert t_llama.LEGACY_INT8 == t_llama.WeightQuantPolicy(
        attn="int8", mlp="int8", unembed="int8")


# -- quantize_weight ---------------------------------------------------------
CASES = [((96, 80), -2), ((96, 80), -1), ((3, 48, 64), -2), ((4, 16, 32), -1)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,axis", CASES, ids=["in-out", "rows", "experts", "w_uv"])
@pytest.mark.parametrize("fmt", ["int8", "fp8"])
def test_quantize_weight_is_bit_equal_to_jax(fmt, shape, axis, dtype):
    jw = _weight(np.random.default_rng(len(shape) + axis), shape, axis, getattr(jnp, dtype))
    want = jq.quantize_weight(jw, axis=axis, fmt=fmt)
    got = tq.quantize_weight(_t(jw), axis=axis, fmt=fmt)
    assert got["q"].dtype == (torch.int8 if fmt == "int8" else torch.float8_e4m3fn)
    # Scales keep the weight's dtype, as the reference's s.astype(w.dtype).
    assert got["s"].dtype == getattr(torch, dtype)
    differing = int((_bytes(got["q"]) != np.asarray(want["q"]).view(np.uint8)).sum())
    assert differing == (0 if fmt == "int8" else FP8_DIFFERING_BYTES)
    np.testing.assert_array_equal(_bytes(got["s"]), np.asarray(want["s"]).view(np.uint8))
    deq = tq.dequantize_weight(got, axis=axis)
    np.testing.assert_array_equal(
        deq.numpy(), np.asarray(jq.dequantize_weight(want, axis=axis)))


@pytest.mark.parametrize("axis", [-2, -1])
def test_quantize_weight_in_slices_equals_one_pass(axis, monkeypatch):
    """The elementwise law runs in slices of QUANT_CHUNK elements along
    the first axis (bounded scratch): the bytes and scales do not depend
    on the slice size."""
    w = torch.from_numpy(np.random.default_rng(9).standard_normal((5, 48, 40)).astype(
        np.float32)).to(torch.bfloat16)
    for fmt in ("int8", "fp8"):
        whole = tq.quantize_weight(w, axis=axis, fmt=fmt)
        monkeypatch.setattr(tq, "QUANT_CHUNK", 100)
        sliced = tq.quantize_weight(w, axis=axis, fmt=fmt)
        monkeypatch.undo()
        assert np.array_equal(_bytes(sliced["q"]), _bytes(whole["q"]))
        assert torch.equal(sliced["s"], whole["s"])


def test_unknown_format_is_refused():
    with pytest.raises(ValueError, match="unknown weight format"):
        tq.quantize_weight(torch.ones(4, 4), fmt="int4")


# -- the plain arms against the JAX functions --------------------------------
def _act(rng, shape, dtype):
    return jnp.asarray(rng.standard_normal(shape).astype(np.float32), getattr(jnp, dtype))


@pytest.mark.parametrize("fmt", ["int8", "fp8"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_arms_match_jax(fmt, dtype):
    rng = np.random.default_rng(7)
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    jdt = getattr(jnp, dtype)
    errs = {}

    w = jq.quantize_weight(_weight(rng, (64, 48), -2, jdt), fmt=fmt)
    x = _act(rng, (5, 64), dtype)
    got = tq.qdot(_t(x), _tq(w))
    assert got.dtype == getattr(torch, dtype)
    errs["qdot"] = _rel(got, jq.qdot(x, w))
    errs["head_mm"] = _rel(tq.head_mm(_t(x), _tq(w)), jq.qdot(x, w).astype(jnp.float32))

    H, dn, dc, dv = 4, 16, 32, 8
    w_uk = jq.quantize_weight(_weight(rng, (H, dn, dc), -2, jdt), axis=-2, fmt=fmt)
    q_nope = _act(rng, (6, H, dn), dtype)
    errs["qeinsum_w_uk"] = _rel(tq.qeinsum("thn,hnc->thc", _t(q_nope), _tq(w_uk)),
                                jq.qeinsum("thn,hnc->thc", q_nope, w_uk))
    w_uv = jq.quantize_weight(_weight(rng, (H, dv, dc), -1, jdt), axis=-1, fmt=fmt)
    lat = _act(rng, (6, H, dc), dtype)
    errs["qeinsum_w_uv"] = _rel(tq.qeinsum("thc,hvc->thv", _t(lat), _tq(w_uv)),
                                jq.qeinsum("...hc,hvc->...hv", lat, w_uv))

    table = jq.quantize_weight(_weight(rng, (40, 64), -1, jdt), axis=-1, fmt=fmt)
    ids = np.array([0, 3, 39, 3, 17])
    got = tq.embed_lookup(_tq(table), torch.from_numpy(ids))
    errs["embed_lookup"] = _rel(got, jq.embed_lookup(table, jnp.asarray(ids)))
    assert got.dtype == getattr(torch, dtype)
    errs["tied_head_mm"] = _rel(tq.tied_head_mm(_t(x), _tq(table)),
                                jq.tied_head_mm(x, table).astype(jnp.float32))

    E, T, D, Im = 3, 5, 64, 32
    w_up = jq.quantize_weight(_weight(rng, (E, D, Im), -2, jdt), fmt=fmt)
    xt = _act(rng, (T, D), dtype)
    want = j_moe._expert_einsum("td,edi->tei", xt.astype(jnp.float32), w_up)
    got = tq.expert_mm(_t(xt)[None].expand(E, T, D), _tq(w_up))
    assert got.dtype == torch.float32
    errs["expert_mm"] = _rel(got.transpose(0, 1), want)
    w_down = jq.quantize_weight(_weight(rng, (E, Im, D), -2, jdt), fmt=fmt)
    h = jnp.asarray(rng.standard_normal((T, E, Im)).astype(np.float32))
    want = j_moe._expert_einsum("tei,eid->ted", h, w_down)
    th = _t(h).transpose(0, 1).contiguous()
    errs["expert_mm_f32"] = _rel(tq.expert_mm_f32(th, _tq(w_down)).transpose(0, 1), want)
    errs["split_bmm"] = _rel(tq.split_bmm(th, _tq(w_down)).transpose(0, 1), want)
    assert max(errs.values()) <= tol, errs


def test_wrapper_takes_its_plain_version_on_the_cpu():
    rng = np.random.default_rng(3)
    a = torch.from_numpy(rng.standard_normal((2, 5, 64)).astype(np.float32))
    w = tq.quantize_weight(torch.from_numpy(rng.standard_normal((2, 64, 48)).astype(np.float32)))
    before = wk.wq_gemm_cuda.launches
    out = wk.wq_gemm_cuda(a, w["q"], w["s"], out_dtype=torch.bfloat16)
    assert wk.wq_gemm_cuda.launches == before            # nothing launched
    want = ((a @ w["q"].float()) * w["s"][:, None, :]).to(torch.bfloat16)
    assert torch.equal(out, want)
    # The transposed entry reads q as [B, N, K]; `out` is written in place.
    qt = {"q": w["q"].transpose(1, 2).contiguous(), "s": w["s"]}
    buf = torch.empty(2, 5, 48)
    got = wk.wq_gemm_cuda(a, qt["q"], qt["s"], out=buf, transposed=True)
    assert got is buf and torch.allclose(buf, want.float(), rtol=1e-2, atol=1e-2)


def test_wrapper_checks_refuse_what_the_kernel_does_not_take():
    a = torch.zeros(1, 4, 64, dtype=torch.bfloat16)
    q = torch.zeros(1, 64, 32, dtype=torch.int8)
    s = torch.zeros(1, 32, dtype=torch.bfloat16)
    out = torch.empty(1, 4, 32, dtype=torch.bfloat16)
    assert wk.check_kernel_args(a, q, s, out, False) == (1, 4, 32, 64)
    # MLA's per-head rows ([T, H, width] read per head) and the dense
    # experts' rows (batch stride 0) are taken as they lie.
    strided = torch.zeros(4, 2, 72, dtype=torch.bfloat16)[..., :64].permute(1, 0, 2)
    q2, s2 = torch.zeros(2, 64, 32, dtype=torch.int8), torch.zeros(2, 32, dtype=torch.bfloat16)
    out2 = torch.empty(2, 4, 32, dtype=torch.bfloat16)
    assert wk.check_kernel_args(strided, q2, s2, out2, False) == (2, 4, 32, 64)
    assert wk.check_kernel_args(a.expand(2, 4, 64), q2, s2, out2, False) == (2, 4, 32, 64)
    bad = [
        (a, q.float(), s, out, False, "q dtype"),
        (a, q, s, out, True, "expected"),
        (a.half(), q, s, out, False, "a dtype"),
        (a, q, s[:, :16], out, False, "s is"),
        (torch.zeros(1, 64, 4, dtype=torch.bfloat16).transpose(1, 2), q, s, out, False,
         "contiguous along k"),
        (torch.zeros(1, 4, 40, dtype=torch.bfloat16), torch.zeros(1, 40, 32, dtype=torch.int8),
         s, out, False, "multiples of 16"),
        # A TMA descriptor takes rows and batches 16 bytes apart only, and
        # the kernel has no other way to load them.
        (torch.zeros(2 * 260, dtype=torch.bfloat16).as_strided((2, 4, 64), (260, 64, 1)),
         q2, s2, out2, False, "contiguous along k"),
        (torch.zeros(1, 4, 68, dtype=torch.bfloat16)[..., 2:66], q, s, out, False,
         "contiguous along k"),
        # The epilogue stores column pairs: an odd row stride or a start
        # off a pair is refused.
        (a, q, s, torch.empty(1, 4, 33, dtype=torch.bfloat16)[..., :32], False, "column pairs"),
        (a, q, s, torch.empty(1, 4, 34, dtype=torch.bfloat16)[..., 1:33], False, "column pairs"),
        (a, q, s, torch.empty(1, 4, 34)[..., 1:33], False, "column pairs"),
    ]
    for a_, q_, s_, o_, tr, match in bad:
        with pytest.raises((ValueError, TypeError), match=match):
            wk.check_kernel_args(a_, q_, s_, o_, tr)


# Every product chip_smoke.py's wquant phase runs (wq_kernel_cases: the
# llama3.2-1b and llama3-8b projections, MLP and heads at T = 1, 16, 64,
# 256 and the ragged 17, 65, 200; deepseek-v2-lite's experts and MLA's
# per-head einsums; the float32 witnesses) as (B, M, N, K).
_DENSE_NK = [(2048, 2048), (512, 2048), (8192, 2048), (2048, 8192), (128256, 2048),
             (4096, 4096), (1024, 4096), (14336, 4096), (4096, 14336), (128256, 4096)]
PLAN_SHAPES = [(1, T, N, K) for N, K in _DENSE_NK for T in (1, 16, 17, 64, 65, 200, 256)] + [
    (64, 4, 1408, 2048), (64, 48, 1408, 2048), (64, 96, 2048, 1408), (64, 8, 1408, 2048),
    (16, 16, 512, 128), (16, 256, 512, 128), (16, 16, 128, 512), (16, 256, 128, 512),
    (1, 1, 576, 2048), (1, 3, 16, 16), (2, 100, 48, 4096),
]


@pytest.mark.parametrize("shape", PLAN_SHAPES)
def test_split_plan_covers_k_in_whole_stages(shape):
    B, M, N, K = shape
    plan = wk.kernel_plan(B, M, N, K)
    # The entry: at most DECODE_ROWS rows take the decode tile, more a
    # rows tile no wider than twice the rows (64 at least).
    if M <= wk.DECODE_ROWS:
        assert (plan.entry, plan.bt) == ("decode", wk.DECODE_ROWS)
    else:
        assert plan.entry == "rows" and plan.bt in wk.TOKEN_TILES
        assert plan.bt < 2 * M or plan.bt == wk.TOKEN_TILES[-1]
    # Every split non-empty and whole in stages.
    splits, per = plan.splits, plan.k_per_split
    assert 1 <= splits <= wk.MAX_SPLITS and per % wk.BK == 0
    assert splits * per >= K > (splits - 1) * per
    assert plan.tiles == B * -(-N // wk.BN) * -(-M // plan.bt)
    assert 1 <= plan.grid <= min(plan.tiles * splits, 132 * wk.BLOCKS_PER_SM[plan.bt])
    if splits > 1:
        # Each split streams at least MIN_SPLIT_STAGES stages; its tiles'
        # arrival counters fit the kernel's, and the f32 partials stay
        # under twice the weight's bytes.
        assert per >= wk.MIN_SPLIT_STAGES * wk.BK
        assert plan.tiles <= wk.COUNTER_SLOTS
        assert plan.part == splits * B * M * N and 4 * plan.part <= 2 * B * N * K
    else:
        assert plan.part == 0
    assert wk.kernel_plan(B, M, N, K, a_bf16=False) == wk.Plan("f32", 0, 1, K, 0, 0, 0)
    with pytest.raises(TypeError):
        wk.kernel_plan(B, M, N, float(K))
    with pytest.raises(TypeError):
        wk.kernel_plan(B, float(M), N, K)


def test_split_plan_fills_the_card_at_decode():
    # llama3.2-1b's wq at one decode row: 16 column tiles x 8 splits, one
    # launch (the last split to arrive sums them).
    plan = wk.kernel_plan(1, 1, 2048, 2048)
    assert (plan.entry, plan.splits, plan.grid) == ("decode", 8, 128)
    # The tied head's 1002 column tiles need no split; at most a wave of
    # blocks (two an SM) walks them.
    plan = wk.kernel_plan(1, 4, 128256, 2048)
    assert (plan.splits, plan.grid) == (1, 264)
    # At 256 rows the tied head takes the widest token tile.
    assert wk.kernel_plan(1, 256, 128256, 2048)[:3] == ("rows", 256, 1)


# -- whole trees --------------------------------------------------------------
TINY = ["tiny-test", "tiny-gemma-test", "tiny-moe-test", "tiny-mla-test"]


def _tiny(name):
    attr = name.replace("-", "_")
    return getattr(JCfg, attr)(), getattr(ModelConfig, attr)()


def _tree(jcfg, dtype=jnp.float32, seed=0):
    return jax.tree.map(np.asarray, j_llama.init_params(jax.random.PRNGKey(seed), jcfg,
                                                         dtype=dtype))


def _assert_same_tree(got, want, fp8_budget=FP8_DIFFERING_BYTES):
    """Same keys, quantized leaves, dtypes, shapes and bytes."""
    assert got.keys() == want.keys()
    pairs = [(k, got[k], want[k]) for k in ("embed", "ln_f", "lm_head") if k in want]
    for i, (g, w) in enumerate(zip(got["layers"], want["layers"])):
        assert g.keys() == w.keys(), i
        pairs += [(f"{i}.{k}", g[k], w[k]) for k in w]
    for name, g, w in pairs:
        assert tq.is_quantized(g) == jq.is_quantized(w), name
        leaves = [(g["q"], w["q"]), (g["s"], w["s"])] if tq.is_quantized(g) else [(g, w)]
        for gt, wa in leaves:
            wa = np.asarray(wa)
            assert tuple(gt.shape) == wa.shape, name
            assert str(gt.dtype).split(".")[-1] == wa.dtype.name, name
            differing = int((_bytes(gt) != wa.view(np.uint8)).sum())
            assert differing <= (fp8_budget if gt.dtype == torch.float8_e4m3fn else 0), name


@pytest.mark.parametrize("spec", ["int8", "attn=int8,mlp=fp8", "unembed=int8", "embedding=fp8"])
@pytest.mark.parametrize("name", TINY)
def test_quantize_params_policy_and_stats_match_jax(name, spec):
    jcfg, tcfg = _tiny(name)
    tree = _tree(jcfg)
    jpol, tpol = (j_llama.WeightQuantPolicy.from_string(spec),
                  t_llama.WeightQuantPolicy.from_string(spec))
    want = jq.quantize_params_policy(jax.tree.map(jnp.asarray, tree), jpol,
                                     tie_embed=jcfg.tie_word_embeddings)
    got = tq.quantize_params_policy(t_llama.params_from_jax(tree, device="cpu"), tpol,
                                    tie_embed=tcfg.tie_word_embeddings)
    _assert_same_tree(got, want)
    assert tq.quant_tree_stats(got, 4) == pytest.approx(jq.quant_tree_stats(want, 4), rel=1e-12)


@pytest.mark.parametrize("name", ["tiny-test", "tiny-mla-test"])
def test_legacy_quantize_params_matches_jax(name):
    jcfg, tcfg = _tiny(name)
    tree = _tree(jcfg)
    for tie in (False, True):
        want = jq.quantize_params(jax.tree.map(jnp.asarray, tree), tie_embed=tie)
        got = tq.quantize_params(t_llama.params_from_jax(tree, device="cpu"), tie_embed=tie)
        _assert_same_tree(got, want)
    # The legacy flag is the all-matmul policy (init_params_int8's).
    via_policy = tq.quantize_params_policy(t_llama.params_from_jax(tree, device="cpu"),
                                           t_llama.LEGACY_INT8, tie_embed=True)
    _assert_same_tree(via_policy, jq.quantize_params(jax.tree.map(jnp.asarray, tree),
                                                     tie_embed=True))


@pytest.mark.parametrize("name", TINY)
def test_init_params_with_a_policy_quantizes_the_same_draws(name):
    _, tcfg = _tiny(name)
    policy = t_llama.WeightQuantPolicy.from_string("attn=fp8,mlp=int8,unembed=int8")

    def draw(pol):
        g = torch.Generator()
        g.manual_seed(5)
        return t_llama.init_params(tcfg, g, torch.bfloat16, device="cpu", policy=pol)

    got = draw(policy)
    want = tq.quantize_params_policy(draw(None), policy, tie_embed=tcfg.tie_word_embeddings)
    for g, w in zip(tq.tree_leaves(got), tq.tree_leaves(want)):
        if tq.is_quantized(w):
            assert np.array_equal(_bytes(g["q"]), _bytes(w["q"])) and torch.equal(g["s"], w["s"])
        else:
            assert torch.equal(g, w)
    # The meta device gives the same tree's shapes with no storage.
    meta = t_llama.init_params(tcfg, torch.Generator(), torch.bfloat16, device="meta",
                               policy=policy)
    assert tq.quant_tree_stats(meta, 2) == tq.quant_tree_stats(got, 2)


# -- loading ------------------------------------------------------------------
@pytest.mark.parametrize("spec", ["int8", "attn=fp8,mlp=int8,unembed=int8"])
@pytest.mark.parametrize("name", ["tiny-test", "tiny-moe-test", "tiny-mla-test"])
def test_load_hf_weights_quantizes_as_the_jax_loader(name, spec, tmp_path):
    pytest.importorskip("safetensors")
    jcfg, tcfg = _tiny(name)
    tree = _tree(jcfg, seed=2)
    wc.write_weights(tmp_path, tcfg, t_llama.params_from_jax(tree, device="cpu"))
    tpol = t_llama.WeightQuantPolicy.from_string(spec)
    got = t_llama.load_hf_weights(tcfg, str(tmp_path), dtype="float32", device="cpu",
                                  policy=tpol)
    after = tq.quantize_params_policy(
        t_llama.load_hf_weights(tcfg, str(tmp_path), dtype="float32", device="cpu"),
        tpol, tie_embed=tcfg.tie_word_embeddings)
    want = j_llama.load_hf_weights(jcfg, str(tmp_path), dtype=jnp.float32,
                                   policy=j_llama.WeightQuantPolicy.from_string(spec))
    _assert_same_tree(got, want)
    _assert_same_tree(after, want)


# -- engines ------------------------------------------------------------------
JAX_CFG = JCfg.tiny_test()
PARAMS = j_llama.init_params(jax.random.PRNGKey(0), JAX_CFG, dtype=jnp.float32)
ENGINE_KW = dict(
    dtype="float32", block_size=4, num_blocks=64, max_num_seqs=4, max_model_len=128,
    prefill_batch=2, unified_token_budget=32, unified_prefill_quantum=8,
)
PROMPTS = [([3, 1, 4, 1, 5], 8), ([2, 7, 1, 8], 8), (list(range(1, 41)), 8),
           ([9, 9, 8, 2, 6, 5, 3], 8)]


async def _serve(engine, proto, ctx_cls, prompts=PROMPTS):
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
        streams = await asyncio.gather(*[one(p, n) for p, n in prompts])
        return streams, engine.readiness()
    finally:
        await engine.stop()


@pytest.mark.parametrize("spec,kv_quant", [
    ("int8", None), ("attn=int8,mlp=fp8", None), ("int8", "int8"),
], ids=["int8", "attn-int8-mlp-fp8", "int8-kv-int8"])
def test_engine_streams_match_the_jax_engine_on_the_same_tree(spec, kv_quant):
    """Both engines serve one quantized tree: the JAX package's eager
    ``quantize_params_policy`` (its runner quantizes under jit, where XLA
    rounds some scales one ulp away from the eager law, so it is given
    the tree as it is). The port's engine quantizing the unquantized
    tree itself serves the same streams: its law is the eager one."""
    jpol = j_llama.WeightQuantPolicy.from_string(spec)
    qtree = jq.quantize_params_policy(PARAMS, jpol, tie_embed=JAX_CFG.tie_word_embeddings)
    jax_eng = TpuEngine(JEngineConfig(model=JAX_CFG, **ENGINE_KW, kv_quant=kv_quant),
                        params=qtree)
    kw = dict(ENGINE_KW, weight_quant=spec, kv_quant=kv_quant)
    ports = [TorchEngine(EngineConfig(model=ModelConfig.tiny_test(), **kw),
                         params=t_llama.params_from_jax(jax.tree.map(np.asarray, tree),
                                                        device="cpu"),
                         device="cpu")
             for tree in (qtree, PARAMS)]
    want, _ = asyncio.run(_serve(jax_eng, j_proto, JContext))
    saved, density = jq.quant_tree_stats(qtree, dtype_bytes=4)
    for port_eng in ports:
        got, ready = asyncio.run(_serve(port_eng, t_proto, Context))
        assert got == want
        assert ready["weight_quant_active"] == 1.0
        assert ready["weight_quant_bytes_saved"] == pytest.approx(saved, rel=1e-12)
        assert ready["weight_quant_density"] == pytest.approx(density, abs=1e-4)
        layer = port_eng.runner.params["layers"][0]
        assert tq.is_quantized(layer["wq"]) and tq.is_quantized(layer["w_up"])


@pytest.mark.parametrize("name,dispatch", [
    ("tiny-moe-test", "dense"), ("tiny-moe-test", "capacity"), ("tiny-mla-test", "auto"),
])
def test_moe_and_mla_engines_match_the_jax_engine_on_a_quantized_tree(name, dispatch):
    """The stacked experts (dense and capacity), the shared experts and
    MLA's absorbed einsums quantized: int8 attention, fp8 MLP, both
    engines on one tree (float32, greedy, byte-identical streams)."""
    jcfg, tcfg = _tiny(name)
    jcfg = jcfg.scaled(moe_dispatch=dispatch, moe_capacity_factor=4.0)
    tcfg = tcfg.scaled(moe_dispatch=dispatch, moe_capacity_factor=4.0)
    spec = "attn=int8,mlp=fp8"
    qtree = jq.quantize_params_policy(
        j_llama.init_params(jax.random.PRNGKey(4), jcfg, dtype=jnp.float32),
        j_llama.WeightQuantPolicy.from_string(spec), tie_embed=jcfg.tie_word_embeddings)
    kw = dict(dtype="float32", block_size=4, num_blocks=64, max_num_seqs=2, max_model_len=128,
              unified_token_budget=32, unified_prefill_quantum=16)
    prompts = [([1, 5, 9, 2, 7], 8),
               (np.random.default_rng(15).integers(0, 384, 19).tolist(), 8)]
    want, _ = asyncio.run(_serve(TpuEngine(JEngineConfig(model=jcfg, **kw), params=qtree),
                                 j_proto, JContext, prompts))
    port = TorchEngine(EngineConfig(model=tcfg, **kw, weight_quant=spec),
                       params=t_llama.params_from_jax(jax.tree.map(np.asarray, qtree),
                                                      device="cpu"), device="cpu")
    got, ready = asyncio.run(_serve(port, t_proto, Context, prompts))
    assert got == want and ready["weight_quant_active"] == 1.0
    moe_layer = port.runner.params["layers"][-1]
    assert moe_layer["w_gate"]["q"].dtype == torch.float8_e4m3fn
    assert moe_layer["w_gate"]["s"].shape == (
        tcfg.num_experts, tcfg.moe_intermediate_size or tcfg.intermediate_size)


def test_greedy_stream_quality_gate():
    """tests/test_weight_quant.py:336's gate on the port: int8 weights
    keep >= 0.7 of the full-precision greedy tokens on tiny-test (2
    prompts, 10 tokens), and the gauges read on and off."""
    prompts = [(np.random.default_rng(s).integers(0, 384, 24).tolist(), 10) for s in range(2)]

    def run(weight_quant):
        cfg = EngineConfig(model=ModelConfig.tiny_test(), dtype="float32", num_blocks=64,
                           max_num_seqs=4, max_model_len=128, prefill_batch=2,
                           unified_token_budget=64, unified_prefill_quantum=16,
                           sampling_extras=False, weight_quant=weight_quant)
        return asyncio.run(_serve(TorchEngine(cfg, device="cpu"), t_proto, Context, prompts))

    (base, g_b), (quant, g_q) = run(None), run("int8")
    assert (g_b["weight_quant_active"], g_b["weight_quant_bytes_saved"]) == (0.0, 0.0)
    assert g_q["weight_quant_active"] == 1.0 and g_q["weight_quant_bytes_saved"] > 0
    assert 0.9 < g_q["weight_quant_density"] <= 1.0
    match = sum(x == y for s1, s2 in zip(base, quant) for x, y in zip(s1, s2))
    assert sum(len(s) for s in base) == 20 and match / 20 >= 0.7


def test_policy_captures_the_same_program_set():
    """The reference's "zero new programs": a policy changes the params'
    values, not the step programs the warmup makes."""
    keys = {}
    for spec in (None, "int8"):
        engine = TorchEngine(EngineConfig(model=ModelConfig.tiny_test(), **ENGINE_KW,
                                          weight_quant=spec), device="cpu")

        async def warm(engine=engine):
            await engine.start()
            try:
                return await engine.warmup()
            finally:
                await engine.stop()

        n = asyncio.run(warm())
        keys[spec] = (n, sorted(engine.runner._programs))
    assert keys[None] == keys["int8"] and keys[None][0] > 0


def test_legacy_quant_serves_without_arming_the_policy_gauge():
    cfg = EngineConfig(model=ModelConfig.tiny_test(), **ENGINE_KW, quant="int8")
    engine = TorchEngine(cfg, device="cpu")
    _, ready = asyncio.run(_serve(engine, t_proto, Context, PROMPTS[:1]))
    assert ready["weight_quant_active"] == 0.0            # the reference's law
    saved, density = jq.quant_tree_stats(
        jq.quantize_params(PARAMS, tie_embed=JAX_CFG.tie_word_embeddings), dtype_bytes=4)
    assert ready["weight_quant_bytes_saved"] == pytest.approx(saved, rel=1e-12) and saved > 0
    assert ready["weight_quant_density"] == pytest.approx(density, abs=1e-4)
    assert tq.is_quantized(engine.runner.params["layers"][0]["w_down"])


# -- config, one-card check, CLI and gauges -----------------------------------
def test_config_law_matches_the_jax_messages():
    cfg = ModelConfig.tiny_test()
    EngineConfig(model=cfg, weight_quant="int8").validate()
    EngineConfig(model=cfg, weight_quant="attn=int8,mlp=fp8").validate()
    EngineConfig(model=cfg, weight_quant="int8", kv_quant="int8").validate()
    EngineConfig(model=cfg, quant="int8", kv_quant="int8").validate()
    for kw, match in (({"weight_quant": "int8", "quant": "int8"}, "--quant \\+ --weight-quant"),
                      ({"weight_quant": "int4"}, "format"),
                      ({"weight_quant": "router=int8"}, "site"),
                      ({"quant": "fp8"}, "quant='fp8' not in")):
        with pytest.raises(ValueError, match=match) as got:
            EngineConfig(model=cfg, **kw).validate()
        with pytest.raises(ValueError) as want:
            JEngineConfig(model=JAX_CFG, **kw).validate()
        assert str(got.value) == str(want.value)
    # A mesh and kv_sp stay refused.
    with pytest.raises(ValueError, match="device mesh"):
        EngineConfig(model=cfg, weight_quant="int8", mesh_shape={"tp": 2}).validate()


def test_one_card_check_prices_the_quantized_tree():
    """mixtral-8x7b: 93.4 GB in bf16 is refused; int8 (and fp8) fit, the
    bytes counted from shapes on the meta device, nothing allocated."""
    model = PRESETS["mixtral-8x7b"]()
    with pytest.raises(ValueError, match="exceed one 80 GB card"):
        EngineConfig(model=model).validate()
    for spec in ("int8", "fp8"):
        cfg = EngineConfig(model=model, weight_quant=spec)
        cfg.validate()
        assert 40e9 < cfg.weight_bytes() < 50e9
    legacy = EngineConfig(model=model, quant="int8")
    legacy.validate()
    assert legacy.weight_bytes() == pytest.approx(
        EngineConfig(model=model, weight_quant="attn=int8,mlp=int8,unembed=int8").weight_bytes())
    # Attention alone leaves the experts in bf16: still over one card.
    with pytest.raises(ValueError, match="bfloat16, attn=int8 weights exceed"):
        EngineConfig(model=model, weight_quant="attn=int8").validate()


def test_cli_accepts_the_flags_and_the_set_key(tmp_path):
    parse = t_cli.build_parser().parse_args
    for argv in (["--weight-quant", "attn=int8,mlp=fp8"], ["--quant", "int8"],
                 ["--weight-quant", "fp8", "--kv-quant", "int8"]):
        t_cli.refuse_unserved(parse(["run", *argv]))
    args = parse(["run", "--set", "Engine.weight_quant=attn=int8,mlp=fp8"])
    t_cli._apply_config(args)
    assert args.weight_quant == "attn=int8,mlp=fp8"
    (tmp_path / "c.yaml").write_text("Engine:\n  weight-quant: fp8\n")
    args = parse(["run", "--config", str(tmp_path / "c.yaml")])
    t_cli._apply_config(args)
    assert args.weight_quant == "fp8"
    args = parse(["run", "--model-path", "preset:tiny-test", "--quant", "int8",
                  "--weight-quant", "int8", "--max-model-len", "64", "--num-blocks", "32"])
    with pytest.raises(SystemExit, match="--quant \\+ --weight-quant"):
        t_cli._local_and_cfg(args)
    _, ecfg = t_cli._local_and_cfg(parse(["run", "--model-path", "preset:tiny-test",
                                          "--weight-quant", "int8", "--max-model-len", "64",
                                          "--num-blocks", "32"]))
    assert ecfg.weight_quant == "int8" and ecfg.weight_policy().active


@pytest.mark.parametrize("flags", [["--weight-quant", "int8"], ["--quant", "int8"]])
def test_cli_batch_serves_quantized_weights(flags, tmp_path, capsys):
    prompts = tmp_path / "p.txt"
    prompts.write_text("hello\nworld\n")
    t_cli.main(["run", "--in", f"batch:{prompts}", "--out", "torch", "--device", "cpu",
                "--dtype", "float32", "--model-path", "preset:tiny-test", "--max-model-len",
                "64", "--num-blocks", "32", "--max-num-seqs", "4", "--max-tokens", "4",
                "--no-warmup", *flags])
    lines = [line for line in capsys.readouterr().out.splitlines() if line.startswith("{")]
    report = json.loads(lines[-1])
    assert report["requests"] == 2 and report["tokens_out_per_s"] > 0


def test_checkout_quantizes_as_it_loads_through_the_cli_path(tmp_path):
    tcfg = ModelConfig.tiny_test()
    g = torch.Generator()
    g.manual_seed(1)
    wc.write_weights(tmp_path, tcfg, t_llama.init_params(tcfg, g, torch.float32, device="cpu"))
    args = t_cli.build_parser().parse_args(
        ["run", "--model-path", str(tmp_path), "--weight-quant", "fp8", "--device", "cpu",
         "--max-model-len", "64", "--num-blocks", "32"])
    local, ecfg = t_cli._local_and_cfg(args)
    params = local.load_params("float32", "cpu", ecfg.weight_policy())
    assert params["layers"][0]["wq"]["q"].dtype == torch.float8_e4m3fn
    assert params["embed"]["q"].dtype == torch.float8_e4m3fn    # tied: per row
    runner_params = TorchEngine(ecfg, params=params, device="cpu")
    asyncio.run(runner_params.start())
    try:
        assert runner_params.runner.params["layers"][0]["wq"]["q"] is params["layers"][0]["wq"]["q"]
    finally:
        asyncio.run(runner_params.stop())


def _gauge(text: str, name: str) -> float:
    for line in text.splitlines():
        if not line.startswith("#") and line.split(" ")[0].split("{")[0].endswith("_" + name):
            return float(line.rsplit(" ", 1)[1])
    raise AssertionError(f"{name} not in /metrics")


def test_gauges_reach_http_metrics_the_plane_and_the_exporter():
    from dynamo_tpu_torch.llm.kv_router.protocols import ForwardPassMetrics
    from dynamo_tpu_torch.llm.metrics_exporter import _GAUGES

    seen = []

    async def main():
        engine = TorchEngine(EngineConfig(model=ModelConfig.tiny_test(), **ENGINE_KW,
                                          weight_quant="int8"),
                             device="cpu", on_metrics=seen.append)
        await engine.start()
        manager = ModelManager()
        card = ModelDeploymentCard(name="tiny-test", context_length=128)
        manager.add_model(card.name, build_serving_pipeline(card, engine))
        service = HttpService(manager, host="127.0.0.1", port=0, readiness=engine.readiness)
        await service.start()
        try:
            resp = await fetch("127.0.0.1", service.port, "POST", "/v1/completions",
                               {"model": "tiny-test", "prompt": [1, 2, 3], "max_tokens": 4})
            assert resp.status == 200
            return (await fetch("127.0.0.1", service.port, "GET", "/metrics")).body.decode()
        finally:
            await service.stop()
            await engine.stop()

    text = asyncio.run(asyncio.wait_for(main(), 120))
    assert _gauge(text, "weight_quant_active") == 1.0
    assert _gauge(text, "weight_quant_bytes_saved") > 0
    assert 0.9 < _gauge(text, "weight_quant_density") <= 1.0
    assert seen and seen[-1]["weight_quant_active"] == 1.0
    fpm = ForwardPassMetrics.from_wire(seen[-1])
    assert fpm.weight_quant_bytes_saved == seen[-1]["weight_quant_bytes_saved"] > 0
    names = {n for n, _ in _GAUGES}
    assert {"weight_quant_active", "weight_quant_bytes_saved", "weight_quant_density"} <= names


def test_mocker_exposes_weight_quant_gauges():
    """tests/test_weight_quant.py:656 on the port's mocker."""
    from dynamo_tpu_torch.mocker.engine import MockerConfig, _SimRunner

    cfg = ModelConfig.tiny_test()
    sim = _SimRunner(EngineConfig(model=cfg, weight_quant="int8"),
                     MockerConfig(weight_bytes_per_step=2e9, weight_bytes_ratio=0.5))
    assert sim.weight_quant_density == 1.0 and sim.weight_quant_bytes_saved == 1e9
    off = _SimRunner(EngineConfig(model=cfg), MockerConfig())
    assert (off.weight_quant_density, off.weight_quant_bytes_saved) == (0.0, 0.0)
