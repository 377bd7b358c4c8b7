"""The PyTorch port's ops, protocol and scheduling pieces against the JAX
package: the same numpy inputs go through both, compared at float32
tolerance (or exactly, where the port copies a pure-Python function).
Runs on the CPU."""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from dynamo_tpu.engine import compile_cache as j_cc
from dynamo_tpu.engine import scheduler as j_sched
from dynamo_tpu.llm.protocols import common as j_proto
from dynamo_tpu.ops import norms as j_norms
from dynamo_tpu.ops import rope as j_rope
from dynamo_tpu.ops import sampling as j_sampling
from dynamo_tpu_torch import resolve_device
from dynamo_tpu_torch.engine import compile_cache as t_cc
from dynamo_tpu_torch.engine import scheduler as t_sched
from dynamo_tpu_torch.engine.config import EngineConfig
from dynamo_tpu_torch.engine.kv_cache import BlockAllocator, BlockStateError
from dynamo_tpu_torch.llm.protocols import common as t_proto
from dynamo_tpu_torch.llm.tokens import TokenBlockSequence
from dynamo_tpu_torch.models.config import ModelConfig
from dynamo_tpu_torch.ops import norms as t_norms
from dynamo_tpu_torch.ops import rope as t_rope
from dynamo_tpu_torch.ops import sampling as t_sampling

F32_TOL = 1e-6


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("shape", [(5, 64), (3, 4, 16)])
def test_rms_norm_matches_jax(shape):
    rng = np.random.default_rng(0)
    x = rng.standard_normal(shape).astype(np.float32)
    w = rng.standard_normal(shape[-1]).astype(np.float32)
    want = np.asarray(j_norms.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-5))
    got = t_norms.rms_norm(_t(x), _t(w), 1e-5).numpy()
    np.testing.assert_allclose(got, want, rtol=F32_TOL, atol=F32_TOL)


def test_rms_norm_bf16_casts_back():
    x = torch.randn(4, 32).to(torch.bfloat16)
    out = t_norms.rms_norm(x, torch.ones(32, dtype=torch.bfloat16))
    assert out.dtype == torch.bfloat16


LLAMA3 = dict(factor=32.0, low_freq_factor=1.0, high_freq_factor=4.0,
              original_max_position=8192)
# The same law with its bands moved down to positions a short test
# reaches: wavelengths above 64 stretch, below 16 stay, a ramp between.
LLAMA3_NARROW = dict(factor=32.0, low_freq_factor=1.0, high_freq_factor=4.0,
                     original_max_position=64)


def _scalings(kind):
    if kind is None:
        return None, None
    if kind == "linear":
        return (j_rope.RopeScaling(kind="linear", factor=8.0),
                t_rope.RopeScaling(kind="linear", factor=8.0))
    kw = LLAMA3 if kind == "llama3" else LLAMA3_NARROW
    return j_rope.RopeScaling(**kw), t_rope.RopeScaling(**kw)


def _rope_pair(kind, theta, head_dim, pos):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((len(pos), 4, head_dim)).astype(np.float32)
    js, ts = _scalings(kind)
    want = np.asarray(
        j_rope.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta, js)
    )
    got = t_rope.apply_rope(_t(x), _t(pos), theta, ts).numpy()
    return got, want


@pytest.mark.parametrize(
    "kind", [None, "llama3_narrow", "llama3", "linear"],
)
@pytest.mark.parametrize("theta,head_dim", [(500000.0, 64), (10000.0, 16)])
def test_apply_rope_matches_jax(kind, theta, head_dim):
    """End to end at the first positions, where a one-ulp difference in
    the frequency table stays below float32 tolerance."""
    got, want = _rope_pair(kind, theta, head_dim, np.arange(8, dtype=np.int32))
    np.testing.assert_allclose(got, want, rtol=F32_TOL, atol=F32_TOL)


@pytest.mark.parametrize("kind", [None, "llama3_narrow", "llama3"])
def test_rotation_matches_jax_given_the_same_tables(kind):
    """The rotation law alone: fed the reference's own cos/sin tables, the
    port rotates exactly as the reference does, at any position."""
    rng = np.random.default_rng(2)
    pos = np.array([0, 5, 63, 700, 9000], np.int32)
    x = rng.standard_normal((len(pos), 4, 64)).astype(np.float32)
    js, _ = _scalings(kind)
    cos, sin = j_rope._angles(jnp.asarray(pos), 64, 500000.0, js)
    want = np.asarray(j_rope.apply_rope(jnp.asarray(x), jnp.asarray(pos),
                                        500000.0, js))
    got = t_rope.rotate(_t(x), _t(np.asarray(cos)), _t(np.asarray(sin)))
    np.testing.assert_allclose(got.numpy(), want, rtol=F32_TOL, atol=F32_TOL)


@pytest.mark.parametrize("kind", [None, "llama3"])
def test_apply_rope_matches_jax_at_long_positions(kind):
    """Far positions: XLA's and PyTorch's float32 exp differ by up to one
    ulp in the frequency table, and the angle p*f carries that relative
    error times p — so the bound is p_max * 2**-22 (two ulps of the
    largest angle), not 1e-6."""
    pos = np.array([700, 4095, 9000, 20004], np.int32)
    got, want = _rope_pair(kind, 500000.0, 64, pos)
    np.testing.assert_allclose(got, want, atol=float(pos.max()) * 2.0**-22)


def test_scaled_freqs_matches_jax():
    half = 32
    freqs = np.exp(-np.log(500000.0) * (np.arange(half) / half)).astype(
        np.float32
    )
    want = np.asarray(
        j_rope._scaled_freqs(jnp.asarray(freqs), j_rope.RopeScaling(**LLAMA3))
    )
    got = t_rope._scaled_freqs(_t(freqs), t_rope.RopeScaling(**LLAMA3)).numpy()
    np.testing.assert_allclose(got, want, rtol=F32_TOL)


@pytest.mark.parametrize("d", [
    None,
    {"rope_type": "default"},
    {"rope_type": "llama3", "factor": 32.0, "low_freq_factor": 1.0,
     "high_freq_factor": 4.0, "original_max_position_embeddings": 8192},
    {"type": "linear", "factor": 8.0},
    {"rope_type": "yarn", "factor": 40.0, "beta_fast": 32.0,
     "original_max_position_embeddings": 4096, "mscale": 0.707},
])
def test_rope_scaling_from_hf_matches_jax(d):
    want = j_rope.RopeScaling.from_hf(d)
    got = t_rope.RopeScaling.from_hf(d)
    if want is None:
        assert got is None
    else:
        assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_yarn_rotation_is_refused():
    s = t_rope.RopeScaling(kind="yarn", factor=40.0)
    with pytest.raises(NotImplementedError, match="MLA"):
        t_rope.apply_rope(torch.zeros(2, 1, 8), torch.arange(2), 10000.0, s)


def test_llama32_1b_preset_matches_jax():
    from dynamo_tpu.models.config import ModelConfig as JCfg

    j, t = JCfg.llama32_1b(), ModelConfig.llama32_1b()
    for f in dataclasses.fields(t):
        if f.name == "rope_scaling":
            assert dataclasses.asdict(t.rope_scaling) == dataclasses.asdict(
                j.rope_scaling
            )
        else:
            assert getattr(t, f.name) == getattr(j, f.name), f.name


def _greedy_inputs(B, V, seed):
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((B, V)).astype(np.float32)
    # Ties: the first maximum must win, as in jnp.argmax.
    logits[0, 3] = logits[0, 10] = logits[0].max() + 1.0
    logits[1, :] = 0.5
    return logits


def test_greedy_sample_matches_jax():
    B, V = 6, 384
    logits = _greedy_inputs(B, V, 2)
    temp = np.zeros(B, np.float32)
    top_k = np.zeros(B, np.int32)
    top_p = np.ones(B, np.float32)
    want = np.asarray(j_sampling.sample_tokens(
        jnp.asarray(logits), jax.random.PRNGKey(0), jnp.asarray(temp),
        jnp.asarray(top_k), jnp.asarray(top_p),
    ))
    got = t_sampling.sample_tokens(
        _t(logits), (0, 1), _t(temp), _t(top_k), _t(top_p)
    ).numpy()
    np.testing.assert_array_equal(got, want)
    assert got[0] == 3 and got[1] == 0


def test_top_k_one_and_tiny_top_p_are_greedy():
    B, V = 4, 128
    logits = np.random.default_rng(3).standard_normal((B, V)).astype(np.float32)
    greedy = np.argmax(logits, axis=-1)
    temp = torch.full((B,), 1.5)
    k1 = t_sampling.sample_tokens(
        _t(logits), (0, 1), temp, torch.ones(B, dtype=torch.int32),
        torch.ones(B),
    )
    p0 = t_sampling.sample_tokens(
        _t(logits), (0, 2), temp, torch.zeros(B, dtype=torch.int32),
        torch.full((B,), 1e-6),
    )
    np.testing.assert_array_equal(k1.numpy(), greedy)
    np.testing.assert_array_equal(p0.numpy(), greedy)


def test_seeded_lane_depends_only_on_seed_and_position():
    """The lane_keys contract: a seeded lane's draw is a function of
    (seed, sample_pos) alone — not of the engine stream key, its lane
    index or what else shares the batch."""
    V = 256
    rng = np.random.default_rng(4)
    row = rng.standard_normal(V).astype(np.float32)

    def draw(lane, B, key, seed, pos, others):
        logits = rng.standard_normal((B, V)).astype(np.float32)
        logits[lane] = row
        seeds = np.full(B, -1, np.int64)
        seeds[lane] = seed
        if others:
            seeds[(lane + 1) % B] = 99
        return int(t_sampling.sample_tokens(
            _t(logits), key, torch.ones(B), torch.zeros(B, dtype=torch.int32),
            torch.ones(B), seed=_t(seeds),
            sample_pos=torch.full((B,), pos, dtype=torch.int32),
        )[lane])

    for pos in (1, 17, 300):
        ref = draw(0, 1, (0, 1), 42, pos, False)
        assert draw(3, 5, (7, 9), 42, pos, True) == ref
        assert draw(1, 8, (123, 4), 42, pos, False) == ref
    streams = {
        seed: [draw(0, 2, (0, 1), seed, p, True) for p in range(24)]
        for seed in (42, 43)
    }
    assert streams[42] != streams[43]


def test_sampled_frequencies_follow_softmax():
    """Gumbel-max over the counter hash samples the softmax: 20000
    unseeded lanes over 4 candidates land within 0.02 of the
    probabilities."""
    B = 20000
    base = np.log(np.array([0.1, 0.2, 0.3, 0.4], np.float32))
    logits = np.tile(base, (B, 1))
    toks = t_sampling.sample_tokens(
        _t(logits), (3, 5), torch.ones(B), torch.zeros(B, dtype=torch.int32),
        torch.ones(B),
    ).numpy()
    freq = np.bincount(toks, minlength=4) / B
    np.testing.assert_allclose(freq, [0.1, 0.2, 0.3, 0.4], atol=0.02)


def test_seed_without_position_is_refused():
    with pytest.raises(ValueError, match="sample_pos"):
        t_sampling.sample_tokens(
            torch.zeros(1, 8), (0, 0), torch.ones(1),
            torch.zeros(1, dtype=torch.int32), torch.ones(1),
            seed=torch.ones(1, dtype=torch.long),
        )


def test_protocol_wire_matches_jax():
    kw = dict(
        token_ids=[1, 2, 3], model="m", annotations={"a": 1},
    )
    jr = j_proto.PreprocessedRequest(
        sampling=j_proto.SamplingOptions(temperature=0.7, top_k=5, seed=3),
        stop=j_proto.StopConditions(max_tokens=9, stop_token_ids=[2]), **kw,
    )
    tr = t_proto.PreprocessedRequest(
        sampling=t_proto.SamplingOptions(temperature=0.7, top_k=5, seed=3),
        stop=t_proto.StopConditions(max_tokens=9, stop_token_ids=[2]), **kw,
    )
    assert tr.to_wire() == jr.to_wire()
    assert t_proto.PreprocessedRequest.from_wire(jr.to_wire()) == tr
    for reason in j_proto.FinishReason:
        jo = j_proto.EngineOutput(token_ids=[4], finish_reason=reason, cum_tokens=2)
        to = t_proto.EngineOutput(
            token_ids=[4], finish_reason=t_proto.FinishReason(reason.value),
            cum_tokens=2,
        )
        assert to.to_wire() == jo.to_wire()
        assert t_proto.EngineOutput.from_wire(jo.to_wire()) == to


def test_opaque_deadline_and_trace_round_trip():
    wire = {"token_ids": [1], "deadline_ms": 250.0, "trace": {"id": "x"}}
    pre = t_proto.PreprocessedRequest.from_wire(wire)
    assert pre.deadline_ms == 250.0 and pre.trace == {"id": "x"}
    back = pre.to_wire()
    assert back["deadline_ms"] == 250.0 and back["trace"] == {"id": "x"}


class _S:
    def __init__(self, i):
        self.i = i

    def __repr__(self):
        return f"S{self.i}"


@pytest.mark.parametrize("seed", range(6))
def test_compose_unified_matches_jax(seed):
    rng = np.random.default_rng(seed)
    seqs = [_S(i) for i in range(12)]
    n_dec = int(rng.integers(0, 10))
    decode = seqs[:n_dec]
    prefill = [(s, int(rng.integers(0, 300))) for s in seqs[n_dec:]]
    budget = int(rng.choice([16, 32, 64, 256]))
    quantum = int(rng.integers(1, budget + 1))
    rot = int(rng.integers(0, 20))
    want = j_sched.compose_unified(decode, prefill, budget, quantum, rot)
    got = t_sched.compose_unified(decode, prefill, budget, quantum, rot)
    assert got == want


def test_token_budget_and_ladder_match_jax():
    for cap in (16, 40, 64, 256, 1000):
        assert t_cc.budget_ladder(cap) == j_cc.budget_ladder(cap)
        for n in (1, 15, 16, 17, 100, 257, 999):
            assert t_cc.token_budget(n, cap) == j_cc.token_budget(n, cap)


def test_block_allocator_prefix_lifecycle():
    a = BlockAllocator(num_blocks=8, block_size=4)
    assert a.num_free == 7  # block 0 reserved
    blocks = a.allocate_many(3)
    assert 0 not in blocks
    a.register(blocks[0], sequence_hash=111)
    a.register(blocks[1], sequence_hash=222)
    for b in blocks:
        a.release(b)
    assert a.num_free == 7  # registered blocks are reusable, still free
    matched = a.match_prefix([111, 222, 333])
    assert matched == blocks[:2]
    assert a.num_free == 5
    # Pressure evicts reusable blocks LRU-first once the free list drains.
    for b in matched:
        a.release(b)
    got = [a.allocate() for _ in range(7)]
    assert sorted(got) == list(range(1, 8))
    assert not a.is_registered(111) and not a.is_registered(222)
    with pytest.raises(MemoryError):
        a.allocate()
    a.release(got[0])
    with pytest.raises(BlockStateError):
        a.release(got[0])


def test_token_block_sequence_chains_hashes():
    a = TokenBlockSequence.from_tokens(range(10), block_size=4)
    b = TokenBlockSequence.from_tokens(list(range(8)) + [99, 98], block_size=4)
    assert len(a.blocks) == 2 and a.partial == [8, 9]
    assert a.sequence_hashes() == b.sequence_hashes()
    c = TokenBlockSequence.from_tokens([1] + list(range(1, 10)), block_size=4)
    # A change in the first block changes every later chained hash.
    assert c.sequence_hashes()[1] != a.sequence_hashes()[1]
    # block_hash is local: the same four tokens hash alike anywhere.
    assert c.blocks[1].block_hash == TokenBlockSequence.from_tokens(
        [4, 5, 6, 7], block_size=4).blocks[0].block_hash


@pytest.mark.parametrize("field,value,extra,match", [
    ("kv_quant", "fp8", {}, "not served"),
    ("quant", "int8", {}, "not served"),
    ("weight_quant", "int8", {}, "not served"),
    # Speculative decoding is served; a k past the block size is refused
    # with the JAX config's rule.
    ("speculative_k", 2, {"block_size": 1, "num_blocks": 1024}, "block_size=1"),
    ("mesh_shape", {"tp": 2}, {}, "not served"),
    ("kv_sp", True, {}, "not served"),
    ("multimodal", True, {}, "not served"),
], ids=["kv_quant-fp8", "quant-int8", "weight_quant-int8", "speculative_k-2",
        "mesh_shape-value4", "kv_sp-True", "multimodal-True"])
def test_engine_config_refuses_unserved_features(field, value, extra, match):
    cfg = EngineConfig(model=ModelConfig.tiny_test(), **{field: value}, **extra)
    with pytest.raises(ValueError, match=match):
        cfg.validate()


@pytest.mark.parametrize("change", [
    {"sliding_window": 32}, {"num_experts": 4}, {"kv_lora_rank": 32},
    {"qkv_bias": True}, {"qk_norm": True}, {"hidden_act": "gelu_tanh"},
])
def test_engine_config_refuses_unserved_models(change):
    model = ModelConfig.tiny_test().scaled(**change)
    with pytest.raises(ValueError, match="not served"):
        EngineConfig(model=model).validate()


def test_engine_config_clamps_budget_like_jax():
    from dynamo_tpu.engine.config import EngineConfig as JEC
    from dynamo_tpu.models.config import ModelConfig as JCfg

    kw = dict(max_num_seqs=1, prefill_batch=1, max_model_len=40,
              num_blocks=16, block_size=4, unified_prefill_quantum=200)
    t = EngineConfig(model=ModelConfig.tiny_test(), **kw)
    j = JEC(model=JCfg.tiny_test(), **kw)
    t.validate()
    j.validate()
    assert t.unified_token_budget == j.unified_token_budget == 64
    assert t.unified_prefill_quantum == j.unified_prefill_quantum == 64


def test_cuda_is_the_default_device():
    assert resolve_device("cpu") == torch.device("cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            resolve_device()
