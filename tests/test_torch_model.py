"""The port's Llama forward (dynamo_tpu_torch/models/llama.py) against
the JAX package: ``unified`` against JAX ``llama.unified`` (plain XLA
attention, AttnDispatch(use_pallas=False)) over two consecutive mixed
batches that share a paged cache, and against ``reference_forward``;
weights carried across by ``params_from_jax``. tiny-test and a narrow
config with llama3 rope scaling, float32, logits within 1e-4."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from dynamo_tpu.models import llama as j_llama
from dynamo_tpu.models.config import ModelConfig as JCfg
from dynamo_tpu.ops.attention import AttnDispatch
from dynamo_tpu.ops.rope import RopeScaling as JRope
from dynamo_tpu_torch.models import llama as t_llama
from dynamo_tpu_torch.models.config import ModelConfig
from dynamo_tpu_torch.ops.rope import RopeScaling

LOGIT_TOL = 1e-4
j_reference_forward = jax.jit(j_llama.reference_forward, static_argnums=0)
BS = 4
NUM_BLOCKS = 32
MAX_BLOCKS = 8

NARROW = dict(
    name="narrow-llama3", vocab_size=256, hidden_size=64,
    intermediate_size=128, num_layers=2, num_heads=4, num_kv_heads=2,
    head_dim=16, rope_theta=500000.0, max_position=512,
    tie_word_embeddings=True,
)
SCALING = dict(factor=32.0, low_freq_factor=1.0, high_freq_factor=4.0,
               original_max_position=64)


def _configs(name):
    if name == "tiny-test":
        return JCfg.tiny_test(), ModelConfig.tiny_test()
    return (JCfg(**NARROW, rope_scaling=JRope(**SCALING)),
            ModelConfig(**NARROW, rope_scaling=RopeScaling(**SCALING)))


def _flat_batch(lanes, S, T):
    """The runner's flat-batch build (engine/runner.py unified_step) for
    lanes [(tokens, block_ids, prefix_len)], as numpy arrays."""
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


A = [5, 17, 3, 99, 42, 7, 250, 11, 2, 64]      # 10 tokens
B = [8, 1, 200, 33, 9, 14, 77, 5, 6, 120, 31, 4, 90]   # 13 tokens
C = [3, 3, 101, 45]
BLOCKS = {"A": [1, 2, 3], "B": [4, 5, 6, 7], "C": [8, 9]}
STEPS = [
    # step 1: prefill A whole, B's first 6 tokens, an idle metadata row
    [(A, BLOCKS["A"], 0), (B[:6], BLOCKS["B"], 0)],
    # step 2: A decodes its next token, B's next 7-token quantum, C whole
    [([12], BLOCKS["A"], 10), (B[6:], BLOCKS["B"], 6), (C, BLOCKS["C"], 0)],
]


def _run_both(name):
    jcfg, tcfg = _configs(name)
    jparams = j_llama.init_params(jax.random.PRNGKey(3), jcfg, dtype=jnp.float32)
    tparams = t_llama.params_from_jax(
        jax.tree.map(np.asarray, jparams), device="cpu"
    )
    shape = (NUM_BLOCKS * BS, tcfg.num_kv_heads, tcfg.head_dim)
    jcaches = [(jnp.zeros(shape), jnp.zeros(shape)) for _ in range(tcfg.num_layers)]
    tcaches = [(torch.zeros(shape), torch.zeros(shape))
               for _ in range(tcfg.num_layers)]
    attn = AttnDispatch(use_pallas=False)
    j_unified = jax.jit(
        lambda p, kv, *meta: j_llama.unified(jcfg, p, kv, *meta, BS, attn=attn)
    )
    outs = []
    for lanes in STEPS:
        meta = _flat_batch(lanes, S=4, T=32)
        jl, jcaches = j_unified(jparams, jcaches, *map(jnp.asarray, meta))
        tl = t_llama.unified(
            tcfg, tparams, tcaches, *(torch.from_numpy(m) for m in meta), BS
        )
        outs.append((np.asarray(jl), tl.numpy()))
    return jcfg, tcfg, jparams, tparams, outs, jcaches, tcaches


@pytest.fixture(scope="module", params=["tiny-test", "narrow-llama3"])
def both(request):
    return _run_both(request.param)


def test_unified_logits_match_jax(both):
    *_, outs, _, _ = both
    for step, (want, got) in enumerate(outs):
        np.testing.assert_allclose(
            got, want, rtol=LOGIT_TOL, atol=LOGIT_TOL, err_msg=f"step {step}"
        )


def test_unified_kv_writes_match_jax(both):
    *_, jcaches, tcaches = both
    for (jk, jv), (tk, tv) in zip(jcaches, tcaches):
        np.testing.assert_allclose(tk.numpy(), np.asarray(jk), atol=1e-5)
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=1e-5)
    # Padding rows wrote only the trash block; block 10+ never touched.
    assert not tcaches[0][0][10 * BS:].any()


def test_unified_matches_reference_forward(both):
    """A whole-prompt span's last-row logits equal the no-cache forward,
    and a chunked prompt's second quantum ends where the full prompt
    does — in both packages."""
    jcfg, tcfg, jparams, tparams, outs, _, _ = both
    for toks, step, span in ((A, 0, 0), (B, 1, 1), (C, 1, 2), (A + [12], 1, 0)):
        want = np.asarray(j_reference_forward(
            jcfg, jparams, jnp.asarray(toks, jnp.int32)))[-1]
        port_ref = t_llama.reference_forward(
            tcfg, tparams, torch.tensor(toks))[-1].numpy()
        np.testing.assert_allclose(port_ref, want, rtol=LOGIT_TOL, atol=LOGIT_TOL)
        np.testing.assert_allclose(outs[step][1][span], want,
                                   rtol=LOGIT_TOL, atol=LOGIT_TOL)


def test_reference_forward_matches_jax_every_row(both):
    jcfg, tcfg, jparams, tparams, *_ = both
    toks = list(range(1, 30))
    want = np.asarray(j_reference_forward(
        jcfg, jparams, jnp.asarray(toks, jnp.int32)))
    got = t_llama.reference_forward(tcfg, tparams, torch.tensor(toks)).numpy()
    np.testing.assert_allclose(got, want, rtol=LOGIT_TOL, atol=LOGIT_TOL)


def test_params_from_jax_keeps_bf16_bits():
    jparams = j_llama.init_params(
        jax.random.PRNGKey(0), JCfg.tiny_test(), dtype=jnp.bfloat16
    )
    tparams = t_llama.params_from_jax(
        jax.tree.map(np.asarray, jparams), device="cpu"
    )
    assert tparams["embed"].dtype == torch.bfloat16
    want = np.asarray(jparams["layers"][1]["wq"]).view(np.uint16)
    got = tparams["layers"][1]["wq"].view(torch.int16).numpy().view(np.uint16)
    np.testing.assert_array_equal(got, want)


def test_params_from_jax_refuses_what_the_slice_does_not_serve():
    tree = jax.tree.map(np.asarray, j_llama.init_params(
        jax.random.PRNGKey(0), JCfg.tiny_test(), dtype=jnp.float32))
    quant = dict(tree, embed={"q": tree["embed"], "s": tree["ln_f"]})
    with pytest.raises(NotImplementedError, match="weight-quant"):
        t_llama.params_from_jax(quant, device="cpu")
    biased = dict(tree, layers=[dict(tree["layers"][0], bq=tree["ln_f"])])
    with pytest.raises(NotImplementedError, match="families"):
        t_llama.params_from_jax(biased, device="cpu")


def test_init_params_shapes_match_jax():
    jshapes = jax.tree.map(
        lambda a: tuple(a.shape),
        j_llama.init_params(jax.random.PRNGKey(0), JCfg.tiny_test()),
    )
    g = torch.Generator().manual_seed(0)
    tparams = t_llama.init_params(ModelConfig.tiny_test(), g, device="cpu")
    assert tparams["embed"].shape == jshapes["embed"]
    for tl, jl in zip(tparams["layers"], jshapes["layers"]):
        assert {k: tuple(v.shape) for k, v in tl.items()} == jl
    assert tparams["embed"].dtype == torch.bfloat16


def test_unserved_model_is_refused():
    cfg = ModelConfig.tiny_test().scaled(num_experts=4)
    with pytest.raises(NotImplementedError, match="MoE"):
        t_llama.init_params(cfg, torch.Generator())
