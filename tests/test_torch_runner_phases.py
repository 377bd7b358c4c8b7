"""The port's phase-split runner entry points (``ModelRunner.prefill``,
``prefill_batch``, ``decode``, ``decode_multi``) against the JAX
package's ``ModelRunner`` on the CPU: tiny-test in float32 with the JAX
weights carried across by ``params_from_jax``, the same calls on the
same block layout give identical greedy tokens and logprobs within 1e-4
(tests/test_torch_model.py's logit bound). Also: decode_multi's tokens
against the no-cache oracle, and the refusal of an int8 cache."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from dynamo_tpu.engine.config import EngineConfig as JEngineConfig
from dynamo_tpu.engine.runner import ModelRunner as JRunner
from dynamo_tpu.models import llama as j_llama
from dynamo_tpu.models.config import ModelConfig as JCfg
from dynamo_tpu_torch.engine.config import EngineConfig
from dynamo_tpu_torch.engine.runner import ModelRunner
from dynamo_tpu_torch.models import llama as t_llama
from dynamo_tpu_torch.models.config import ModelConfig

LP_TOL = 1e-4
GREEDY = (0.0, 0, 1.0)
KW = dict(dtype="float32", block_size=4, num_blocks=64, max_num_seqs=4,
          max_model_len=128, prefill_batch=2, prefill_chunk=64)
PARAMS = j_llama.init_params(jax.random.PRNGKey(0), JCfg.tiny_test(), dtype=jnp.float32)
TPARAMS = t_llama.params_from_jax(jax.tree.map(np.asarray, PARAMS), device="cpu")

A = [5, 17, 3, 99, 42, 7, 250, 11, 2, 64, 8]        # 11 tokens, blocks 1-3
B_NEW = [31, 4, 90, 12, 77]                          # after A's first 8 tokens
C = [3, 3, 101, 45, 9, 14, 6]                        # 7 tokens
D = [8, 1, 200, 33, 9, 14, 77, 5, 6, 120, 31, 4, 90]  # 13 tokens
E_NEW = [60, 61, 62]                                 # after A's first 8 tokens


def _logprobs(lp):
    return [np.asarray(x.numpy() if isinstance(x, torch.Tensor) else x) for x in lp]


def _drive(runner):
    """The same phase-split calls on one runner; returns every sampled
    token and logprob set along the way."""
    out = {}
    out["prefill"] = runner.prefill(A, [1, 2, 3], 0, GREEDY)
    out["prefill_lp"] = _logprobs(runner.last_logprobs)
    # Prefix hit: A's first two blocks are shared.
    out["prefill_hit"] = runner.prefill(B_NEW, [1, 2, 4, 5], 8, GREEDY)
    lanes = [(C, [6, 7], 0, GREEDY), (D, [8, 9, 10, 11], 0, GREEDY),
             (E_NEW, [1, 2, 12], 8, GREEDY)]
    out["prefill_batch"] = runner.prefill_batch(lanes)
    out["prefill_batch_lp"] = _logprobs(runner.last_logprobs)

    # Decode lanes A, C, D and an idle lane; tables pre-grown for 8 steps.
    seqs = [(A + [out["prefill"]], [1, 2, 3, 13, 14]),
            (C + [out["prefill_batch"][0]], [6, 7, 15, 16]),
            (D + [out["prefill_batch"][1]], [8, 9, 10, 11, 17, 18])]
    B, MB, bs = 4, 32, 4
    tables = np.zeros((B, MB), np.int32)
    tok, pos, ctx, slot = (np.zeros(B, np.int32) for _ in range(4))
    for i, (toks, blocks) in enumerate(seqs):
        tables[i, :len(blocks)] = blocks
        n = len(toks)
        tok[i], pos[i], ctx[i] = toks[-1], n - 1, n
        slot[i] = blocks[(n - 1) // bs] * bs + (n - 1) % bs
    temp, top_k, top_p = np.zeros(B, np.float32), np.zeros(B, np.int32), np.ones(B, np.float32)
    step = runner.decode(tok, pos, tables, ctx, slot, temp, top_k, top_p)
    out["decode"] = np.asarray(step).tolist()
    active = ctx > 0
    nxt = np.where(active, step, 0).astype(np.int32)
    out["decode_multi"] = np.asarray(runner.decode_multi(
        nxt, pos + active, tables, ctx + active, temp, top_k, top_p, num_steps=6,
    )).tolist()
    out["seqs"] = seqs
    return out


@pytest.fixture(scope="module")
def both():
    jrun = JRunner(JEngineConfig(model=JCfg.tiny_test(), **KW), params=PARAMS)
    trun = ModelRunner(EngineConfig(model=ModelConfig.tiny_test(), **KW),
                       params=TPARAMS, device="cpu")
    return _drive(jrun), _drive(trun)


@pytest.mark.parametrize("key", ["prefill", "prefill_hit", "prefill_batch",
                                 "decode", "decode_multi"])
def test_phase_tokens_match_jax_runner(key, both):
    want, got = both
    assert got[key] == want[key]


@pytest.mark.parametrize("key", ["prefill_lp", "prefill_batch_lp"])
def test_phase_logprobs_match_jax_runner(key, both):
    want, got = both
    (wc, wi, wl), (gc, gi, gl) = want[key], got[key]
    n = len(gc) if key == "prefill_lp" else 3               # real lanes
    np.testing.assert_allclose(gc[:n], wc[:n], rtol=LP_TOL, atol=LP_TOL)
    np.testing.assert_array_equal(gi[:n], wi[:n])
    np.testing.assert_allclose(gl[:n], wl[:n], rtol=LP_TOL, atol=LP_TOL)


def test_decode_multi_continues_like_the_no_cache_oracle(both):
    """Each lane's decode + decode_multi tokens are the greedy
    continuation reference_forward gives from its whole sequence."""
    _, got = both
    cfg = ModelConfig.tiny_test()
    for i, (toks, _) in enumerate(got["seqs"]):
        seq = list(toks)
        stream = [got["decode"][i]] + [row[i] for row in got["decode_multi"]]
        for t in stream:
            logits = t_llama.reference_forward(cfg, TPARAMS, torch.tensor(seq))
            assert int(torch.argmax(logits[-1])) == t
            seq.append(t)
    assert all(row[3] == 0 for row in got["decode_multi"])  # idle lane


def test_prefill_refuses_a_chunk_over_prefill_chunk():
    runner = ModelRunner(EngineConfig(model=ModelConfig.tiny_test(), **KW),
                         params=TPARAMS, device="cpu")
    with pytest.raises(ValueError, match="prefill_chunk"):
        runner.prefill(list(range(1, 70)), list(range(1, 19)), 0, GREEDY)


@pytest.mark.parametrize("call", ["prefill", "prefill_batch", "decode", "decode_multi"])
def test_phase_entry_points_refuse_an_int8_cache(call):
    runner = ModelRunner(
        EngineConfig(model=ModelConfig.tiny_test(), kv_quant="int8", **KW),
        params=TPARAMS, device="cpu",
    )
    z = np.zeros(2, np.int32)
    args = {
        "prefill": ([1, 2, 3], [1], 0, GREEDY),
        "prefill_batch": ([([1, 2, 3], [1], 0, GREEDY)],),
        "decode": (z, z, np.zeros((2, 32), np.int32), z, z, z.astype(np.float32), z, z + 1),
        "decode_multi": (z, z, np.zeros((2, 32), np.int32), z, z.astype(np.float32), z,
                         z + 1, 2),
    }[call]
    with pytest.raises(ValueError, match="kv_quant"):
        getattr(runner, call)(*args)
