"""The port's spec-verify and sampling-extras variants of the unified step
(dynamo_tpu_torch: models/llama.py ``unified(verify_rows=R)``, the
runner's accept-prefix law and extras program, ops/sampling.py
``apply_penalties`` / ``token_logprobs``, the engine's prompt-lookup
drafting, penalties and logprob delivery, the OpenAI front's logprob
rendering) against the JAX package's, on the CPU.

The same numpy inputs, or tiny-test's JAX weights carried across by
``params_from_jax``, go through both packages. Tolerances: float32
values 1e-5 (logits of one float32 forward, logprobs); token ids,
accepted counts and greedy streams exactly. Mirrors
tests/test_unified.py:292 (spec streams byte-identical),
tests/test_engine.py:470 (frequency penalty) and :491 (logprob payload).
"""

import asyncio
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dynamo_tpu.engine.config import EngineConfig as JEngineConfig
from dynamo_tpu.engine.engine import TpuEngine
from dynamo_tpu.engine.runner import ModelRunner as JModelRunner
from dynamo_tpu.llm.backend import Detokenizer as JDetokenizer
from dynamo_tpu.llm.discovery import ModelManager as JManager
from dynamo_tpu.llm.http_service import HttpService as JService
from dynamo_tpu.llm.model_card import ModelDeploymentCard as JCard
from dynamo_tpu.llm.preprocessor import OpenAIPreprocessor as JPre
from dynamo_tpu.llm.protocols import common as j_proto
from dynamo_tpu.llm.tokenizer import ToyTokenizer as JToy
from dynamo_tpu.models import llama as j_llama
from dynamo_tpu.models.config import ModelConfig as JCfg
from dynamo_tpu.ops import sampling as j_sampling
from dynamo_tpu.ops.attention import AttnDispatch
from dynamo_tpu.runtime.engine import Context as JContext
from dynamo_tpu.runtime.pipeline import Pipeline as JPipeline
from dynamo_tpu_torch.engine.config import EngineConfig
from dynamo_tpu_torch.engine.engine import TorchEngine
from dynamo_tpu_torch.engine.runner import ModelRunner
from dynamo_tpu_torch.llm.discovery import ModelManager, build_serving_pipeline
from dynamo_tpu_torch.llm.http_client import fetch
from dynamo_tpu_torch.llm.http_service import HttpService
from dynamo_tpu_torch.llm.model_card import ModelDeploymentCard
from dynamo_tpu_torch.llm.protocols import common as t_proto
from dynamo_tpu_torch.models import llama as t_llama
from dynamo_tpu_torch.models.config import ModelConfig
from dynamo_tpu_torch.ops import sampling as t_sampling
from dynamo_tpu_torch.runtime.engine import Context

TOL = 1e-5
JAX_CFG = JCfg.tiny_test()
CFG = ModelConfig.tiny_test()
PARAMS = j_llama.init_params(jax.random.PRNGKey(0), JAX_CFG, dtype=jnp.float32)
TPARAMS = t_llama.params_from_jax(jax.tree.map(np.asarray, PARAMS), device="cpu")
# tests/test_engine.py's engine_config; tests/test_unified.py's _engine_cfg.
ENGINE_KW = dict(dtype="float32", block_size=4, num_blocks=64, max_num_seqs=4,
                 max_model_len=128)
SPEC_KW = dict(dtype="float32", num_blocks=64, max_num_seqs=4, max_model_len=96,
               prefill_chunk=32, unified_token_budget=64,
               unified_prefill_quantum=32, sampling_extras=False)


def greedy(prompt, n):
    """The port's no-cache greedy continuation (held to the JAX
    reference_forward by tests/test_torch_model.py)."""
    toks, out = list(prompt), []
    for _ in range(n):
        logits = t_llama.reference_forward(CFG, TPARAMS, torch.tensor(toks))
        toks.append(int(torch.argmax(logits[-1])))
        out.append(toks[-1])
    return out


# -- sampling laws on shared numpy inputs ------------------------------------
@pytest.mark.parametrize("B,V", [(3, 17), (8, 384)])
def test_apply_penalties_matches_jax(B, V):
    rng = np.random.default_rng(B * V)
    logits = rng.normal(size=(B, V)).astype(np.float32)
    counts = rng.integers(0, 4, size=(B, V)).astype(np.int32) * (rng.random((B, V)) < 0.3)
    freq = rng.uniform(0, 2, B).astype(np.float32)
    pres = rng.uniform(0, 2, B).astype(np.float32)
    want = np.asarray(j_sampling.apply_penalties(*map(jnp.asarray, (logits, counts, freq, pres))))
    got = t_sampling.apply_penalties(*map(torch.from_numpy, (logits, counts, freq, pres)))
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("B,V", [(4, 64), (6, 384)])
def test_token_logprobs_match_jax(B, V):
    rng = np.random.default_rng(V)
    logits = (3 * rng.normal(size=(B, V))).astype(np.float32)
    chosen = rng.integers(0, V, B).astype(np.int32)
    jc, jids, jlps = map(np.asarray, j_sampling.token_logprobs(
        jnp.asarray(logits), jnp.asarray(chosen)))
    tc, tids, tlps = t_sampling.token_logprobs(torch.from_numpy(logits),
                                               torch.from_numpy(chosen))
    np.testing.assert_allclose(tc.numpy(), jc, atol=TOL, rtol=TOL)
    np.testing.assert_array_equal(tids.numpy(), jids)
    np.testing.assert_allclose(tlps.numpy(), jlps, atol=TOL, rtol=TOL)


def test_device_key_gives_the_host_keys_streams():
    """The unified step reads the engine stream's key from its metadata
    block (int32 words); the phase-split entry points pass host ints.
    Both draw the same lanes, seeded lanes depend on (seed, position)
    only, and the stream moves with the step."""
    seed = torch.tensor([-1, 7, -1, 7])
    pos = torch.tensor([5, 5, 9, 9])
    for key in ((0, 1), (3, 0xFFFFFFF0), (0xFFFFFFFF, 12)):
        words = torch.from_numpy(np.array(key, np.uint32).view(np.int32))
        assert torch.equal(t_sampling.lane_keys(key, seed, pos),
                           t_sampling.lane_keys(words, seed, pos))
    a = t_sampling.lane_keys((0, 1), seed, pos)
    b = t_sampling.lane_keys((0, 2), seed, pos)
    assert a[1] == b[1] and a[0] != b[0]
    assert t_sampling.lane_keys((0, 1), seed, torch.tensor([5, 6, 9, 9]))[1] != a[1]


# -- verify rows of the unified forward --------------------------------------
BS = 4


def _flat(lanes, S, T, max_blocks=8):
    token_ids = np.zeros(T, np.int32)
    token_pos = np.full(T, -1, np.int32)
    slot_mapping = np.zeros(T, np.int32)
    token_seq = np.zeros(T, np.int32)
    tables = np.zeros((S, max_blocks), np.int32)
    q_start, q_len, kv_len, row_start = (np.zeros(S, np.int32) for _ in range(4))
    cursor = 0
    for s, (toks, blocks, prefix) in enumerate(lanes):
        n = len(toks)
        row_start[s], q_start[s], q_len[s], kv_len[s] = cursor, prefix, n, prefix + n
        tables[s, :len(blocks)] = blocks
        token_ids[cursor:cursor + n] = toks
        pos = np.arange(prefix, prefix + n)
        token_pos[cursor:cursor + n] = pos
        token_seq[cursor:cursor + n] = s
        slot_mapping[cursor:cursor + n] = tables[s, pos // BS] * BS + pos % BS
        cursor += n
    return (token_ids, token_pos, slot_mapping, token_seq, tables, q_start,
            q_len, kv_len, row_start)


@pytest.mark.parametrize("R", [2, 4])
def test_unified_verify_rows_match_jax(R):
    """Per-span verify logits [S, R, V]: rows ``q_len - 1 - draft_len + j``
    clamped into the span, short and idle spans included."""
    lanes = [(list(range(3, 13)), [1, 2, 3], 0), ([7, 8, 9], [4], 0),
             ([5], [5], 0), ([11, 12, 13, 14, 15, 16], [6, 7], 0)]
    draft_len = np.array([3, 2, 0, 1, 0], np.int32)
    meta = _flat(lanes, S=5, T=32)
    shape = (32 * BS, CFG.num_kv_heads, CFG.head_dim)
    jcaches = [(jnp.zeros(shape), jnp.zeros(shape)) for _ in range(CFG.num_layers)]
    tcaches = [(torch.zeros(shape), torch.zeros(shape)) for _ in range(CFG.num_layers)]
    attn = AttnDispatch(use_pallas=False)
    want, _ = j_llama.unified(JAX_CFG, PARAMS, jcaches, *map(jnp.asarray, meta), BS,
                              attn=attn, draft_len=jnp.asarray(draft_len), verify_rows=R)
    got = t_llama.unified(CFG, TPARAMS, tcaches, *map(torch.from_numpy, meta), BS,
                          draft_len=torch.from_numpy(draft_len), verify_rows=R)
    assert tuple(got.shape) == (5, R, CFG.vocab_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=1e-4)


# -- the runner's spec-verify and extras programs against the JAX runner -----
P0, P1, P2, P3 = [5, 17, 3, 99, 42, 7], [8, 1, 200, 33, 9], [3, 3, 101, 45, 2], [9, 4, 7]


def _spec_lanes():
    g0, g1, g2 = greedy(P0, 3), greedy(P1, 3), greedy(P2, 3)
    wrong = (g0[2] + 1) % CFG.vocab_size
    lanes = [
        (P0 + [g0[0], g0[1], wrong], [1, 2, 3], 0, (0.0, 0, 1.0, -1)),  # accepts 2
        (P1 + g1, [4, 5], 0, (0.0, 0, 1.0, -1)),                         # accepts 3
        (P2 + g2, [6, 7], 0, (1.0, 0, 1.0, 5)),      # sampled: accepts 0 by law
        (P3, [8], 0, (0.0, 0, 1.0, -1)),             # plain span
    ]
    return lanes, [3, 3, 3, 0]


def test_spec_accept_prefix_law_matches_jax_runner():
    lanes, draft_lens = _spec_lanes()
    kw = dict(ENGINE_KW, speculative_k=3, unified_token_budget=64)
    jr = JModelRunner(JEngineConfig(model=JAX_CFG, **kw), params=PARAMS)
    tr = ModelRunner(EngineConfig(model=CFG, **kw), params=TPARAMS, device="cpu")
    jout = jr.unified_step(lanes, draft_lens=draft_lens)
    tout = tr.unified_step(lanes, draft_lens=draft_lens)
    emitted, counts = tout.spec()
    j_emitted, j_counts = np.asarray(jout.toks), np.asarray(jout.counts)
    np.testing.assert_array_equal(counts, j_counts)
    assert counts[:4].tolist() == [3, 4, 1, 1]
    greedy_lanes = [0, 1, 3]
    np.testing.assert_array_equal(emitted[greedy_lanes], j_emitted[greedy_lanes])
    np.testing.assert_array_equal(tout.tokens()[greedy_lanes],
                                  np.asarray(jout.last)[greedy_lanes])
    # The bonus: lane 0's third position re-decided, lane 1's fourth.
    assert emitted[0, :3].tolist() == greedy(P0, 3)
    assert emitted[1].tolist() == greedy(P1, 4)
    # The sampled lane takes no draft; its one token is its bonus sample.
    assert emitted[2, 0] == tout.tokens()[2] and not emitted[2, 1:].any()


def test_extras_program_matches_jax_runner():
    """Penalties over the per-slot count buffer (reset, counts of each
    decode span's fed token) and logprobs, two dispatches in a row."""
    kw = dict(ENGINE_KW, unified_token_budget=32)
    jr = JModelRunner(JEngineConfig(model=JAX_CFG, **kw), params=PARAMS)
    tr = ModelRunner(EngineConfig(model=CFG, **kw), params=TPARAMS, device="cpu")
    g = (0.0, 0, 1.0, -1)
    steps = [
        ([(P0, [1, 2], 0, g), (P1, [3, 4], 0, g)],
         {"slots": [0, 2], "counts_add": [False, False], "reset": [True, True],
          "freq": [1.5, 0.0], "pres": [0.5, 2.0]}),
    ]
    jouts, touts = [], []
    for lanes, extras in steps:
        jouts.append(jr.unified_step(lanes, extras=extras))
        jouts[-1] = (np.asarray(jouts[-1].last), *map(np.asarray, jr.last_unified_logprobs))
        touts.append(tr.unified_step(lanes, extras=extras))
    # The next dispatch: both lanes decode their sampled token (counted).
    toks = touts[0].tokens()
    lanes = [([int(toks[0])], [1, 2], len(P0), g), ([int(toks[1])], [3, 4], len(P1), g)]
    extras = {"slots": [0, 2], "counts_add": [True, True], "reset": [False, False],
              "freq": [1.5, 0.0], "pres": [0.5, 2.0]}
    j2 = jr.unified_step(lanes, extras=extras)
    jouts.append((np.asarray(j2.last), *map(np.asarray, jr.last_unified_logprobs)))
    touts.append(tr.unified_step(lanes, extras=extras))
    for (jl, jc, jids, jlps), tout in zip(jouts, touts):
        tc, tids, tlps = tout.logprobs()
        np.testing.assert_array_equal(tout.tokens()[:2], jl[:2])
        np.testing.assert_allclose(tc[:2], jc[:2], atol=TOL, rtol=TOL)
        np.testing.assert_array_equal(tids[:2], jids[:2])
        np.testing.assert_allclose(tlps[:2], jlps[:2], atol=TOL, rtol=TOL)
    np.testing.assert_array_equal(tr._counts.numpy(), np.asarray(jr._counts))
    assert tr._counts[0, toks[0]] == 1 and tr._counts[2, toks[1]] == 1


# -- engines -----------------------------------------------------------------
async def _collect_full(engine, proto, ctx_cls, prompt, max_tokens=8,
                        sampling=None, logprobs=None):
    pre = proto.PreprocessedRequest(
        token_ids=prompt, sampling=sampling or proto.SamplingOptions(temperature=0.0),
        stop=proto.StopConditions(max_tokens=max_tokens, ignore_eos=True),
        logprobs=logprobs,
    )
    tokens, entries = [], []
    async for raw in engine.generate(ctx_cls(pre.to_wire())):
        out = proto.EngineOutput.from_wire(raw)
        tokens.extend(out.token_ids)
        entries.extend(out.logprobs or [])
    return tokens, entries


def _port(engine_kw, params=TPARAMS):
    return TorchEngine(EngineConfig(model=CFG, **engine_kw), params=params, device="cpu")


def _jax(engine_kw):
    return TpuEngine(JEngineConfig(model=JAX_CFG, **engine_kw), params=PARAMS)


SPEC_PROMPTS = [np.random.default_rng(0).integers(0, CFG.vocab_size, n).tolist()
                for n in (7, 19, 40, 12, 33)]
# Repeated n-grams: prompt lookup drafts from these, and the greedy
# continuation of tiny-test falls into loops it accepts.
LOOP_PROMPTS = [[4, 9, 2] * 6, [11, 5, 11, 5, 11, 5, 11]]


def _spec_run(engine, proto, ctx_cls, prompts, warm):
    async def main():
        await engine.start()
        try:
            if warm:
                await engine.warmup()
            out = []
            for p in prompts:
                out.append((await _collect_full(engine, proto, ctx_cls, p, 8))[0])
            return out
        finally:
            await engine.stop()

    return asyncio.run(main())


@pytest.fixture(scope="module")
def spec_streams():
    prompts = SPEC_PROMPTS + LOOP_PROMPTS
    engines = {k: _port(dict(SPEC_KW, speculative_k=k)) for k in (0, 3)}
    port = {k: _spec_run(e, t_proto, Context, prompts, warm=True)
            for k, e in engines.items()}
    jax_spec = _spec_run(_jax(dict(SPEC_KW, speculative_k=3)), j_proto, JContext,
                         prompts, warm=False)
    return port, jax_spec, engines


def test_engine_spec_greedy_streams_byte_identical(spec_streams):
    """tests/test_unified.py:292: greedy streams through the unified step
    are byte-identical with speculative decoding on and off — and equal
    to the JAX spec engine's."""
    port, jax_spec, engines = spec_streams
    assert port[3] == port[0] == jax_spec
    assert all(len(t) == 8 for t in port[0])
    assert engines[3].runner.compile_stats.manifest.count_of("unified:t16")


def test_engine_spec_drafts_and_accepts(spec_streams):
    _, _, engines = spec_streams
    ready = engines[3].readiness()
    assert ready["spec_drafted_tokens_total"] > 0
    assert ready["spec_accepted_tokens_total"] > 0
    assert ready["spec_tokens_per_step"] > 1.0
    assert ready["mid_traffic_compiles_total"] == 0
    assert engines[0].readiness()["spec_drafted_tokens_total"] == 0


def test_spec_auto_gate_disables_and_reprobes():
    """Below break-even over a window speculation turns off; after
    speculative_probe_steps plain steps a short probe turns it on again."""
    engine = _port(dict(SPEC_KW, speculative_k=3, speculative_break_even=9.0,
                        speculative_window=4, speculative_probe_steps=3,
                        speculative_probe_window=2))
    streams = _spec_run(engine, t_proto, Context, SPEC_PROMPTS[:2], warm=False)
    assert streams == [greedy(p, 8) for p in SPEC_PROMPTS[:2]]
    assert engine.spec_probe_count >= 1


def test_sampling_extras_refusals_match_jax():
    async def main(engine, proto, ctx_cls):
        await engine.start()
        errors = []
        try:
            for kw in ({"sampling": proto.SamplingOptions(presence_penalty=1.0)},
                       {"logprobs": 99}):
                try:
                    await _collect_full(engine, proto, ctx_cls, [1, 2, 3], 4, **kw)
                    errors.append(None)
                except ValueError as exc:
                    errors.append(str(exc))
        finally:
            await engine.stop()
        return errors

    kw = dict(ENGINE_KW, speculative_k=2)
    port = asyncio.run(main(_port(kw), t_proto, Context))
    want = asyncio.run(main(_jax(kw), j_proto, JContext))
    assert port == want
    assert "speculative" in port[0] and "exceeds" in port[1]


@pytest.fixture(scope="module")
def extras_streams():
    async def main(engine, proto, ctx_cls):
        await engine.start()
        try:
            prompt = [1, 5, 9, 2, 7]
            plain = await _collect_full(engine, proto, ctx_cls, prompt, 16)
            pen = await _collect_full(
                engine, proto, ctx_cls, prompt, 16,
                sampling=proto.SamplingOptions(temperature=0.0, frequency_penalty=8.0))
            both = await _collect_full(
                engine, proto, ctx_cls, prompt, 10,
                sampling=proto.SamplingOptions(temperature=0.0, frequency_penalty=0.7,
                                               presence_penalty=1.3), logprobs=2)
            lp = await _collect_full(engine, proto, ctx_cls, prompt, 6, logprobs=3)
            return plain, pen, both, lp, engine.readiness()
        finally:
            await engine.stop()

    port = asyncio.run(main(_port(ENGINE_KW), t_proto, Context))
    want = asyncio.run(main(_jax(ENGINE_KW), j_proto, JContext))
    return port, want


def test_frequency_penalty_discourages_repeats(extras_streams):
    """tests/test_engine.py:470, held to the JAX engine's streams."""
    (plain, pen, both, *_), (j_plain, j_pen, j_both, *_) = extras_streams
    prompt = [1, 5, 9, 2, 7]
    assert plain[0] == greedy(prompt, 16) == j_plain[0]
    assert pen[0] == j_pen[0] and both[0] == j_both[0]
    assert pen[0] != plain[0]
    assert len(set(pen[0])) > len(set(plain[0]))


def _assert_entries_match(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g["id"] == w["id"]
        assert abs(g["logprob"] - w["logprob"]) < TOL
        assert [i for i, _ in g["top"]] == [i for i, _ in w["top"]]
        np.testing.assert_allclose([v for _, v in g["top"]], [v for _, v in w["top"]],
                                   atol=TOL, rtol=TOL)


def test_logprobs_payload_shape_and_values(extras_streams):
    """tests/test_engine.py:491, held to the JAX engine's payload."""
    (_, _, both, (tokens, entries), ready), (_, _, j_both, j_lp, _) = extras_streams
    prompt = [1, 5, 9, 2, 7]
    assert tokens == greedy(prompt, 6) == j_lp[0]
    assert len(entries) == len(tokens)
    for tok, e in zip(tokens, entries):
        assert e["id"] == tok and e["logprob"] <= 0.0 and len(e["top"]) == 3
        lps = [lp for _, lp in e["top"]]
        assert lps == sorted(lps, reverse=True)
        assert e["top"][0][0] == tok and abs(e["top"][0][1] - e["logprob"]) < 1e-5
    _assert_entries_match(entries, j_lp[1])
    # Logprobs of the penalized distribution, as the JAX engine reports.
    _assert_entries_match(both[1], j_both[1])
    assert ready["mid_traffic_compiles_total"] > 0 and ready["served_unwarmed"]


# -- the OpenAI front's logprob payload through both servers -----------------
LP_REQUESTS = [
    ("/v1/completions", {"prompt": [7, 1, 8, 2, 8], "max_tokens": 5, "logprobs": 2}),
    ("/v1/completions", {"prompt": "once upon", "max_tokens": 4, "logprobs": 0,
                         "stream": True}),
    ("/v1/chat/completions", {"messages": [{"role": "user", "content": "hi"}],
                              "max_tokens": 4, "logprobs": True, "top_logprobs": 3}),
    ("/v1/chat/completions", {"messages": [{"role": "user", "content": "why?"}],
                              "max_tokens": 3, "logprobs": True, "top_logprobs": 1,
                              "stream": True, "frequency_penalty": 0.5}),
]


def _lp_view(resp):
    """Every choice's logprobs of an aggregated or streamed reply."""
    if resp.headers.get("content-type", "").startswith("text/event-stream"):
        return [ch.get("logprobs") for ev in resp.events() if ev.data != "[DONE]"
                for ch in json.loads(ev.data).get("choices", [])]
    return [ch.get("logprobs") for ch in resp.json()["choices"]]


def _split_floats(obj, floats):
    """obj with every float replaced by a marker, its floats collected."""
    if isinstance(obj, float):
        floats.append(obj)
        return "<float>"
    if isinstance(obj, dict):
        return {k: _split_floats(v, floats) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_split_floats(v, floats) for v in obj]
    return obj


def test_logprob_payload_through_both_servers():
    """The same requests through the JAX server over the JAX engine and
    the port's over the port's: the logprob payloads equal, key for key
    and token for token, their floats within 1e-5."""
    kw = dict(ENGINE_KW, prefill_batch=2, unified_token_budget=32,
              unified_prefill_quantum=8)

    async def main():
        jeng, teng = _jax(kw), _port(kw)
        jcard = JCard(name="tiny-test", context_length=128)
        tcard = ModelDeploymentCard(name="tiny-test", context_length=128)
        jman, tman = JManager(), ModelManager()
        jman.add_model("tiny-test", JPipeline.link(
            JPre(jcard, JToy()), JDetokenizer(JToy()), engine=jeng), jcard)
        tman.add_model("tiny-test", build_serving_pipeline(tcard, teng))
        views = {}
        for name, eng, man, cls in (("jax", jeng, jman, JService),
                                    ("port", teng, tman, HttpService)):
            await eng.start()
            service = cls(man, host="127.0.0.1", port=0, readiness=eng.readiness)
            await service.start()
            try:
                out = []
                for path, body in LP_REQUESTS:
                    resp = await fetch("127.0.0.1", service.port, "POST", path, {
                        "model": "tiny-test", "temperature": 0,
                        "nvext": {"ignore_eos": True}, **body})
                    out.append((resp.status, _lp_view(resp)))
                views[name] = out
            finally:
                await service.stop()
                await eng.stop()
        return views

    views = asyncio.run(main())
    for (t_status, t_lp), (j_status, j_lp) in zip(views["port"], views["jax"]):
        assert t_status == j_status == 200
        t_floats, j_floats = [], []
        assert _split_floats(t_lp, t_floats) == _split_floats(j_lp, j_floats)
        assert t_floats, "no logprobs in the reply"
        np.testing.assert_allclose(t_floats, j_floats, atol=TOL, rtol=TOL)
