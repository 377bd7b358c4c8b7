"""The port's multimodal serving (dynamo_tpu_torch/models/vision.py,
llm/multimodal.py, the engine's mm segments and the runner's
``unified_mm`` variant) against the JAX package on the CPU, mirroring
tests/test_multimodal.py: image decoding, the encoder against JAX's on
the same weights, the soft-prompt splice in ``llama.unified`` and
``runner.prefill`` against the oracle, chunk-relative segments across a
dispatch boundary, tiny-test engine streams byte-identical to the JAX
engine's, the engine's mm guards (prefix cache, KV events, offload,
onboard, peer park, spec drafts, remote prefill), the warmup plan, the
pipeline end to end and discovery over the runtime plane.

Inputs come from numpy seeds; weights from the JAX params trees through
``params_from_jax`` / ``vision_params_from_jax``. float32 within 1e-5;
bf16 within 1e-2."""

import asyncio
import base64
import dataclasses
import io

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from dynamo_tpu.engine import engine as j_engine_mod
from dynamo_tpu.engine.config import EngineConfig as JEngineConfig
from dynamo_tpu.engine.engine import TpuEngine
from dynamo_tpu.llm import multimodal as j_mm
from dynamo_tpu.llm.protocols import common as j_proto
from dynamo_tpu.models import llama as j_llama
from dynamo_tpu.models import vision as j_vision
from dynamo_tpu.models.config import ModelConfig as JCfg
from dynamo_tpu.ops.attention import AttnDispatch
from dynamo_tpu.runtime.engine import Context as JContext
from dynamo_tpu_torch.engine import engine as t_engine_mod
from dynamo_tpu_torch.engine.compile_cache import default_shape_grid
from dynamo_tpu_torch.engine.config import EngineConfig
from dynamo_tpu_torch.engine.engine import TorchEngine
from dynamo_tpu_torch.engine.runner import ModelRunner
from dynamo_tpu_torch.engine.sequence import Sequence
from dynamo_tpu_torch.llm import multimodal as t_mm
from dynamo_tpu_torch.llm.protocols import common as t_proto
from dynamo_tpu_torch.models import llama as t_llama
from dynamo_tpu_torch.models import vision as t_vision
from dynamo_tpu_torch.models.config import ModelConfig
from dynamo_tpu_torch.runtime.engine import Context

TOL = 1e-5
BS = 4
JCFG, TCFG = JCfg.tiny_test(), ModelConfig.tiny_test()
D = TCFG.hidden_size
JP = j_llama.init_params(jax.random.PRNGKey(0), JCFG, dtype=jnp.float32)
TP = t_llama.params_from_jax(jax.tree.map(np.asarray, JP), device="cpu")
VCFG = t_vision.VisionConfig.tiny_test(out_dim=D)
JVP = j_vision.init_vision_params(jax.random.PRNGKey(7), j_vision.VisionConfig.tiny_test(out_dim=D))
TVP = t_vision.vision_params_from_jax(jax.tree.map(np.asarray, JVP), device="cpu")


def _npy_data_url(arr: np.ndarray) -> str:
    buf = io.BytesIO()
    np.save(buf, arr)
    return "data:application/x-npy;base64," + base64.b64encode(buf.getvalue()).decode()


def _image(seed: int, shape=(32, 32, 3)) -> np.ndarray:
    return np.random.default_rng(seed).random(shape, np.float32)


def _tokens(seed: int, n: int) -> list[int]:
    return [int(t) for t in np.random.default_rng(seed).integers(1, TCFG.vocab_size, n)]


def _segment(seed: int, n: int = 16) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal((n, D)).astype(np.float32)


def test_decode_image_npy_and_resize():
    """Exact round trip of a float .npy image; a uint8 300x200 image is
    scaled to [0, 1] and resized by nearest neighbour exactly as the JAX
    package resizes it; a non-data URL is refused."""
    img = _image(1)
    np.testing.assert_array_equal(t_mm.decode_image(_npy_data_url(img), 32), img)
    big = (np.arange(300 * 200 * 3) % 255).reshape(300, 200, 3).astype(np.uint8)
    got = t_mm.decode_image(_npy_data_url(big), 32)
    assert got.shape == (32, 32, 3) and 0.0 <= got.min() and got.max() <= 1.0
    np.testing.assert_array_equal(got, j_mm.decode_image(_npy_data_url(big), 32))
    gray = _image(2, (20, 24))
    np.testing.assert_array_equal(t_mm.decode_image(_npy_data_url(gray), 32),
                                  j_mm.decode_image(_npy_data_url(gray), 32))
    with pytest.raises(ValueError, match="data:"):
        t_mm.decode_image("http://example.com/cat.png", 32)


def test_vision_encoder_shape_and_determinism():
    g = torch.Generator().manual_seed(0)
    params = t_vision.init_vision_params(g, VCFG, device="cpu")
    a = t_vision.encode_image(params, VCFG, _image(2))
    b = t_vision.encode_image(params, VCFG, _image(2))
    assert a.shape == (VCFG.num_patches, D) and a.dtype == torch.float32
    assert torch.equal(a, b)
    c = t_vision.encode_image(params, VCFG, _image(3))
    assert (a - c).abs().max() > 1e-3   # another image, other embeddings
    assert VCFG.param_count() == sum(
        t.numel() for t in [params[k] for k in ("patch_proj", "pos_embed", "ln_f", "out_proj")]
        + [w for layer in params["layers"] for w in layer.values()])


@pytest.mark.parametrize("vit_b16", [False, True], ids=["tiny", "vit_b16_widths_2_layers"])
def test_encode_image_matches_jax(vit_b16):
    """The port's encoder on the JAX params tree's weights: within 1e-5
    of JAX's ``encode_image`` in float32 (tiny-test, and ViT-B/16's
    widths at 2 layers: 224 px, 16 px patches, hidden 768, 12 heads)."""
    kw = dict(image_size=224, patch_size=16, hidden_size=768, num_layers=2,
              num_heads=12, out_dim=128) if vit_b16 else dict(out_dim=D)
    jcfg, tcfg = j_vision.VisionConfig(**kw), t_vision.VisionConfig(**kw)
    jp = j_vision.init_vision_params(jax.random.PRNGKey(3), jcfg)
    tp = t_vision.vision_params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    img = _image(5, (tcfg.image_size, tcfg.image_size, 3))
    want = np.asarray(j_vision.encode_image(jp, jcfg, jnp.asarray(img)))
    got = t_vision.encode_image(tp, tcfg, img).numpy()
    assert got.shape == (tcfg.num_patches, tcfg.out_dim)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def _flat_batch(lanes, S, T, max_blocks=16):
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
        token_pos[cursor:cursor + n] = np.arange(prefix, prefix + n)
        token_seq[cursor:cursor + n] = s
        for j in range(n):
            p = prefix + j
            slot_mapping[cursor + j] = blocks[p // BS] * BS + p % BS
        cursor += n
    return (token_ids, token_pos, slot_mapping, token_seq, tables, q_start,
            q_len, kv_len, row_start)


def test_unified_with_embeds_matches_jax():
    """``llama.unified`` with soft-prompt rows in the flat batch (an image
    cut across two steps, beside a text lane and a decode lane): logits
    and every layer's K/V within 1e-5 of JAX's ``unified`` with the same
    ``embeds``/``embed_mask``."""
    A, B = _tokens(1, 30), _tokens(2, 12)
    seg = _segment(3, 12)
    steps = [
        ([(A[:20], [1, 2, 3, 4, 5, 6, 7, 8], 0), (B, [9, 10, 11], 0)], {0: (14, 0, 6)}),
        ([(A[20:], [1, 2, 3, 4, 5, 6, 7, 8], 20), (B[-1:], [9, 10, 11, 12], 12)],
         {0: (0, 6, 12)}),
    ]
    shape = (40 * BS, TCFG.num_kv_heads, TCFG.head_dim)
    jc = [(jnp.zeros(shape), jnp.zeros(shape)) for _ in range(TCFG.num_layers)]
    tc = [(torch.zeros(shape), torch.zeros(shape)) for _ in range(TCFG.num_layers)]
    attn = AttnDispatch(use_pallas=False)
    j_unified = jax.jit(lambda p, kv, e, m, *meta: j_llama.unified(
        JCFG, p, kv, *meta, BS, attn=attn, embeds=e, embed_mask=m))
    for lanes, rows in steps:
        meta = _flat_batch(lanes, S=4, T=32)
        embeds = np.zeros((32, D), np.float32)
        mask = np.zeros(32, bool)
        for s, (off, lo, hi) in rows.items():
            r0 = meta[-1][s] + off
            embeds[r0:r0 + hi - lo] = seg[lo:hi]
            mask[r0:r0 + hi - lo] = True
        want, jc = j_unified(JP, jc, jnp.asarray(embeds), jnp.asarray(mask), *map(jnp.asarray, meta))
        got = t_llama.unified(TCFG, TP, tc, *(torch.from_numpy(m) for m in meta), BS,
                              embeds=torch.from_numpy(embeds),
                              embed_mask=torch.from_numpy(mask))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)
    for (jk, jv), (tk, tv) in zip(jc, tc):
        np.testing.assert_allclose(tk.numpy()[BS:], np.asarray(jk)[BS:], rtol=TOL, atol=TOL)
        np.testing.assert_allclose(tv.numpy()[BS:], np.asarray(jv)[BS:], rtol=TOL, atol=TOL)


def test_bf16_embeds_round_to_the_weights_dtype_before_the_stream():
    """The splice rounds the float32 embeddings to the weights' dtype, as
    the reference's ``embeds.astype(x.dtype)`` does, before the float32
    residual stream: bf16 logits with embeds equal (bitwise) those with
    the embeds rounded to bf16 first; against the same weights widened to
    float32 with the rounded embeds, they are closer on average than
    JAX's bf16 ``reference_forward`` with the same embeds (whose stream
    is bf16 too), as tests/test_torch_families.py holds the text path."""
    jb = j_llama.init_params(jax.random.PRNGKey(0), JCFG, dtype=jnp.bfloat16)
    tb = t_llama.params_from_jax(jax.tree.map(np.asarray, jb), device="cpu")
    toks = torch.tensor(_tokens(4, 24))
    seg = _segment(5, 10) * 3.0
    embeds = np.zeros((24, D), np.float32)
    embeds[6:16] = seg
    mask = np.zeros(24, bool)
    mask[6:16] = True
    e, m = torch.from_numpy(embeds), torch.from_numpy(mask)
    got = t_llama.reference_forward(TCFG, tb, toks, e, m)
    rounded = t_llama.reference_forward(TCFG, tb, toks, e.bfloat16().float(), m)
    assert torch.equal(got, rounded)
    assert not torch.equal(got, t_llama.reference_forward(TCFG, tb, toks))
    jax_bf16 = torch.from_numpy(np.asarray(j_llama.reference_forward(
        JCFG, jb, jnp.asarray(toks.numpy()), embeds=jnp.asarray(embeds),
        embed_mask=jnp.asarray(mask))).astype(np.float32)).double()
    t64 = t_llama.params_from_jax(jax.tree.map(np.asarray, jb), dtype=torch.float64,
                                  device="cpu")
    exact = t_llama.reference_forward(TCFG, t64, toks, e.bfloat16().double(), m)
    assert (got.double() - exact).abs().mean() < (jax_bf16 - exact).abs().mean()


def test_runner_mm_prefill_matches_oracle():
    """``runner.prefill(..., mm_embeds=)`` (the paged prefill kernel's
    plain version on the CPU) agrees with the no-cache oracle with the
    same rows spliced (greedy first token identical, logprobs within
    1e-5), with JAX's oracle, and differs from the text-only prefill."""
    ecfg = EngineConfig(model=TCFG, num_blocks=32, max_num_seqs=2, max_model_len=128,
                        dtype="float32")
    runner = ModelRunner(ecfg, params=TP, device="cpu")
    prompt = list(range(10, 40))
    seg, off = _segment(0, 8), 5
    tok = runner.prefill(prompt, [1, 2, 3, 4, 5, 6, 7, 8], 0, (0.0, 0, 1.0),
                         mm_embeds=[(off, seg)])
    embeds = np.zeros((len(prompt), D), np.float32)
    mask = np.zeros(len(prompt), bool)
    embeds[off:off + len(seg)] = seg
    mask[off:off + len(seg)] = True
    want = t_llama.reference_forward(TCFG, TP, torch.tensor(prompt),
                                     torch.from_numpy(embeds), torch.from_numpy(mask))
    jwant = np.asarray(j_llama.reference_forward(
        JCFG, JP, jnp.asarray(prompt), embeds=jnp.asarray(embeds), embed_mask=jnp.asarray(mask)))
    np.testing.assert_allclose(want.numpy(), jwant, rtol=TOL, atol=TOL)
    assert tok == int(torch.argmax(want[-1]))
    lp = torch.log_softmax(want[-1], -1)
    np.testing.assert_allclose(float(runner.last_logprobs[0][0]), float(lp[tok]), atol=TOL)
    plain = ModelRunner(ecfg, params=TP, device="cpu").prefill(
        prompt, [1, 2, 3, 4, 5, 6, 7, 8], 0, (0.0, 0, 1.0))
    assert plain == int(torch.argmax(t_llama.reference_forward(TCFG, TP, torch.tensor(prompt))[-1]))


def test_mm_for_chunk_cuts_an_image_across_two_chunks():
    """``_mm_for_chunk`` gives what JAX's gives: an image at prompt rows
    [10, 26) cut by chunks [0, 16) and [16, 32) into its first 6 rows at
    chunk offset 10 and its last 10 at offset 0; a chunk with no image row
    gets None."""
    seg = _segment(1, 16)
    segs = [(10, seg), (40, seg[:4])]
    t_seq = Sequence(request_id="r", prompt_tokens=[1] * 48, sampling=None, stop=None,
                     emit=None, mm_segments=segs)
    j_seq = j_engine_mod.Sequence(request_id="r", prompt_tokens=[1] * 48, sampling=None,
                                  stop=None, emit=None, mm_segments=segs)
    for start, n in ((0, 16), (16, 16), (32, 16), (26, 14), (0, 48)):
        got = t_engine_mod._mm_for_chunk(t_seq, start, n)
        want = j_engine_mod._mm_for_chunk(j_seq, start, n)
        assert (got is None) == (want is None)
        for (go, ga), (wo, wa) in zip(got or [], want or []):
            assert go == wo
            np.testing.assert_array_equal(ga, wa)
    first = t_engine_mod._mm_for_chunk(t_seq, 0, 16)
    second = t_engine_mod._mm_for_chunk(t_seq, 16, 16)
    assert [(o, len(a)) for o, a in first] == [(10, 6)]
    assert [(o, len(a)) for o, a in second] == [(0, 10)]
    assert t_engine_mod._mm_for_chunk(t_seq, 26, 14) is None


def _mm_pre(proto, prompt, segs, n, temperature=0.0):
    return proto.PreprocessedRequest(
        token_ids=prompt, sampling=proto.SamplingOptions(temperature=temperature),
        stop=proto.StopConditions(max_tokens=n, ignore_eos=True),
        mm_segments=[{"offset": off, "data": seg.tobytes(), "shape": list(seg.shape),
                      "dtype": "float32"} for off, seg in segs])


async def _collect(engine, proto, ctx_cls, pre):
    out = []
    async for raw in engine.generate(ctx_cls(pre.to_wire())):
        out += proto.EngineOutput.from_wire(raw).token_ids
    return out


async def _serve(engine, proto, ctx_cls, requests, warm=False):
    await engine.start()
    if warm:
        await engine.warmup()
    try:
        return await asyncio.gather(*[_collect(engine, proto, ctx_cls, r) for r in requests])
    finally:
        await engine.stop()


# Prompts with 1 or 2 images (16 rows each) against a 32-token budget
# and a 16-token quantum: images straddle dispatches.
MM_REQUESTS = [
    (_tokens(11, 40), [(5, _segment(1))]),
    (_tokens(12, 60), [(3, _segment(2)), (30, _segment(3))]),
    (_tokens(13, 20), []),
]
ENGINE_KW = dict(dtype="float32", block_size=BS, num_blocks=96, max_num_seqs=3,
                 max_model_len=128, unified_token_budget=32, unified_prefill_quantum=16,
                 multimodal=True)


def _oracle(prompt, segs, n):
    embeds = torch.zeros((len(prompt) + n, D))
    mask = torch.zeros(len(prompt) + n, dtype=torch.bool)
    for off, seg in segs:
        embeds[off:off + len(seg)] = torch.from_numpy(seg)
        mask[off:off + len(seg)] = True
    toks, out = list(prompt), []
    for _ in range(n):
        T = len(toks)
        logits = t_llama.reference_forward(TCFG, TP, torch.tensor(toks), embeds[:T], mask[:T])
        out.append(int(torch.argmax(logits[-1])))
        toks.append(out[-1])
    return out


def test_mm_engine_streams_match_the_jax_engine_and_the_oracle():
    """tiny-test in float32, multimodal on both engines: greedy streams of
    image requests (one and two images, cut across dispatches) and a text
    request are byte-identical to the JAX engine's and equal the no-cache
    oracle with the same rows spliced; the port ran the unified_mm
    program, and no program was made mid-traffic."""
    n = 8
    j = asyncio.run(_serve(TpuEngine(JEngineConfig(model=JCFG, **ENGINE_KW), params=JP),
                           j_proto, JContext,
                           [_mm_pre(j_proto, p, s, n) for p, s in MM_REQUESTS]))
    engine = TorchEngine(EngineConfig(model=TCFG, **ENGINE_KW), params=TP, device="cpu")
    t = asyncio.run(_serve(engine, t_proto, Context,
                           [_mm_pre(t_proto, p, s, n) for p, s in MM_REQUESTS], warm=True))
    assert t == j
    for (p, s), got in zip(MM_REQUESTS, t):
        assert got == _oracle(p, s, n)
    stats = engine.runner.compile_stats
    assert stats.mid_traffic_compiles == 0
    assert "unified_mm" in {spec[0] for spec in stats.manifest.specs()}


class _PeerKvbm:
    """A block manager stand-in whose peer client would take any pull."""

    def __init__(self):
        self.planned = 0

    def has_peer_client(self):
        return True

    def peek_host_match(self, hashes):
        return 0

    def add_pull_listener(self, fn):
        pass

    def plan_peer_pull(self, missing, prefill_tps=None):
        self.planned += 1
        return "key"


def test_mm_sequences_skip_prefix_cache_kv_events_offload_onboard_and_park():
    """Two image requests with the same tokens and different images: no
    prefix block matched or registered, no KV event, nothing offered to
    the host tier (its stats stay empty), the second one's stream is its
    own; a text request with the same tokens registers and publishes.
    The onboard and the G4 park decline an mm sequence outright."""
    from dynamo_tpu_torch.block_manager import KvbmConfig, KvBlockManager, KvLayoutConfig

    prompt = _tokens(21, 40)
    cfg = EngineConfig(model=TCFG, **ENGINE_KW)
    events = []

    async def main():
        kvbm = await KvBlockManager(KvbmConfig(
            layout=KvLayoutConfig.for_engine(cfg), host_blocks=16)).start()
        engine = TorchEngine(cfg, params=TP, device="cpu", block_manager=kvbm,
                             on_kv_event=events.append)
        await engine.start()
        try:
            out = [await _collect(engine, t_proto, Context,
                                  _mm_pre(t_proto, prompt, [(4, _segment(s))], 4))
                   for s in (31, 32)]
            mm_events, mm_reused = len(events), engine._reused_device_blocks
            await kvbm.drain_offers()
            mm_host = kvbm.stats()["host_registered"]
            await _collect(engine, t_proto, Context, _mm_pre(t_proto, prompt, [], 4))
            seq = Sequence(request_id="x", prompt_tokens=prompt, sampling=None, stop=None,
                           emit=None, mm_segments=[(4, _segment(31))])
            seq.hashes = object()
            engine._onboard_host_prefix(seq)   # returns before touching the tier
            engine.kvbm = _PeerKvbm()
            parked = engine._maybe_park_for_peer_pull(seq)
            planned = engine.kvbm.planned
            engine.kvbm = kvbm
            await engine.stop()
            return out, mm_events, mm_reused, mm_host, len(events), parked, planned
        finally:
            await kvbm.stop()

    out, mm_events, mm_reused, mm_host, text_events, parked, planned = asyncio.run(main())
    assert (mm_events, mm_reused, mm_host) == (0, 0, 0)
    assert out[0] == _oracle(prompt, [(4, _segment(31))], 4)
    assert out[1] == _oracle(prompt, [(4, _segment(32))], 4)
    assert text_events > 0
    assert parked is False and planned == 0


def test_spec_engine_composes_no_drafts_beside_an_mm_prefill():
    """On a speculative engine (k=2) an image prefill arriving while a
    text lane decodes rides a dispatch without drafts (the unified_mm
    program has no verify rows): both streams equal the oracle."""
    text = [5, 6, 7, 5, 6, 7, 5, 6, 7, 5, 6, 7]
    prompt, segs = MM_REQUESTS[0]
    engine = TorchEngine(EngineConfig(model=TCFG, speculative_k=2, **ENGINE_KW),
                         params=TP, device="cpu")

    async def main():
        await engine.start()
        try:
            first = asyncio.ensure_future(
                _collect(engine, t_proto, Context, _mm_pre(t_proto, text, [], 16)))
            while engine.unified_dispatches < 3:
                await asyncio.sleep(0.001)
            mm = await _collect(engine, t_proto, Context, _mm_pre(t_proto, prompt, segs, 6))
            return await first, mm
        finally:
            await engine.stop()

    got_text, got_mm = asyncio.run(main())
    assert got_text == _oracle(text, [], 16)
    assert got_mm == _oracle(prompt, segs, 6)


def test_remote_prefill_serves_mm_lanes_apart_and_a_poison_one_fails_alone():
    """``prefill_only_batch`` with an image prompt, a malformed image
    prompt (rows of the wrong width) and a text prompt: the image and the
    text prompts resolve with the oracle's first token and their blocks,
    the malformed one resolves None, and no block stays allocated."""
    prompt, segs = MM_REQUESTS[1]
    text = _tokens(41, 30)
    bad = _mm_pre(t_proto, prompt, [(3, np.zeros((16, D + 1), np.float32))], 1)
    engine = TorchEngine(EngineConfig(model=TCFG, **ENGINE_KW), params=TP, device="cpu")

    async def main():
        await engine.start()
        try:
            free = engine.scheduler.allocator.num_free
            futs = engine.prefill_only_batch([
                (_mm_pre(t_proto, prompt, segs, 1), "a", False), (bad, "b", False),
                (_mm_pre(t_proto, text, [], 1), "c", False)])
            out = await asyncio.gather(*futs)
            await asyncio.sleep(0.05)
            return out, free, engine.scheduler.allocator.num_free
        finally:
            await engine.stop()

    (a, b, c), free, after = asyncio.run(main())
    assert b is None
    assert a[0] == _oracle(prompt, segs, 1)[0] and len(a[1]) == (len(prompt) + BS - 1) // BS
    assert c[0] == _oracle(text, [], 1)[0]
    assert after == free


def test_unified_mm_in_the_warmup_plan_only_when_multimodal():
    """The shape grid and the runner's warmup list ``unified_mm`` at the
    top rung exactly when ``cfg.multimodal``; its two programs are made
    before traffic (greedy and sampled), as the JAX runner warms it."""
    from dynamo_tpu.engine.compile_cache import default_shape_grid as j_grid

    for mm in (False, True):
        cfg = EngineConfig(model=TCFG, dtype="float32", num_blocks=32, max_model_len=64,
                           unified_token_budget=32, unified_prefill_quantum=16,
                           multimodal=mm)
        jcfg = JEngineConfig(model=JCFG, dtype="float32", num_blocks=32, max_model_len=64,
                             unified_token_budget=32, multimodal=mm)
        cfg.validate()
        kinds = [s[0] for s in default_shape_grid(cfg)]
        assert ("unified_mm" in kinds) == mm
        assert kinds.count("unified_mm") == [s[0] for s in j_grid(jcfg)].count("unified_mm")
        runner = ModelRunner(cfg, params=TP, device="cpu")
        runner.warmup()
        made = {k.split(":")[0] for k in runner._programs}
        assert ("unified_mm" in made) == mm


async def _pipeline_streams(pipe, chat_request, url_a, url_b):
    async def run(url):
        toks = []
        async for chunk in pipe.generate(Context(chat_request(url))):
            for choice in getattr(chunk, "choices", []):
                if choice.delta and choice.delta.content:
                    toks.append(choice.delta.content)
        return "".join(toks)

    out_a = await run(url_a)
    return out_a, await run(url_a), await run(url_b)


def _chat(model, max_tokens=6):
    from dynamo_tpu_torch.llm.protocols.openai import ChatCompletionRequest

    def make(url):
        content = [{"type": "text", "text": "describe "}]
        if url is not None:
            content.append({"type": "image_url", "image_url": {"url": url}})
        return ChatCompletionRequest.model_validate({
            "model": model, "messages": [{"role": "user", "content": content}],
            "stream": True, "max_tokens": max_tokens, "temperature": 0.0,
            "ext": {"ignore_eos": True}})

    return make


def test_multimodal_pipeline_end_to_end():
    """A chat request with an image part: the preprocessor routes the
    image through the encode engine, placeholder tokens carry the patch
    embeddings into the engine, greedy output is reproducible and
    depends on the image; a literal marker is refused; text-only chats
    pass through untouched."""
    from dynamo_tpu_torch.llm.backend import Detokenizer
    from dynamo_tpu_torch.llm.model_card import ModelDeploymentCard
    from dynamo_tpu_torch.llm.protocols.common import RequestError
    from dynamo_tpu_torch.llm.tokenizer import ToyTokenizer
    from dynamo_tpu_torch.runtime.pipeline import Pipeline

    # Vocab in the ToyTokenizer's one-byte ASCII range: every sampled
    # token renders as one character.
    mcfg = dataclasses.replace(TCFG, vocab_size=128)
    jp = j_llama.init_params(jax.random.PRNGKey(0), dataclasses.replace(JCFG, vocab_size=128))
    engine = TorchEngine(EngineConfig(model=mcfg, num_blocks=64, max_num_seqs=2,
                                      max_model_len=256, dtype="float32", multimodal=True),
                         params=t_llama.params_from_jax(jax.tree.map(np.asarray, jp), device="cpu"),
                         device="cpu")
    encoder = t_mm.VisionEncodeEngine(VCFG, params=TVP, device="cpu")
    pre = t_mm.MultimodalPreprocessor(ModelDeploymentCard(name="tiny-mm", model_path="toy"),
                                      ToyTokenizer(), encoder, placeholder_token=1)
    pipe = Pipeline.link(pre, Detokenizer(ToyTokenizer()), engine=engine)
    chat = _chat("tiny-mm")

    async def main():
        await engine.start()
        try:
            streams = await _pipeline_streams(pipe, chat, _npy_data_url(_image(11)),
                                              _npy_data_url(_image(99)))
            plain = await _pipeline_streams(pipe, chat, None, None)
            literal = chat(_npy_data_url(_image(11)))
            literal.messages[0].content[0]["text"] = "<image> twice "
            with pytest.raises(RequestError, match="marker"):
                async for _ in pipe.generate(Context(literal)):
                    pass
            return streams, plain
        finally:
            await engine.stop()

    (a, a2, b), (p, p2, _) = asyncio.run(main())
    assert a and a == a2 and b != a
    assert p and p == p2 and p != a
    assert encoder.images == 3


def test_multimodal_model_discovery_deployment():
    """The deployment's shape: an encode worker and an engine served over
    the runtime plane, a card with ``model_type="multimodal"`` and
    ``extra.encode_endpoint``; the watcher builds the multimodal pipeline
    and a request crosses the request plane with embeddings on the wire,
    giving the stream the in-process pipeline gives."""
    from dynamo_tpu_torch.llm.discovery import ModelManager, ModelWatcher, register_llm
    from dynamo_tpu_torch.llm.model_card import ModelDeploymentCard
    from dynamo_tpu_torch.runtime.distributed import DistributedRuntime

    async def main():
        drt = await DistributedRuntime.in_process()
        encoder = t_mm.VisionEncodeEngine(VCFG, params=TVP, device="cpu")
        await drt.namespace("mm").component("encoder").endpoint("encode").serve(encoder)
        engine = TorchEngine(EngineConfig(model=TCFG, num_blocks=64, max_num_seqs=2,
                                          max_model_len=256, dtype="float32", multimodal=True),
                             params=TP, device="cpu")
        await engine.start()
        gen_ep = drt.namespace("mm").component("torch").endpoint("generate")
        await gen_ep.serve(engine)
        card = ModelDeploymentCard(name="tiny-mm", model_path="toy", extra={
            "encode_endpoint": "mm.encoder.encode", "placeholder_token": 1})
        await register_llm(drt, gen_ep, card, model_type="multimodal")
        manager = ModelManager()
        await ModelWatcher(drt, manager).start()
        for _ in range(100):
            if manager.get("tiny-mm") is not None:
                break
            await asyncio.sleep(0.02)
        pipe = manager.get("tiny-mm")
        assert pipe is not None and manager.card("tiny-mm").model_type == "multimodal"
        usage, tokens = None, []
        async for chunk in pipe.generate(Context(_chat("tiny-mm", 4)(_npy_data_url(_image(42))))):
            if getattr(chunk, "usage", None) is not None:
                usage = chunk.usage
        await engine.stop()
        await drt.shutdown()
        return usage, encoder.images

    usage, images = asyncio.run(main())
    assert usage is not None and usage.completion_tokens == 4
    assert usage.prompt_tokens > VCFG.num_patches
    assert images == 1


def test_example_deployment_serves_image_chats_over_http():
    """examples/multimodal.py's ``deploy`` (encode worker and engine on
    the runtime plane, the OpenAI server over the watcher's pipeline):
    a streamed and an aggregated image chat (an image resized from
    48 x 40) give the same greedy text; the encode worker served both,
    and nothing was captured mid-traffic."""
    from dynamo_tpu_torch.examples.multimodal import deploy
    from dynamo_tpu_torch.llm.http_client import fetch
    from dynamo_tpu_torch.llm.model_card import ModelDeploymentCard

    url = _npy_data_url(_image(8, (48, 40, 3)))
    body = {"model": "tiny-test", "max_tokens": 5, "temperature": 0.0,
            "ext": {"ignore_eos": True}, "messages": [{"role": "user", "content": [
                {"type": "text", "text": "what is "},
                {"type": "image_url", "image_url": {"url": url}}]}]}

    async def main():
        engine = TorchEngine(EngineConfig(model=TCFG, num_blocks=64, max_num_seqs=2,
                                          max_model_len=256, dtype="float32",
                                          multimodal=True), params=TP, device="cpu")
        await engine.start()
        await engine.warmup()
        encoder = t_mm.VisionEncodeEngine(VCFG, params=TVP, device="cpu")
        dep = await deploy(engine, encoder, ModelDeploymentCard(name="tiny-test",
                                                                model_path="toy"))
        try:
            agg = await fetch("127.0.0.1", dep.service.port, "POST", "/v1/chat/completions",
                              body)
            streamed = await fetch("127.0.0.1", dep.service.port, "POST",
                                   "/v1/chat/completions", {**body, "stream": True})
            return agg, streamed, encoder.images, engine.runner.compile_stats
        finally:
            await dep.stop()
            await engine.stop()

    agg, streamed, images, stats = asyncio.run(main())
    assert agg.status == 200 and streamed.status == 200
    text = agg.json()["choices"][0]["message"]["content"]
    deltas = [e.data for e in streamed.events() if e.data != "[DONE]"]
    import json

    got = "".join((json.loads(d)["choices"] or [{}])[0].get("delta", {}).get("content") or ""
                  for d in deltas)
    assert got == text and agg.json()["usage"]["completion_tokens"] == 5
    assert images == 2 and stats.mid_traffic_compiles == 0


def test_decode_image_refuses_what_it_cannot_decode():
    """A payload that is no .npy array (an image file's bytes) is refused
    as a client error, never decoded wrong."""
    from dynamo_tpu_torch.llm.protocols.common import RequestError

    png = "data:image/png;base64," + base64.b64encode(b"\x89PNG\r\n\x1a\n" + b"\0" * 16).decode()
    with pytest.raises(RequestError, match=".npy"):
        t_mm.decode_image(png, 32)
