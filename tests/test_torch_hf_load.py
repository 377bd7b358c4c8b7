"""Checkouts read by the port (``ModelConfig.from_hf``,
``models/llama.py load_hf_weights``, ``llm/local_model.py``,
``llm/model_card.py``) against the JAX package on the same files.

Each family's checkout is written by the test from a JAX params tree
whose norm gains are redrawn from numpy, in F32 and in F16 (and a bf16
one by ``tools/write_checkout``). The loaded params equal
``params_from_jax`` of the JAX loader's exactly, in float32 and in
bfloat16; greedy streams served from a checkout equal the JAX engine's
on the same files; Gemma-3 is held to ``transformers`` within 2e-3 where
it is installed. ``hf://`` resolves on a fake hub cache, and a frontend
without the model's files tokenizes with the worker's, shipped through
an in-process object store."""

import asyncio
import dataclasses
import json
import os
import shutil

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from dynamo_tpu.engine.config import EngineConfig as JEngineConfig
from dynamo_tpu.engine.engine import TpuEngine
from dynamo_tpu.llm.local_model import LocalModel as JLocal
from dynamo_tpu.llm.local_model import resolve_hub_snapshot as j_resolve
from dynamo_tpu.llm.protocols import common as j_proto
from dynamo_tpu.models import llama as j_llama
from dynamo_tpu.models.config import ModelConfig as JCfg
from dynamo_tpu.runtime.engine import Context as JContext
from dynamo_tpu_torch.engine.config import EngineConfig
from dynamo_tpu_torch.engine.engine import TorchEngine
from dynamo_tpu_torch.llm.local_model import LocalModel, resolve_hub_snapshot
from dynamo_tpu_torch.llm.protocols import common as t_proto
from dynamo_tpu_torch.models import llama as t_llama
from dynamo_tpu_torch.models.config import ModelConfig
from dynamo_tpu_torch.runtime.engine import Context
from dynamo_tpu_torch.tools import write_checkout as wc

sf_numpy = pytest.importorskip("safetensors.numpy")

_NOISY = ("ln_attn", "ln_mlp", "ln_post_attn", "ln_post_mlp", "ln_q_head", "ln_k_head",
          "bq", "bk", "bv", "ln_kv", "ln_q", "router_bias")


def _configs(name):
    """(JAX config, port config) of one family at test size."""
    change = {
        "tiny-test": {}, "tiny-mla-test": None, "tiny-moe-test": None, "tiny-gemma-test": None,
        "qwen3": dict(qk_norm=True, tie_word_embeddings=True),
        "qwen2": dict(qkv_bias=True, sliding_window=8, max_window_layers=1),
    }[name]
    if change is None:
        return getattr(JCfg, name.replace("-", "_"))(), getattr(
            ModelConfig, name.replace("-", "_"))()
    return (dataclasses.replace(JCfg.tiny_test(), name=name, **change),
            ModelConfig.tiny_test().scaled(name=name, **change))


FAMILIES = ["tiny-test", "tiny-mla-test", "tiny-moe-test", "qwen3", "qwen2", "tiny-gemma-test"]


def _tree(jcfg, seed=3):
    tree = jax.tree.map(np.asarray, j_llama.init_params(
        jax.random.PRNGKey(seed), jcfg, dtype=jnp.float32))
    rng = np.random.default_rng(seed)
    for layer in tree["layers"]:
        for k in _NOISY:
            if k in layer:
                layer[k] = (layer[k] + rng.normal(0, 0.2, layer[k].shape)).astype(np.float32)
    return tree


def _mixtral_names(tensors: dict) -> dict:
    """DeepSeek's expert names → Mixtral's block_sparse_moe layout."""
    out = {}
    for k, v in tensors.items():
        k = k.replace(".mlp.gate.weight", ".block_sparse_moe.gate.weight")
        for theirs, ours in (("gate_proj", "w1"), ("up_proj", "w3"), ("down_proj", "w2")):
            if ".mlp.experts." in k and f".{theirs}." in k:
                k = k.replace(".mlp.experts.", ".block_sparse_moe.experts.").replace(
                    f".{theirs}.", f".{ours}.")
        out[k] = v
    return out


def _write(path, tcfg, tree, file_dtype, shards=1):
    """An HF checkout of ``tree`` in ``file_dtype`` (numpy F32/F16),
    written with the safetensors package (the JAX loader's reader)."""
    path.mkdir(parents=True, exist_ok=True)
    tensors = t_llama.hf_tensors(tcfg, t_llama.params_from_jax(tree, device="cpu"))
    if tcfg.is_moe and not tcfg.is_mla:
        tensors = _mixtral_names(tensors)
    arrays = {k: np.ascontiguousarray(v.numpy().astype(file_dtype)) for k, v in tensors.items()}
    names = sorted(arrays)
    weight_map = {}
    for s in range(shards):
        fname = f"model-{s + 1:05d}-of-{shards:05d}.safetensors"
        part = {n: arrays[n] for n in names[s::shards]}
        sf_numpy.save_file(part, str(path / fname), metadata={"format": "pt"})
        weight_map.update({n: fname for n in part})
    if shards > 1:
        (path / "model.safetensors.index.json").write_text(json.dumps({"weight_map": weight_map}))
    from dynamo_tpu_torch.models.config import to_hf_config

    (path / "config.json").write_text(json.dumps(to_hf_config(tcfg)))
    return path


def _assert_same_params(got, want):
    assert got.keys() == want.keys()
    for k in ("embed", "ln_f", "lm_head"):
        if k in want:
            assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]), k
    for i, (g, w) in enumerate(zip(got["layers"], want["layers"])):
        assert g.keys() == w.keys(), (i, sorted(g), sorted(w))
        for k in w:
            assert g[k].dtype == w[k].dtype and g[k].shape == w[k].shape, (i, k)
            assert torch.equal(g[k], w[k]), (i, k)


@pytest.fixture(scope="module", params=FAMILIES)
def family(request, tmp_path_factory):
    jcfg, tcfg = _configs(request.param)
    tree = _tree(jcfg)
    root = tmp_path_factory.mktemp(request.param)
    dirs = {"f32": _write(root / "f32", tcfg, tree, np.float32, shards=2),
            "f16": _write(root / "f16", tcfg, tree, np.float16)}
    return request.param, jcfg, tcfg, tree, dirs


def test_config_from_hf_matches_jax(family):
    name, jcfg, tcfg, _, dirs = family
    got, want = ModelConfig.from_hf(str(dirs["f32"])), JCfg.from_hf(str(dirs["f32"]))
    for f in dataclasses.fields(want):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if f.name == "rope_scaling":
            assert (vars(a) if a else None) == (vars(b) if b else None)
        else:
            assert a == b, f.name
    assert dataclasses.replace(got, name=tcfg.name) == tcfg


@pytest.mark.parametrize("file_dtype", ["f32", "f16"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_load_hf_weights_matches_jax_exactly(family, file_dtype, dtype):
    _, jcfg, tcfg, _, dirs = family
    path = str(dirs[file_dtype])
    want = t_llama.params_from_jax(jax.tree.map(np.asarray, j_llama.load_hf_weights(
        jcfg, path, dtype=getattr(jnp, dtype))), device="cpu")
    got = t_llama.load_hf_weights(tcfg, path, dtype=dtype, device="cpu")
    _assert_same_params(got, want)


def test_load_hf_weights_round_trips_the_written_params(family):
    _, _, tcfg, tree, dirs = family
    got = t_llama.load_hf_weights(tcfg, str(dirs["f32"]), dtype=torch.float32, device="cpu")
    _assert_same_params(got, t_llama.params_from_jax(tree, dtype=torch.float32, device="cpu"))


def test_bf16_checkout_loads_bit_for_bit(tmp_path):
    """Real checkouts are bf16: a sharded bf16 checkout written by the
    port's writer loads bit for bit, and equals the JAX loader's load of
    the same files (safetensors' numpy reader knows bfloat16 once
    ml_dtypes is imported, which importing JAX does)."""
    cfg = ModelConfig.tiny_test()
    g = torch.Generator().manual_seed(0)
    params = t_llama.init_params(cfg, g, dtype=torch.bfloat16, device="cpu")
    wc.write_weights(tmp_path, cfg, params, shards=3)
    assert (tmp_path / "model.safetensors.index.json").is_file()
    got = t_llama.load_hf_weights(cfg, str(tmp_path), dtype=torch.bfloat16, device="cpu")
    _assert_same_params(got, params)
    want = t_llama.params_from_jax(jax.tree.map(np.asarray, j_llama.load_hf_weights(
        JCfg.tiny_test(), str(tmp_path), dtype=jnp.bfloat16)), device="cpu")
    _assert_same_params(got, want)


def test_policy_is_refused_naming_roadmap_a3(tmp_path):
    with pytest.raises(NotImplementedError, match="A3"):
        t_llama.load_hf_weights(ModelConfig.tiny_test(), str(tmp_path), policy=object())


def test_hf_load_applies_rope_permutation(tmp_path):
    """tests/test_deepseek.py's permutation check on the port's loader:
    the checkpoint's pair-interleaved rope dims land in NeoX halves, in
    the q_pe columns and the k_pe rows, as the JAX loader puts them."""
    cfg = ModelConfig.tiny_mla_test().scaled(num_layers=1, num_experts=0, first_k_dense_replace=1)
    jcfg = dataclasses.replace(JCfg.tiny_mla_test(), num_layers=1, num_experts=0,
                               first_k_dense_replace=1)
    H, dn, dr, dc = cfg.num_heads, cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.kv_lora_rank
    D, dv = cfg.hidden_size, cfg.v_head_dim
    rng = np.random.default_rng(1)

    def t(*shape):
        return (rng.standard_normal(shape) * 0.02).astype(np.float32)

    qb, dkv = t(H * (dn + dr), cfg.q_lora_rank), t(dc + dr, D)
    p = "model.layers.0"
    tensors = {
        "model.embed_tokens.weight": t(cfg.vocab_size, D), "model.norm.weight": t(D),
        "lm_head.weight": t(cfg.vocab_size, D),
        f"{p}.self_attn.q_a_proj.weight": t(cfg.q_lora_rank, D),
        f"{p}.self_attn.q_a_layernorm.weight": t(cfg.q_lora_rank),
        f"{p}.self_attn.q_b_proj.weight": qb,
        f"{p}.self_attn.kv_a_proj_with_mqa.weight": dkv,
        f"{p}.self_attn.kv_a_layernorm.weight": t(dc),
        f"{p}.self_attn.kv_b_proj.weight": t(H * (dn + dv), dc),
        f"{p}.self_attn.o_proj.weight": t(D, H * dv),
        f"{p}.input_layernorm.weight": t(D), f"{p}.post_attention_layernorm.weight": t(D),
        f"{p}.mlp.gate_proj.weight": t(cfg.intermediate_size, D),
        f"{p}.mlp.up_proj.weight": t(cfg.intermediate_size, D),
        f"{p}.mlp.down_proj.weight": t(D, cfg.intermediate_size),
    }
    sf_numpy.save_file(tensors, str(tmp_path / "model.safetensors"))
    got = t_llama.load_hf_weights(cfg, str(tmp_path), dtype=torch.float32, device="cpu")
    want = t_llama.params_from_jax(jax.tree.map(np.asarray, j_llama.load_hf_weights(
        jcfg, str(tmp_path), dtype=jnp.float32)), device="cpu")
    _assert_same_params(got, want)
    perm = np.concatenate([np.arange(0, dr, 2), np.arange(1, dr, 2)])
    w_uq = got["layers"][0]["w_uq"].numpy().reshape(cfg.q_lora_rank, H, dn + dr)
    want_q = qb.T.reshape(cfg.q_lora_rank, H, dn + dr)[..., dn:][..., perm]
    np.testing.assert_array_equal(w_uq[..., dn:], want_q)
    np.testing.assert_array_equal(got["layers"][0]["w_dkv"].numpy()[:, dc:], dkv.T[:, dc:][:, perm])
    kvb = tensors[f"{p}.self_attn.kv_b_proj.weight"].reshape(H, dn + dv, dc)
    np.testing.assert_array_equal(got["layers"][0]["w_uk"].numpy(), kvb[:, :dn])
    np.testing.assert_array_equal(got["layers"][0]["w_uv"].numpy(), kvb[:, dn:])


def test_gemma3_matches_hf_transformers(tmp_path):
    """tests/test_gemma.py's end-to-end parity on the port: a random HF
    Gemma-3 saved by transformers, read by from_hf + load_hf_weights,
    full-sequence logits within 2e-3."""
    transformers = pytest.importorskip("transformers")
    hf_cfg = transformers.Gemma3TextConfig(
        vocab_size=384, hidden_size=64, intermediate_size=128, num_hidden_layers=4,
        num_attention_heads=4, num_key_value_heads=2, head_dim=16, rope_theta=1_000_000.0,
        rope_local_base_freq=10_000.0, sliding_window=32, sliding_window_pattern=2,
        max_position_embeddings=512, rms_norm_eps=1e-6, query_pre_attn_scalar=32,
        hidden_activation="gelu_pytorch_tanh", tie_word_embeddings=True, attention_bias=False,
    )
    torch.manual_seed(0)
    model = transformers.Gemma3ForCausalLM(hf_cfg).eval()
    model.save_pretrained(tmp_path)
    cfg = ModelConfig.from_hf(str(tmp_path))
    assert cfg.window_pattern == 2 and cfg.post_norms and cfg.norm_offset and cfg.embed_scale
    params = t_llama.load_hf_weights(cfg, str(tmp_path), dtype=torch.float32, device="cpu")
    toks = np.random.default_rng(5).integers(1, 384, 48)
    with torch.no_grad():
        want = model(torch.tensor(toks)[None]).logits[0].float().numpy()
        got = t_llama.reference_forward(cfg, params, torch.from_numpy(toks)).numpy()
    np.testing.assert_allclose(got, want, atol=2e-3, rtol=2e-3)


# -- serving from the files --------------------------------------------------

async def _collect(engine, proto, ctx_cls, prompt, n):
    pre = proto.PreprocessedRequest(
        token_ids=prompt, sampling=proto.SamplingOptions(temperature=0.0),
        stop=proto.StopConditions(max_tokens=n, ignore_eos=True))
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


@pytest.mark.parametrize("name", ["tiny-test", "tiny-mla-test"])
def test_checkout_streams_match_the_jax_engine(name, tmp_path):
    jcfg, tcfg = _configs(name)
    path = str(_write(tmp_path / name, tcfg, _tree(jcfg, seed=7), np.float32))
    jl, tl = JLocal.prepare(path), LocalModel.prepare(path)
    assert tl.name == jl.name == name and tl.model_path == path
    kw = dict(dtype="float32", block_size=4, num_blocks=64, max_num_seqs=2, max_model_len=96)
    rng = np.random.default_rng(2)
    prompts = [[int(t) for t in rng.integers(1, 384, n)] for n in (5, 23)]
    j = asyncio.run(_serve(TpuEngine(JEngineConfig(model=jl.config, **kw),
                                     params=jl.load_params("float32")),
                           j_proto, JContext, prompts, 8))
    t = asyncio.run(_serve(TorchEngine(EngineConfig(model=tl.config, **kw),
                                       params=tl.load_params("float32", device="cpu"),
                                       device="cpu"), t_proto, Context, prompts, 8))
    assert t == j and all(len(s) == 8 for s in t)


# -- hf:// and the card's artifacts ------------------------------------------

def _fake_hub(root, repo_id, revs):
    """An HF hub cache: models--org--name/snapshots/<rev> with refs/main."""
    folder = root / "hub" / ("models--" + repo_id.replace("/", "--"))
    for i, rev in enumerate(revs):
        snap = folder / "snapshots" / rev
        snap.mkdir(parents=True)
        yield snap, i
    (folder / "refs").mkdir(parents=True, exist_ok=True)
    (folder / "refs" / "main").write_text(revs[-1])


def test_hf_reference_resolves_in_a_fake_hub_cache(tmp_path, monkeypatch):
    import time

    monkeypatch.setenv("HF_HOME", str(tmp_path / "hf"))
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    jcfg, tcfg = _configs("tiny-test")
    tree = _tree(jcfg)
    snaps = []
    for snap, i in _fake_hub(tmp_path / "hf", "org/tiny", ["aaa111", "bbb222", "ccc333"]):
        if i < 2:  # the newest has no config.json: an incomplete download
            _write(snap, tcfg, tree, np.float32)
            os.utime(snap, (time.time() + i, time.time() + i))
        snaps.append(str(snap))
    assert resolve_hub_snapshot("org/tiny") == j_resolve("org/tiny") == snaps[1]
    local = LocalModel.prepare("hf://org/tiny")
    assert local.model_path == snaps[1] and local.name == "tiny"
    assert local.config == dataclasses.replace(tcfg, name=tcfg.name)
    _assert_same_params(local.load_params("float32", device="cpu"),
                        t_llama.params_from_jax(tree, device="cpu"))
    with pytest.raises(FileNotFoundError, match="hf://org/none"):
        LocalModel.prepare("hf://org/none")


def _tokenizer_checkout(path, vocab=384):
    tok = wc.llama3_tokenizer(vocab, merges=100)
    eos = [t["id"] for t in tok["added_tokens"] if t["content"] in ("<|end_of_text|>", "<|eot_id|>")]
    wc.write_tokenizer(path, tok, eos)
    return eos


def test_card_ships_and_materializes_the_tokenizer_files(tmp_path):
    from dynamo_tpu_torch.llm.model_card import ARTIFACT_FILES, ModelDeploymentCard
    from dynamo_tpu_torch.runtime.distributed import DistributedRuntime
    from dynamo_tpu_torch.llm.tokenizer import load_tokenizer

    src = tmp_path / "worker"
    _tokenizer_checkout(src)

    async def run():
        drt = await DistributedRuntime.in_process()
        try:
            card = ModelDeploymentCard(name="m", model_path=str(src))
            await card.publish(drt.bus)
            assert card.extra["artifacts"] == [f for f in ARTIFACT_FILES if (src / f).is_file()]
            got = await ModelDeploymentCard.fetch(drt.bus, "m")
            assert await got.materialize(drt.bus, tmp_path / "frontend")
            return got
        finally:
            await drt.shutdown()

    got = asyncio.run(run())
    assert got.model_path == str(tmp_path / "frontend" / "m")
    for f in got.extra["artifacts"]:
        assert (tmp_path / "frontend" / "m" / f).read_bytes() == (src / f).read_bytes()
    a, b = load_tokenizer(str(src)), load_tokenizer(got.model_path)
    text = "Hello <|eot_id|> world 12345"
    assert a.encode(text) == b.encode(text) and a.eos_token_ids == b.eos_token_ids


def test_frontend_without_model_files_tokenizes_like_the_worker(tmp_path, monkeypatch):
    """A worker registers a card whose model directory then disappears
    (another host's path); the frontend's watcher materializes the
    shipped files and its chat pipeline renders and tokenizes as the
    worker's tokenizer does: the echo engine returns the prompt's ids, so
    the reply is the decode of the worker tokenizer's ids."""
    import tempfile

    from dynamo_tpu_torch.llm.discovery import ModelManager, ModelWatcher, register_llm
    from dynamo_tpu_torch.llm.engines import EchoEngineCore
    from dynamo_tpu_torch.llm.model_card import ModelDeploymentCard
    from dynamo_tpu_torch.llm.protocols.openai import ChatCompletionRequest
    from dynamo_tpu_torch.llm.tokenizer import HfTokenizer
    from dynamo_tpu_torch.runtime.distributed import DistributedRuntime

    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path / "tmp"))
    (tmp_path / "tmp").mkdir()
    src = tmp_path / "worker"
    _tokenizer_checkout(src)
    worker_tok = HfTokenizer(src)
    messages = [{"role": "user", "content": "Hi there, 2048 tokens?"}]
    rendered = worker_tok.apply_chat_template(messages)
    want_ids = worker_tok.encode(rendered)

    async def run():
        drt = await DistributedRuntime.in_process()
        try:
            ep = drt.namespace("dyn").component("w").endpoint("generate")
            await ep.serve(EchoEngineCore())
            await register_llm(drt, ep, ModelDeploymentCard(name="m", model_path=str(src)))
            shutil.rmtree(src)
            manager = ModelManager()
            await ModelWatcher(drt, manager).start()
            for _ in range(100):
                if manager.models():
                    break
                await asyncio.sleep(0.02)
            req = ChatCompletionRequest.model_validate(
                {"model": "m", "messages": messages, "max_tokens": len(want_ids) + 4})
            text, usage = "", None
            async for chunk in manager.get("m").generate(Context(req)):
                obj = chunk.model_dump(exclude_none=True) if hasattr(chunk, "model_dump") else chunk
                for choice in obj.get("choices", []):
                    text += (choice.get("delta") or choice.get("message") or {}).get("content") or ""
                usage = obj.get("usage") or usage
            return text, usage, manager.card("m")
        finally:
            await drt.shutdown()

    text, usage, card = asyncio.run(run())
    assert card.model_path == str(tmp_path / "tmp" / f"dynamo_tpu_mdc_{os.getuid()}" / "m")
    # The file's eos ids (tokenizer_config's and generation_config's) are
    # stop ids: the echo stops at the prompt's first <|eot_id|>, which the
    # stream does not show.
    cut = next(i for i, t in enumerate(want_ids) if t in worker_tok.eos_token_ids)
    assert len(worker_tok.eos_token_ids) == 2 and cut < len(want_ids) - 1
    assert text == worker_tok.decode(want_ids[:cut])
    assert usage is None or usage["prompt_tokens"] == len(want_ids)


@pytest.mark.parametrize("kind", ["checkout", "gguf"])
def test_cli_serves_files_with_config_and_set(kind, tmp_path):
    """``run --in http --model-path <checkout | .gguf> --config --set`` on
    the CPU: a chat's usage counts the rendered template's tokens as the
    file tokenizer encodes them, the streamed pieces join into the
    aggregated reply, and a value from the YAML and one from --set both
    reach the engine."""
    from dynamo_tpu_torch.llm.http_client import fetch
    from dynamo_tpu_torch.llm.tokenizer import load_tokenizer

    cfg = ModelConfig.tiny_test(vocab_size=512)
    g = torch.Generator().manual_seed(0)
    params = t_llama.init_params(cfg, g, dtype=torch.float32, device="cpu")
    tok_json = wc.llama3_tokenizer(512, merges=150)
    eos = [t["id"] for t in tok_json["added_tokens"] if t["content"] == "<|eot_id|>"]
    if kind == "checkout":
        ref = tmp_path / "m"
        wc.write_weights(ref, cfg, params, shards=2)
        wc.write_tokenizer(ref, tok_json, eos)
    else:
        ref = tmp_path / "m.gguf"
        wc.write_gguf_checkout(ref, cfg, params, tok_json, eos[0], dtype=torch.float32)
    (tmp_path / "c.yaml").write_text(
        "Common:\n  max-model-len: 96\nEngine:\n  common-configs: [max-model-len]\n"
        "  num-blocks: 40\n  warmup: false\nFrontend:\n  host: 127.0.0.1\n  port: 0\n")
    args = t_cli_parse(["run", "--in", "http", "--device", "cpu", "--dtype", "float32",
                        "--model-path", str(ref), "--config", str(tmp_path / "c.yaml"),
                        "--set", "Engine.max-num-seqs=3", "--kv-cache-block-size", "4"])
    tok = load_tokenizer(str(ref))
    messages = [{"role": "user", "content": "Serve me from files, please."}]
    prompt_ids = tok.encode(tok.apply_chat_template(messages))

    async def run():
        import contextlib

        from dynamo_tpu_torch import cli

        async with contextlib.AsyncExitStack() as stack:
            service, engine = await cli.start_http(args, stack)
            assert (engine.cfg.max_num_seqs, engine.cfg.num_blocks, engine.cfg.max_model_len) == (
                3, 40, 96)
            body = {"model": "m", "messages": messages, "max_tokens": 6, "temperature": 0.0}
            full = await fetch("127.0.0.1", service.port, "POST", "/v1/chat/completions", body)
            streamed = await fetch("127.0.0.1", service.port, "POST", "/v1/chat/completions",
                                   {**body, "stream": True})
            return full, streamed

    full, streamed = asyncio.run(run())
    assert full.status == 200, full.body
    out = full.json()
    assert out["usage"]["prompt_tokens"] == len(prompt_ids)
    pieces = [json.loads(e.data)["choices"][0]["delta"].get("content") or ""
              for e in streamed.events() if e.data != "[DONE]" and json.loads(e.data)["choices"]]
    assert "".join(pieces) == out["choices"][0]["message"]["content"]


def t_cli_parse(argv):
    from dynamo_tpu_torch import cli

    args = cli.build_parser().parse_args(argv)
    cli._apply_config(args)
    cli.refuse_unserved(args)
    return args
