"""The port's GGUF module (dynamo_tpu_torch/llm/gguf.py) against the JAX
package's (dynamo_tpu/llm/gguf.py): tests/test_gguf.py's six tests,
each run through both packages on the same files — metadata and config,
the SentencePiece and byte-level BPE vocabularies (ids, text and stream
equal), unquantized weights loaded exactly and served to the same greedy
streams as the JAX engine's, quantized tensors refused by type, Qwen3's
QK-norm. The writers write the same bytes for float32 tensors; F16 and
BF16 tensors keep their type and load exactly."""

import asyncio

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from dynamo_tpu.engine.config import EngineConfig as JEngineConfig
from dynamo_tpu.engine.engine import TpuEngine
from dynamo_tpu.llm import gguf as j_gguf
from dynamo_tpu.llm.local_model import LocalModel as JLocal
from dynamo_tpu.llm.protocols import common as j_proto
from dynamo_tpu.models import llama as j_llama
from dynamo_tpu.models.config import ModelConfig as JCfg
from dynamo_tpu.runtime.engine import Context as JContext
from dynamo_tpu_torch.engine.config import EngineConfig
from dynamo_tpu_torch.engine.engine import TorchEngine
from dynamo_tpu_torch.llm import gguf as t_gguf
from dynamo_tpu_torch.llm.local_model import LocalModel
from dynamo_tpu_torch.llm.protocols import common as t_proto
from dynamo_tpu_torch.llm.tokenizer import load_tokenizer
from dynamo_tpu_torch.models import llama as t_llama
from dynamo_tpu_torch.runtime.engine import Context

VOCAB = (
    ["<unk>", "<s>", "</s>"]
    + [f"<0x{b:02X}>" for b in range(256)]
    + ["▁hello", "▁world", "▁he", "llo", "▁", "hel", "lo"]
)


def _meta(cfg) -> dict:
    return {
        "general.architecture": "llama",
        "general.name": "tiny-gguf",
        "llama.embedding_length": cfg.hidden_size,
        "llama.feed_forward_length": cfg.intermediate_size,
        "llama.block_count": cfg.num_layers,
        "llama.attention.head_count": cfg.num_heads,
        "llama.attention.head_count_kv": cfg.num_kv_heads,
        "llama.attention.key_length": cfg.head_dim,
        "llama.attention.layer_norm_rms_epsilon": cfg.rms_eps,
        "llama.rope.freq_base": cfg.rope_theta,
        "llama.context_length": cfg.max_position,
        "llama.vocab_size": cfg.vocab_size,
        "tokenizer.ggml.tokens": VOCAB,
        "tokenizer.ggml.bos_token_id": 1,
        "tokenizer.ggml.eos_token_id": 2,
    }


def _tiny_gguf(path, cfg, params=None) -> None:
    """tests/test_gguf.py's fixture, written by the JAX writer."""
    tensors = {}
    if params is not None:
        tensors["token_embd.weight"] = np.asarray(params["embed"], np.float32)
        tensors["output_norm.weight"] = np.asarray(params["ln_f"], np.float32)
        if "lm_head" in params:
            tensors["output.weight"] = np.asarray(params["lm_head"], np.float32).T
        for i, layer in enumerate(params["layers"]):
            for our, theirs in j_gguf._LAYER_MAP.items():
                tensors[f"blk.{i}.{theirs}.weight"] = np.asarray(layer[our], np.float32).T
            tensors[f"blk.{i}.attn_norm.weight"] = np.asarray(layer["ln_attn"], np.float32)
            tensors[f"blk.{i}.ffn_norm.weight"] = np.asarray(layer["ln_mlp"], np.float32)
    j_gguf.write_gguf(path, _meta(cfg), tensors)


def _cfgs():
    from dynamo_tpu_torch.models.config import ModelConfig

    return JCfg.tiny_test(vocab_size=len(VOCAB)), ModelConfig.tiny_test(vocab_size=len(VOCAB))


def test_gguf_metadata_and_config(tmp_path):
    jcfg, tcfg = _cfgs()
    path = tmp_path / "tiny.gguf"
    _tiny_gguf(path, jcfg)
    gf, jgf = t_gguf.read_gguf(path), j_gguf.read_gguf(path)
    assert gf.metadata == jgf.metadata and gf.metadata["general.architecture"] == "llama"
    got, want = t_gguf.model_config_from_gguf(gf), j_gguf.model_config_from_gguf(jgf)
    assert {k: v for k, v in vars(got).items() if k != "rope_scaling"} == {
        k: v for k, v in vars(want).items() if k != "rope_scaling"}
    for attr in ("vocab_size", "hidden_size", "intermediate_size", "num_layers",
                 "num_heads", "num_kv_heads", "head_dim", "max_position", "rope_theta"):
        assert getattr(got, attr) == getattr(tcfg, attr), attr


def _same_tokenizer(tok, jtok, texts):
    assert tok.eos_token_ids == jtok.eos_token_ids and tok.vocab_size == jtok.vocab_size
    for text in texts:
        ids = tok.encode(text)
        assert ids == jtok.encode(text), text
        assert tok.decode(ids) == jtok.decode(ids) == text
        ts, js = tok.decode_stream(), jtok.decode_stream()
        got = [ts.step(t) for t in ids]
        assert got == [js.step(t) for t in ids]
        assert "".join(p for p in got if p) == text


def test_gguf_tokenizer_roundtrip(tmp_path):
    jcfg, _ = _cfgs()
    path = tmp_path / "tok.gguf"
    _tiny_gguf(path, jcfg)
    tok = t_gguf.GgufTokenizer(t_gguf.read_gguf(path, load_tensors_index=False))
    jtok = j_gguf.GgufTokenizer(j_gguf.read_gguf(path, load_tensors_index=False))
    assert tok.eos_token_ids == [2]
    _same_tokenizer(tok, jtok, ["hello world", "hello Zx", "héllo ✓ wörld"])
    assert isinstance(load_tokenizer(str(path)), t_gguf.GgufTokenizer)


async def _gen(engine, proto, ctx_cls, prompts, n):
    await engine.start()
    try:
        out = []
        for p in prompts:
            pre = proto.PreprocessedRequest(
                token_ids=p, sampling=proto.SamplingOptions(temperature=0.0),
                stop=proto.StopConditions(max_tokens=n, ignore_eos=True))
            toks = []
            async for raw in engine.generate(ctx_cls(pre.to_wire())):
                toks += proto.EngineOutput.from_wire(raw).token_ids
            out.append(toks)
        return out
    finally:
        await engine.stop()


def test_gguf_weights_serve_identically(tmp_path):
    """The loaded weights equal the source params and the JAX loader's
    exactly, and the port's engine serves them to the source params'
    streams and the JAX engine's."""
    jcfg, tcfg = _cfgs()
    src = jax.tree.map(np.asarray, j_llama.init_params(jax.random.PRNGKey(7), jcfg,
                                                       dtype="float32"))
    path = tmp_path / "model.gguf"
    _tiny_gguf(path, jcfg, params=src)
    local, jlocal = LocalModel.prepare(str(path)), JLocal.prepare(str(path))
    assert local.name == jlocal.name == "model" and local.config.num_layers == tcfg.num_layers
    loaded = local.load_params("float32", device="cpu")
    want = t_llama.params_from_jax(jax.tree.map(np.asarray, jlocal.load_params("float32")),
                                   device="cpu")
    src_t = t_llama.params_from_jax(src, device="cpu")
    for ref in (want, src_t):
        assert loaded.keys() == ref.keys()
        for k in ("embed", "ln_f"):
            assert torch.equal(loaded[k], ref[k])
        for a, b in zip(loaded["layers"], ref["layers"]):
            assert a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)
    kw = dict(num_blocks=32, max_num_seqs=2, max_model_len=64, dtype="float32")
    prompts = [[1, 260, 261, 262], [5, 6, 7, 8, 9, 10, 11]]
    got = asyncio.run(_gen(TorchEngine(EngineConfig(model=local.config, **kw), params=loaded,
                                       device="cpu"), t_proto, Context, prompts, 5))
    base = asyncio.run(_gen(TorchEngine(EngineConfig(model=tcfg, **kw), params=src_t,
                                        device="cpu"), t_proto, Context, prompts, 5))
    jax_streams = asyncio.run(_gen(TpuEngine(JEngineConfig(model=jcfg, **kw),
                                             params=jax.tree.map(jnp.asarray, src)),
                                   j_proto, JContext, prompts, 5))
    assert got == base == jax_streams


@pytest.mark.parametrize("dtype", [torch.float16, torch.bfloat16])
def test_half_tensors_keep_their_type_and_load_exactly(tmp_path, dtype):
    _, tcfg = _cfgs()
    g = torch.Generator().manual_seed(3)
    params = t_llama.init_params(tcfg, g, dtype=dtype, device="cpu")
    path = tmp_path / "half.gguf"
    t_gguf.write_gguf(path, _meta(tcfg), t_gguf.gguf_tensors(tcfg, params))
    gf = t_gguf.read_gguf(path)
    assert {i.ggml_type for i in gf.tensors.values()} == {
        t_gguf.GGML_F16 if dtype == torch.float16 else t_gguf.GGML_BF16}
    loaded = t_gguf.load_gguf_weights(tcfg, gf, dtype=dtype, device="cpu")
    assert all(torch.equal(loaded[k], params[k]) for k in ("embed", "ln_f"))
    for a, b in zip(loaded["layers"], params["layers"]):
        assert all(a[k].dtype == dtype and torch.equal(a[k], b[k]) for k in a)


def test_writers_write_the_same_bytes_for_float32(tmp_path):
    jcfg, _ = _cfgs()
    rng = np.random.default_rng(0)
    tensors = {"a.weight": rng.normal(size=(3, 5)).astype(np.float32),
               "b": rng.normal(size=(7,)).astype(np.float32)}
    j_gguf.write_gguf(tmp_path / "j.gguf", _meta(jcfg), tensors)
    t_gguf.write_gguf(tmp_path / "t.gguf", _meta(jcfg), tensors)
    assert (tmp_path / "j.gguf").read_bytes() == (tmp_path / "t.gguf").read_bytes()


def test_gguf_quantized_tensor_rejected(tmp_path):
    path = tmp_path / "q.gguf"
    t_gguf.write_gguf(path, {"general.architecture": "llama"},
                      {"token_embd.weight": np.zeros((4, 4))})
    gf = t_gguf.read_gguf(path)
    gf.tensors["token_embd.weight"].ggml_type = 2  # Q4_0
    with pytest.raises(NotImplementedError, match="quantized ggml type 2"):
        gf.load_tensor("token_embd.weight")


def test_gguf_bpe_tokenizer_roundtrip(tmp_path):
    b2u = t_gguf.bytes_to_unicode()
    assert b2u == j_gguf._bytes_to_unicode()

    def mapped(s: str) -> str:
        return "".join(b2u[b] for b in s.encode("utf-8"))

    vocab = (["<|end|>"] + [b2u[b] for b in range(256)]
             + [mapped(" hello"), mapped(" world"), mapped("hel"), mapped("lo")])
    t_gguf.write_gguf(tmp_path / "bpe.gguf", {
        "general.architecture": "qwen2", "tokenizer.ggml.model": "gpt2",
        "tokenizer.ggml.tokens": vocab, "tokenizer.ggml.eos_token_id": 0})
    tok = t_gguf.GgufTokenizer(t_gguf.read_gguf(tmp_path / "bpe.gguf"))
    jtok = j_gguf.GgufTokenizer(j_gguf.read_gguf(tmp_path / "bpe.gguf"))
    assert tok.is_bpe and jtok.is_bpe
    _same_tokenizer(tok, jtok, ["hello world", " hello Zx ✓", "  東京\n"])


def test_gguf_qwen3_maps_qk_norm(tmp_path):
    t_gguf.write_gguf(tmp_path / "q3.gguf", {
        "general.architecture": "qwen3", "qwen3.attention.head_count": 16,
        "qwen3.attention.head_count_kv": 8, "qwen3.embedding_length": 1024,
        "qwen3.block_count": 2, "qwen3.feed_forward_length": 3072,
        "tokenizer.ggml.tokens": ["a"] * 128})
    cfg = t_gguf.model_config_from_gguf(t_gguf.read_gguf(tmp_path / "q3.gguf"))
    jcfg = j_gguf.model_config_from_gguf(j_gguf.read_gguf(tmp_path / "q3.gguf"))
    assert cfg.qk_norm is True and cfg.qkv_bias is False
    assert (cfg.qk_norm, cfg.qkv_bias, cfg.num_kv_heads, cfg.head_dim) == (
        jcfg.qk_norm, jcfg.qkv_bias, jcfg.num_kv_heads, jcfg.head_dim)


def test_llama3_rope_scaling_and_embedded_template(tmp_path):
    """A full GGUF checkout from tools/write_checkout: llama3 rope scaling
    and the chat template travel in the metadata."""
    from dynamo_tpu_torch.models.config import ModelConfig
    from dynamo_tpu_torch.tools import write_checkout as wc

    cfg = ModelConfig.llama32_1b().scaled(vocab_size=1024, hidden_size=64,
                                          intermediate_size=128, num_layers=2,
                                          num_heads=4, num_kv_heads=2, head_dim=16)
    g = torch.Generator().manual_seed(1)
    params = t_llama.init_params(cfg, g, dtype=torch.float32, device="cpu")
    tok_json = wc.llama3_tokenizer(1024, merges=200)
    wc.write_gguf_checkout(tmp_path / "m.gguf", cfg, params, tok_json, eos_id=1017)
    local, jlocal = LocalModel.prepare(str(tmp_path / "m.gguf")), JLocal.prepare(
        str(tmp_path / "m.gguf"))
    assert vars(local.config.rope_scaling) == vars(cfg.rope_scaling)
    assert vars(jlocal.config.rope_scaling) == {
        k: v for k, v in vars(cfg.rope_scaling).items() if k in vars(jlocal.config.rope_scaling)}
    assert local.config.tie_word_embeddings
    tok = load_tokenizer(str(tmp_path / "m.gguf"))
    msgs = [{"role": "user", "content": "hi"}]
    assert tok.apply_chat_template(msgs) == (
        "<|begin_of_text|><|start_header_id|>user<|end_header_id|>\n\nhi<|eot_id|>"
        "<|start_header_id|>assistant<|end_header_id|>\n\n")
    assert tok.decode(tok.encode("hello world")) == "hello world"
