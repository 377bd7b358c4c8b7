"""The port's embeddings (dynamo_tpu_torch/llm/embedding.py, the
/v1/embeddings route of llm/http_service.py, ``--model-type
embeddings``) against the JAX package on the CPU: ``embed_forward``
against JAX's (which pads to a power-of-two bucket; the port runs at the
real length) on tiny-test and a Qwen3 preset cut to a tiny width, the
engine's and the preprocessor's refusals, the HTTP route with several
inputs in both encodings, and the CLI serving an embeddings model.

Weights come from the JAX params trees through ``params_from_jax``;
float32 vectors within 1e-5."""

import asyncio
import base64
import contextlib
import struct

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from dynamo_tpu.llm import embedding as j_embedding
from dynamo_tpu.models import llama as j_llama
from dynamo_tpu.models.config import ModelConfig as JCfg
from dynamo_tpu_torch.llm import embedding as t_embedding
from dynamo_tpu_torch.llm.discovery import ModelManager, build_serving_pipeline
from dynamo_tpu_torch.llm.http_client import fetch
from dynamo_tpu_torch.llm.model_card import ModelDeploymentCard
from dynamo_tpu_torch.llm.protocols.common import RequestError
from dynamo_tpu_torch.llm.tokenizer import ToyTokenizer
from dynamo_tpu_torch.models import llama as t_llama
from dynamo_tpu_torch.models.config import ModelConfig
from dynamo_tpu_torch.runtime.engine import Context

TOL = 1e-5
HOST = "127.0.0.1"
NARROW = dict(hidden_size=64, intermediate_size=128, num_layers=2, vocab_size=384,
              num_heads=4, num_kv_heads=2, head_dim=16)
MODELS = {
    "tiny-test": (JCfg.tiny_test(), ModelConfig.tiny_test()),
    "qwen3-0.6b-narrow": (JCfg.qwen3_06b().scaled(**NARROW),
                          ModelConfig.qwen3_06b().scaled(**NARROW)),
}


def _weights(jcfg, seed=0):
    jp = j_llama.init_params(jax.random.PRNGKey(seed), jcfg, dtype=jnp.float32)
    return jp, t_llama.params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")


JP, TP = _weights(MODELS["tiny-test"][0])


def _jax_embedding(jcfg, jp, ids):
    """JAX's engine law: pad to the power-of-two bucket (>= 16)."""
    T = 16
    while T < len(ids):
        T *= 2
    padded = jnp.zeros(T, jnp.int32).at[:len(ids)].set(jnp.asarray(ids, jnp.int32))
    return np.asarray(j_embedding.embed_forward(jcfg, jp, padded, jnp.int32(len(ids))))


@pytest.mark.parametrize("name", sorted(MODELS))
def test_embed_forward_matches_jax(name):
    """Unit vectors within 1e-5 of JAX's at 5, 16, 17 and 40 tokens (JAX
    pads to 16, 16, 32, 64 rows; the causal trunk leaves the real rows
    unchanged)."""
    jcfg, tcfg = MODELS[name]
    jp, tp = _weights(jcfg, seed=1)
    rng = np.random.default_rng(3)
    for n in (5, 16, 17, 40):
        ids = rng.integers(1, tcfg.vocab_size, n).tolist()
        got = t_embedding.embed_forward(tcfg, tp, torch.tensor(ids), n).numpy()
        np.testing.assert_allclose(got, _jax_embedding(jcfg, jp, ids), rtol=TOL, atol=TOL)
        assert abs(np.linalg.norm(got) - 1.0) < 1e-5


def test_embedding_engine_and_preprocessor():
    """Token ids and text both reach the engine as token ids; the engine
    refuses no ids and more than ``max_position``; the preprocessor
    refuses more than the card's context length."""
    tcfg = MODELS["tiny-test"][1]
    engine = t_embedding.EmbeddingEngine(tcfg, params=TP, device="cpu")
    card = ModelDeploymentCard(name="tiny-embed", model_path="toy", context_length=64,
                               model_type="embeddings")
    pipe = build_serving_pipeline(card, engine)

    async def one(payload):
        out = []
        async for item in pipe.generate(Context(payload)):
            out.append(item)
        return out

    async def main():
        by_ids = await one({"token_ids": [104, 105]})
        by_text = await one({"input": "hi"})
        errors = []
        for payload in ({"input": "x" * 65},):
            with pytest.raises(RequestError, match="context length"):
                await one(payload)
        for payload in ({"token_ids": []}, {"token_ids": [1] * (tcfg.max_position + 1)}):
            with pytest.raises(RequestError) as exc:
                async for _ in engine.generate(Context(payload)):
                    pass
            errors.append(str(exc.value))
        return by_ids, by_text, errors

    by_ids, by_text, errors = asyncio.run(main())
    assert ToyTokenizer().encode("hi") == [104, 105]
    assert by_ids == by_text and by_ids[0]["prompt_tokens"] == 2
    np.testing.assert_allclose(by_ids[0]["embedding"], _jax_embedding(JCfg.tiny_test(), JP,
                                                                      [104, 105]), atol=TOL)
    assert "no token_ids" in errors[0] and "exceeds context" in errors[1]


async def _embedding_server():
    from dynamo_tpu_torch.llm.http_service import HttpService

    manager = ModelManager()
    card = ModelDeploymentCard(name="tiny-embed", model_path="toy", context_length=64,
                               model_type="embeddings")
    engine = t_embedding.EmbeddingEngine(MODELS["tiny-test"][1], params=TP, device="cpu")
    manager.add_model(card.name, build_serving_pipeline(card, engine), card)
    chat = ModelDeploymentCard(name="chat-model", model_path="toy")
    manager.add_model(chat.name, build_serving_pipeline(chat, engine), chat)
    service = HttpService(manager, host=HOST, port=0)
    await service.start()
    return service


@pytest.mark.parametrize("encoding", ["float", "base64"])
def test_v1_embeddings_through_the_port_server(encoding):
    """Several inputs in one request (texts, then token-id lists): one
    vector per input in input order, each the JAX vector within 1e-5
    (base64: little-endian float32), usage the total prompt tokens; one
    string alone; an empty input and a chat model answer 400, an unknown
    model 404; the requests are counted under the ``embeddings``
    endpoint."""
    tok = ToyTokenizer()
    texts = ["hello", "a longer input of text", "xyz"]
    ids = [[104, 105, 106], [1, 2, 3, 4, 5]]
    want = [_jax_embedding(JCfg.tiny_test(), JP, tok.encode(x)) for x in texts]
    want += [_jax_embedding(JCfg.tiny_test(), JP, x) for x in ids]

    async def main():
        service = await _embedding_server()
        try:
            many = [await fetch(HOST, service.port, "POST", "/v1/embeddings", {
                "model": "tiny-embed", "input": inputs, "encoding_format": encoding})
                for inputs in (texts, ids)]
            single = await fetch(HOST, service.port, "POST", "/v1/embeddings", {
                "model": "tiny-embed", "input": "hello"})
            errs = [(await fetch(HOST, service.port, "POST", "/v1/embeddings", body)).status
                    for body in ({"model": "tiny-embed", "input": [""]},
                                 {"model": "chat-model", "input": "x"},
                                 {"model": "nope", "input": "x"})]
            metrics = (await fetch(HOST, service.port, "GET", "/metrics")).body.decode()
            return many, single, errs, metrics
        finally:
            await service.stop()

    many, single, errs, metrics = asyncio.run(main())
    assert [r.status for r in many] == [200, 200] and single.status == 200
    bodies = [r.json() for r in many]
    assert all(b["object"] == "list" and b["model"] == "tiny-embed" for b in bodies)
    assert [d["index"] for b in bodies for d in b["data"]] == [0, 1, 2, 0, 1]
    for d, w in zip([d for b in bodies for d in b["data"]], want):
        assert d["object"] == "embedding"
        vec = d["embedding"]
        if encoding == "base64":
            raw = base64.b64decode(vec)
            vec = struct.unpack(f"<{len(raw) // 4}f", raw)
        np.testing.assert_allclose(np.asarray(vec, np.float32), w, atol=TOL)
    for b, inputs in zip(bodies, ([tok.encode(x) for x in texts], ids)):
        total = sum(len(x) for x in inputs)
        assert b["usage"] == {"prompt_tokens": total, "completion_tokens": 0,
                              "total_tokens": total}
    np.testing.assert_allclose(single.json()["data"][0]["embedding"], want[0], atol=TOL)
    assert errs == [400, 400, 404]
    assert 'endpoint="embeddings",status="success"' in metrics


def test_cli_serves_an_embeddings_model():
    """``run --in http --out torch --model-type embeddings --device cpu
    --model-path preset:tiny-test``: the card says ``embeddings`` and a
    POST gives unit vectors of the model's width for text and for token
    ids; the echo engines with ``--model-type embeddings`` are refused."""
    from dynamo_tpu_torch import cli

    args = cli.build_parser().parse_args([
        "run", "--out", "torch", "--device", "cpu", "--dtype", "float32",
        "--model-type", "embeddings", "--model-path", "preset:tiny-test",
        "--http-host", HOST, "--http-port", "0", "--max-model-len", "64"])
    cli.refuse_unserved(args)

    async def main():
        async with contextlib.AsyncExitStack() as stack:
            service, engine = await cli.start_http(args, stack)
            resp = await fetch(HOST, service.port, "POST", "/v1/embeddings", {
                "model": "tiny-test", "input": [[1, 2, 3, 4], [5, 6]]})
            text = await fetch(HOST, service.port, "POST", "/v1/embeddings", {
                "model": "tiny-test", "input": "hi there"})
            card = service.manager.card("tiny-test")
            return resp, text, card, engine

    resp, text, card, engine = asyncio.run(main())
    assert engine is None and card.model_type == "embeddings"
    assert resp.status == 200 and text.status == 200
    for d in resp.json()["data"] + text.json()["data"]:
        assert len(d["embedding"]) == 64
        assert abs(np.linalg.norm(d["embedding"]) - 1.0) < 1e-5
    with pytest.raises(SystemExit, match="--model-type"):
        cli.refuse_unserved(cli.build_parser().parse_args(
            ["run", "--model-type", "embeddings", "--out", "echo_core"]))
