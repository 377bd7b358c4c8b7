"""Embeddings: the pooled-forward engine and its pipeline operator (port
of dynamo_tpu/llm/embedding.py).

One full no-cache pass of the model (embeddings are one-shot: no KV
cache), masked mean pooling over the real tokens after ``ln_f``, then L2
normalisation. The reference pads a prompt to a power-of-two bucket (at
least 16) for its compiled programs; attention is causal, so padding
rows leave the real rows unchanged, and here the pass runs at the real
length.

Wire contract: request payload ``{"token_ids": [...]}`` (one input per
request: the HTTP front fans a multi-input request out); one response
item ``{"embedding": [...], "prompt_tokens": N}``.
"""

from __future__ import annotations

import asyncio
from typing import AsyncIterator

import torch

from dynamo_tpu_torch import resolve_device
from dynamo_tpu_torch.engine.config import DTYPES
from dynamo_tpu_torch.llm.model_card import ModelDeploymentCard
from dynamo_tpu_torch.llm.protocols.common import RequestError
from dynamo_tpu_torch.llm.tokenizer import Tokenizer
from dynamo_tpu_torch.models import llama
from dynamo_tpu_torch.models.config import ModelConfig
from dynamo_tpu_torch.ops.norms import rms_norm
from dynamo_tpu_torch.runtime.engine import AsyncEngine, Context
from dynamo_tpu_torch.runtime.pipeline import Operator


def embed_forward(
    cfg: ModelConfig, params, token_ids: torch.Tensor, length: int
) -> torch.Tensor:
    """Full no-cache forward [T] → pooled embedding [hidden] (float32):
    ``hidden_states``, then ``rms_norm(x, ln_f, rms_eps)`` (the
    reference's own norm here, not the family's final norm), the mean
    over the first ``length`` rows, L2-normalised with a floor of 1e-12."""
    x = llama.hidden_states(cfg, params, token_ids)
    h = rms_norm(x, params["ln_f"], cfg.rms_eps).float()
    mask = (torch.arange(token_ids.shape[0], device=h.device) < length)[:, None]
    pooled = (h * mask).sum(dim=0) / max(length, 1)
    return pooled / torch.clamp(torch.linalg.vector_norm(pooled), min=1e-12)


class EmbeddingEngine:
    """AsyncEngine serving pooled-forward embeddings: one dispatch at a
    time under a lock, each run on a worker thread so the event loop
    stays live."""

    def __init__(
        self,
        cfg: ModelConfig,
        params=None,
        dtype: str = "bfloat16",
        seed: int = 0,
        device: str | torch.device | None = None,
    ) -> None:
        self.cfg = cfg
        self.device = resolve_device(device)
        if params is None:
            g = torch.Generator(device=self.device)
            g.manual_seed(seed)
            params = llama.init_params(cfg, g, dtype=DTYPES[dtype], device=self.device)
        self.params = params
        self._lock = asyncio.Lock()

    def _run(self, token_ids: list[int]) -> list[float]:
        ids = torch.tensor(token_ids, dtype=torch.int32, device=self.device)
        with torch.inference_mode():
            vec = embed_forward(self.cfg, self.params, ids, len(token_ids))
        return vec.cpu().tolist()

    async def generate(self, request: Context) -> AsyncIterator[dict]:
        token_ids = list(request.payload.get("token_ids") or [])
        if not token_ids:
            raise RequestError("embeddings request carries no token_ids")
        if len(token_ids) > self.cfg.max_position:
            raise RequestError(
                f"input ({len(token_ids)} tokens) exceeds context "
                f"{self.cfg.max_position}"
            )
        async with self._lock:   # one device dispatch at a time
            vec = await asyncio.to_thread(self._run, token_ids)
        yield {"embedding": vec, "prompt_tokens": len(token_ids)}


class EmbeddingPreprocessor(Operator):
    """Frontend operator: tokenize one embeddings input (or take its
    token ids) and forward them to the (possibly remote) engine."""

    def __init__(self, card: ModelDeploymentCard, tokenizer: Tokenizer) -> None:
        self.card = card
        self.tokenizer = tokenizer

    async def generate(self, request: Context, downstream: AsyncEngine) -> AsyncIterator[dict]:
        payload = request.payload
        if isinstance(payload, dict) and "token_ids" in payload:
            token_ids = list(payload["token_ids"])
        else:
            text = payload["input"] if isinstance(payload, dict) else payload
            token_ids = self.tokenizer.encode(text)
        if len(token_ids) > self.card.context_length:
            raise RequestError(
                f"input ({len(token_ids)} tokens) exceeds context length "
                f"{self.card.context_length}"
            )
        async for item in downstream.generate(request.map({"token_ids": token_ids})):
            yield item
