"""Model registry and the serving pipeline (port of ModelManager and
build_serving_pipeline of dynamo_tpu/llm/discovery.py).

In one process the pipeline links preprocessor → detokenizer → the local
engine. The reference's pipeline reaches its workers through a router
over the runtime's endpoints and watches the registry for them
(``ModelWatcher``, ``register_llm``); those arrive with the runtime
slice.
"""

from __future__ import annotations

from dynamo_tpu_torch.llm.backend import Detokenizer
from dynamo_tpu_torch.llm.model_card import ModelDeploymentCard
from dynamo_tpu_torch.llm.preprocessor import OpenAIPreprocessor
from dynamo_tpu_torch.llm.tokenizer import load_tokenizer
from dynamo_tpu_torch.runtime.engine import AsyncEngine
from dynamo_tpu_torch.runtime.pipeline import Operator, Pipeline


class ModelManager:
    """Name → serving pipeline registry backing the HTTP service."""

    def __init__(self) -> None:
        self._engines: dict[str, AsyncEngine] = {}

    def add_model(self, name: str, engine: AsyncEngine) -> None:
        self._engines[name] = engine

    def get(self, name: str) -> AsyncEngine | None:
        return self._engines.get(name)

    def models(self) -> list[str]:
        return sorted(self._engines)


def build_serving_pipeline(
    card: ModelDeploymentCard,
    engine: AsyncEngine,
    engine_ops: tuple[Operator, ...] = (),
) -> Pipeline:
    """preprocessor → detokenizer → ``engine_ops`` → the local engine.
    ``engine_ops`` see the engine's own requests and outputs (a ``Tap``
    recording token ids, for one)."""
    if card.model_type != "chat":
        raise ValueError(
            f"model type {card.model_type!r} is not served by this slice"
        )
    tokenizer = load_tokenizer(card.model_path)
    return Pipeline.link(
        OpenAIPreprocessor(card, tokenizer),
        Detokenizer(tokenizer),
        *engine_ops,
        engine=engine,
    )
