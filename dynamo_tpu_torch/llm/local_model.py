"""LocalModel: resolve a model reference into config + card (port of
dynamo_tpu/llm/local_model.py).

This slice serves ``preset:NAME`` — an architecture preset of
models/config.py with seeded random weights and the ToyTokenizer. A
local HF checkout, ``hf://org/name`` and ``.gguf`` files need checkpoint
loading and real tokenizers, which arrive with a later slice; they are
refused here by name.
"""

from __future__ import annotations

from dataclasses import dataclass

from dynamo_tpu_torch.llm.model_card import ModelDeploymentCard
from dynamo_tpu_torch.models.config import PRESETS, ModelConfig


@dataclass
class LocalModel:
    name: str
    config: ModelConfig
    model_path: str | None  # None = preset (ToyTokenizer, random weights)
    card: ModelDeploymentCard

    @staticmethod
    def prepare(
        ref: str,
        name: str | None = None,
        context_length: int | None = None,
        kv_block_size: int = 16,
    ) -> "LocalModel":
        if not ref.startswith("preset:"):
            kind = (
                "a .gguf file" if ref.endswith(".gguf")
                else "an hf:// reference" if ref.startswith("hf://")
                else "a model directory"
            )
            raise ValueError(
                f"--model-path {ref!r} is {kind}: dynamo_tpu_torch serves "
                f"'preset:NAME' only until checkpoint loading is ported "
                f"(presets: {sorted(PRESETS)})"
            )
        preset = ref.split(":", 1)[1]
        if preset not in PRESETS:
            raise ValueError(
                f"unknown preset {preset!r}; have {sorted(PRESETS)}"
            )
        config = PRESETS[preset]()
        name = name or preset
        card = ModelDeploymentCard(
            name=name,
            model_path=None,  # None → ToyTokenizer (load_tokenizer)
            context_length=min(
                context_length or config.max_position, config.max_position
            ),
            kv_block_size=kv_block_size,
        )
        return LocalModel(name=name, config=config, model_path=None, card=card)
