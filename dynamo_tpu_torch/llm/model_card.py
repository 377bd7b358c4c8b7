"""Model Deployment Card (port of the local fields of
dynamo_tpu/llm/model_card.py): what a frontend needs to serve a model
without loading its weights — tokenizer location, context length, KV
block size. Its JSON form, and publishing the card and its tokenizer
files to the control plane's object store, arrive with the runtime
slice."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any


@dataclass
class ModelDeploymentCard:
    name: str
    model_path: str | None = None       # local dir with tokenizer/config
    context_length: int = 8192
    kv_block_size: int = 16
    model_type: str = "chat"            # chat | completions | embeddings
    extra: dict[str, Any] = field(default_factory=dict)
