"""Model Deployment Card (port of dynamo_tpu/llm/model_card.py): what a
frontend needs to serve a model without loading its weights — tokenizer
location, context length, KV block size. A worker publishes its card to
the control plane's object store (``register_llm``); a frontend fetches
it when discovery announces the model. The JSON form is the reference's,
field for field, so either package's frontend reads either package's
card. The port serves presets (toy tokenizer, no model directory), so no
tokenizer files ship with the card.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Any

MDC_BUCKET = "mdc"


@dataclass
class ModelDeploymentCard:
    name: str
    model_path: str | None = None       # local dir with tokenizer/config
    context_length: int = 8192
    kv_block_size: int = 16
    model_type: str = "chat"            # chat | completions | embeddings
    extra: dict[str, Any] = field(default_factory=dict)

    def to_json(self) -> bytes:
        return json.dumps({
            "name": self.name,
            "model_path": self.model_path,
            "context_length": self.context_length,
            "kv_block_size": self.kv_block_size,
            "model_type": self.model_type,
            "extra": self.extra,
        }).encode()

    @staticmethod
    def from_json(raw: bytes) -> "ModelDeploymentCard":
        d = json.loads(raw)
        return ModelDeploymentCard(
            name=d["name"],
            model_path=d.get("model_path"),
            context_length=d.get("context_length", 8192),
            kv_block_size=d.get("kv_block_size", 16),
            model_type=d.get("model_type", "chat"),
            extra=d.get("extra") or {},
        )

    async def publish(self, object_store) -> None:
        await object_store.put_object(MDC_BUCKET, self.name, self.to_json())

    @staticmethod
    async def fetch(object_store, name: str) -> "ModelDeploymentCard | None":
        raw = await object_store.get_object(MDC_BUCKET, name)
        return ModelDeploymentCard.from_json(raw) if raw else None
