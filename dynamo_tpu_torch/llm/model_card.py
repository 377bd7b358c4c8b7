"""Model Deployment Card (port of dynamo_tpu/llm/model_card.py): what a
frontend needs to serve a model without loading its weights — tokenizer
location, context length, KV block size. A worker publishes its card to
the control plane's object store (``register_llm``); a frontend fetches
it when discovery announces the model. The JSON form is the reference's,
field for field, so either package's frontend reads either package's
card. A card whose ``model_path`` is a directory ships its
prompt-formatter files (``ARTIFACT_FILES``) through the same object
store, so a frontend on another host materializes the worker's
tokenizer without sharing its filesystem.
"""

from __future__ import annotations

import asyncio
import json
import logging
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any

logger = logging.getLogger(__name__)

MDC_BUCKET = "mdc"
ARTIFACT_BUCKET = "mdc-artifacts"
#: tokenizer and prompt-formatter files worth shipping (HF layout; the
#: chat template lives in tokenizer_config.json or its own .jinja file)
ARTIFACT_FILES = (
    "tokenizer.json",
    "tokenizer_config.json",
    "special_tokens_map.json",
    "chat_template.jinja",
    "generation_config.json",
)


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

    async def publish(self, object_store, ship_artifacts: bool = True) -> None:
        """Publish the card; when ``model_path`` is a directory, ship its
        prompt-formatter files too (listed in ``extra["artifacts"]``)."""
        if ship_artifacts and self.model_path:
            root = Path(self.model_path)
            shipped = []
            for fname in ARTIFACT_FILES:
                p = root / fname
                if p.is_file():
                    await object_store.put_object(
                        ARTIFACT_BUCKET, f"{self.name}/{fname}",
                        await asyncio.to_thread(p.read_bytes),
                    )
                    shipped.append(fname)
            if shipped:
                self.extra["artifacts"] = shipped
        await object_store.put_object(MDC_BUCKET, self.name, self.to_json())

    async def materialize(self, object_store, dest_root: str | Path) -> bool:
        """Fetch the shipped files into ``dest_root/<name>`` and point
        ``model_path`` there; True when a tokenizer directory is now
        local. All or nothing: with a file missing from the store,
        ``model_path`` stays as it was."""
        shipped = self.extra.get("artifacts") or []
        if not shipped:
            return False
        dest = Path(dest_root) / self.name
        await asyncio.to_thread(dest.mkdir, parents=True, exist_ok=True)
        for fname in shipped:
            raw = await object_store.get_object(ARTIFACT_BUCKET, f"{self.name}/{fname}")
            if raw is None:
                logger.warning("artifact %s/%s missing from the object store; "
                               "not materializing", self.name, fname)
                return False
            await asyncio.to_thread((dest / fname).write_bytes, raw)
        self.model_path = str(dest)
        return True

    @staticmethod
    async def fetch(object_store, name: str) -> "ModelDeploymentCard | None":
        raw = await object_store.get_object(MDC_BUCKET, name)
        return ModelDeploymentCard.from_json(raw) if raw else None
