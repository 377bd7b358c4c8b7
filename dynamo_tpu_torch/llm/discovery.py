"""Model discovery: registration, manager and watcher (port of
dynamo_tpu/llm/discovery.py).

Workers call ``register_llm``: publish the card to the object store and
put a ``ModelEntry`` at ``models/{name}:{lease}``, bound to the worker's
lease. Frontends run a ``ModelWatcher`` on the ``models/`` prefix: on a
PUT they fetch the card and build the serving pipeline — preprocessor →
detokenizer → ``FailoverEngine(PushRouter)`` to the worker endpoint —
and register it with the ``ModelManager``; when the last instance of a
model goes, they drop it. In one process, ``build_serving_pipeline``
links the same operators onto a local engine.
"""

from __future__ import annotations

import asyncio
import json
import logging
from dataclasses import dataclass

from dynamo_tpu_torch.llm.backend import Detokenizer
from dynamo_tpu_torch.llm.model_card import ModelDeploymentCard
from dynamo_tpu_torch.llm.preprocessor import OpenAIPreprocessor
from dynamo_tpu_torch.llm.tokenizer import load_tokenizer
from dynamo_tpu_torch.runtime.engine import AsyncEngine
from dynamo_tpu_torch.runtime.pipeline import Operator, Pipeline
from dynamo_tpu_torch.runtime.transports.store import EventKind

logger = logging.getLogger(__name__)

MODEL_ROOT = "models/"


@dataclass(frozen=True)
class ModelEntry:
    name: str
    endpoint: str  # dyn://ns.component.endpoint
    model_type: str = "chat"
    lease_id: int = 0

    def key(self) -> str:
        return f"{MODEL_ROOT}{self.name}:{self.lease_id:x}"

    def to_json(self) -> bytes:
        return json.dumps({
            "name": self.name,
            "endpoint": self.endpoint,
            "model_type": self.model_type,
            "lease_id": self.lease_id,
        }).encode()

    @staticmethod
    def from_json(raw: bytes) -> "ModelEntry":
        d = json.loads(raw)
        return ModelEntry(
            name=d["name"],
            endpoint=d["endpoint"],
            model_type=d.get("model_type", "chat"),
            lease_id=d.get("lease_id", 0),
        )


async def register_llm(
    drt, endpoint, card: ModelDeploymentCard, model_type: str = "chat",
) -> ModelEntry:
    """Advertise a served engine endpoint as a model (worker side)."""
    await card.publish(drt.bus)
    entry = ModelEntry(
        name=card.name,
        endpoint=str(endpoint.id),
        model_type=model_type,
        lease_id=drt.primary_lease_id,
    )
    await drt.store.put(entry.key(), entry.to_json(), lease_id=drt.primary_lease_id)
    logger.info("registered model %s -> %s", card.name, entry.endpoint)
    return entry


class ModelManager:
    """Name → serving pipeline registry backing the HTTP service."""

    def __init__(self) -> None:
        self._engines: dict[str, AsyncEngine] = {}
        self._cards: dict[str, ModelDeploymentCard] = {}

    def add_model(
        self, name: str, engine: AsyncEngine, card: ModelDeploymentCard | None = None
    ) -> None:
        self._engines[name] = engine
        if card is not None:
            self._cards[name] = card

    def remove_model(self, name: str) -> None:
        self._engines.pop(name, None)
        self._cards.pop(name, None)

    def get(self, name: str) -> AsyncEngine | None:
        return self._engines.get(name)

    def card(self, name: str) -> ModelDeploymentCard | None:
        return self._cards.get(name)

    def models(self) -> list[str]:
        return sorted(self._engines)


class ModelWatcher:
    """Watches the model registry and keeps a ModelManager in sync.
    ``engine_ops`` are linked between the detokenizer and the router of
    every pipeline it builds (a ``Tap`` on the routed token ids, for
    one)."""

    def __init__(
        self,
        drt,
        manager: ModelManager,
        router_mode=None,
        engine_ops: tuple[Operator, ...] = (),
    ) -> None:
        from dynamo_tpu_torch.runtime.egress import RouterMode

        self._drt = drt
        self.manager = manager
        self.router_mode = router_mode or RouterMode.ROUND_ROBIN
        self._engine_ops = engine_ops
        self._task: asyncio.Task | None = None
        self._refcount: dict[str, int] = {}

    async def start(self) -> None:
        watch = await self._drt.store.watch_prefix(MODEL_ROOT)
        for raw in watch.initial.values():
            await self._handle_put(raw)
        self._task = asyncio.ensure_future(self._pump(watch))
        self._drt.runtime.token.on_cancel(watch.cancel)

    async def _pump(self, watch) -> None:
        async for ev in watch:
            try:
                if ev.kind is EventKind.PUT and ev.value:
                    await self._handle_put(ev.value)
                elif ev.kind is EventKind.DELETE:
                    self._handle_delete(ev.key)
            except Exception:  # noqa: BLE001 — one bad entry must not stop discovery
                logger.exception("model watcher failed handling %s", ev.key)

    async def _handle_put(self, raw: bytes) -> None:
        from dynamo_tpu_torch.runtime.egress import PushRouter
        from dynamo_tpu_torch.runtime.failover import FailoverEngine

        entry = ModelEntry.from_json(raw)
        self._refcount[entry.name] = self._refcount.get(entry.name, 0) + 1
        if self.manager.get(entry.name) is not None:
            return  # another instance of a model already served
        card = await ModelDeploymentCard.fetch(self._drt.bus, entry.name)
        if card is None:
            card = ModelDeploymentCard(name=entry.name)
        card.model_type = entry.model_type or card.model_type
        push = await PushRouter.create(self._drt, entry.endpoint, self.router_mode)
        # Worker death mid-decode is a replay on a sibling, not an error
        # (runtime/failover.py).
        pipeline = build_serving_pipeline(card, FailoverEngine(push), self._engine_ops)
        self.manager.add_model(entry.name, pipeline, card)
        logger.info("model %s now served via %s", entry.name, entry.endpoint)

    def _handle_delete(self, key: str) -> None:
        name = key[len(MODEL_ROOT):].rsplit(":", 1)[0]
        count = self._refcount.get(name, 0) - 1
        self._refcount[name] = max(count, 0)
        if count <= 0:
            self.manager.remove_model(name)
            logger.info("model %s removed (no instances)", name)


def build_serving_pipeline(
    card: ModelDeploymentCard,
    engine: AsyncEngine,
    engine_ops: tuple[Operator, ...] = (),
) -> Pipeline:
    """preprocessor → detokenizer → ``engine_ops`` → ``engine`` (a local
    engine, or a FailoverEngine over a PushRouter). ``engine_ops`` see
    the engine's own requests and outputs."""
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
