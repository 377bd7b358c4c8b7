"""Conditional disaggregation decision (port of
dynamo_tpu/disagg/router.py).

Prefill goes remote iff the *effective* prefill work (prompt beyond the
local prefix hit) is above threshold AND the shared prefill queue isn't
backed up (reference: lib/llm/src/disagg_router.rs:25-262 and its Python
mirror examples/llm/components/disagg_router.py:47-67:
``remote iff prefill_len*(1-prefix_hit_rate) > max_local AND
queue_size < max_queue``). Thresholds live in the discovery store and are
watched, so operators can retune a live system (reference:
EtcdKvCache transports/etcd.rs:471-597).
"""

from __future__ import annotations

import asyncio
import json
import logging
from dataclasses import dataclass

from dynamo_tpu_torch.runtime.transports.store import EventKind

logger = logging.getLogger(__name__)

CONFIG_KEY = "disagg_router/config/"


@dataclass
class DisaggConfig:
    max_local_prefill_length: int = 512
    max_prefill_queue_size: int = 16
    # Per-item SLA: if the oldest queued prefill has waited longer than
    # this, the pool is stalled (dead/slow workers) even at low depth —
    # keep prefill local rather than queue behind it.
    max_prefill_queue_age_s: float = 10.0

    def to_json(self) -> bytes:
        return json.dumps(self.__dict__).encode()

    @staticmethod
    def from_json(raw: bytes) -> "DisaggConfig":
        d = json.loads(raw)
        return DisaggConfig(
            max_local_prefill_length=d.get("max_local_prefill_length", 512),
            max_prefill_queue_size=d.get("max_prefill_queue_size", 16),
            max_prefill_queue_age_s=d.get("max_prefill_queue_age_s", 10.0),
        )


class DisaggRouter:
    def __init__(
        self, drt, namespace: str = "default", cfg: DisaggConfig | None = None
    ) -> None:
        self._drt = drt
        self._ns = namespace
        self.cfg = cfg or DisaggConfig()
        self._watch_task: asyncio.Task | None = None

    @property
    def _key(self) -> str:
        return f"{CONFIG_KEY}{self._ns}"

    async def start(self) -> "DisaggRouter":
        """Load + live-watch config from the store."""
        watch = await self._drt.store.watch_prefix(self._key)
        for _, raw in watch.initial.items():
            self.cfg = DisaggConfig.from_json(raw)

        async def pump():
            async for ev in watch:
                if ev.kind is EventKind.PUT and ev.value:
                    self.cfg = DisaggConfig.from_json(ev.value)
                    logger.info("disagg config updated: %s", self.cfg)

        self._watch_task = asyncio.ensure_future(pump())
        self._drt.runtime.token.on_cancel(watch.cancel)
        return self

    async def publish_config(self, cfg: DisaggConfig) -> None:
        self.cfg = cfg
        await self._drt.store.put(self._key, cfg.to_json())

    def prefill_remote(
        self,
        prefill_length: int,
        prefix_hit_rate: float,
        queue_size: int,
        queue_age_s: float = 0.0,
    ) -> bool:
        effective = prefill_length * (1.0 - prefix_hit_rate)
        return (
            effective > self.cfg.max_local_prefill_length
            and queue_size < self.cfg.max_prefill_queue_size
            and queue_age_s < self.cfg.max_prefill_queue_age_s
        )
