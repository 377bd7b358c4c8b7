"""Annotated: the SSE-able response envelope (port of
dynamo_tpu/llm/protocols/annotated.py). Pipeline operators yield
``Annotated`` items for out-of-band events (``formatted_prompt``,
``token_ids``); the HTTP layer encodes them as named SSE events and the
aggregator skips them."""

from __future__ import annotations

import json
from dataclasses import dataclass
from typing import Any

from dynamo_tpu_torch.llm.protocols.sse import SseEvent


@dataclass
class Annotated:
    data: Any = None
    event: str | None = None
    id: str | None = None
    comment: str | None = None

    def to_sse(self) -> SseEvent:
        return SseEvent(
            data=None if self.data is None else json.dumps(self.data),
            event=self.event,
            id=self.id,
            comment=self.comment,
        )

    @staticmethod
    def annotation(event: str, data: Any, request_id: str | None = None) -> "Annotated":
        return Annotated(data=data, event=event, id=request_id)
