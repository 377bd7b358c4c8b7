"""Server-Sent Events codec (port of dynamo_tpu/llm/protocols/sse.py):
the streaming wire format of the OpenAI endpoints."""

from __future__ import annotations

import json
from dataclasses import dataclass
from typing import Any, Iterator

DONE = "[DONE]"


@dataclass
class SseEvent:
    data: str | None = None
    event: str | None = None
    id: str | None = None
    comment: str | None = None

    def encode(self) -> bytes:
        lines: list[str] = []
        if self.comment is not None:
            lines.append(f": {self.comment}")
        if self.id is not None:
            lines.append(f"id: {self.id}")
        if self.event is not None:
            lines.append(f"event: {self.event}")
        if self.data is not None:
            for dline in self.data.splitlines() or [""]:
                lines.append(f"data: {dline}")
        return ("\n".join(lines) + "\n\n").encode()

    @staticmethod
    def data_json(obj: Any, event: str | None = None) -> "SseEvent":
        return SseEvent(data=json.dumps(obj, separators=(",", ":")), event=event)

    @staticmethod
    def done() -> "SseEvent":
        return SseEvent(data=DONE)


def decode_stream(text: str) -> Iterator[SseEvent]:
    """Parse an SSE byte stream (for tests and response aggregation)."""
    for block in text.split("\n\n"):
        if not block.strip():
            continue
        ev = SseEvent()
        data_lines: list[str] = []
        for line in block.split("\n"):
            if line.startswith("data:"):
                data_lines.append(line[5:].lstrip())
            elif line.startswith("event:"):
                ev.event = line[6:].strip()
            elif line.startswith("id:"):
                ev.id = line[3:].strip()
            elif line.startswith(":"):
                ev.comment = line[1:].strip()
        if data_lines:
            ev.data = "\n".join(data_lines)
        yield ev
