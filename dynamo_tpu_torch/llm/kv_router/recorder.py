"""Timestamped router-event recording and replay (port of
dynamo_tpu/llm/kv_router/recorder.py).

Capture router events to disk and replay them into an indexer later,
for offline router analysis and router tests against recorded traffic.
A typed wrapper over the rotating recorder of utils/recorder.py.
"""

from __future__ import annotations

from pathlib import Path
from typing import Callable, Iterator

from dynamo_tpu_torch.llm.kv_router.protocols import RouterEvent
from dynamo_tpu_torch.utils.recorder import Recorder


class KvRecorder(Recorder):
    def __init__(
        self,
        path: str | Path,
        max_events: int | None = None,
        max_bytes: int | None = None,
        max_files: int = 4,
    ) -> None:
        super().__init__(
            path,
            max_bytes=max_bytes,
            max_files=max_files,
            max_events=max_events,
            encode=lambda ev: ev.to_wire(),
        )

    @staticmethod
    def load(path: str | Path) -> Iterator[tuple[float, RouterEvent]]:
        return Recorder.load(path, decode=RouterEvent.from_wire)

    @staticmethod
    async def send_events(
        path: str | Path,
        apply: Callable[[RouterEvent], None],
        timed: bool = False,
        max_count: int | None = None,
    ) -> int:
        """Replay a recording into `apply` (e.g. KvIndexer.apply); `timed`
        preserves inter-event gaps."""
        return await Recorder.replay(
            path,
            apply,
            decode=RouterEvent.from_wire,
            timed=timed,
            max_count=max_count,
        )
