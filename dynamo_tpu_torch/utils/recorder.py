"""Timestamped JSONL event recorder with rotation and replay (port of
dynamo_tpu/utils/recorder.py, same file layout: a capture written by
either package loads in the other). The tracer's ``DYNTPU_TRACE``
capture and the KV router's event recorder (llm/kv_router/recorder.py)
stream through it.

Rotation is logrotate-style: when the active file exceeds ``max_bytes``
it is renamed ``<path>.1`` (existing ``.1`` → ``.2`` …), keeping at most
``max_files`` rotated generations; ``load`` reads the full rotated set
oldest-first so replay order is total.
"""

from __future__ import annotations

import asyncio
import json
import time
from pathlib import Path
from typing import Any, Callable, Iterator

from dynamo_tpu_torch.utils.concurrency import make_lock


class Recorder:
    def __init__(
        self,
        path: str | Path,
        max_bytes: int | None = None,
        max_files: int = 4,
        max_events: int | None = None,
        encode: Callable[[Any], Any] | None = None,
    ) -> None:
        self.path = Path(path)
        self.max_bytes = max_bytes
        self.max_files = max_files
        self.max_events = max_events
        self._encode = encode
        self.count = 0
        self._fh = self.path.open("a")
        # Writers span threads (the tracer streams spans from both the
        # engine dispatch thread and the asyncio thread): interleaved
        # write()/rotate() would corrupt the JSONL or close the handle
        # under a concurrent record.
        self._write_lock = make_lock("recorder.write")

    def record(self, event: Any) -> None:
        if self.max_events is not None and self.count >= self.max_events:
            return
        obj = self._encode(event) if self._encode is not None else event
        line = json.dumps({"ts": time.time(), "event": obj})
        with self._write_lock:
            if (
                self.max_bytes is not None
                and self._fh.tell() + len(line) + 1 > self.max_bytes
                and self._fh.tell() > 0
            ):
                self._rotate_locked()
            self._fh.write(line)
            self._fh.write("\n")
            # Flushed under the lock: a concurrent rotate must not close
            # the handle mid-flush.
            self._fh.flush()
            self.count += 1

    def _rotate_locked(self) -> None:
        # Only called from record() with _write_lock held.
        self._fh.close()
        for i in range(self.max_files - 1, 0, -1):
            src = self.path.with_name(f"{self.path.name}.{i}")
            if src.exists():
                if i + 1 >= self.max_files:
                    src.unlink()  # oldest generation falls off
                else:
                    src.rename(self.path.with_name(f"{self.path.name}.{i + 1}"))
        if self.max_files > 1:
            self.path.rename(self.path.with_name(f"{self.path.name}.1"))
        else:
            self.path.unlink()
        self._fh = self.path.open("a")

    def close(self) -> None:
        self._fh.close()

    def __enter__(self) -> "Recorder":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    @staticmethod
    def files(path: str | Path) -> list[Path]:
        """The rotated set for ``path``, oldest first."""
        path = Path(path)
        out = []
        i = 1
        while (p := path.with_name(f"{path.name}.{i}")).exists():
            out.append(p)
            i += 1
        out.reverse()  # highest index = oldest
        if path.exists():
            out.append(path)
        return out

    @staticmethod
    def load(
        path: str | Path, decode: Callable[[Any], Any] | None = None
    ) -> Iterator[tuple[float, Any]]:
        """(timestamp, event) for every record of the rotated set, oldest
        first, each event through ``decode`` when given."""
        for p in Recorder.files(path):
            with p.open() as fh:
                for line in fh:
                    if not line.strip():
                        continue
                    d = json.loads(line)
                    ev = d["event"]
                    yield d["ts"], (decode(ev) if decode is not None else ev)

    @staticmethod
    async def replay(
        path: str | Path,
        apply: Callable[[Any], None],
        decode: Callable[[Any], Any] | None = None,
        timed: bool = False,
        max_count: int | None = None,
    ) -> int:
        """Feed a recording into ``apply``; ``timed`` keeps the gaps
        between events. Returns the number of events fed."""
        last_ts: float | None = None
        n = 0
        for ts, ev in Recorder.load(path, decode):
            if timed and last_ts is not None:
                await asyncio.sleep(max(0.0, ts - last_ts))
            last_ts = ts
            apply(ev)
            n += 1
            if max_count is not None and n >= max_count:
                break
        return n
