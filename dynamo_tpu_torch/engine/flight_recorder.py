"""Engine step flight recorder: a black box for postmortems (port of
dynamo_tpu/engine/flight_recorder.py, same record fields).

Per-step batch composition is the unified step's central performance
variable; without a record of it, a latency spike or an engine fault
leaves no evidence of what the steps around it looked like. The flight
recorder is a bounded
in-memory ring of per-dispatch records — step kind ("unified", or
"spec" for a draft-verify dispatch, which additionally carries its
drafted/accepted token split), token counts, batch fill ratio, dispatch
duration, the compile-stall and shed/deadline counters at that instant —
cheap enough to run always-on (one dict append per dispatch, no I/O).

Two ways out of the ring:

- live: ``/debug/steps?n=N`` (llm/http_service.py) returns the last N
  records while the engine serves (the worker's ``--health-port`` too);
- postmortem: the engine loop's top-level catch calls ``dump_fault()``,
  flushing the whole ring plus the fault reason to a JSON file under
  ``EngineConfig.flight_record_dir`` (or ``$DYNTPU_FLIGHT_DIR``) before
  the engine dies — the steps leading INTO the fault survive it.

Thread model: the engine thread writes, HTTP handlers read — every
access takes the (uncontended) lock, and records are plain dicts copied
out at snapshot time.
"""

from __future__ import annotations

import json
import logging
import os
import time
from collections import deque
from typing import Any

from dynamo_tpu_torch.utils.atomic_io import atomic_write_text
from dynamo_tpu_torch.utils.concurrency import make_lock

logger = logging.getLogger(__name__)

DEFAULT_CAPACITY = 512


class FlightRecorder:
    def __init__(
        self, capacity: int = DEFAULT_CAPACITY, dump_dir: str | None = None
    ) -> None:
        self._lock = make_lock("flight.ring")
        self._ring: deque[dict[str, Any]] = deque(maxlen=max(8, capacity))
        self._seq = 0  # every ring record (steps AND events)
        self._steps = 0  # dispatches only — what total_steps reports
        self.dump_dir = dump_dir or os.environ.get("DYNTPU_FLIGHT_DIR")
        self.dumped_path: str | None = None  # last fault dump (tests/ops)

    def note_step(
        self,
        kind: str,
        *,
        decode_tokens: int = 0,
        prefill_tokens: int = 0,
        batch_fill_ratio: float = 0.0,
        dispatch_ms: float = 0.0,
        lanes: int = 0,
        inflight_depth: int = 0,
        waiting: int = 0,
        running: int = 0,
        compile_stall_ms_total: float = 0.0,
        mid_traffic_compiles_total: int = 0,
        shed_total: int = 0,
        deadline_total: int = 0,
        quantum: int = 0,
        itl_ema_ms: float = 0.0,
        headroom_ms: float = 0.0,
        drafted: int = 0,
        accepted: int = 0,
    ) -> None:
        """One dispatch's record. Counter fields are the process totals
        AT the step, so a reader diffs adjacent records to see exactly
        which step paid a compile stall or shed load. The co-location
        fields (quantum / itl_ema_ms / headroom_ms — engine/coloc.py)
        let a trace_merge timeline attribute an ITL spike to the quantum
        decision that caused it. ``kind="spec"`` records (unified
        draft-verify dispatches) carry the drafted/accepted token
        split — the per-step acceptance evidence next to the cumulative
        spec counters on the metric surfaces."""
        rec = {
            "t_unix": round(time.time(), 6),
            "kind": kind,
            "decode_tokens": decode_tokens,
            "prefill_tokens": prefill_tokens,
            "batch_fill_ratio": round(batch_fill_ratio, 4),
            "dispatch_ms": round(dispatch_ms, 3),
            "lanes": lanes,
            "drafted": drafted,
            "accepted": accepted,
            "inflight_depth": inflight_depth,
            "waiting": waiting,
            "running": running,
            "compile_stall_ms_total": round(compile_stall_ms_total, 1),
            "mid_traffic_compiles_total": mid_traffic_compiles_total,
            "shed_total": shed_total,
            "deadline_total": deadline_total,
            "quantum": quantum,
            "itl_ema_ms": round(itl_ema_ms, 3),
            "headroom_ms": round(headroom_ms, 3),
        }
        with self._lock:
            self._seq += 1
            self._steps += 1
            rec["seq"] = self._seq
            self._ring.append(rec)

    def note_event(self, kind: str, **fields: Any) -> None:
        """Out-of-band event in the same timeline (engine fault, drain,
        degradation) — rides the ring between step records."""
        rec = {"t_unix": round(time.time(), 6), "kind": kind, **fields}
        with self._lock:
            self._seq += 1
            rec["seq"] = self._seq
            self._ring.append(rec)

    def snapshot(self, n: int | None = None) -> list[dict[str, Any]]:
        """The last ``n`` records (all with ``n=None``), oldest first."""
        with self._lock:
            records = list(self._ring)
        if n is not None:
            # n<=0 asks for nothing — falling through would return the
            # WHOLE ring (/debug/steps?n=0 dumping 512 records).
            records = records[-n:] if n > 0 else []
        return records

    @property
    def total_steps(self) -> int:
        """Dispatches recorded — events (fault/drain notes) ride the
        ring and bump ``seq`` but are not steps."""
        with self._lock:
            return self._steps

    def dump(self, path: str, reason: str = "") -> str:
        """Flush the ring to ``path`` as one JSON document."""
        doc = {
            "reason": reason,
            "dumped_unix": time.time(),
            "pid": os.getpid(),
            "records": self.snapshot(),
        }
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        # Atomic: a dump raced by the crash it documents must never
        # leave torn JSON for the post-mortem tooling to choke on.
        atomic_write_text(path, json.dumps(doc))
        return path

    def dump_fault(self, reason: str) -> str | None:
        """Fault-path dump: never raises (the engine is already dying —
        the black box must not mask the original fault). Returns the
        written path, or None when no dump dir is configured or the
        write itself failed."""
        d = self.dump_dir
        if not d:
            return None
        path = os.path.join(
            d, f"flight_{os.getpid()}_{int(time.time())}.json"
        )
        try:
            self.note_event("fault", reason=reason[:500])
            self.dumped_path = self.dump(path, reason=reason[:500])
            logger.error("engine fault: flight record dumped to %s", path)
            return self.dumped_path
        except Exception:  # noqa: BLE001 — best-effort; the original fault must surface
            logger.exception("flight-record dump failed")
            return None
