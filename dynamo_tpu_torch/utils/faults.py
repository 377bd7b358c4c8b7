"""Fault-injection registry: named fault points on the runtime plane's
seams (port of dynamo_tpu/utils/faults.py, for the seams this slice has).

The recovery paths the runtime leans on — lease TTL ⇒ deregister, the
router's mark-dead fast path, mid-stream failover — are only trusted once
exercised: each seam calls ``FAULTS.maybe_fail_async(point)`` and a test
or an operator arms that point. Disarmed, a seam pays one dict-emptiness
check (``FAULTS.active``).

Actions:
- ``raise``     raise ``exc`` (default ``FaultError``, a ConnectionError
                so retry and failover filters treat it as transport loss)
                for the next ``times`` hits;
- ``delay``     sleep ``delay_s``, then proceed;
- ``drop``      ``maybe_fail_async`` returns False and the caller skips its
                side effect (a lost message); honoured only where the
                seam can skip (``bus.publish``, ``bus.broadcast``,
                ``indexer.apply``), inert and uncounted elsewhere;
- ``partition`` raise until the point is disarmed (``times`` ignored).

Arming: ``FAULTS.arm(...)`` in tests, or ``DYNAMO_TPU_FAULTS`` — a
comma-separated list of ``point[:action[:arg]]`` read when this module is
first imported (``arg`` is seconds for ``delay``, a trigger count
otherwise), e.g. ``DYNAMO_TPU_FAULTS="fleet.worker_kill:raise:1"``.

The instrumented points are ``KNOWN_FAULT_POINTS``; the reference's
stepcast points arrive with their slice.
"""

from __future__ import annotations

import asyncio
import logging
import os
import random
import threading
import time
from dataclasses import dataclass

logger = logging.getLogger(__name__)

#: Every instrumented fault point of the port:
#: ``bus.publish`` / ``bus.broadcast`` — the in-process bus (request and
#: events planes); ``control.call`` — every control-plane RPC;
#: ``control.keepalive`` — the lease keep-alive; ``tcp.respond`` — a
#: response-plane frame send; ``fleet.worker_kill`` — the router's
#: dispatch seam (the chosen worker is dead at dispatch);
#: ``indexer.apply`` — the KV router's radix-index consumer (a delay
#: keeps events pending, a drop loses one); ``disagg.send`` /
#: ``disagg.recv`` — a KV block push and its landing (a drop loses one
#: frame: the decode side degrades to local recompute); ``kvbm.pump`` —
#: the KVBM offer pump; ``kvbm.peer_pull`` — a G4 peer block fetch (an
#: armed raise is the serving peer dying mid-pull: the request completes
#: by local recompute, degraded, never hung); ``kvbm.corrupt_disk`` — G3
#: bytes mutated at the disk write; ``kvbm.corrupt_frame`` — KV bytes
#: mutated on the wire;
#: ``kvbm.torn_write`` — a G3 block or sidecar write cut short. The three
#: ``kvbm.corrupt_*``/``torn_write`` points take the payload mutators
#: ``flip`` and ``truncate`` (``FAULTS.corrupt``).
KNOWN_FAULT_POINTS: tuple[str, ...] = (
    "bus.publish",
    "bus.broadcast",
    "control.call",
    "control.keepalive",
    "tcp.respond",
    "fleet.worker_kill",
    "indexer.apply",
    "disagg.send",
    "disagg.recv",
    "kvbm.pump",
    "kvbm.peer_pull",
    "kvbm.corrupt_disk",
    "kvbm.corrupt_frame",
    "kvbm.torn_write",
)

_ACTIONS = ("raise", "delay", "drop", "partition", "flip", "truncate")


class FaultError(ConnectionError):
    """An injected failure. Subclasses ConnectionError so every retry /
    reconnect filter on the transport seams classifies it as retryable."""


@dataclass
class _ArmedFault:
    action: str = "raise"
    times: int | None = 1            # remaining triggers; None = unbounded
    probability: float = 1.0         # per-hit trigger probability
    delay_s: float = 0.0             # for action == "delay"
    exc: type[BaseException] = FaultError
    fired: int = 0


class FaultRegistry:
    """Process-wide registry of armed fault points + injection counters."""

    def __init__(self) -> None:
        self._armed: dict[str, _ArmedFault] = {}
        self._lock = threading.Lock()
        # point -> times injected; kept across disarm/clear.
        self.injected: dict[str, int] = {}

    def arm(
        self,
        point: str,
        action: str = "raise",
        times: int | None = 1,
        probability: float = 1.0,
        delay_s: float = 0.0,
        exc: type[BaseException] = FaultError,
    ) -> None:
        if action not in _ACTIONS:
            raise ValueError(f"unknown fault action {action!r}")
        with self._lock:
            self._armed[point] = _ArmedFault(
                action=action,
                times=None if action == "partition" else times,
                probability=probability,
                delay_s=delay_s,
                exc=exc,
            )
        logger.warning("fault point %s armed: %s", point, action)

    def disarm(self, point: str) -> None:
        with self._lock:
            self._armed.pop(point, None)

    def clear(self) -> None:
        """Disarm everything (counters are kept)."""
        with self._lock:
            self._armed.clear()

    def armed(self, point: str) -> bool:
        return point in self._armed

    @property
    def active(self) -> bool:
        """True when any point is armed: hot per-frame seams guard their
        await on this, so the disarmed path makes no coroutine."""
        return bool(self._armed)

    def _trigger(
        self, point: str, can_drop: bool, mutate: bool = False
    ) -> _ArmedFault | None:
        """One armed-state transition under the lock; the action runs
        outside it. A ``drop`` at a seam that cannot skip is inert, and so
        is a ``flip``/``truncate`` anywhere but a ``corrupt`` call site."""
        if not self._armed:
            return None
        with self._lock:
            f = self._armed.get(point)
            if f is None:
                return None
            if f.action == "drop" and not can_drop:
                return None
            if f.action in ("flip", "truncate") and not mutate:
                return None
            if f.probability < 1.0 and random.random() >= f.probability:
                return None
            f.fired += 1
            self.injected[point] = self.injected.get(point, 0) + 1
            if f.times is not None:
                f.times -= 1
                if f.times <= 0:
                    del self._armed[point]
            return f

    def maybe_fail(self, point: str, can_drop: bool = False) -> bool:
        """The blocking twin of ``maybe_fail_async`` (worker-thread seams):
        a ``delay`` sleeps the calling thread."""
        f = self._trigger(point, can_drop)
        if f is None:
            return True
        if f.action == "delay":
            time.sleep(f.delay_s)
            return True
        if f.action == "drop":
            return False
        raise f.exc(f"injected fault at {point}")

    def corrupt(self, point: str, data: bytes) -> bytes:
        """A payload seam: ``data`` unchanged when nothing fires, else a
        mutated copy — ``flip`` XORs one bit in the middle, ``truncate``
        keeps the first half. Other actions keep their meaning."""
        f = self._trigger(point, can_drop=False, mutate=True)
        if f is None:
            return data
        if f.action == "flip":
            if not data:
                return data
            buf = bytearray(data)
            buf[len(buf) // 2] ^= 0x01
            return bytes(buf)
        if f.action == "truncate":
            return data[: len(data) // 2]
        if f.action == "delay":
            time.sleep(f.delay_s)
            return data
        raise f.exc(f"injected fault at {point}")

    async def maybe_fail_async(self, point: str, can_drop: bool = False) -> bool:
        """One call per seam hit: True to proceed, False when an armed
        ``drop`` fired; raises for ``raise``/``partition``; sleeps
        (without blocking the loop) for ``delay``."""
        f = self._trigger(point, can_drop)
        if f is None:
            return True
        if f.action == "delay":
            await asyncio.sleep(f.delay_s)
            return True
        if f.action == "drop":
            return False
        raise f.exc(f"injected fault at {point}")

    @property
    def total_injected(self) -> int:
        with self._lock:
            return sum(self.injected.values())

    def snapshot(self) -> dict[str, int]:
        with self._lock:
            return dict(self.injected)


FAULTS = FaultRegistry()


def arm_from_env(registry: FaultRegistry, spec: str) -> None:
    """Arm ``point[:action[:arg]]`` entries; a malformed one is logged
    and skipped."""
    for entry in spec.split(","):
        entry = entry.strip()
        if not entry:
            continue
        parts = entry.split(":")
        point = parts[0]
        action = parts[1] if len(parts) > 1 else "raise"
        arg = parts[2] if len(parts) > 2 else None
        try:
            if action == "delay":
                registry.arm(point, action, times=None,
                             delay_s=float(arg) if arg else 0.1)
            else:
                registry.arm(point, action, times=int(arg) if arg else 1)
        except (ValueError, TypeError):
            logger.error("bad DYNAMO_TPU_FAULTS entry %r ignored", entry)


_env_spec = os.environ.get("DYNAMO_TPU_FAULTS")
if _env_spec:
    arm_from_env(FAULTS, _env_spec)
