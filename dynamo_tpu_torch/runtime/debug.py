"""Control-plane debug verbs: on-demand profiling (port of
dynamo_tpu/runtime/debug.py, on the port's own MessagePack codec).

The drain verb's twin (runtime/drain.py): an operator captures a
profile window on a running worker without reaching its debug HTTP
endpoint. Workers with a profile directory subscribe to a per-component
``_profile`` subject at startup and run one ``utils/profiling.Profiler``
window when a message targets their lease (or all instances,
``lease_id: null``). Fire-and-forget, like drain: the trace lands in the
worker's profile directory and its log carries the path.
"""

from __future__ import annotations

import asyncio
import logging

from dynamo_tpu_torch.runtime.transports import wire
from dynamo_tpu_torch.utils.task import spawn_tracked

logger = logging.getLogger(__name__)


def profile_subject(namespace: str, component: str) -> str:
    return f"{namespace}.{component}._profile"


async def request_profile(
    drt,
    namespace: str,
    component: str,
    seconds: float = 5.0,
    lease_id: int | None = None,
) -> None:
    """Ask instances of ``namespace.component`` to capture a profile
    window: one instance by lease id, or every instance with
    ``lease_id=None``."""
    await drt.bus.broadcast(
        profile_subject(namespace, component),
        wire.packb({"lease_id": lease_id, "seconds": float(seconds)}),
    )


async def watch_profile(drt, namespace: str, component: str, profiler) -> "ProfileWatch":
    """Subscribe this process to the component's profile subject; each
    targeted message runs one ``profiler.capture(seconds)`` window (the
    profiler's single-flight and cap rails apply)."""
    sub = await drt.bus.subscribe(profile_subject(namespace, component))
    watch = ProfileWatch(sub, drt.primary_lease_id, profiler)
    watch.start()
    drt.runtime.token.on_cancel(sub.close)
    return watch


class ProfileWatch:
    def __init__(self, sub, lease_id: int, profiler) -> None:
        self._sub = sub
        self._lease_id = lease_id
        self._profiler = profiler
        self._task: asyncio.Task | None = None
        self.fired = 0

    def start(self) -> None:
        self._task = spawn_tracked(self._pump(), name="profile-watch")

    async def _pump(self) -> None:
        try:
            async for raw in self._sub:
                try:
                    msg = wire.unpackb(raw)
                    target = msg.get("lease_id")
                    if target is not None and target != self._lease_id:
                        continue
                    seconds = float(msg.get("seconds") or 5.0)
                except (ValueError, TypeError, AttributeError):
                    # A malformed frame or body must not kill the pump and
                    # disable profiling for the rest of the worker's life.
                    logger.warning("malformed profile message ignored")
                    continue
                self.fired += 1
                try:
                    result = await self._profiler.capture(seconds)
                    logger.info("control-plane profile window done: %s", result["path"])
                except Exception:  # noqa: BLE001 — a refused window is logged; fire-and-forget
                    logger.exception("control-plane profile window failed")
        except asyncio.CancelledError:
            pass

    def close(self) -> None:
        self._sub.close()
        if self._task is not None:
            self._task.cancel()
