"""Control-plane drain verb (port of dynamo_tpu/runtime/drain.py).

A worker drains two ways: SIGTERM and an explicit control-plane verb.
Both funnel into the same in-process flow (cli.py ``_graceful_drain``):
stop admitting → deregister → finish in-flight → exit.

The verb rides the message bus as a broadcast on a per-component subject;
each worker subscribes at startup and fires its drain callback when a
message targets its lease (or every instance, ``lease_id: null``). The
broadcast is fire-and-forget: the authoritative sign that the drain
completed is the instance key vanishing from the discovery store, which
the initiator can watch.
"""

from __future__ import annotations

import asyncio
import logging

from dynamo_tpu_torch.runtime.transports import wire
from dynamo_tpu_torch.utils.task import spawn_tracked

logger = logging.getLogger(__name__)


def drain_subject(namespace: str, component: str) -> str:
    return f"{namespace}.{component}._drain"


async def request_drain(
    drt, namespace: str, component: str, lease_id: int | None = None
) -> None:
    """Ask instances of ``namespace.component`` to drain: one instance by
    lease id, or every instance with ``lease_id=None``."""
    await drt.bus.broadcast(
        drain_subject(namespace, component),
        wire.packb({"lease_id": lease_id}),
    )


async def watch_drain(
    drt, namespace: str, component: str, on_drain
) -> "DrainWatch":
    """Subscribe this process to the component's drain subject;
    ``on_drain()`` fires (once) when a drain message targets this
    process's primary lease or all instances."""
    sub = await drt.bus.subscribe(drain_subject(namespace, component))
    watch = DrainWatch(sub, drt.primary_lease_id, on_drain)
    watch.start()
    drt.runtime.token.on_cancel(sub.close)
    return watch


class DrainWatch:
    def __init__(self, sub, lease_id: int, on_drain) -> None:
        self._sub = sub
        self._lease_id = lease_id
        self._on_drain = on_drain
        self._task: asyncio.Task | None = None
        self.fired = False

    def start(self) -> None:
        self._task = spawn_tracked(self._pump(), name="drain-watch")

    async def _pump(self) -> None:
        try:
            async for raw in self._sub:
                try:
                    msg = wire.unpackb(raw)
                except (ValueError, TypeError):  # malformed frame: ignored, not fatal
                    logger.warning("malformed drain message ignored")
                    continue
                target = msg.get("lease_id")
                if target is not None and target != self._lease_id:
                    continue
                if not self.fired:
                    self.fired = True
                    logger.info(
                        "drain requested via control plane (lease %#x)",
                        self._lease_id,
                    )
                    self._on_drain()
        except asyncio.CancelledError:
            pass

    def close(self) -> None:
        self._sub.close()
        if self._task is not None:
            self._task.cancel()
