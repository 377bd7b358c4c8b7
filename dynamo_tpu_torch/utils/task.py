"""Critical background tasks (port of dynamo_tpu/utils/task.py).

``spawn_tracked`` keeps a strong reference to a fire-and-forget task and
logs its exception the moment it dies (the event loop holds tasks only
weakly). ``CriticalTask`` runs a background function whose unexpected
failure cancels a parent token, so a dead keepalive loop takes the
runtime down instead of leaving it silently wedged.
"""

from __future__ import annotations

import asyncio
import logging
from typing import Awaitable, Callable

from dynamo_tpu_torch.runtime.engine import CancellationToken

logger = logging.getLogger(__name__)

_TRACKED: set[asyncio.Future] = set()


def _reap(task: asyncio.Future) -> None:
    _TRACKED.discard(task)
    if task.cancelled():
        return
    exc = task.exception()
    if exc is not None:
        logger.error("background task %s failed", task.get_name(), exc_info=exc)


def _prune_dead_loops() -> None:
    """Drop tasks whose event loop closed before they finished: their
    done callback never fires."""
    for t in list(_TRACKED):
        try:
            dead = t.get_loop().is_closed()
        except RuntimeError:
            dead = True
        if dead:
            _TRACKED.discard(t)


def spawn_tracked(aw, *, name: str | None = None) -> asyncio.Future:
    """Schedule ``aw`` (coroutine or future), hold it until it finishes,
    and log its exception when it dies."""
    _prune_dead_loops()
    task = asyncio.ensure_future(aw)
    if name is not None:
        task.set_name(name)
    if not task.done():
        _TRACKED.add(task)
    task.add_done_callback(_reap)
    return task


class CriticalTask:
    """Run ``fn(token)`` in the background; if it raises, cancel the
    parent token. Returning is a graceful exit."""

    def __init__(
        self,
        fn: Callable[[CancellationToken], Awaitable[None]],
        parent_token: CancellationToken,
        name: str = "critical-task",
    ) -> None:
        self.name = name
        self._parent = parent_token
        self._token = parent_token.child_token()
        self._task = asyncio.ensure_future(self._run(fn))

    async def _run(self, fn) -> None:
        try:
            await fn(self._token)
        except asyncio.CancelledError:
            pass
        except Exception:
            logger.exception("critical task %r failed; cancelling runtime", self.name)
            self._parent.cancel()

    async def join(self) -> None:
        try:
            await self._task
        except asyncio.CancelledError:
            pass
