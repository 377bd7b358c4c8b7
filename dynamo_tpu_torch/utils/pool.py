"""Generic async object pool (port of dynamo_tpu/utils/pool.py).

A bounded pool of reusable objects: ``acquire`` awaits a free item
(building one with the factory while under capacity) and returns a
``PoolGuard`` async context manager; leaving the guard returns the item,
and ``detach`` removes it for good (a broken connection, say), freeing
its slot for a fresh build.
"""

from __future__ import annotations

import asyncio
import inspect
import logging
from typing import Awaitable, Callable, Generic, TypeVar

from dynamo_tpu_torch.utils.task import spawn_tracked

logger = logging.getLogger(__name__)

T = TypeVar("T")


class PoolGuard(Generic[T]):
    """Holds one pooled item; return it by exiting the context (or calling
    ``release``), or drop it from the pool with ``detach``."""

    __slots__ = ("_pool", "item", "_done")

    def __init__(self, pool: "Pool[T]", item: T) -> None:
        self._pool = pool
        self.item = item
        self._done = False

    async def __aenter__(self) -> T:
        return self.item

    async def __aexit__(self, exc_type, exc, tb) -> None:
        self.release()

    def release(self) -> None:
        if not self._done:
            self._done = True
            self._pool._return(self.item)

    def detach(self) -> T:
        """Remove the item from the pool (its slot becomes buildable again);
        the caller owns teardown."""
        if not self._done:
            self._done = True
            self._pool._discard()
        return self.item


class Pool(Generic[T]):
    def __init__(
        self,
        factory: Callable[[], T | Awaitable[T]],
        capacity: int,
        reset: Callable[[T], None] | None = None,
    ) -> None:
        if capacity <= 0:
            raise ValueError("capacity must be positive")
        self._factory = factory
        self._capacity = capacity
        self._reset = reset
        self._idle: list[T] = []
        self._built = 0
        self._cond = asyncio.Condition()

    @property
    def size(self) -> int:
        """Objects currently existing (idle + acquired)."""
        return self._built

    @property
    def idle(self) -> int:
        return len(self._idle)

    async def acquire(self) -> PoolGuard[T]:
        async with self._cond:
            while True:
                if self._idle:
                    item = self._idle.pop()
                    if self._reset is not None:
                        try:
                            self._reset(item)
                        except Exception:
                            # Broken item: drop it (its slot becomes
                            # buildable) and try the next / build fresh.
                            logger.warning(
                                "pool reset failed; discarding item",
                                exc_info=True,
                            )
                            self._built -= 1
                            continue
                    return PoolGuard(self, item)
                if self._built < self._capacity:
                    self._built += 1  # reserve the slot before awaiting
                    break
                await self._cond.wait()
        try:
            made = self._factory()
            if inspect.isawaitable(made):
                made = await made
        except BaseException:
            async with self._cond:
                self._built -= 1
                self._cond.notify(1)
            raise
        return PoolGuard(self, made)

    def _return(self, item: T) -> None:
        self._idle.append(item)
        self._notify()

    def _discard(self) -> None:
        self._built -= 1
        self._notify()

    def _notify(self) -> None:
        async def kick() -> None:
            async with self._cond:
                self._cond.notify(1)

        try:
            asyncio.get_running_loop()
        except RuntimeError:
            return  # loop gone at teardown — nobody left to notify
        spawn_tracked(kick(), name="pool-notify")

    def drain(self) -> list[T]:
        """Remove and return all idle items (caller tears them down)."""
        items, self._idle = self._idle, []
        self._built -= len(items)
        self._notify()
        return items
