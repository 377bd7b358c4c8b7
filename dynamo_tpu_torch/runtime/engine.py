"""The streaming engine contract (port of dynamo_tpu/runtime/engine.py
and the cancellation tokens of dynamo_tpu/utils/cancellation.py).

``generate(request: Context) -> AsyncIterator[resp]``: a ``Context``
wraps the payload, the request id and the stop/kill signals.
"""

from __future__ import annotations

import asyncio
import logging
import uuid
from typing import (
    Any,
    AsyncIterator,
    Callable,
    Generic,
    Protocol,
    TypeVar,
    runtime_checkable,
)

T = TypeVar("T")
U = TypeVar("U")


class CancellationToken:
    """A cancellable token forming a tree: cancelling a parent cancels all
    descendants; cancelling a child leaves the parent alive."""

    def __init__(self, parent: "CancellationToken | None" = None) -> None:
        self._event = asyncio.Event()
        self._children: list[CancellationToken] = []
        self._callbacks: list[Callable[[], None]] = []
        if parent is not None:
            parent._children.append(self)
            if parent.is_cancelled():
                self.cancel()

    def child_token(self) -> "CancellationToken":
        return CancellationToken(parent=self)

    def is_cancelled(self) -> bool:
        return self._event.is_set()

    def cancel(self) -> None:
        if self._event.is_set():
            return
        self._event.set()
        for cb in self._callbacks:
            try:
                cb()
            except Exception:  # noqa: BLE001 — one callback must not stop the cascade
                logging.getLogger(__name__).exception("cancel callback failed")
        for child in self._children:
            child.cancel()

    def on_cancel(self, cb: Callable[[], None]) -> None:
        """Register a synchronous callback run once on cancellation (at
        once if already cancelled)."""
        if self.is_cancelled():
            cb()
        else:
            self._callbacks.append(cb)


class Context(Generic[T]):
    """Request envelope: payload + id + stop/kill signals + annotations.
    ``stop`` asks for a graceful end of generation; ``kill`` aborts."""

    __slots__ = ("payload", "id", "_stop", "_kill", "annotations")

    def __init__(
        self,
        payload: T,
        id: str | None = None,
        stop: CancellationToken | None = None,
        kill: CancellationToken | None = None,
        annotations: dict[str, Any] | None = None,
    ) -> None:
        self.payload = payload
        self.id = id or uuid.uuid4().hex
        self._stop = stop or CancellationToken()
        self._kill = kill or self._stop.child_token()
        self.annotations = annotations if annotations is not None else {}

    def map(self, payload: U) -> "Context[U]":
        """New payload, same identity/signals — the request-path transform."""
        return Context(
            payload, id=self.id, stop=self._stop, kill=self._kill,
            annotations=self.annotations,
        )

    def stop_generating(self) -> None:
        self._stop.cancel()

    def kill(self) -> None:
        self._stop.cancel()
        self._kill.cancel()

    @property
    def is_stopped(self) -> bool:
        return self._stop.is_cancelled()

    @property
    def is_killed(self) -> bool:
        return self._kill.is_cancelled()


@runtime_checkable
class AsyncEngine(Protocol):
    """Anything that turns one request into a stream of responses."""

    def generate(self, request: Context) -> AsyncIterator[Any]:
        ...
