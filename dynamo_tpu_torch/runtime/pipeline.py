"""Operator pipelines (port of dynamo_tpu/runtime/pipeline.py).

An Operator transforms the request on the way down and the response
stream on the way back up: ``generate(request, downstream)`` may change
the request, call ``downstream.generate(...)`` and transform or annotate
each item it yields.

- ``Pipeline.link(*ops, engine=...)`` — the linear chain; the composed
  object is itself an AsyncEngine.
- ``Segment(*ops)`` — a reusable operator fragment: segments ``link()``
  onto each other and end ``into(engine)``.
- ``Tap(on_request, on_response)`` — sees the request on the way down and
  every item on the way up without transforming either.

Not in this slice: ``Switch`` (request-path branching), which serves the
multimodal encode branch.
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from typing import Any, AsyncIterator, Callable

from dynamo_tpu_torch.runtime.engine import AsyncEngine, Context


class Operator(ABC):
    """A bidirectional pipeline stage."""

    @abstractmethod
    def generate(
        self, request: Context, downstream: AsyncEngine
    ) -> AsyncIterator[Any]:
        ...


class _Linked:
    """An Operator bound to its downstream engine; an AsyncEngine itself."""

    __slots__ = ("_op", "_next")

    def __init__(self, op: Operator, next_engine: AsyncEngine) -> None:
        self._op = op
        self._next = next_engine

    def generate(self, request: Context) -> AsyncIterator[Any]:
        return self._op.generate(request, self._next)


class Pipeline:
    """Compose ``ops`` in order onto ``engine``: ops[0] sees the request
    first."""

    def __init__(self, ops: list[Operator], engine: AsyncEngine) -> None:
        composed: AsyncEngine = engine
        for op in reversed(ops):
            composed = _Linked(op, composed)
        self._engine = composed

    @staticmethod
    def link(*ops: Operator, engine: AsyncEngine) -> "Pipeline":
        return Pipeline(list(ops), engine)

    def generate(self, request: Context) -> AsyncIterator[Any]:
        return self._engine.generate(request)


class Segment:
    """A reusable operator fragment. Segments hold no engine: ``a.link(b)``
    concatenates fragments and ``seg.into(engine)`` makes a Pipeline.
    Operators keep per-request state on the Context, never on
    themselves, so one segment may serve many pipelines."""

    def __init__(self, *ops: Operator) -> None:
        self.ops: tuple[Operator, ...] = tuple(ops)

    def link(self, other: "Segment | Operator") -> "Segment":
        more = other.ops if isinstance(other, Segment) else (other,)
        return Segment(*self.ops, *more)

    def into(self, engine: AsyncEngine) -> Pipeline:
        return Pipeline(list(self.ops), engine)


class Tap(Operator):
    """Observe both directions without transforming either."""

    def __init__(
        self,
        on_request: Callable[[Context], None] | None = None,
        on_response: Callable[[Context, Any], None] | None = None,
    ) -> None:
        self._on_request = on_request
        self._on_response = on_response

    async def generate(
        self, request: Context, downstream: AsyncEngine
    ) -> AsyncIterator[Any]:
        if self._on_request is not None:
            self._on_request(request)
        async for item in downstream.generate(request):
            if self._on_response is not None:
                self._on_response(request, item)
            yield item
