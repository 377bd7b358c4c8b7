"""Opt-in runtime concurrency checker: thread affinity and lock order
(port of dynamo_tpu/utils/concurrency.py).

What only an execution can show — an object touched from the wrong
thread, two locks taken in inverted order — checked with no cost when
off, so the instrumentation stays wired into the serving code.

Enable with ``DYNTPU_CHECK_THREADS=1`` (read at import; tests flip it
via :func:`refresh_enabled`). When off:

- :func:`make_lock` returns a plain ``threading.Lock``: the serving
  locks built through it pay nothing;
- :func:`assert_context` / :func:`bind_thread` return at once;
- :func:`owned_by` returns the decorated function unchanged (no wrapper
  frame) when disabled at decoration time.

Thread affinity: threads *bind* to a named execution context
(``engine``, ``loop``, ``worker``, …) and ``assert_context`` checks the
calling thread's binding. An unbound thread always passes: the checker
judges only what it was told, so a partial wiring raises no false alarm
from unrelated threads.

Lock order: locks made by ``make_lock(name)`` (or wrapped in
``TrackedLock``) record, per thread, the stack of tracked locks held.
Acquiring ``B`` while holding ``A`` records the edge ``A→B`` with the
acquiring stack; if the opposite edge was ever seen — from any thread,
at any earlier time in the process — :class:`LockOrderError` raises with
both stacks. A deadlock that needs an unlucky interleaving becomes a
failure on the first run that takes both orders.

The port's engine crosses threads on the card: the engine thread, the
event loop, the KVBM pump and offload workers, and the device channel
between two engines' threads. The named locks are ``tracer``,
``flight.ring``, ``recorder.write``, ``route_obs``, ``planner_obs``,
``kvbm.pool`` and ``compile.{stats,cache,manifest}``.
"""

from __future__ import annotations

import os
import threading
import traceback
from typing import Any, Callable

__all__ = [
    "LockOrderError",
    "ThreadAffinityError",
    "TrackedLock",
    "assert_context",
    "bind_thread",
    "bound",
    "checks_enabled",
    "current_context",
    "make_lock",
    "owned_by",
    "refresh_enabled",
    "reset_tracking",
]

_ENV = "DYNTPU_CHECK_THREADS"


class ThreadAffinityError(AssertionError):
    """An object/context was touched from a thread bound elsewhere."""


class LockOrderError(AssertionError):
    """Two tracked locks were observed acquired in both orders."""


def _read_env() -> bool:
    return os.environ.get(_ENV, "") not in ("", "0", "false", "no")


_enabled = _read_env()

_tls = threading.local()

# Observed acquisition order: (held_name, acquired_name) -> summary of
# the stack that first recorded the edge. Guarded by _graph_lock (plain
# threading.Lock — the tracker must not track itself).
_graph_lock = threading.Lock()
_edges: dict[tuple[str, str], str] = {}


def checks_enabled() -> bool:
    return _enabled


def refresh_enabled() -> bool:
    """Re-read the env var (test fixtures flip it after import)."""
    global _enabled
    _enabled = _read_env()
    return _enabled


def reset_tracking() -> None:
    """Drop all observed lock-order edges (test isolation only)."""
    with _graph_lock:
        _edges.clear()


# -- thread affinity ---------------------------------------------------------

def bind_thread(context: str) -> None:
    """Bind the calling thread to a named execution context. Cheap and
    idempotent; rebinding overwrites (executor threads are reused)."""
    if not _enabled:
        return
    _tls.context = context


def current_context() -> str | None:
    return getattr(_tls, "context", None)


class bound:
    """``with bound("worker"):`` — bind for a scope, restore on exit.
    For to_thread/executor bodies, where the thread outlives the task."""

    def __init__(self, context: str) -> None:
        self._context = context
        self._prev: str | None = None

    def __enter__(self) -> "bound":
        if _enabled:
            self._prev = current_context()
            _tls.context = self._context
        return self

    def __exit__(self, *exc: object) -> None:
        if _enabled:
            _tls.context = self._prev


def assert_context(*allowed: str, what: str = "") -> None:
    """Raise :class:`ThreadAffinityError` when the calling thread is
    bound to a context not in ``allowed``. Unbound threads pass (the
    checker only judges threads it was told about); disabled ⇒ no-op."""
    if not _enabled:
        return
    ctx = current_context()
    if ctx is None or ctx in allowed:
        return
    subject = what or "this code"
    raise ThreadAffinityError(
        f"{subject} ran in context {ctx!r} "
        f"(thread {threading.current_thread().name!r}) but is owned by "
        f"{' / '.join(repr(a) for a in allowed)}"
    )


def owned_by(*contexts: str, what: str = "") -> Callable:
    """Decorator form of :func:`assert_context`. When the checker is
    disabled at decoration time the function is returned UNCHANGED —
    zero wrapper overhead in the common (off) case, which is why
    production hot paths prefer an inline ``assert_context`` (it also
    honors a later :func:`refresh_enabled`)."""

    def deco(fn: Callable) -> Callable:
        if not _enabled:
            return fn
        label = what or getattr(fn, "__qualname__", repr(fn))

        def wrapper(*args: Any, **kwargs: Any) -> Any:
            assert_context(*contexts, what=label)
            return fn(*args, **kwargs)

        wrapper.__name__ = getattr(fn, "__name__", "wrapped")
        wrapper.__qualname__ = getattr(fn, "__qualname__", "wrapped")
        wrapper.__doc__ = fn.__doc__
        wrapper.__wrapped__ = fn
        return wrapper

    return deco


# -- lock-order tracking -----------------------------------------------------

def _held_stack() -> list[str]:
    stack = getattr(_tls, "locks", None)
    if stack is None:
        stack = _tls.locks = []
    return stack


def _brief_stack(skip: int = 3, limit: int = 6) -> str:
    frames = traceback.extract_stack()[:-skip]
    return " <- ".join(
        f"{os.path.basename(f.filename)}:{f.lineno}:{f.name}"
        for f in frames[-limit:]
    )


class TrackedLock:
    """A ``threading.Lock`` that feeds the process-wide order graph.

    Not reentrant (neither is the lock it wraps); acquiring a tracked
    lock already held by the calling thread raises :class:`LockOrderError`
    immediately instead of deadlocking silently."""

    def __init__(self, name: str, lock: Any | None = None) -> None:
        self.name = name
        self._lock = lock if lock is not None else threading.Lock()

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        held = _held_stack()
        if self.name in held:
            raise LockOrderError(
                f"nested reacquisition of tracked lock {self.name!r} "
                f"(held: {held}) — deadlock for a non-reentrant lock\n"
                f"  at: {_brief_stack()}"
            )
        for outer in held:
            edge = (outer, self.name)
            inverse = (self.name, outer)
            with _graph_lock:
                first_inverse = _edges.get(inverse)
                if edge not in _edges:
                    _edges[edge] = _brief_stack()
            if first_inverse is not None:
                raise LockOrderError(
                    f"lock-order inversion: acquiring {self.name!r} while "
                    f"holding {outer!r}, but the opposite order was "
                    f"observed earlier\n"
                    f"  this order:  {_brief_stack()}\n"
                    f"  other order: {first_inverse}"
                )
        ok = self._lock.acquire(blocking, timeout)
        if ok:
            held.append(self.name)
        return ok

    def release(self) -> None:
        held = _held_stack()
        if self.name in held:
            held.remove(self.name)
        self._lock.release()

    def locked(self) -> bool:
        return self._lock.locked()

    def __enter__(self) -> "TrackedLock":
        self.acquire()
        return self

    def __exit__(self, *exc: object) -> None:
        self.release()


def make_lock(name: str):
    """The production seam: a named lock that is plain when the checker
    is off and tracked when it is on. Serving code creates its locks
    through this so enabling ``DYNTPU_CHECK_THREADS=1`` instruments the
    real lock graph with no code change."""
    if _enabled:
        return TrackedLock(name)
    return threading.Lock()
