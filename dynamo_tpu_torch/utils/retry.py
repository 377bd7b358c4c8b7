"""One retry/backoff policy for the runtime plane's seams (port of
dynamo_tpu/utils/retry.py).

``RetryPolicy``: jittered exponential backoff under both an attempt
budget and a wall-clock deadline, with an explicit retryable-exception
filter. Every retry is counted per seam in ``RETRIES``
(``retries_total``): silent retries hide dying links.
"""

from __future__ import annotations

import asyncio
import logging
import random
import threading
import time
from dataclasses import dataclass
from typing import Awaitable, Callable, TypeVar

logger = logging.getLogger(__name__)

T = TypeVar("T")

# Transport loss every plane agrees is worth a retry; injected
# FaultErrors count through their ConnectionError parentage.
DEFAULT_RETRYABLE: tuple[type[BaseException], ...] = (
    ConnectionError,
    TimeoutError,
    asyncio.TimeoutError,
    asyncio.IncompleteReadError,
    OSError,
)


class RetryCounter:
    """Thread-safe per-seam retry accounting (``retries_total``)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.by_seam: dict[str, int] = {}

    def note(self, seam: str) -> None:
        with self._lock:
            self.by_seam[seam] = self.by_seam.get(seam, 0) + 1

    @property
    def total(self) -> int:
        with self._lock:
            return sum(self.by_seam.values())

    def snapshot(self) -> dict[str, int]:
        with self._lock:
            return dict(self.by_seam)


RETRIES = RetryCounter()


@dataclass(frozen=True)
class RetryPolicy:
    """``attempts`` counts total tries (1 = no retry); ``deadline_s``
    caps the whole operation including backoff sleeps."""

    attempts: int = 3
    base_delay_s: float = 0.05
    max_delay_s: float = 2.0
    multiplier: float = 2.0
    jitter: float = 0.5           # ± fraction of the computed delay
    deadline_s: float | None = None
    retryable: tuple[type[BaseException], ...] = DEFAULT_RETRYABLE

    def is_retryable(self, exc: BaseException) -> bool:
        if isinstance(exc, asyncio.CancelledError):
            return False
        return isinstance(exc, self.retryable)

    def delay_for(self, attempt: int) -> float:
        """Backoff before try ``attempt + 1`` (0-indexed)."""
        d = min(self.base_delay_s * (self.multiplier ** attempt), self.max_delay_s)
        if self.jitter:
            d *= 1.0 + self.jitter * (2.0 * random.random() - 1.0)
        return max(0.0, d)


# A worker may start before the control plane has bound its port: ride
# out ~19 s of backoff across 8 dials, capped by the deadline.
CONTROL_CONNECT = RetryPolicy(
    attempts=8, base_delay_s=0.3, max_delay_s=5.0, deadline_s=30.0
)


# The KV push: its whole retried send (ack waits included) stays under
# the decode side's remote_kv_timeout_s default (30 s). Queue redelivery:
# the prefill worker's requeue budget. Block import: a G4 peer pull (a
# read-only prefix fetch, so a clean re-request is always safe).
TRANSFER = RetryPolicy(
    attempts=3, base_delay_s=0.05, max_delay_s=1.0, deadline_s=25.0
)
QUEUE_REDELIVERY = RetryPolicy(attempts=3, base_delay_s=0.05, max_delay_s=0.5)
BLOCK_IMPORT = RetryPolicy(attempts=3, base_delay_s=0.1, max_delay_s=1.0)


async def retry_async(
    fn: Callable[[], Awaitable[T]],
    policy: RetryPolicy = RetryPolicy(),
    seam: str = "unnamed",
    on_retry: Callable[[BaseException, int], None] | None = None,
) -> T:
    """Run ``fn`` under ``policy``; re-raise the last failure when it is
    not retryable or a budget is spent. ``on_retry(exc, attempt)`` runs
    before each backoff sleep (e.g. to drop a cached connection)."""
    start = time.monotonic()
    for attempt in range(policy.attempts):
        try:
            return await fn()
        except BaseException as exc:  # noqa: BLE001 — filtered below
            if not policy.is_retryable(exc) or attempt + 1 >= policy.attempts:
                raise
            delay = policy.delay_for(attempt)
            if (policy.deadline_s is not None
                    and time.monotonic() - start + delay > policy.deadline_s):
                raise
            RETRIES.note(seam)
            if on_retry is not None:
                on_retry(exc, attempt)
            logger.warning(
                "%s failed (attempt %d/%d): %r — retrying in %.2fs",
                seam, attempt + 1, policy.attempts, exc, delay,
            )
            await asyncio.sleep(delay)
    raise AssertionError("unreachable: the loop exits by return or raise")
