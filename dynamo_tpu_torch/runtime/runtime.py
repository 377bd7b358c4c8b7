"""Runtime and Worker harness (port of dynamo_tpu/runtime/runtime.py).

The reference `Runtime` owns the async executor and the root cancellation
token; `Worker` is the main() harness wiring SIGINT/SIGTERM to graceful
shutdown (reference: lib/runtime/src/lib.rs:66-73, worker.rs:16-66). Our
Runtime owns the asyncio loop's root token; everything long-lived hangs a
child token (or a CriticalTask) off it.
"""

from __future__ import annotations

import asyncio
import logging
import signal
from typing import Awaitable, Callable

from dynamo_tpu_torch.runtime.engine import CancellationToken
from dynamo_tpu_torch.utils.logging import init_logging

logger = logging.getLogger(__name__)


class Runtime:
    """Process-wide runtime: root cancellation token + background tasks."""

    def __init__(self) -> None:
        self._token = CancellationToken()

    def child_token(self) -> CancellationToken:
        return self._token.child_token()

    @property
    def token(self) -> CancellationToken:
        return self._token

    def shutdown(self) -> None:
        logger.info("runtime shutdown requested")
        self._token.cancel()

    @property
    def is_shutdown(self) -> bool:
        return self._token.is_cancelled()


class Worker:
    """Main harness: run an async entrypoint under a Runtime with signal
    handling; the entrypoint receives the Runtime and should exit when its
    token cancels."""

    def __init__(self) -> None:
        init_logging()

    def execute(self, main: Callable[[Runtime], Awaitable[None]]) -> None:
        asyncio.run(self._run(main))

    async def _run(self, main: Callable[[Runtime], Awaitable[None]]) -> None:
        runtime = Runtime()
        loop = asyncio.get_running_loop()
        for sig in (signal.SIGINT, signal.SIGTERM):
            try:
                loop.add_signal_handler(sig, runtime.shutdown)
            except NotImplementedError:  # non-unix / nested loops
                pass
        try:
            await main(runtime)
        finally:
            runtime.shutdown()
