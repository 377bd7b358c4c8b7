"""On-demand profiling windows on ``torch.profiler`` (port of
dynamo_tpu/utils/profiling.py, whose windows are ``jax.profiler``'s).

A serving worker must be profilable without a restart: the
``/debug/profile?seconds=N`` endpoint (llm/http_service.py) and the
control-plane profile verb (runtime/debug.py) both funnel into one
``Profiler`` that runs ``torch.profiler`` with CPU and CUDA activities
around an async sleep — the engine keeps serving while the window
captures — and exports a Chrome trace (``trace.json``, viewable in
Perfetto or chrome://tracing) into a fresh directory under the
configured one.

What the window sees:

- every thread's CPU ops (the engine thread's among them): the window
  asks for Kineto's ``profile_all_threads`` (without it a window started
  on the HTTP loop records that thread's ops only);
- the card's kernels through CUPTI, those of replayed CUDA graphs
  included; the result counts them (``device_events``).

Safety rails (the reference's):

- the output directory is FIXED at construction (``--profile-dir`` /
  ``$DYNTPU_PROFILE_DIR``); callers choose a window length, never a
  path;
- an unconfigured profiler refuses to capture (the endpoint answers
  503), and so does a process without a CUDA device: the window traces
  the card or nothing, never an empty trace reported as a success;
- windows are single-flight (409 while one runs) and capped at
  ``max_seconds``.
"""

from __future__ import annotations

import asyncio
import logging
import os
import time

logger = logging.getLogger(__name__)

DEFAULT_MAX_SECONDS = 60.0
TRACE_FILE = "trace.json"


class ProfileError(RuntimeError):
    """Capture refused: unconfigured, busy, or no device to trace. The
    HTTP layer maps this to 503/409, never a 500."""

    def __init__(self, message: str, busy: bool = False) -> None:
        super().__init__(message)
        self.busy = busy


class Profiler:
    def __init__(
        self,
        base_dir: str | None = None,
        max_seconds: float = DEFAULT_MAX_SECONDS,
    ) -> None:
        self.base_dir = base_dir or os.environ.get("DYNTPU_PROFILE_DIR")
        self.max_seconds = max_seconds
        self._busy = False
        self._prof = None
        self.captures = 0  # completed windows

    @property
    def configured(self) -> bool:
        return bool(self.base_dir)

    @property
    def busy(self) -> bool:
        return self._busy

    async def capture(self, seconds: float) -> dict:
        """One profiling window. Returns {"path", "seconds", "trace",
        "device_events"}; raises ProfileError when refused or when the
        window produced no trace."""
        if not self.configured:
            raise ProfileError(
                "profiling not configured — set --profile-dir / "
                "DYNTPU_PROFILE_DIR on this worker"
            )
        if self._busy:
            raise ProfileError("a profile window is already running", busy=True)
        seconds = min(max(0.1, float(seconds)), self.max_seconds)
        out = os.path.join(
            self.base_dir, f"profile_{os.getpid()}_{int(time.time() * 1000)}"
        )
        self._busy = True
        try:
            # Any setup failure (unwritable dir, a profiler already
            # running process-wide) is a ProfileError: the endpoint's
            # contract is 503/409, never a 500.
            try:
                os.makedirs(out, exist_ok=True)
                started = self._start(out)
            except ProfileError:
                raise
            except Exception as exc:  # noqa: BLE001 — keep the contract
                raise ProfileError(f"profiler start failed: {exc}") from exc
            result: dict = {}
            try:
                await asyncio.sleep(seconds)
            finally:
                if started:
                    try:
                        result = self._stop()
                    except ProfileError:
                        raise
                    except Exception as exc:  # noqa: BLE001 — keep the contract
                        raise ProfileError(f"profiler stop failed: {exc}") from exc
        finally:
            self._busy = False
        self.captures += 1
        logger.info("profile window (%.1fs) captured to %s", seconds, out)
        return {"path": out, "seconds": seconds, **result}

    # Split so tests can stub the torch halves without a device.
    def _start(self, out: str) -> bool:
        import torch
        from torch._C._profiler import _ExperimentalConfig
        from torch.profiler import ProfilerActivity, profile

        if not torch.cuda.is_available():
            raise ProfileError(
                "no CUDA device in this process: the profile window traces "
                "the card's kernels"
            )
        self._out = out
        self._prof = profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
            experimental_config=_ExperimentalConfig(profile_all_threads=True),
        )
        self._prof.start()
        return True

    def _stop(self) -> dict:
        """Stop the window and export its Chrome trace; the device events
        it holds are counted (a replayed graph's kernels among them)."""
        prof, self._prof = self._prof, None
        prof.stop()
        path = os.path.join(self._out, TRACE_FILE)
        prof.export_chrome_trace(path)
        if not os.path.exists(path) or os.path.getsize(path) == 0:
            raise ProfileError(f"profile window exported no trace at {path}")
        device_events = sum(
            1 for e in prof.events() if str(e.device_type).endswith("CUDA")
        )
        return {"trace": path, "device_events": device_events}
