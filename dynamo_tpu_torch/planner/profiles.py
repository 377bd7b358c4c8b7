"""Perf profiles: measured TTFT/ITL-against-load curves for SLA scaling
(port of dynamo_tpu/planner/profiles.py).

A ``PerfProfile`` holds (concurrency, TTFT p50, ITL p50) points of one
worker and answers "how many concurrent requests can one worker carry
inside the SLA", which turns observed load into a worker count
(``target_workers``). ``from_bench_json`` reads a bench output line's
``extras.sweep``: the same format as the JAX package's, so one profile
file serves both planners.
"""

from __future__ import annotations

import json
import math
from dataclasses import dataclass
from pathlib import Path


@dataclass(frozen=True)
class PerfPoint:
    concurrency: int
    ttft_ms: float
    itl_ms: float


class PerfProfile:
    def __init__(self, points: list[PerfPoint]) -> None:
        if not points:
            raise ValueError("profile needs at least one measured point")
        self.points = sorted(points, key=lambda p: p.concurrency)

    @staticmethod
    def from_bench_json(path: str | Path) -> "PerfProfile":
        """Build from a bench output line (``extras.sweep``)."""
        d = json.loads(Path(path).read_text())
        sweep = (d.get("extras") or {}).get("sweep") or []
        points = [
            PerfPoint(
                concurrency=int(lvl["concurrency"]),
                ttft_ms=float(lvl["p50_ttft_ms"]),
                itl_ms=float(lvl["p50_itl_ms"]),
            )
            for lvl in sweep
            # Smoke/short runs can emit null percentiles (a level where no
            # request produced the metric) — skip those levels.
            if lvl.get("p50_ttft_ms") is not None
            and lvl.get("p50_itl_ms") is not None
        ]
        if not points:
            raise ValueError(
                f"{path}: no usable sweep levels (extras.sweep missing or "
                f"all percentiles null)"
            )
        return PerfProfile(points)

    def _interp(self, c: float, attr: str) -> float:
        """Piecewise-linear metric estimate at concurrency `c` (clamped to
        the measured range; past the last point, extrapolate along the
        final segment — load beyond what was measured only gets worse)."""
        pts = self.points
        if c <= pts[0].concurrency:
            return getattr(pts[0], attr)
        for lo, hi in zip(pts, pts[1:]):
            if c <= hi.concurrency:
                f = (c - lo.concurrency) / (hi.concurrency - lo.concurrency)
                return getattr(lo, attr) + f * (
                    getattr(hi, attr) - getattr(lo, attr)
                )
        if len(pts) == 1:
            return getattr(pts[0], attr)
        lo, hi = pts[-2], pts[-1]
        slope = (getattr(hi, attr) - getattr(lo, attr)) / (
            hi.concurrency - lo.concurrency
        )
        return getattr(hi, attr) + slope * (c - hi.concurrency)

    def ttft_ms(self, concurrency: float) -> float:
        return self._interp(concurrency, "ttft_ms")

    def itl_ms(self, concurrency: float) -> float:
        return self._interp(concurrency, "itl_ms")

    def max_concurrency_within(
        self,
        ttft_sla_ms: float | None = None,
        itl_sla_ms: float | None = None,
    ) -> float:
        """Highest per-worker concurrency meeting every given SLA bound
        (binary search over the interpolated curves; both curves are
        treated as non-decreasing in load). At least 1.0 — a worker can
        always serve one request, however slowly."""
        if ttft_sla_ms is None and itl_sla_ms is None:
            return float(self.points[-1].concurrency)

        def ok(c: float) -> bool:
            if ttft_sla_ms is not None and self.ttft_ms(c) > ttft_sla_ms:
                return False
            if itl_sla_ms is not None and self.itl_ms(c) > itl_sla_ms:
                return False
            return True

        lo, hi = 1.0, float(self.points[-1].concurrency) * 2.0
        if not ok(lo):
            return 1.0
        if ok(hi):
            return hi
        for _ in range(40):
            mid = (lo + hi) / 2
            if ok(mid):
                lo = mid
            else:
                hi = mid
        return lo

    def target_workers(
        self,
        observed_load: float,
        ttft_sla_ms: float | None = None,
        itl_sla_ms: float | None = None,
    ) -> int:
        """Workers needed so per-worker load stays within the SLA envelope
        (replicas = load / per-replica capacity at the SLA point)."""
        cap = self.max_concurrency_within(ttft_sla_ms, itl_sla_ms)
        # The capacity search converges from below (7.999...); the epsilon
        # keeps an exact-boundary load from rounding up a spurious worker.
        return max(1, math.ceil(observed_load / cap - 1e-6))
