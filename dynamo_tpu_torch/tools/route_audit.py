"""Close the predicted-vs-actual KV-reuse loop from trace captures (port
of benchmarks/route_audit.py, which imports the JAX package; this copy
reads the same record layout with the port's capture reader,
tools/trace_merge.py).

Two record kinds share the ``DYNTPU_TRACE`` capture:

- ``route``      router-side, at decision time (llm/kv_router/audit.py):
                 predicted ``overlap_blocks``, the candidate score field,
                 the indexer's event watermark, the metrics age, the
                 decision latency;
- ``kv_actual``  engine-side, at admission (engine/engine.py
                 ``_note_kv_actual``): blocks the request actually
                 reused, split by tier.

The tool joins them by trace id and reports the predicted-vs-actual
overlap error, how much of it falls on decisions made while the indexer
had events pending, and the per-worker and per-replica split.
``--assert`` is the gate: join rate >= ``--min-join``, orphan routes
(a route whose trace never produced an actual) <= ``--max-orphan-routes``
(default 0), at least one actual, and with ``--max-abs-p95`` every
replica's |error| p95 within the bound.

Usage:
    python -m dynamo_tpu_torch.tools.route_audit CAPTURE [CAPTURE ...]
        [--assert] [--min-join 0.95] [--max-orphan-routes 0] [--json]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from collections import defaultdict
from typing import Any

if __package__ in (None, ""):  # `python dynamo_tpu_torch/tools/route_audit.py`
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))))

from dynamo_tpu_torch.tools.trace_merge import _expand_captures, _pct
from dynamo_tpu_torch.utils.recorder import Recorder


def load_records(
    paths: list[str],
) -> tuple[list[dict], list[dict], list[dict]]:
    """All route / kv_actual / planner records across the capture set
    (pid-suffixed captures expand as trace_merge's do), and a planner's
    ``kind="planner"`` scale decisions, which share the capture."""
    routes: list[dict] = []
    actuals: list[dict] = []
    planner: list[dict] = []
    for path in _expand_captures(list(paths)):
        for _ts, rec in Recorder.load(path):
            kind = rec.get("kind")
            if kind == "route":
                routes.append(rec)
            elif kind == "kv_actual":
                actuals.append(rec)
            elif kind == "planner":
                planner.append(rec)
    return routes, actuals, planner


def _pctl(values: list[float], q: float) -> float:
    """Nearest-rank percentile over unsorted values (sorts, then reuses
    trace_merge's helper so the two tools can't drift)."""
    return _pct(sorted(values), q)


def join_report(
    routes: list[dict], actuals: list[dict], stale_pending_threshold: int = 1
) -> dict[str, Any]:
    """Join predicted↔actual by trace id and compute the audit report."""
    by_trace: dict[str, list[dict]] = defaultdict(list)
    for a in actuals:
        if a.get("trace"):
            by_trace[a["trace"]].append(a)

    joined: list[tuple[dict, dict]] = []
    orphan_routes: list[dict] = []
    for r in routes:
        hits = by_trace.get(r.get("trace") or "")
        if hits:
            # Disagg can produce one actual per executing process; the
            # prefill-side report (the one with reuse) wins — max total.
            best = max(
                hits,
                key=lambda a: a.get("device_blocks", 0)
                + a.get("host_blocks", 0)
                + a.get("disk_blocks", 0)
                + a.get("peer_blocks", 0),
            )
            joined.append((r, best))
        else:
            orphan_routes.append(r)

    joined_traces = {r.get("trace") for r, _ in joined}
    orphan_actuals = sum(
        1 for a in actuals if a.get("trace") and a["trace"] not in joined_traces
    )

    errors: list[float] = []
    abs_errors: list[float] = []
    stale_scored = 0
    stale_mispredicted = 0
    fresh_mispredicted = 0
    per_worker: dict[int, dict[str, float]] = defaultdict(
        lambda: {"routes": 0, "predicted_blocks": 0, "actual_blocks": 0}
    )
    # Per-router-replica error: a stale replica's mispredictions are
    # bounded as its own, not averaged away across warm siblings.
    per_replica_abs: dict[int, list[float]] = defaultdict(list)
    per_replica_routes: dict[int, int] = defaultdict(int)
    staleness_pending: list[float] = []
    decision_ms: list[float] = []
    for r in routes:
        per_replica_routes[int(r.get("replica_id", 0))] += 1
    for r, a in joined:
        actual = (
            a.get("device_blocks", 0)
            + a.get("host_blocks", 0)
            + a.get("disk_blocks", 0)
            + a.get("peer_blocks", 0)
        )
        err = r.get("overlap_blocks", 0) - actual
        errors.append(err)
        abs_errors.append(abs(err))
        per_replica_abs[int(r.get("replica_id", 0))].append(abs(err))
        pending = (r.get("indexer") or {}).get("pending", 0)
        staleness_pending.append(pending)
        decision_ms.append(r.get("decision_ms", 0.0))
        stale = pending >= stale_pending_threshold
        if stale:
            stale_scored += 1
        if err != 0:
            if stale:
                stale_mispredicted += 1
            else:
                fresh_mispredicted += 1
        w = per_worker[r.get("worker_id", -1)]
        w["routes"] += 1
        w["predicted_blocks"] += r.get("overlap_blocks", 0)
        w["actual_blocks"] += actual

    tiers = {
        "device_blocks": sum(a.get("device_blocks", 0) for _, a in joined),
        "host_blocks": sum(a.get("host_blocks", 0) for _, a in joined),
        "disk_blocks": sum(a.get("disk_blocks", 0) for _, a in joined),
        "peer_blocks": sum(a.get("peer_blocks", 0) for _, a in joined),
    }
    route_counts = [w["routes"] for w in per_worker.values()]
    mispredicted = stale_mispredicted + fresh_mispredicted
    return {
        "routes": len(routes),
        "actuals": len(actuals),
        "joined": len(joined),
        "join_rate": round(len(joined) / max(len(routes), 1), 4),
        "orphan_routes": len(orphan_routes),
        "orphan_actuals": orphan_actuals,
        "overlap_error": {
            "mean": round(sum(errors) / max(len(errors), 1), 3),
            "abs_p50": _pctl(abs_errors, 0.50),
            "abs_p95": _pctl(abs_errors, 0.95),
            "abs_max": max(abs_errors, default=0),
            "exact": sum(1 for e in errors if e == 0),
            "underpredicted": sum(1 for e in errors if e < 0),
            "overpredicted": sum(1 for e in errors if e > 0),
        },
        "staleness": {
            # Indexer event-watermark staleness at score time, and how
            # mispredictions split across stale vs fresh decisions.
            "pending_p50": _pctl(staleness_pending, 0.50),
            "pending_p99": _pctl(staleness_pending, 0.99),
            "pending_max": max(staleness_pending, default=0),
            "stale_scored": stale_scored,
            "mispredicted_total": mispredicted,
            "mispredicted_while_stale": stale_mispredicted,
            "mispredicted_while_fresh": fresh_mispredicted,
            "indexer_lag_p99_ms": max(
                ((r.get("indexer") or {}).get("lag_p99_ms", 0.0) for r in routes),
                default=0.0,
            ),
        },
        "decision_ms": {
            "p50": round(_pctl(decision_ms, 0.50), 3),
            "p95": round(_pctl(decision_ms, 0.95), 3),
        },
        "tier_split": tiers,
        "per_replica": {
            str(rid): {
                "routes": per_replica_routes[rid],
                "joined": len(per_replica_abs.get(rid, [])),
                "abs_p50": _pctl(per_replica_abs.get(rid, []), 0.50),
                "abs_p95": _pctl(per_replica_abs.get(rid, []), 0.95),
                "abs_max": max(per_replica_abs.get(rid, []), default=0),
                "exact": sum(
                    1 for e in per_replica_abs.get(rid, []) if e == 0
                ),
            }
            for rid in sorted(per_replica_routes)
        },
        "per_worker": {
            f"{wid:x}" if isinstance(wid, int) and wid >= 0 else str(wid): {
                "routes": int(w["routes"]),
                "predicted_blocks": int(w["predicted_blocks"]),
                "actual_blocks": int(w["actual_blocks"]),
            }
            for wid, w in sorted(per_worker.items(), key=lambda kv: str(kv[0]))
        },
        "balance": {
            "min_routes": min(route_counts, default=0),
            "max_routes": max(route_counts, default=0),
            "workers": len(per_worker),
        },
    }


def run_asserts(
    report: dict, min_join: float, max_orphan_routes: int = 0,
    max_abs_p95: float | None = None,
) -> list[str]:
    """The gates; returns the list of failures (empty = all hold)."""
    failures: list[str] = []
    if report["routes"] == 0:
        failures.append("no route records found — is the router auditing?")
    if report["actuals"] == 0:
        failures.append(
            "ZERO actual-reuse reports from the engine — the loop is open"
        )
    if report["join_rate"] < min_join and report["routes"]:
        failures.append(
            f"join rate {report['join_rate']:.2%} < required {min_join:.2%}"
        )
    if report["orphan_routes"] > max_orphan_routes:
        failures.append(
            f"{report['orphan_routes']} ORPHAN route record(s) "
            f"(allowed {max_orphan_routes}): routed requests whose trace "
            "never produced an engine-side actual"
        )
    if max_abs_p95 is not None:
        # The multi-replica error bound: every replica's
        # |predicted - actual| p95 must hold on its own.
        for rid, rep in sorted(report.get("per_replica", {}).items()):
            if rep["joined"] and rep["abs_p95"] > max_abs_p95:
                failures.append(
                    f"replica {rid}: overlap-error |p95| {rep['abs_p95']}"
                    f" blocks > bound {max_abs_p95} "
                    f"({rep['joined']} joined routes)"
                )
    return failures


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("captures", nargs="+", help="DYNTPU_TRACE capture(s)/base(s)")
    ap.add_argument(
        "--assert", dest="do_assert", action="store_true",
        help="exit 1 unless the gates hold",
    )
    ap.add_argument("--min-join", type=float, default=0.95)
    ap.add_argument(
        "--max-orphan-routes", type=int, default=0,
        help="tolerated routes with no engine-side actual (default 0: "
        "every routed request must close the loop)",
    )
    ap.add_argument(
        "--stale-pending", type=int, default=1,
        help="pending events at score time >= N counts as a stale decision",
    )
    ap.add_argument(
        "--max-abs-p95", type=float, default=None,
        help="bound EVERY router replica's |predicted - actual| overlap "
        "error p95 (blocks); off by default",
    )
    ap.add_argument("--json", action="store_true", help="report as JSON only")
    args = ap.parse_args(argv)

    routes, actuals, planner = load_records(args.captures)
    report = join_report(routes, actuals, args.stale_pending)
    # Planner context for the window (JAX package captures).
    report["planner_decisions"] = {
        "total": len(planner),
        "scale_events": [
            {k: r.get(k) for k in ("pool", "decision", "size", "unix")}
            for r in planner if r.get("decision") in ("up", "down")
        ],
    }

    print(json.dumps(report, indent=2, sort_keys=True))
    if not args.json:
        oe, st = report["overlap_error"], report["staleness"]
        ts = report["tier_split"]
        print(
            f"\nroute audit: {report['joined']}/{report['routes']} joined "
            f"({report['join_rate']:.1%}), overlap error |p95| {oe['abs_p95']}"
            f" blocks, {st['mispredicted_total']} mispredictions "
            f"({st['mispredicted_while_stale']} while the indexer was stale)",
            file=sys.stderr,
        )
        print(
            "tier split (actual reuse blocks): "
            f"G1 {ts['device_blocks']} | G2 {ts['host_blocks']} | "
            f"G3 {ts['disk_blocks']} | G4 {ts['peer_blocks']}",
            file=sys.stderr,
        )

    if args.do_assert:
        failures = run_asserts(
            report, args.min_join, args.max_orphan_routes,
            max_abs_p95=args.max_abs_p95,
        )
        if failures:
            for f in failures:
                print(f"ROUTE AUDIT FAIL: {f}", file=sys.stderr)
            return 1
        print("route audit: all gates passed", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
