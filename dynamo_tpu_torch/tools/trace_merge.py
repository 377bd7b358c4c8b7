"""Join multi-process trace captures into per-request timelines (port of
benchmarks/trace_merge.py, which imports the JAX package's tracer; this
copy reads the port's, and both read the same record layout).

Each process a request crosses writes its own ``DYNTPU_TRACE`` JSONL
capture (utils/tracing.py): ``span`` records stream out as spans close,
one ``finish`` (or ``abandon``) record lands per process per trace.
This tool joins any number of captures by trace id and reports WHERE a
request's TTFT went —

    admission | tokenize | route | queue_wait | prefill | kv_transfer
    | decode_first

with percentiles over the run, plus the unattributed remainder (clock
gaps, hop transit). Span timestamps are absolute wall clock; captures
from different hosts are assumed NTP-aligned — ``clock_offset_hint_ms``
(worst recv−sent per trace across adoption seams) flags runs where that
assumption broke.

``--assert-complete`` is the gate: every COMPLETED request (its finish
record carries a ``first_token`` mark) must have the full span chain —
the core spans present and the covered timeline gapless within
``--max-gap-ms`` — and any ORPHAN trace (spans recorded but no
finish/abandon anywhere) is a hard failure: some seam opened a capture
it never closed.

Usage:
    python -m dynamo_tpu_torch.tools.trace_merge CAPTURE [CAPTURE ...]
        [--assert-complete] [--max-gap-ms 250] [--dump-timelines]
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys
from collections import defaultdict
from typing import Any

if __package__ in (None, ""):  # `python dynamo_tpu_torch/tools/trace_merge.py`
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))))

from dynamo_tpu_torch.utils.recorder import Recorder
from dynamo_tpu_torch.utils.tracing import SPAN_NAMES

#: Spans every completed request must have regardless of deployment
#: shape (they are recorded by the engine itself). Frontend spans
#: (admission/tokenize/route) and kv_transfer are required only when the
#: trace's marks show it crossed those seams.
CORE_SPANS = ("queue_wait", "prefill", "decode_first", "decode")


class TraceRecord:
    """Everything captured for one trace id, across all processes."""

    __slots__ = ("trace_id", "spans", "marks", "finishes", "abandons",
                 "offset_hints", "request_id")

    def __init__(self, trace_id: str) -> None:
        self.trace_id = trace_id
        self.request_id = ""
        self.spans: list[dict[str, Any]] = []
        self.marks: dict[str, float] = {}
        self.finishes = 0
        self.abandons = 0
        self.offset_hints: list[float] = []

    # -- derived ------------------------------------------------------------
    @property
    def completed(self) -> bool:
        return self.finishes > 0 and "first_token" in self.marks

    @property
    def failed_over(self) -> bool:
        """True when the ingress failover plane re-dispatched this
        request mid-stream (the ``failover`` mark/span). The dead
        worker's process capture holds OPEN spans it could never close —
        its streaming window is a legitimate, un-coverable hole in the
        merged timeline, so the gap gate must not red-bar the chain the
        failure model designed."""
        return "failover" in self.marks or any(
            s["name"] == "failover" for s in self.spans
        )

    @property
    def orphan(self) -> bool:
        return self.finishes == 0 and self.abandons == 0

    def timeline(self) -> list[dict[str, Any]]:
        return sorted(self.spans, key=lambda s: s["start_unix"])

    def span_totals(self) -> dict[str, float]:
        out: dict[str, float] = defaultdict(float)
        for s in self.spans:
            out[s["name"]] += s["dur_ms"]
        return dict(out)

    def ttft_ms(self) -> float | None:
        start = self.marks.get("received", self.marks.get("engine_queued"))
        first = self.marks.get("first_token")
        if start is None or first is None:
            return None
        return 1000.0 * (first - start)

    def max_gap_ms(self) -> float:
        """Largest hole in span coverage from the first span's start to
        the last span's end (0 when coverage is contiguous)."""
        tl = self.timeline()
        if not tl:
            return 0.0
        worst = 0.0
        covered_end = tl[0]["start_unix"]
        for s in tl:
            gap = s["start_unix"] - covered_end
            worst = max(worst, 1000.0 * gap)
            covered_end = max(
                covered_end, s["start_unix"] + s["dur_ms"] / 1000.0
            )
        return worst

    def missing_spans(self) -> list[str]:
        have = {s["name"] for s in self.spans}
        need = list(CORE_SPANS)
        # A degraded request (remote prefill died, decode recomputed
        # locally) completes without a kv_transfer span; only an
        # un-degraded remote request must have one.
        if (
            "remote_prefill" in self.marks
            and "degraded_local" not in self.marks
        ):
            need.append("kv_transfer")
        if "received" in self.marks:
            need.append("admission")
        return [n for n in need if n not in have]


def _expand_captures(paths: list[str]) -> list[str]:
    """Resolve each argument to concrete capture files. A path may be a
    capture itself, or a ``DYNTPU_TRACE`` BASE: every process suffixes
    the base with its pid (utils/tracing.capture_path), so ``base`` on
    the command line expands to ``base.<pid>`` for each writer."""
    out: list[str] = []
    seen_files: set[str] = set()

    def _add(p: str) -> bool:
        """Append a capture path unless every concrete file in its
        rotated set was already covered — a pid-1 worker's capture is
        literally ``<base>.1``, which ALSO names the bare base's first
        rotated generation, and loading it twice would double-count
        finish/abandon records."""
        files = [str(f) for f in Recorder.files(p)]
        if not files or all(f in seen_files for f in files):
            return False
        seen_files.update(files)
        out.append(p)
        return True

    for path in paths:
        any_found = _add(path)
        # ALWAYS also glob the per-pid set: a stray file at the bare
        # base (touch, a pre-upgrade single-process capture) must not
        # shadow the captures the processes actually wrote.
        for p in sorted(
            p for p in glob.glob(f"{path}.*")
            if p[len(path) + 1:].isdigit()
        ):
            any_found = _add(p) or any_found
        if not any_found and not Recorder.files(path):
            raise FileNotFoundError(f"no capture at {path} (or {path}.<pid>)")
    return out


def load_captures(paths: list[str]) -> dict[str, TraceRecord]:
    traces: dict[str, TraceRecord] = {}
    seen_spans: set[tuple] = set()
    for path in _expand_captures(paths):
        for _ts, ev in Recorder.load(path):
            tid = ev.get("trace")
            if not tid:
                continue
            if ev.get("kind") not in ("span", "finish", "abandon"):
                # Timeline-less records (failover) share the capture; they
                # must not register a trace here and read as an orphan.
                continue
            tr = traces.get(tid)
            if tr is None:
                tr = traces[tid] = TraceRecord(tid)
            tr.request_id = ev.get("id") or tr.request_id
            kind = ev.get("kind")
            if kind == "span":
                key = (
                    tid, ev.get("pid"), ev["span"],
                    round(ev["start_unix"], 5),
                )
                if key not in seen_spans:
                    seen_spans.add(key)
                    tr.spans.append({
                        "name": ev["span"],
                        "start_unix": ev["start_unix"],
                        "dur_ms": ev["dur_ms"],
                        "pid": ev.get("pid"),
                        "role": ev.get("role", ""),
                    })
            elif kind == "finish":
                tr.finishes += 1
                for name, t in (ev.get("marks") or {}).items():
                    tr.marks.setdefault(name, t)
                if ev.get("offset_hint_ms") is not None:
                    tr.offset_hints.append(ev["offset_hint_ms"])
                # The finish record restates its process's spans (it is
                # self-contained for single-file captures); the dedup key
                # makes restatement idempotent with the streamed records.
                for s in ev.get("spans") or []:
                    key = (
                        tid, ev.get("pid"), s["name"],
                        round(s["start_unix"], 5),
                    )
                    if key not in seen_spans:
                        seen_spans.add(key)
                        tr.spans.append({
                            "name": s["name"],
                            "start_unix": s["start_unix"],
                            "dur_ms": s["dur_ms"],
                            "pid": ev.get("pid"),
                            "role": "",
                        })
            elif kind == "abandon":
                tr.abandons += 1
    return traces


def _pct(sorted_vals: list[float], q: float) -> float:
    if not sorted_vals:
        return 0.0
    idx = min(len(sorted_vals) - 1, int(q * (len(sorted_vals) - 1) + 0.5))
    return sorted_vals[idx]


def _digest(vals: list[float]) -> dict[str, float]:
    vals = sorted(vals)
    return {
        "count": len(vals),
        "p50_ms": round(_pct(vals, 0.50), 3),
        "p95_ms": round(_pct(vals, 0.95), 3),
        "max_ms": round(vals[-1], 3) if vals else 0.0,
    }


def merge_report(
    traces: dict[str, TraceRecord], max_gap_ms: float = 250.0
) -> dict[str, Any]:
    """The run-level report: per-span TTFT decomposition percentiles and
    the completeness audit --assert-complete gates on."""
    completed = [t for t in traces.values() if t.completed]
    orphans = [t.trace_id for t in traces.values() if t.orphan]
    # Per-trace worst clock-offset hint (recv_unix - sent_unix at each
    # low-latency adoption seam): offset + transit, so values well above
    # hop transit mean the captures' hosts disagree on wall clock and the
    # decomposition below is suspect.
    skew_hints = [
        max(abs(h) for h in t.offset_hints)
        for t in traces.values() if t.offset_hints
    ]
    decomposition: dict[str, list[float]] = defaultdict(list)
    ttfts: list[float] = []
    unattributed: list[float] = []
    incomplete: list[dict[str, Any]] = []
    errored = 0
    for t in completed:
        if "error" in t.marks:
            # A request that DIED after its first token (worker fault,
            # exhausted failover) legitimately truncates its chain —
            # completeness is a property of successful requests. Counted
            # so a run full of errors is still visible in the report.
            errored += 1
            continue
        totals = t.span_totals()
        for name in SPAN_NAMES:
            if name in totals:
                decomposition[name].append(totals[name])
        ttft = t.ttft_ms()
        if ttft is not None:
            ttfts.append(ttft)
            pre_decode = sum(
                v for k, v in totals.items() if k != "decode"
            )
            unattributed.append(max(0.0, ttft - pre_decode))
        missing = t.missing_spans()
        gap = t.max_gap_ms()
        # Failover chains keep the missing-span requirement (the REPLAY
        # worker records the full core chain) but not the gap bound: the
        # killed worker streamed tokens inside spans it died too soon to
        # close, and closed spans are all a capture ever exports.
        if missing or (gap > max_gap_ms and not t.failed_over):
            incomplete.append({
                "trace": t.trace_id,
                "request": t.request_id,
                "missing_spans": missing,
                "max_gap_ms": round(gap, 1),
            })
    return {
        "captures_traces": len(traces),
        "completed_requests": len(completed),
        "errored_requests": errored,
        "orphan_traces": orphans,
        "abandoned_traces": sum(
            1 for t in traces.values() if t.abandons and not t.finishes
        ),
        "incomplete": incomplete,
        "max_gap_ms_allowed": max_gap_ms,
        "ttft_ms": _digest(ttfts),
        "unattributed_ms": _digest(unattributed),
        "clock_offset_hint_ms": _digest(skew_hints),
        "ttft_decomposition_ms": {
            name: _digest(vals)
            for name, vals in decomposition.items()
        },
    }


def assert_complete(report: dict[str, Any]) -> list[str]:
    """The gate's predicate: returns human-readable failures (empty =
    pass)."""
    failures: list[str] = []
    if report["orphan_traces"]:
        failures.append(
            f"{len(report['orphan_traces'])} orphan trace(s) — spans "
            f"recorded but never finished/abandoned: "
            f"{report['orphan_traces'][:5]}"
        )
    if report["incomplete"]:
        failures.append(
            f"{len(report['incomplete'])} completed request(s) with a "
            f"broken span chain: "
            + "; ".join(
                f"{i['request'] or i['trace']}"
                f" missing={i['missing_spans']}"
                f" max_gap={i['max_gap_ms']}ms"
                for i in report["incomplete"][:5]
            )
        )
    if report["completed_requests"] == 0:
        failures.append("capture contains no completed requests")
    return failures


def _dump_timelines(traces: dict[str, TraceRecord]) -> None:
    for t in sorted(traces.values(), key=lambda t: t.trace_id):
        head = t.request_id or t.trace_id
        state = (
            "completed" if t.completed
            else ("orphan" if t.orphan else "abandoned/partial")
        )
        print(f"-- {head} [{state}]")
        tl = t.timeline()
        t0 = tl[0]["start_unix"] if tl else 0.0
        for s in tl:
            off = 1000.0 * (s["start_unix"] - t0)
            print(
                f"   {off:9.1f}ms +{s['dur_ms']:8.1f}ms  {s['name']:<12}"
                f" pid={s['pid']}"
            )


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m dynamo_tpu_torch.tools.trace_merge",
        description="join DYNTPU_TRACE captures into per-request "
                    "timelines and a TTFT decomposition",
    )
    ap.add_argument("captures", nargs="+", help="JSONL capture paths "
                    "(each process's DYNTPU_TRACE file; rotated sets "
                    "are read in full)")
    ap.add_argument("--assert-complete", action="store_true",
                    help="exit 1 unless every completed request has the "
                    "full span chain and no trace is orphaned")
    ap.add_argument("--max-gap-ms", type=float, default=250.0,
                    help="largest allowed hole in a request's span "
                    "coverage before it counts as incomplete")
    ap.add_argument("--dump-timelines", action="store_true",
                    help="print every request's merged span timeline")
    args = ap.parse_args(argv)

    try:
        traces = load_captures(args.captures)
    except FileNotFoundError as exc:
        print(f"error: {exc}", file=sys.stderr)
        return 2
    report = merge_report(traces, max_gap_ms=args.max_gap_ms)
    if args.dump_timelines:
        _dump_timelines(traces)
    print(json.dumps(report, indent=2))
    if args.assert_complete:
        failures = assert_complete(report)
        if failures:
            for f in failures:
                print(f"ASSERT-COMPLETE FAIL: {f}", file=sys.stderr)
            return 1
        print("assert-complete: OK", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
