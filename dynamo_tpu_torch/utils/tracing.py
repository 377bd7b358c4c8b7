"""Cross-process request tracing: spans, wire context, histograms (port
of dynamo_tpu/utils/tracing.py, same record layout).

A request's TTFT decomposes into named spans recorded in EVERY process it
crosses (frontend → worker), joined offline by
``dynamo_tpu_torch/tools/trace_merge.py`` — or by the reference's
``benchmarks/trace_merge.py``, which reads the same capture — into one
per-request timeline.

Three pieces:

- ``TraceContext`` — the wire form (trace id + parent span + the
  sender's wall clock at serialization, the clock-offset hint). It
  travels where ``deadline_ms`` travels: the PreprocessedRequest wire
  and the TCP request envelope.
- ``Tracer`` — per-process collector. ``mark()`` records point events
  (received / engine_queued / first_token / finished);
  ``span_begin``/``span_end``/``span()`` record named intervals from the
  standard catalog (SPAN_NAMES). Completed spans stream to a JSONL
  capture (``DYNTPU_TRACE=/path.jsonl``, utils/recorder.py rotation) as
  they close, so a process that never owns a request's finish still
  exports its part of the timeline. ``finish()`` folds the trace's
  derived intervals into bucketed histograms and emits the terminal
  record.
- Histograms — Prometheus bucket histograms (the llm/metrics.py
  ``_BUCKETS`` ladder, in ms) for every interval AND per-token ITL
  (``observe_itl``).

Cost on the engine thread: every call is dict work under one
uncontended lock; file writes happen after the lock is released and only
when a span or a trace closes, never per token.

Leak hygiene: auto-opened traces that never finish (marks landing after
a cancellation) are reaped by a TTL sweep and counted in
``abandoned_traces_total`` — run opportunistically from mark/finish and
render, so no background thread is needed.
"""

from __future__ import annotations

import logging
import os
import threading
import time
import uuid
from collections import deque
from contextlib import contextmanager
from typing import Any

from dynamo_tpu_torch.utils.concurrency import make_lock

logger = logging.getLogger(__name__)

#: The standard span catalog, the reference's names. Every
#: seam uses these names so trace_merge can decompose TTFT without
#: per-deployment configuration:
#:   admission    HTTP gate admit (frontend)
#:   tokenize     template + tokenization (frontend preprocessor)
#:   route        instance selection + envelope publish (frontend egress)
#:   queue_wait   any queue: engine waiting list, disagg prefill queue
#:   prefill      prompt KV computation (local or prefill worker)
#:   kv_transfer  prefill→decode KV push (prefill worker; the port has no
#:                disaggregation yet, so no seam records it)
#:   decode_first KV ready → first token on the stream (decode worker)
#:   decode       first token → finish (decode worker)
#:   failover     worker death detected → replay's first frame (ingress
#:                failover plane, runtime/failover.py — covers exactly
#:                the client-visible resume gap of a mid-stream kill)
SPAN_NAMES = (
    "admission",
    "tokenize",
    "route",
    "queue_wait",
    "prefill",
    "kv_transfer",
    "decode_first",
    "decode",
    "failover",
)

#: Derived point-mark intervals (kept from the pre-span tracer; the
#: engine and HTTP layers still mark these).
INTERVALS: dict[str, tuple[str, str]] = {
    "ttft": ("received", "first_token"),
    "engine": ("engine_queued", "first_token"),
    "decode": ("first_token", "finished"),
    "total": ("received", "finished"),
}

#: Histogram bucket ladder in milliseconds — the llm/metrics.py
#: ``_BUCKETS`` seconds ladder scaled by 1000, so both Prometheus
#: surfaces quantize latency identically. Inlined rather than imported:
#: utils must not depend on llm (tests/test_trace.py pins the two
#: ladders equal, so they cannot drift silently).
BUCKETS_MS: tuple[float, ...] = (
    5.0, 10.0, 25.0, 50.0, 100.0, 250.0, 500.0,
    1000.0, 2500.0, 5000.0, 10000.0, 30000.0, 60000.0,
)

#: Active traces idle longer than this are abandoned by the sweep.
DEFAULT_TTL_S = 600.0


class TraceContext:
    """Wire-portable trace identity: carried wherever ``deadline_ms``
    already travels, re-adopted on receipt. ``sent_unix`` is the
    sender's wall clock at serialization — the receiver's
    ``recv_unix - sent_unix`` upper-bounds the clock offset between the
    two processes (offset + transit), which trace_merge uses to flag
    skewed captures (same NTP-level assumption as ``deadline_unix``)."""

    __slots__ = ("trace_id", "parent_span", "sent_unix")

    #: "caller did not pass sent_unix" — distinct from an explicit None,
    #: which means "no offset hint" (a wire dict without the field, or a
    #: seam whose stamp measures dwell rather than transit).
    _UNSET = object()

    def __init__(
        self,
        trace_id: str,
        parent_span: str = "",
        sent_unix: float | None | object = _UNSET,
    ) -> None:
        self.trace_id = trace_id
        self.parent_span = parent_span
        self.sent_unix = (
            time.time() if sent_unix is TraceContext._UNSET else sent_unix
        )

    def to_wire(self) -> dict[str, Any]:
        # Emit the stored stamp, not a fresh now(): contexts are built
        # immediately before sending (where the default stamp IS now),
        # and a re-serialized context whose hint was deliberately
        # stripped (sent_unix=None — a seam measuring dwell, not
        # transit) must stay stripped on the next hop.
        return {
            "trace_id": self.trace_id,
            "parent_span": self.parent_span,
            "sent_unix": self.sent_unix,
        }

    @staticmethod
    def from_wire(d: dict[str, Any] | None) -> "TraceContext | None":
        if not d or not d.get("trace_id"):
            return None
        return TraceContext(
            str(d["trace_id"]),
            str(d.get("parent_span") or ""),
            float(d.get("sent_unix") or 0.0) or None,
        )


class Histogram:
    """Bucketed latency histogram (ms). Quantiles interpolate inside the
    winning bucket; the true max is tracked exactly."""

    __slots__ = ("counts", "sum_ms", "max_ms")

    def __init__(self) -> None:
        self.counts = [0] * (len(BUCKETS_MS) + 1)
        self.sum_ms = 0.0
        self.max_ms = 0.0

    @property
    def count(self) -> int:
        return sum(self.counts)

    def clone(self) -> "Histogram":
        """Point-in-time copy. Readers (summary/render) must clone under
        the tracer lock and compute on the clone — iterating the LIVE
        counts while observe() mutates them yields a scrape where
        _sum/_count/bucket lines disagree, breaking the per-scrape
        consistency Prometheus histogram consumers assume."""
        h = Histogram()
        h.counts = self.counts[:]
        h.sum_ms = self.sum_ms
        h.max_ms = self.max_ms
        return h

    def observe(self, ms: float) -> None:
        for i, ub in enumerate(BUCKETS_MS):
            if ms <= ub:
                self.counts[i] += 1
                break
        else:
            self.counts[-1] += 1
        self.sum_ms += ms
        self.max_ms = max(self.max_ms, ms)

    def quantile(self, q: float) -> float:
        total = self.count
        if total == 0:
            return 0.0
        rank = q * total
        cum = 0
        lo = 0.0
        for i, ub in enumerate(BUCKETS_MS):
            prev = cum
            cum += self.counts[i]
            if cum >= rank:
                if self.counts[i] == 0:
                    return ub
                frac = (rank - prev) / self.counts[i]
                return min(lo + frac * (ub - lo), self.max_ms)
            lo = ub
        return self.max_ms  # landed in the +Inf bucket

    def render(self, name: str, lines: list[str]) -> None:
        lines.append(f"# TYPE {name} histogram")
        cum = 0
        for i, ub in enumerate(BUCKETS_MS):
            cum += self.counts[i]
            lines.append(f'{name}_bucket{{le="{ub:g}"}} {cum}')
        cum += self.counts[-1]
        lines.append(f'{name}_bucket{{le="+Inf"}} {cum}')
        lines.append(f"{name}_sum {self.sum_ms:.3f}")
        lines.append(f"{name}_count {cum}")


class RequestTrace:
    """One request's per-process capture: point marks + named spans,
    anchored to the wall clock once so every exported timestamp is
    absolute (cross-process sortable)."""

    __slots__ = (
        "id", "trace_id", "marks", "spans", "_open",
        "_mono0", "_unix0", "offset_hint_ms", "parent_span", "last_touch",
    )

    def __init__(self, request_id: str, trace_id: str | None = None) -> None:
        self.id = request_id
        self.trace_id = trace_id or uuid.uuid4().hex
        self.marks: dict[str, float] = {}          # name -> monotonic
        self.spans: list[tuple[str, float, float]] = []  # (name, t0, t1) mono
        self._open: dict[str, float] = {}          # name -> start mono
        self._mono0 = time.monotonic()
        self._unix0 = time.time()
        self.offset_hint_ms: float | None = None
        self.parent_span = ""  # which span the adopted context crossed under
        self.last_touch = self._mono0

    def to_unix(self, mono: float) -> float:
        return self._unix0 + (mono - self._mono0)

    def mark(self, name: str) -> None:
        self.marks.setdefault(name, time.monotonic())
        self.last_touch = time.monotonic()

    def interval_ms(self, a: str, b: str) -> float | None:
        if a in self.marks and b in self.marks:
            return 1000.0 * (self.marks[b] - self.marks[a])
        return None

    def to_wire(self) -> dict[str, Any]:
        """Terminal record (kind="finish"): absolute-time marks + the
        span list, one line per process per trace."""
        return {
            "kind": "finish",
            "id": self.id,
            "trace": self.trace_id,
            "pid": os.getpid(),
            "offset_hint_ms": self.offset_hint_ms,
            "parent_span": self.parent_span,
            "marks": {
                k: round(self.to_unix(v), 6) for k, v in self.marks.items()
            },
            "spans": [
                {
                    "name": n,
                    "start_unix": round(self.to_unix(t0), 6),
                    "dur_ms": round(1000.0 * (t1 - t0), 3),
                }
                for n, t0, t1 in self.spans
            ],
        }


class Tracer:
    def __init__(
        self,
        capacity: int = 2048,
        record_path: str | None = None,
        ttl_s: float = DEFAULT_TTL_S,
    ) -> None:
        self._lock = make_lock("tracer")
        self._active: dict[str, RequestTrace] = {}
        self._done: deque[RequestTrace] = deque(maxlen=capacity)
        self._hist: dict[str, Histogram] = {}
        self.ttl_s = ttl_s
        self.abandoned_total = 0
        self.role = os.environ.get("DYNTPU_TRACE_ROLE", "")
        self._ops_since_sweep = 0
        # Capture records produced while holding _lock (TTL-sweep
        # abandons) are buffered here and written by _drain() after the
        # lock is released — the hot paths must never do file I/O inside
        # the critical section.
        self._pending: list[dict[str, Any]] = []
        self._recorder = None
        if record_path:
            from dynamo_tpu_torch.utils.recorder import Recorder

            # Rotation bounds are env-tunable: a long replay writes
            # hundreds of MB of span records, and the default 4x64 MB set
            # would silently drop the oldest generations.
            try:
                max_mb = int(os.environ.get("DYNTPU_TRACE_MAX_MB") or 64)
                max_files = int(
                    os.environ.get("DYNTPU_TRACE_MAX_FILES") or 4
                )
            except ValueError:
                max_mb, max_files = 64, 4
            self._recorder = Recorder(
                record_path, max_bytes=max(1, max_mb) << 20,
                max_files=max(1, max_files),
            )

    # -- trace identity -----------------------------------------------------
    def _get(self, request_id: str) -> RequestTrace:
        tr = self._active.get(request_id)
        if tr is None:
            tr = self._active[request_id] = RequestTrace(request_id)
        return tr

    def trace_id(self, request_id: str) -> str:
        with self._lock:
            return self._get(request_id).trace_id

    def trace_id_if_active(self, request_id: str) -> str | None:
        """The trace id only when a trace is already open — engine-side
        observers (KV-actual reporting) must never re-open a trace for a
        request that already finished (it would leak until the sweep and
        inflate ``abandoned_traces_total``)."""
        with self._lock:
            tr = self._active.get(request_id)
            return tr.trace_id if tr is not None else None

    def context(
        self, request_id: str, parent_span: str = ""
    ) -> TraceContext:
        """The wire context for this request's trace (opens one if
        needed) — attach wherever the request crosses a process seam."""
        return TraceContext(self.trace_id(request_id), parent_span)

    def context_wire(
        self, request_id: str, parent_span: str = ""
    ) -> dict[str, Any]:
        return self.context(request_id, parent_span).to_wire()

    def adopt(
        self, request_id: str, ctx: TraceContext | None
    ) -> None:
        """Bind a remote trace id to this process's capture of
        `request_id`. In-process seams (same Tracer) are a no-op — the
        ids already agree; a genuinely remote context also records the
        clock-offset hint for trace_merge."""
        if ctx is None:
            return
        with self._lock:
            tr = self._get(request_id)
            if tr.trace_id != ctx.trace_id:
                # Same request id seen under two trace ids (e.g. a
                # retried envelope) — keep the capture, relabel it.
                # Spans already STREAMED to the capture stay under the
                # old id; trace_merge sees them as a separate (orphan)
                # trace, which is the honest rendering of a relabel.
                tr.trace_id = ctx.trace_id
            if ctx.parent_span:
                # Which span the context crossed under (route, queue_wait,
                # tokenize) — exported in the finish record so a capture
                # shows each process's inbound hop edge.
                tr.parent_span = ctx.parent_span
            if ctx.sent_unix:
                tr.offset_hint_ms = round(
                    1000.0 * (time.time() - ctx.sent_unix), 3
                )
            self._maybe_sweep_locked()
        self._drain()

    # -- point marks ---------------------------------------------------------
    def mark(self, request_id: str, name: str) -> None:
        with self._lock:
            self._get(request_id).mark(name)
            self._maybe_sweep_locked()
        self._drain()

    def has_span(self, request_id: str, name: str) -> bool:
        """True when this process's capture already holds (or has open)
        a span of that name — admission seams use it so a RE-admitted
        request (preemption, remote-KV degradation) doesn't record a
        second overlapping queue_wait that trace_merge would sum. Never
        opens a trace."""
        with self._lock:
            tr = self._active.get(request_id)
            if tr is None:
                return False
            return name in tr._open or any(
                n == name for n, _, _ in tr.spans
            )

    def touch(self, request_id: str) -> None:
        """Refresh a live trace's TTL without recording anything — the
        per-token streaming paths call this so a long-running request
        (decode > ttl_s) is not reaped mid-flight by the sweep and
        falsely counted abandoned. Never opens a trace."""
        with self._lock:
            tr = self._active.get(request_id)
            if tr is not None:
                tr.last_touch = time.monotonic()

    def mark_if_active(self, request_id: str, name: str) -> bool:
        """Mark only when a trace is already open — the late-event path
        (an error landing after the stream closed must not re-open a
        trace that would then leak until the sweep)."""
        with self._lock:
            tr = self._active.get(request_id)
            if tr is None:
                return False
            tr.mark(name)
            return True

    # -- spans ---------------------------------------------------------------
    def span_begin(self, request_id: str, name: str) -> None:
        with self._lock:
            tr = self._get(request_id)
            tr._open.setdefault(name, time.monotonic())
            tr.last_touch = time.monotonic()

    def span_end(self, request_id: str, name: str) -> float | None:
        """Close an open span; no-op (None) when it was never begun —
        seams share one call site for local and remote shapes. Returns
        the duration in ms."""
        with self._lock:
            tr = self._active.get(request_id)
            if tr is None:
                return None
            t0 = tr._open.pop(name, None)
            if t0 is None:
                return None
            t1 = time.monotonic()
            tr.spans.append((name, t0, t1))
            tr.last_touch = t1
            rec = self._span_record_locked(tr, name, t0, t1)
        self._write(rec)
        return 1000.0 * (t1 - t0)

    @contextmanager
    def span(self, request_id: str, name: str):
        self.span_begin(request_id, name)
        try:
            yield
        finally:
            self.span_end(request_id, name)

    def add_span(
        self,
        request_id: str,
        name: str,
        start_mono: float | None = None,
        start_unix: float | None = None,
        end_mono: float | None = None,
    ) -> None:
        """Record an already-elapsed interval (e.g. queue wait measured
        from a wall-clock enqueue stamp carried in a queue entry)."""
        t1 = end_mono if end_mono is not None else time.monotonic()
        with self._lock:
            tr = self._get(request_id)
            if start_mono is None:
                if start_unix is None:
                    start_mono = t1
                else:
                    start_mono = tr._mono0 + (start_unix - tr._unix0)
            t0 = min(start_mono, t1)
            tr.spans.append((name, t0, t1))
            tr.last_touch = time.monotonic()
            rec = self._span_record_locked(tr, name, t0, t1)
        self._write(rec)

    def _span_record_locked(
        self, tr: RequestTrace, name: str, t0: float, t1: float
    ) -> dict[str, Any] | None:
        """Fold one completed span into its histogram (pure memory) and
        build the capture record for the caller to write AFTER releasing
        the lock — the engine dispatch thread closes spans on its hot
        path, and a file write+flush inside the critical section would
        serialize every tracer user behind disk I/O. Spans still stream
        to the capture AS THEY CLOSE: a process that never owns the
        request's finish (a prefill worker shipping KV) still exports
        its part of the timeline."""
        dur_ms = 1000.0 * (t1 - t0)
        self._hist_locked(name).observe(dur_ms)
        if self._recorder is None:
            return None
        return {
            "kind": "span",
            "id": tr.id,
            "trace": tr.trace_id,
            "span": name,
            "start_unix": round(tr.to_unix(t0), 6),
            "dur_ms": round(dur_ms, 3),
            "pid": os.getpid(),
            "role": self.role,
        }

    def _write(self, rec: dict[str, Any] | None) -> None:
        if rec is None or self._recorder is None:
            return
        try:
            self._recorder.record(rec)
        except Exception:  # noqa: BLE001 — capture I/O must not kill serving
            # span_end runs on the engine dispatch thread: a disk-full /
            # unlinked-dir write error propagating out of _deliver would
            # mark the engine dead (same rationale as the metrics-export
            # guard). Disable the capture instead of spamming a failure
            # per span.
            logger.warning(
                "trace capture write failed; disabling capture",
                exc_info=True,
            )
            # Racing writers agree on the value; close() tolerates a
            # double call.
            rec_, self._recorder = self._recorder, None
            try:
                rec_.close()
            except Exception:  # noqa: BLE001 — best-effort close
                pass

    def export(self, rec: dict[str, Any] | None) -> None:
        """Write an arbitrary record to the capture stream (no-op without
        a capture): the failover plane's ``kind="failover"`` line — same
        file, same rotation, same disable-on-write-failure guard as span
        streaming."""
        self._write(rec)

    # -- scalar observations -------------------------------------------------
    def _hist_locked(self, name: str) -> Histogram:
        """Get-or-create a named histogram. Caller holds ``_lock``."""
        hist = self._hist.get(name)
        if hist is None:
            hist = self._hist[name] = Histogram()
        return hist

    def observe(self, name: str, ms: float) -> None:
        """Free-form latency observation (per-token ITL, transfer hops)
        folded straight into the named histogram."""
        with self._lock:
            self._hist_locked(name).observe(ms)

    def observe_itl(self, ms: float, request_id: str | None = None) -> None:
        # One lock acquisition per token: the histogram observe and the
        # TTL refresh (each token proves the request is alive — keep its
        # trace out of the sweep's reach) share the critical section.
        with self._lock:
            self._hist_locked("itl").observe(ms)
            if request_id is not None:
                tr = self._active.get(request_id)
                if tr is not None:
                    tr.last_touch = time.monotonic()

    # -- lifecycle -----------------------------------------------------------
    def finish(self, request_id: str) -> RequestTrace | None:
        pending: list[dict[str, Any] | None] = []
        with self._lock:
            tr = self._active.pop(request_id, None)
            if tr is None:
                return None
            tr.mark("finished")
            now = time.monotonic()
            for name, t0 in list(tr._open.items()):
                tr.spans.append((name, t0, now))
                pending.append(self._span_record_locked(tr, name, t0, now))
            tr._open.clear()
            # Mark-derived intervals are the FALLBACK form: where a real
            # span of the same name was recorded (e.g. "decode" — both a
            # span begun at first token and the first_token→finished
            # interval), the span already observed into the histogram;
            # folding the interval too would double-count every request.
            span_names = {name for name, _, _ in tr.spans}
            for name, (a, b) in INTERVALS.items():
                if name in span_names:
                    continue
                ms = tr.interval_ms(a, b)
                if ms is None:
                    continue
                self._hist_locked(name).observe(ms)
            self._done.append(tr)
            if self._recorder is not None:
                pending.append(tr.to_wire())
            self._maybe_sweep_locked()
        for rec in pending:
            self._write(rec)
        self._drain()
        return tr

    def abandon(self, request_id: str, reason: str | None = None) -> None:
        """Drop an active trace without folding it into the stats (a
        request that failed validation before doing any work, or a
        process whose part in the request ended without owning the
        finish). Emits a terminal "abandon" record so trace_merge can
        tell a deliberate drop from an orphaned capture."""
        rec = None
        with self._lock:
            tr = self._active.pop(request_id, None)
            if tr is not None and self._recorder is not None:
                rec = {
                    "kind": "abandon",
                    "id": tr.id,
                    "trace": tr.trace_id,
                    "pid": os.getpid(),
                }
                if reason:
                    rec["reason"] = reason
        self._write(rec)

    # -- TTL sweep -----------------------------------------------------------
    def sweep(self, ttl_s: float | None = None) -> int:
        """Reap active traces idle past the TTL. Requests that never
        reach ``finish()`` — marks arriving after cancellation, late KV
        frames, crashed peers — would otherwise pin RequestTrace objects
        in ``_active`` forever."""
        with self._lock:
            n = self._sweep_locked(
                self.ttl_s if ttl_s is None else ttl_s
            )
        self._drain()
        return n

    def _sweep_locked(self, ttl_s: float) -> int:
        """Reap under the lock, but only BUFFER the abandon records —
        the caller drains them to disk after releasing (file I/O inside
        the critical section would stall every tracer user, including
        the engine dispatch thread)."""
        now = time.monotonic()
        stale = [
            rid for rid, tr in self._active.items()
            if now - tr.last_touch > ttl_s
        ]
        for rid in stale:
            tr = self._active.pop(rid)
            self.abandoned_total += 1
            if self._recorder is not None:
                self._pending.append({
                    "kind": "abandon",
                    "id": tr.id,
                    "trace": tr.trace_id,
                    "pid": os.getpid(),
                    "reason": "ttl",
                })
        return len(stale)

    def _drain(self) -> None:
        """Write records buffered by a locked section. Must be called
        WITHOUT the lock held."""
        while True:
            with self._lock:
                if not self._pending:
                    return
                recs, self._pending = self._pending, []
            for rec in recs:
                self._write(rec)

    def _maybe_sweep_locked(self) -> None:
        # Opportunistic: every 256 tracer operations, so a quiet process
        # with a leaked trace still reaps it without a background thread.
        self._ops_since_sweep += 1
        if self._ops_since_sweep >= 256:
            self._ops_since_sweep = 0
            self._sweep_locked(self.ttl_s)

    # -- reporting -----------------------------------------------------------
    @property
    def active_count(self) -> int:
        with self._lock:
            return len(self._active)

    def summary(self) -> dict[str, dict[str, float]]:
        """Per-interval/span/ITL digest computed from the bucketed
        histograms (quantiles are bucket-interpolated, max is exact)."""
        with self._lock:
            hists = {n: h.clone() for n, h in self._hist.items()}
        out: dict[str, dict[str, float]] = {}
        for name, h in hists.items():
            if h.count == 0:
                continue
            out[name] = {
                "count": h.count,
                "p50_ms": round(h.quantile(0.50), 3),
                "p95_ms": round(h.quantile(0.95), 3),
                "max_ms": round(h.max_ms, 3),
            }
        return out

    def render(self, prefix: str = "dyntpu_trace") -> str:
        with self._lock:
            self._sweep_locked(self.ttl_s)
            hists = sorted((n, h.clone()) for n, h in self._hist.items())
            abandoned = self.abandoned_total
            active = len(self._active)
        self._drain()
        lines: list[str] = []
        for name, h in hists:
            if h.count:
                h.render(f"{prefix}_{name}_ms", lines)
        lines.append(f"# TYPE {prefix}_abandoned_traces_total counter")
        lines.append(f"{prefix}_abandoned_traces_total {abandoned}")
        lines.append(f"# TYPE {prefix}_active gauge")
        lines.append(f"{prefix}_active {active}")
        return "\n".join(lines) + "\n"

    def snapshot(self, n: int = 32) -> dict[str, Any]:
        """Live debug view for the /debug/trace endpoint: histogram
        digest plus the most recent completed traces."""
        with self._lock:
            done = list(self._done)[-n:]
            active = len(self._active)
            abandoned = self.abandoned_total
        return {
            "active_traces": active,
            "abandoned_traces_total": abandoned,
            "histograms": self.summary(),
            "recent": [tr.to_wire() for tr in done],
        }


_default: Tracer | None = None
_default_lock = threading.Lock()


def capture_path(base: str) -> str:
    """Per-process capture path for a ``DYNTPU_TRACE`` base: co-hosted
    processes (frontend + prefill + decode) inherit the SAME env value,
    and Recorder's append/rotate is single-process — two writers on one
    file silently clobber each other's rotated generations. Each process
    therefore writes ``<base>.<pid>`` (the 'each process writes its own
    capture' shape trace_merge joins; it expands the suffixed set from
    the base path automatically)."""
    return f"{base}.{os.getpid()}"


def tracer() -> Tracer:
    """The process-default tracer (capture path from ``DYNTPU_TRACE``,
    pid-suffixed via :func:`capture_path`)."""
    global _default
    with _default_lock:
        if _default is None:
            base = os.environ.get("DYNTPU_TRACE")
            _default = Tracer(
                record_path=capture_path(base) if base else None
            )
        return _default


def reset_tracer(record_path: str | None = None, role: str = "") -> Tracer:
    """Swap the process-default tracer (tests and bench harnesses that
    need a fresh capture file mid-process). Not for serving code."""
    global _default
    with _default_lock:
        old = _default
        _default = Tracer(record_path=record_path)
        if role:
            _default.role = role
        if old is not None and old._recorder is not None:
            old._recorder.close()
        return _default
