"""SLO class taxonomy: interactive vs batch, one label per request (a
copy of dynamo_tpu/llm/slo.py).

A serving cell carries two kinds of traffic through one ingress:
**interactive** requests a human is waiting on, and **batch** requests a
pipeline will collect later. Degradation is cheapest-first: when the
cell runs out of headroom, batch work absorbs the 429s, the queue
evictions and the preemptions BEFORE any interactive request pays.

The label enters at the HTTP boundary (``X-Request-Class`` header,
``AdmissionConfig.default_request_class`` when absent), rides the
``PreprocessedRequest`` annotations wire to every hop — the admission
watermarks (llm/admission.py) and the engine scheduler's shed and
preempt victim selection (engine/scheduler.py) — and labels the
per-class shed counters on the metric surfaces.

Exactly two classes, on purpose: a priority ladder invites priority
inversion and starvation tuning; a binary human-waiting bit is
enforceable end to end.
"""

from __future__ import annotations

#: The canonical class labels.
INTERACTIVE = "interactive"
BATCH = "batch"
CLASSES = (INTERACTIVE, BATCH)

#: HTTP request header carrying the client's class; absent/unknown
#: values fall back to the configured default (llm/http_service.py).
REQUEST_CLASS_HEADER = "X-Request-Class"

#: Wire key under ``PreprocessedRequest.annotations`` the class travels
#: as.
ANNOTATION_KEY = "request_class"


def normalize_class(value, default: str = INTERACTIVE) -> str:
    """Map a client-supplied class label to the taxonomy. Unknown or
    absent labels take the configured default rather than erroring: the
    class steers degradation order, and a typo'd header must not become
    a 400 on an otherwise valid request."""
    if isinstance(value, str):
        v = value.strip().lower()
        if v in CLASSES:
            return v
    return default if default in CLASSES else INTERACTIVE


def is_batch(value) -> bool:
    """True only for an explicit batch label — the shed/preempt victim
    predicate (unlabeled legacy sequences count as interactive, so the
    class system can never make legacy traffic WORSE off)."""
    return value == BATCH
