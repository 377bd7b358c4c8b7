"""Logging setup: readable or JSONL lines, trace-correlated (port of
dynamo_tpu/utils/logging.py).

``init_logging`` configures the root logger once: readable lines by
default, JSONL when ``DYNTPU_LOG_JSONL`` is set, levels from
``DYNTPU_LOG`` (``debug`` or ``dynamo_tpu_torch.runtime=debug,info``).

Trace correlation: code handling a request wraps its work in
``request_scope(request_id, trace_id)``; every record emitted inside the
scope carries both ids — JSONL as ``request_id``/``trace_id`` fields,
readable as a ``[rid=... trace=...]`` suffix — so ``grep <trace_id>``
reconstructs one request's story across the log and the span capture
(``DYNTPU_TRACE``) of every process it crossed. The scope is a
contextvar: it follows async tasks, not threads, so the engine thread's
own lines stay unscoped.
"""

from __future__ import annotations

import contextvars
import json
import logging
import os
import sys
import time
from contextlib import contextmanager

_LEVELS = {
    "trace": logging.DEBUG,
    "debug": logging.DEBUG,
    "info": logging.INFO,
    "warn": logging.WARNING,
    "warning": logging.WARNING,
    "error": logging.ERROR,
}

#: (request_id, trace_id) for the task currently handling a request.
_REQUEST_SCOPE: contextvars.ContextVar[tuple[str, str | None] | None] = (
    contextvars.ContextVar("dyntpu_torch_request_scope", default=None)
)


@contextmanager
def request_scope(request_id: str, trace_id: str | None = None):
    """Attach a request/trace identity to every log record this task (and
    the tasks it spawns) emits until the scope exits."""
    token = _REQUEST_SCOPE.set((request_id, trace_id))
    try:
        yield
    finally:
        _REQUEST_SCOPE.reset(token)


class _ScopeFilter(logging.Filter):
    """Stamps the active request scope onto each record. Always sets the
    attributes (possibly empty) so format strings referencing them never
    KeyError on unscoped records."""

    def filter(self, record: logging.LogRecord) -> bool:
        scope = _REQUEST_SCOPE.get()
        if scope is not None:
            rid, tid = scope
            record.request_id = rid
            record.trace_id = tid or ""
            record.scope_suffix = (
                f" [rid={rid} trace={tid}]" if tid else f" [rid={rid}]"
            )
        elif not hasattr(record, "request_id"):
            # Unscoped: empty stamps, but never over a stamp another
            # filter already put on this record (a process that hosts
            # both packages' handlers passes one record through both).
            record.request_id = ""
            record.trace_id = ""
            record.scope_suffix = ""
        return True


class JsonlFormatter(logging.Formatter):
    def format(self, record: logging.LogRecord) -> str:
        entry = {
            "ts": time.strftime("%Y-%m-%dT%H:%M:%S", time.gmtime(record.created)),
            "level": record.levelname,
            "target": record.name,
            "message": record.getMessage(),
        }
        if getattr(record, "request_id", ""):
            entry["request_id"] = record.request_id
        if getattr(record, "trace_id", ""):
            entry["trace_id"] = record.trace_id
        if record.exc_info:
            entry["exception"] = self.formatException(record.exc_info)
        return json.dumps(entry)


def init_logging(level: str | None = None) -> None:
    """Idempotent root-logger setup honouring ``DYNTPU_LOG`` and
    ``DYNTPU_LOG_JSONL``."""
    root = logging.getLogger()
    if getattr(root, "_dynamo_tpu_torch_configured", False):
        return
    spec = level or os.environ.get("DYNTPU_LOG", "info")
    default = logging.INFO
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        if "=" in part:
            target, lvl = part.split("=", 1)
            logging.getLogger(target).setLevel(_LEVELS.get(lvl.lower(), logging.INFO))
        else:
            default = _LEVELS.get(part.lower(), logging.INFO)
    handler = logging.StreamHandler(sys.stderr)
    handler.addFilter(_ScopeFilter())
    if os.environ.get("DYNTPU_LOG_JSONL"):
        handler.setFormatter(JsonlFormatter())
    else:
        handler.setFormatter(logging.Formatter(
            "%(asctime)s %(levelname)-7s %(name)s: %(message)s%(scope_suffix)s",
            "%H:%M:%S",
        ))
    root.addHandler(handler)
    root.setLevel(default)
    root._dynamo_tpu_torch_configured = True  # type: ignore[attr-defined]
