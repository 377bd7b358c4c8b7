"""Logging setup with request correlation (port of init_logging and
request_scope of dynamo_tpu/utils/logging.py).

``init_logging`` configures the root logger once: readable lines by
default, levels from ``DYNTPU_LOG`` (``debug`` or
``dynamo_tpu_torch.runtime=debug,info``). Code handling a request wraps
its work in ``request_scope(request_id)``; every record emitted inside it
ends with ``[rid=...]``. The scope is a contextvar: it follows async
tasks, not threads. JSONL output and trace ids arrive with the tracer
(ROADMAP A4).
"""

from __future__ import annotations

import contextvars
import logging
import os
import sys
from contextlib import contextmanager

_LEVELS = {
    "trace": logging.DEBUG,
    "debug": logging.DEBUG,
    "info": logging.INFO,
    "warn": logging.WARNING,
    "warning": logging.WARNING,
    "error": logging.ERROR,
}

_REQUEST_SCOPE: contextvars.ContextVar[str | None] = contextvars.ContextVar(
    "dyntpu_torch_request_scope", default=None
)


@contextmanager
def request_scope(request_id: str):
    """Attach a request id to every log record this task (and the tasks
    it spawns) emits until the scope exits."""
    token = _REQUEST_SCOPE.set(request_id)
    try:
        yield
    finally:
        _REQUEST_SCOPE.reset(token)


class _ScopeFilter(logging.Filter):
    def filter(self, record: logging.LogRecord) -> bool:
        rid = _REQUEST_SCOPE.get()
        record.scope_suffix = f" [rid={rid}]" if rid else ""
        return True


def init_logging(level: str | None = None) -> None:
    """Idempotent root-logger setup honouring ``DYNTPU_LOG``."""
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
    handler.setFormatter(logging.Formatter(
        "%(asctime)s %(levelname)-7s %(name)s: %(message)s%(scope_suffix)s",
        "%H:%M:%S",
    ))
    root.addHandler(handler)
    root.setLevel(default)
    root._dynamo_tpu_torch_configured = True  # type: ignore[attr-defined]
