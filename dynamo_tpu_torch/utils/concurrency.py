"""Named locks (the ``make_lock`` seam of dynamo_tpu/utils/concurrency.py).

The reference routes every serving lock through ``make_lock`` so that a
lock-order checker can wrap them; the port keeps the seam and its names
(``tracer``, ``flight.ring``, ``recorder.write``) but has no checker yet,
so a named lock is a plain ``threading.Lock``.
"""

from __future__ import annotations

import threading


def make_lock(name: str) -> threading.Lock:
    """A lock for the seam ``name`` (unused until a checker exists)."""
    del name
    return threading.Lock()
