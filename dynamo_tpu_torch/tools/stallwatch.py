"""A watchdog for one Python process: reports each event-loop callback
that runs over 0.5 s, dumps every thread's stack once a callback has run
for 2 s, and (faulthandler's own thread, which needs no GIL) dumps them
when this watchdog's thread is starved for 4 s. All of it on stderr.

    python3 <this file> -m MODULE [ARGS...]   # run MODULE under the watch

Imported, it watches the importing process. ``planner_repeat.py
--watch`` runs the planner phase's processes under it.
"""

from __future__ import annotations

import asyncio.events
import faulthandler
import os
import runpy
import sys
import threading
import time

SLOW_S = 0.5        # a callback reported when it ends
STUCK_S = 2.0       # a running callback whose stacks are dumped
STARVED_S = 4.0     # the watchdog thread itself not run for this long

_current: list = [None]   # (start, handle) of the callback running now


def _timed(run):
    def timed_run(self):
        t0 = time.monotonic()
        _current[0] = (t0, self)
        try:
            run(self)
        finally:
            _current[0] = None
            took = time.monotonic() - t0
            if took > SLOW_S:
                print(f"STALL callback took {took:.2f} s: {self!r}"[:800],
                      file=sys.stderr, flush=True)
    return timed_run


def _watch() -> None:
    reported = None
    while True:
        faulthandler.dump_traceback_later(STARVED_S, exit=False)
        time.sleep(0.25)
        cur = _current[0]
        if cur is not None and cur is not reported and time.monotonic() - cur[0] > STUCK_S:
            reported = cur
            print(f"STALL in progress {time.monotonic() - cur[0]:.2f} s: {cur[1]!r}"[:800],
                  file=sys.stderr, flush=True)
            faulthandler.dump_traceback(all_threads=True)


asyncio.events.Handle._run = _timed(asyncio.events.Handle._run)
threading.Thread(target=_watch, daemon=True, name="stallwatch").start()

if __name__ == "__main__":
    if len(sys.argv) < 3 or sys.argv[1] != "-m":
        raise SystemExit(__doc__)
    module = sys.argv[2]
    sys.argv = [module] + sys.argv[3:]
    sys.path[0] = os.getcwd()   # as ``python -m`` has it
    runpy.run_module(module, run_name="__main__", alter_sys=True)
