"""On-demand native builds: g++ -shared, cached by source content hash
(port of dynamo_tpu/native/build.py).

Build artifacts live under dynamo_tpu_torch/_build, which is gitignored —
a fresh clone always compiles from the audited sources (mtime-based
staleness would let a stale checked-in blob win, since git does not
preserve mtimes). The content hash of all inputs plus the compile command
is embedded in the artifact name, so any source edit forces a rebuild.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
from pathlib import Path

logger = logging.getLogger(__name__)

PKG_DIR = Path(__file__).resolve().parents[1]
BUILD_DIR = PKG_DIR / "_build"

_CXX_CMD = ["g++", "-O2", "-std=c++17", "-shared", "-fPIC", "-pthread"]

_cache: dict[str, ctypes.CDLL] = {}


def load_library(name: str, sources: list[str]) -> ctypes.CDLL | None:
    """Compile (if needed) and dlopen a native library; ``sources`` are
    relative to the package directory. None if the toolchain or the
    build fails (the reason is logged): a caller that asked for the
    native path explicitly raises, ``auto`` falls back to TCP."""
    if name in _cache:
        return _cache[name]
    srcs = [PKG_DIR / s for s in sources]
    h = hashlib.sha256(" ".join(_CXX_CMD).encode())
    try:
        for s in srcs:
            h.update(s.read_bytes())
    except OSError as exc:
        logger.warning("native sources for %s unreadable: %s", name, exc)
        return None
    digest = h.hexdigest()[:16]
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = BUILD_DIR / f"lib{name}-{digest}.so"
    if not out.exists():
        # Compile to a process-unique temp path then atomically rename, so
        # concurrent processes (prefill + decode workers on one host) never
        # dlopen a half-written artifact.
        tmp = out.with_suffix(f".tmp{os.getpid()}")
        cmd = [*_CXX_CMD, *[str(s) for s in srcs], "-o", str(tmp)]
        try:
            subprocess.run(cmd, check=True, capture_output=True, text=True)
            # The rename only guards concurrent dlopen; a crash loses
            # nothing a rebuild can't recreate, so fsync is overkill.
            os.replace(tmp, out)
        except (subprocess.CalledProcessError, FileNotFoundError, OSError) as exc:
            detail = getattr(exc, "stderr", "") or str(exc)
            logger.warning("native build of %s failed: %s", name, detail)
            tmp.unlink(missing_ok=True)
            return None
        # Drop .so artifacts from older source revisions. A concurrent
        # process's live .tmp<pid> must NOT be swept (it would break that
        # process's atomic rename); orphans from killed processes are
        # reclaimed once they are demonstrably old.
        import time

        for stale in BUILD_DIR.glob(f"lib{name}-*"):
            if stale == out:
                continue
            if ".tmp" in stale.name:
                try:
                    if time.time() - stale.stat().st_mtime < 600:
                        continue
                except OSError:
                    continue
            stale.unlink(missing_ok=True)
    try:
        lib = ctypes.CDLL(str(out))
    except OSError as exc:
        logger.warning("dlopen %s failed: %s", out, exc)
        return None
    _cache[name] = lib
    return lib
