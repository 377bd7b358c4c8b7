"""Crash-consistent small-file writes: tmp + ``os.replace`` + fsync (port
of dynamo_tpu/utils/atomic_io.py).

A reader after a crash sees either the complete previous contents or the
complete new contents, never a truncated tail: ``os.replace`` is atomic
on POSIX, and the fsync pair (file, then parent directory) makes the
rename durable. The tmp file lives in the target's directory so the
replace never crosses a filesystem boundary. The flight recorder's fault
dump writes through here.
"""

from __future__ import annotations

import os
from pathlib import Path


def atomic_write_bytes(path: Path | str, data: bytes) -> None:
    """Write ``data`` to ``path`` all-or-nothing (tmp+replace+fsync)."""
    path = Path(path)
    tmp = path.with_suffix(path.suffix + ".tmp")
    fd = os.open(tmp, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o644)
    try:
        os.write(fd, data)
        os.fsync(fd)
    finally:
        os.close(fd)
    os.replace(tmp, path)
    # Durability of the rename itself: fsync the parent directory (some
    # filesystems, tmpfs among them, refuse; the rename stays atomic).
    try:
        dfd = os.open(path.parent, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(dfd)
    except OSError:
        pass
    finally:
        os.close(dfd)


def atomic_write_text(path: Path | str, text: str) -> None:
    atomic_write_bytes(path, text.encode("utf-8"))
