"""Build the port's hand-written CUDA kernels and load them with ctypes.

Each ``csrc/<name>.cu`` compiles on first use with ``nvcc`` for
``sm_90a`` into ``dynamo_tpu_torch/_build/lib<name>.so`` (a directory git
ignores): a plain C interface, no PyTorch headers, so a build takes
seconds. ``build_all`` starts one ``nvcc`` per source at once and waits
for all of them. Nothing here runs at import time: the CPU tests import
every module on machines without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
]

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError(
        "nvcc not found: the port's CUDA kernels build from "
        "dynamo_tpu_torch/csrc on a machine with the CUDA toolkit"
    )


def source_path(name: str) -> Path:
    return CSRC_DIR / f"{name}.cu"


def library_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}.so"


def nvcc_command(nvcc: str, name: str, out: Path) -> list[str]:
    return [nvcc, *NVCC_FLAGS, "-o", str(out), str(source_path(name))]


def _stale(name: str) -> bool:
    """The library is missing or older than its source or a shared
    header (``csrc/*.cuh``)."""
    lib = library_path(name)
    if not lib.exists():
        return True
    sources = [source_path(name), *CSRC_DIR.glob("*.cuh")]
    return lib.stat().st_mtime < max(p.stat().st_mtime for p in sources)


def build_all(names: list[str]) -> dict[str, str]:
    """Compile every stale kernel library in parallel (one nvcc each,
    all started together). Returns {name: ptxas report, ending with a
    line ``nvcc seconds: <wall time of that nvcc>``}. Raises with the
    compiler's output if any build fails."""
    todo = [n for n in names if _stale(n)]
    if not todo:
        return {}
    nvcc = nvcc_path()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.monotonic()
    procs = {}
    for name in todo:
        tmp = BUILD_DIR / f"lib{name}.so.tmp{os.getpid()}"
        procs[name] = (
            tmp,
            subprocess.Popen(
                nvcc_command(nvcc, name, tmp),
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            ),
        )

    def finish(proc):
        output, _ = proc.communicate()
        return f"{output}\nnvcc seconds: {time.monotonic() - t0:.1f}\n"

    with ThreadPoolExecutor(len(procs)) as pool:
        outputs = {name: pool.submit(finish, proc) for name, (_, proc) in procs.items()}
    reports, failed = {}, []
    for name, (tmp, proc) in procs.items():
        output = outputs[name].result()
        reports[name] = output
        if proc.returncode != 0:
            failed.append(f"{name}:\n{output}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, library_path(name))
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return reports


def load(name: str) -> ctypes.CDLL:
    """The kernel library ``name``, built first if it is missing or
    older than its source."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build_all([name])
            lib = ctypes.CDLL(str(library_path(name)))
            _libs[name] = lib
        return lib


def launch(name: str, symbol: str, argtypes: list, *args) -> None:
    """Call the launcher ``symbol`` of kernel library ``name`` (a C
    function returning a CUDA error code, with ``<symbol>_error`` for its
    message); raises if the launch failed. ``argtypes`` declares the
    signature on first use: pointers as c_void_p, so none is cut to 32
    bits."""
    lib = load(name)
    fn = getattr(lib, symbol)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        err = getattr(lib, f"{symbol}_error")
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
    code = fn(*args)
    if code:
        msg = getattr(lib, f"{symbol}_error")(code).decode()
        raise RuntimeError(f"{symbol} kernel launch failed: {msg}")
