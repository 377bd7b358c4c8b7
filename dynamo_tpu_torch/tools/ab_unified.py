"""Time the unified step (the main serving path) of two checkouts of the
port on one card, in turns.

    python3 dynamo_tpu_torch/tools/ab_unified.py BASE_DIR CHANGE_DIR [--reps N]

Each directory is a checkout of the repository (a ``git archive`` of a
commit, unpacked). Both build their kernels first, in parallel. Then
BASE, CHANGE, CHANGE, BASE run one after another, each in its own
process from its own directory: a ``TorchEngine`` for llama3.2-1b in
bf16 at ``chip_smoke.py``'s full-width config (random weights from seed
0), with caches in bf16 and then in int8, serves ``chip_smoke.py``'s 8
prompts (32 tokens each, all submitted at once) through ``generate``:
``engine.warmup()`` where the checkout has it (it captures the step's
CUDA graphs), a warm-up serve, N timed serves (wall ms per unified
dispatch, tokens/s, median TTFT), then one serve under ``torch.profiler``
(device ms per dispatch: the sum of the card's kernels and copies over
the dispatches).
Prints one JSON line per process, then the card's name and power limit
and a summary line: the median of each number per checkout and cache
dtype over its processes. Needs one CUDA device.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

BUILD = """
from dynamo_tpu_torch.ops.kernels import KERNEL_SOURCES, _build
_build.build_all(KERNEL_SOURCES)
"""

RUN = """
import asyncio, json, sys
import numpy as np
import torch
import chip_smoke as cs
from dynamo_tpu_torch.engine.engine import TorchEngine

reps = int(sys.argv[1])
rng = np.random.default_rng(1)
vocab = cs.full_width_config().model.vocab_size
lens = rng.integers(64, 513, 8)
prompts = [rng.integers(0, vocab, n).tolist() for n in lens]
max_tokens = 32


async def leg(kv_quant):
    engine = TorchEngine(cs.full_width_config(kv_quant=kv_quant), device="cuda")
    await engine.start()
    got = {}
    try:
        if hasattr(engine, "warmup"):
            await engine.warmup()
        await cs.serve(engine, prompts, max_tokens)                 # warm-up
        for _ in range(reps):
            d0 = engine.unified_dispatches
            streams, _, ttft, wall = await cs.serve(engine, prompts, max_tokens)
            n = engine.unified_dispatches - d0
            for key, value in (
                ("wall_ms_per_dispatch", wall * 1e3 / n),
                ("tokens_per_s", sum(map(len, streams)) / wall),
                ("ttft_p50_ms", float(np.median(ttft)) * 1e3),
            ):
                got.setdefault(key, []).append(value)
        prof = await cs.profile_serve(engine, prompts, max_tokens)
        got["profiled_device_ms_per_dispatch"] = [prof["device_ms_per_dispatch"]]
        got["profiled_wall_ms_per_dispatch"] = [prof["wall_ms_per_dispatch"]]
    finally:
        await engine.stop()
    return got


out = {kv or "bf16": asyncio.run(leg(kv)) for kv in (None, "int8")}
print(json.dumps(out))
"""


def run(code: str, cwd: Path, *args: str) -> subprocess.Popen:
    return subprocess.Popen(
        [sys.executable, "-c", code, *args], cwd=cwd, stdout=subprocess.PIPE, text=True,
    )


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("base", type=Path)
    ap.add_argument("change", type=Path)
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()
    trees = {"base": args.base.resolve(), "change": args.change.resolve()}
    builds = [run(BUILD, path) for path in trees.values()]
    if any(p.wait() for p in builds):
        raise SystemExit("a checkout's kernels failed to build")
    got: dict[str, dict[str, dict[str, list[float]]]] = {name: {} for name in trees}
    for name in ("base", "change", "change", "base"):
        proc = run(RUN, trees[name], str(args.reps))
        out, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"{name} run failed")
        line = json.loads(out.strip().splitlines()[-1])
        print(json.dumps({"tree": name, **line}), flush=True)
        for kv, numbers in line.items():
            for key, values in numbers.items():
                got[name].setdefault(kv, {}).setdefault(key, []).extend(values)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader", "-i", "0"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    print(card, flush=True)
    print(json.dumps({name: {kv: {key: statistics.median(v) for key, v in m.items()}
                             for kv, m in legs.items()}
                      for name, legs in got.items()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
