"""Time the phase-split entry points of two checkouts of the port on one
card, in turns.

    python3 dynamo_tpu_torch/tools/ab_phase_split.py BASE_DIR CHANGE_DIR [--reps N]

Each directory is a checkout of the repository (a ``git archive`` of a
commit, unpacked). Both build their kernels first, in parallel. Then
BASE, CHANGE, CHANGE, BASE run one after another, each in its own
process from its own directory: ``ModelRunner`` for llama3.2-1b in bf16
at ``chip_smoke.py``'s full-width config (random weights from seed 0),
the 4 prompts of ``chip_smoke.py``'s phase-split run; a warm-up round,
then N timed rounds of ``prefill_batch`` + ``decode_multi`` (32 steps),
and N times the decode kernel's wrapper alone, 500 calls back to back at
the run's middle decode step (its host cost per call). Prints one JSON
line per process, then the card's name and power limit and a summary
line: the median of each number per checkout over its processes.
Needs one CUDA device.
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
import json, sys
import numpy as np
import torch
import chip_smoke as cs
from dynamo_tpu_torch.engine.runner import ModelRunner

reps = int(sys.argv[1])
rng = np.random.default_rng(1)
ecfg = cs.full_width_config()
lens = rng.integers(64, 513, 8)
prompts = [rng.integers(0, ecfg.model.vocab_size, n).tolist() for n in lens][:cs.PHASE_LANES]
runner = ModelRunner(ecfg, device="cuda")
cs.phase_split(runner, prompts, 32)                      # warm-up
rounds = [cs.phase_split(runner, prompts, 32)[1] for _ in range(reps)]
got = {k: [r[k] for r in rounds] for k in ("prefill_batch_ms", "decode_ms_per_step")}
# The decode wrapper alone, back to back at the run's middle step: its
# host cost per call (the kernel's device time is far below it).
lens4 = [len(p) for p in prompts]
_, table = cs.contiguous_tables(lens4, 32, ecfg.max_blocks_per_seq)
c = cs.decode_case(np.random.default_rng(1), [n + 17 for n in lens4], torch.bfloat16,
                   num_blocks=ecfg.num_blocks, tables=table)
got["decode_wrapper_host_ms"] = [cs.host_ms(lambda: cs.decode_kernel(c), 500)
                                 for _ in range(reps)]
print(json.dumps(got))
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
    got: dict[str, dict[str, list[float]]] = {name: {} for name in trees}
    for name in ("base", "change", "change", "base"):
        proc = run(RUN, trees[name], str(args.reps))
        out, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"{name} run failed")
        line = json.loads(out.strip().splitlines()[-1])
        print(json.dumps({"tree": name, **line}), flush=True)
        for key, values in line.items():
            got[name].setdefault(key, []).extend(values)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader", "-i", "0"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    print(card, flush=True)
    print(json.dumps({name: {key: statistics.median(v) for key, v in m.items()}
                      for name, m in got.items()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
