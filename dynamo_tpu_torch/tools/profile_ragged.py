"""Device time of the ragged attention wrapper, kernel by kernel.

    cd <checkout> && python3 <this file> LABEL [--blocks-per-sm N ...]

Builds the checkout's ragged kernels, then, for each value of the split
plan's ``BLOCKS_PER_SM`` (default: the module's own), times the wrapper
on five cases at llama3.2-1b attention shapes (H=32, kvH=8, D=64,
bs=16, bf16 q): ``chip_smoke.py``'s mixed T=256 batch with caches in
bf16 and in int8, and two of the full-width serve's dispatches: 8 decode
spans at contexts 95-505 (T=16, 64-column tables) with each cache dtype,
and 4 decode spans beside 4 prefill quanta of 60-64 rows (T=256). Prints
one JSON line per case: the plan, the wrapper's device ms (CUDA-graph
replay) and each kernel's mean device ms over 30 calls under
``torch.profiler`` (kernels that overlap each count in full), with the
error against the plain version. Needs one CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.getcwd())   # the checkout's own chip_smoke and package

import numpy as np  # noqa: E402
import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

import chip_smoke as cs  # noqa: E402
from dynamo_tpu_torch.ops.kernels import _build  # noqa: E402
from dynamo_tpu_torch.ops.kernels import paged_decode_attention as pd  # noqa: E402
from dynamo_tpu_torch.ops.kernels import ragged_attention as ra  # noqa: E402

DECODE = [(c - 1, 1) for c in (64, 130, 257, 300, 411, 512, 600, 1)]
MIXED = DECODE + [(0, 64), (128, 64), (32, 100), (0, 0)]
SERVE_DECODE = [(c - 1, 1) for c in (290, 305, 415, 505, 95, 140, 450, 505)]
SERVE_MIXED = [(300, 1), (420, 1), (96, 1), (500, 1), (128, 64), (256, 64), (0, 64), (64, 60)]
# (name, spans, T, cache dtype or None for q's, make_case keywords)
CASES = [
    ("mixed_T256", MIXED, 256, None, {}),
    ("int8_mixed_T256", MIXED, 256, torch.int8, {}),
    ("serve_decode8_T16", SERVE_DECODE, 16, None, dict(max_blocks=64)),
    ("int8_serve_decode8_T16", SERVE_DECODE, 16, torch.int8, dict(max_blocks=64)),
    ("serve_mixed_T256", SERVE_MIXED, 256, None, dict(max_blocks=64)),
]


def kernel_ms(fn, calls: int = 30) -> dict[str, float]:
    """Mean device ms per call of each kernel fn() launches."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    by: dict[str, float] = {}
    for e in prof.events():
        if str(e.device_type).endswith("CUDA"):
            name = e.name.split("<")[0].split("::")[-1]
            by[name] = by.get(name, 0.0) + e.time_range.elapsed_us() / 1e3 / calls
    return by


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("label")
    ap.add_argument("--blocks-per-sm", type=int, nargs="+", default=[ra.BLOCKS_PER_SM])
    args = ap.parse_args()
    _build.build_all(["ragged_attention"])
    for blocks in args.blocks_per_sm:
        ra.BLOCKS_PER_SM = blocks
        ra.ragged_split_plan.cache_clear()
        pd.decode_split_plan.cache_clear()
        for name, spans, T, kv, kw in CASES:
            c = cs.make_case(np.random.default_rng(0), spans, T, torch.bfloat16,
                             kv_dtype=kv, **kw)

            def fn(c=c):
                return cs.run_kernel(c)

            err = cs.max_err(fn(), cs.run_plain(c))
            print(json.dumps({
                "tree": args.label, "blocks_per_sm": blocks, "case": name,
                "plan": list(ra.call_split_plan(c["q"], c["k"], c["tables"], c["bs"])),
                "ms": cs.device_ms(fn, 20), "max_abs_err": err,
                "per_kernel_ms": kernel_ms(fn),
            }), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
