"""Device time of the ragged attention wrapper, kernel by kernel.

    cd <checkout> && python3 <this file> LABEL [--blocks-per-sm N ...]
        [--tile-ranges R ...] [--only NAME ...] [--decode-prefill]

Builds the checkout's ragged kernels, then, for each value of the split
plan's blocks per SM (default: the module's ``split_blocks_per_sm``),
times the wrapper on its cases. At llama3.2-1b attention shapes (H=32,
kvH=8, D=64, bs=16, no window): ``chip_smoke.py``'s mixed T=256 batch
with caches in bf16 and in int8, and two of the full-width serve's
dispatches: 8 decode spans at contexts 95-505 (T=16, 64-column tables)
with each cache dtype, and 4 decode spans beside 4 prefill quanta of
60-64 rows (T=256).
At the families' shapes, each with caches in bf16 and in int8:
``chip_smoke.py``'s phase 12 cases (gemma3-1b (4, 1, 256), window 512,
6 decode + 3 prefill spans, T=256, 80 columns; mistral-7b (32, 8, 128),
window 4096, 4 decode spans at contexts 4200-4700 + prefill spans of 64
and 96 rows, T=192, 320 columns), their long-prefix twins (the
prefill spans alone, with no decode span) and mistral's decode spans
alone (T=16: the split path by itself).

Prints one JSON line per case: the plans (the split path's splits and
pages, the tile's key ranges), the wrapper's device ms (CUDA-graph
replay), each kernel's mean device ms over 30 calls under
``torch.profiler`` (kernels that overlap each count in full), the bound,
one SDPA call over the gathered K/V (the yardstick ``chip_smoke.py``
times; at the families' shapes only), and the error against the plain
version. ``--tile-ranges`` times the cases again with the tile's key
ranges forced to each value instead of ``ragged_tile_plan``'s.
``--decode-prefill`` also runs ``chip_smoke.py``'s decode and prefill
kernel phases on the full-width serve's lanes and prints their timing
lines. The card's name and power limit come first. Needs one
CUDA device.
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
GEMMA_PREFILL = [(0, 64), (480, 64), (900, 100), (0, 0)]
GEMMA_MIXED = [(c - 1, 1) for c in (300, 511, 513, 700, 1024, 1200)] + GEMMA_PREFILL
MISTRAL_PREFILL = [(4300, 64), (4100, 96), (0, 0)]
MISTRAL_DECODE = [(c - 1, 1) for c in (4200, 4350, 4511, 4700)]
MISTRAL_MIXED = MISTRAL_DECODE + MISTRAL_PREFILL
GEMMA = dict(dims=(4, 1, 256, 16), max_blocks=80, num_blocks=1024)
MISTRAL = dict(dims=(32, 8, 128, 16), max_blocks=320, num_blocks=2304)
# (name, spans, T, window, make_case keywords); each runs with caches in
# q's dtype and again in int8 (name prefixed "int8_").
CASES = [
    ("mixed_T256", MIXED, 256, 0, {}),
    ("serve_decode8_T16", SERVE_DECODE, 16, 0, dict(max_blocks=64)),
    ("serve_mixed_T256", SERVE_MIXED, 256, 0, dict(max_blocks=64)),
    ("gemma_w512", GEMMA_MIXED, 256, 512, GEMMA),
    ("gemma_prefill_w512", GEMMA_PREFILL, 256, 512, GEMMA),
    ("mistral_w4096", MISTRAL_MIXED, 192, 4096, MISTRAL),
    ("mistral_prefill_w4096", MISTRAL_PREFILL, 192, 4096, MISTRAL),
    ("mistral_decode_w4096", MISTRAL_DECODE + [(0, 0)], 16, 4096, MISTRAL),
]
FAMILY_CASES = {"gemma_w512", "gemma_prefill_w512", "mistral_w4096", "mistral_prefill_w4096",
                "mistral_decode_w4096"}


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


def plans(c, window: int) -> dict:
    """The plans the wrapper makes for this case's call."""
    return {"split": cs.ragged_plan(c, window), "tile_ranges": cs.tile_plan(c, window)}


def run_case(label, blocks, name, spans, T, window, kv, kw, forced=None) -> None:
    c = cs.make_case(np.random.default_rng(0), spans, T, torch.bfloat16, kv_dtype=kv, **kw)

    def fn(c=c):
        return cs.run_kernel(c, window)

    err = cs.max_err(fn(), cs.run_plain(c, window))
    line = {
        "tree": label, "blocks_per_sm": blocks, "tile_ranges_forced": forced,
        "case": ("int8_" if kv else "") + name,
        "plan": plans(c, window), "ms": cs.device_ms(fn, 20), "max_abs_err": err,
        "per_kernel_ms": kernel_ms(fn),
    }
    nbytes, flops = cs.ragged_work(c, window)
    line["bound_ms"], line["bound_by"] = cs.bound(nbytes, flops, torch.bfloat16)
    if name in FAMILY_CASES:
        library, _ = cs.ragged_library(c, window)
        line["library_ms"] = cs.device_ms(library, 5)
    print(json.dumps(line), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("label")
    ap.add_argument("--blocks-per-sm", type=int, nargs="+", default=[None],
                    help="force the split plan's blocks per SM (default: the module's)")
    ap.add_argument("--tile-ranges", type=int, nargs="+", default=[])
    ap.add_argument("--only", nargs="+", default=None, help="case names to run")
    ap.add_argument("--decode-prefill", action="store_true")
    args = ap.parse_args()
    print(cs.card_line(), flush=True)
    names = ["ragged_attention"]
    if args.decode_prefill:
        names += ["paged_decode_attention", "paged_prefill_attention"]
    reports = _build.build_all(names)
    print(json.dumps({"tree": args.label, "ptxas": cs.ptxas_summary(reports)}), flush=True)
    planned = ra.ragged_tile_plan
    planned_blocks = ra.split_blocks_per_sm
    for blocks in args.blocks_per_sm:
        ra.split_blocks_per_sm = (planned_blocks if blocks is None
                                  else lambda *a, n=blocks: n)
        ra.ragged_split_plan.cache_clear()
        pd.decode_split_plan.cache_clear()
        for forced in [None, *args.tile_ranges]:
            if forced is not None:
                ra.ragged_tile_plan = lambda *a, n=forced, **k: n
            for name, spans, T, window, kw in CASES:
                if args.only and name not in args.only:
                    continue
                for kv in (None, torch.int8):
                    run_case(args.label, blocks, name, spans, T, window, kv, kw, forced)
            ra.ragged_tile_plan = planned
    if args.decode_prefill:
        # chip_smoke.py's run_all draws the phase-split lanes so.
        rng = np.random.default_rng(1)
        lens = [int(n) for n in rng.integers(64, 513, 8)[:cs.PHASE_LANES]]
        for phase in (cs.phase_decode, cs.phase_prefill):
            print(json.dumps({"tree": args.label, **phase(lens, 32)}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
