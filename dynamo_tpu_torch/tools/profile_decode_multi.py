"""Profile one ``decode_multi`` of the checkout in the current directory.

    cd <checkout> && python3 <this file> LABEL

Builds nothing itself (kernels build on first use). Runs ``ModelRunner``
for llama3.2-1b in bf16 at ``chip_smoke.py``'s full-width config (random
weights from seed 0) on the 4 prompts of ``chip_smoke.py``'s phase-split
run: two timed ``prefill_batch`` + ``decode_multi`` rounds (the first is
the warm-up), then one ``decode_multi`` of 32 steps under
``torch.profiler``. Prints a JSON line per round, then one with the
profiled wall, the device's busy ms (the sum of its kernels and copies),
the top device kernels and the top host ops by self CPU time with their
call counts, so that two checkouts' host work can be compared op by op.
Needs one CUDA device.
"""

from __future__ import annotations

import json
import os
import sys
import time

sys.path.insert(0, os.getcwd())   # the checkout's own chip_smoke and package

import numpy as np  # noqa: E402
import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

import chip_smoke as cs  # noqa: E402
from dynamo_tpu_torch.engine.runner import ModelRunner  # noqa: E402


def main() -> int:
    label = sys.argv[1] if len(sys.argv) > 1 else os.path.basename(os.getcwd())
    rng = np.random.default_rng(1)
    ecfg = cs.full_width_config()
    lens = rng.integers(64, 513, 8)
    prompts = [rng.integers(0, ecfg.model.vocab_size, n).tolist()
               for n in lens][:cs.PHASE_LANES]
    runner = ModelRunner(ecfg, device="cuda")
    for _ in range(2):
        _, times = cs.phase_split(runner, prompts, 32)
        print(json.dumps({"tree": label, **times}), flush=True)

    B, steps = len(prompts), 32
    blocks, table = cs.contiguous_tables([len(p) for p in prompts], steps,
                                         ecfg.max_blocks_per_seq)
    first = runner.prefill_batch([(p, b, 0, (0.0, 0, 1.0)) for p, b in zip(prompts, blocks)])
    n = np.asarray([len(p) for p in prompts], np.int32)
    zeros = np.zeros(B, np.float32)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        runner.decode_multi(np.asarray(first, np.int32), n, table, n + 1, zeros,
                            np.zeros(B, np.int32), zeros + 1.0, num_steps=steps)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    device: dict[str, float] = {}
    for e in prof.events():
        if str(e.device_type).endswith("CUDA"):
            device[e.name[:60]] = device.get(e.name[:60], 0.0) + e.time_range.elapsed_us() / 1e3
    host = sorted(((k.key[:60], k.self_cpu_time_total / 1e3, k.count)
                   for k in prof.key_averages()), key=lambda x: -x[1])[:15]
    print(json.dumps({
        "tree": label, "steps": steps, "profiled_wall_ms": wall,
        "device_busy_ms": sum(device.values()),
        "top_device_ms": sorted(device.items(), key=lambda kv: -kv[1])[:10],
        "top_host_self_ms_calls": host,
    }), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
