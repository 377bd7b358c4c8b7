"""The weight-quantized GEMM under every plan the rows entry may take.

    cd <checkout> && python3 <this file> [--out FILE]

Builds the checkout's ``wq_gemm`` kernel, then, for llama3.2-1b's and
llama3-8b's int8 projections, MLP and tied head at 64, 128 and 256 rows
(bf16 activations), times the wrapper (device ms, CUDA-graph replay)
under each token tile and K split that ``kernel_plan``'s rules allow and
under the plan it picks, with the cost model's estimate beside each.
Prints one JSON line per shape: every plan's µs, the best, the picked
plan and its share of the best (how far the cost model, whose constants
were fitted to such timings, is from the measured optimum). Needs one
CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.getcwd())   # the checkout's own package

import torch  # noqa: E402

from dynamo_tpu_torch.ops import quant as tq  # noqa: E402
from dynamo_tpu_torch.ops.kernels import wq_gemm as wk  # noqa: E402

# name: (N, K, transposed, float32 out)
SHAPES = {
    "llama3.2-1b_q": (2048, 2048, False, False),
    "llama3.2-1b_kv": (512, 2048, False, False),
    "llama3.2-1b_gate_up": (8192, 2048, False, False),
    "llama3.2-1b_down": (2048, 8192, False, False),
    "llama3.2-1b_tied_head": (128256, 2048, True, True),
    "llama3-8b_q": (4096, 4096, False, False),
    "llama3-8b_gate_up": (14336, 4096, False, False),
    "llama3-8b_down": (4096, 14336, False, False),
}
ROWS = (64, 128, 256)


def device_us(fn, iters: int = 10) -> float:
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(5):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) * 1e3 / (5 * iters)


def candidates(M: int, N: int, K: int, num_sms: int) -> list:
    """Every (token tile, split) plan the rows entry's rules allow."""
    plans = []
    for bt in wk.TOKEN_TILES:
        if bt >= 2 * M and bt != wk.TOKEN_TILES[-1]:
            continue
        tiles = -(-N // wk.BN) * -(-M // bt)
        most = 1 if bt == 256 else wk._max_splits(tiles, M, K)
        for s in range(1, most + 1):
            stages = -(-K // wk.BK)
            per = -(-stages // s)
            splits = -(-stages // per)
            if splits != s:
                continue
            slots = num_sms * wk.BLOCKS_PER_SM[bt]
            plans.append(wk.Plan("rows", bt, s, per * wk.BK, tiles, min(tiles * s, slots),
                                 s * M * N if s > 1 else 0))
    return plans


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", help="also write the lines to this file")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("wq_sweep: no CUDA device", file=sys.stderr)
        return 1
    wk.build()
    num_sms = torch.cuda.get_device_properties(0).multi_processor_count
    real = wk.kernel_plan
    lines = []
    gen = torch.Generator(device="cuda")
    for name, (N, K, tr, f32_out) in SHAPES.items():
        gen.manual_seed(N + K)
        shape = (1, N, K) if tr else (1, K, N)
        w = (torch.randn(shape, generator=gen, device="cuda") / K ** 0.5).to(torch.bfloat16)
        qw = tq.quantize_weight(w, axis=-1 if tr else -2, fmt="int8")
        del w
        for M in ROWS:
            a = torch.randn((1, M, K), generator=gen, device="cuda").to(torch.bfloat16)
            out = torch.empty(1, M, N, device="cuda",
                              dtype=torch.float32 if f32_out else torch.bfloat16)
            timed = {}
            try:
                for plan in candidates(M, N, K, num_sms):
                    wk.kernel_plan = lambda *_a, _p=plan, **_k: _p
                    key = f"bt{plan.bt}_S{plan.splits}"
                    timed[key] = {
                        "us": device_us(lambda: wk.wq_gemm_cuda(a, qw["q"], qw["s"], out=out,
                                                                transposed=tr)),
                        "model_us": wk._rows_cost(1, M, N, K, num_sms, plan.bt, plan.splits)}
            finally:
                wk.kernel_plan = real
            picked = real(1, M, N, K, num_sms)
            best = min(timed, key=lambda k: timed[k]["us"])
            key = f"bt{picked.bt}_S{picked.splits}"
            line = {"shape": name, "M": M, "N": N, "K": K, "plans": timed, "best": best,
                    "picked": key, "picked_over_best": timed[key]["us"] / timed[best]["us"],
                    "card": torch.cuda.get_device_name(0)}
            lines.append(line)
            print(json.dumps(line), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write("".join(json.dumps(x) + "\n" for x in lines))
    return 0


if __name__ == "__main__":
    sys.exit(main())
