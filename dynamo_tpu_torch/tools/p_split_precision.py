"""How many bf16 terms the prefill tensor-core tile needs for P in P.V.

    python3 dynamo_tpu_torch/tools/p_split_precision.py [--trials N] [--terms 1 2 3]

The tile (csrc/paged_attention_tc.cuh) feeds the softmax weights P to a
bf16 tensor-core product, as a sum of bf16 terms (value, remainder, ...).
This emulates that on the CPU, on the shapes of chip_smoke.py's main
prefill case (prompts of 276/293/403/490 tokens, 32 heads, D=64, causal,
random normal q/k/v rounded to bf16): P is the plain version's f32
weights, split into ``terms`` bf16 terms; the output sum runs in float64
so that only the split differs from the plain version. Each lane's
output, rounded to bf16, is held against the plain output rounded to
bf16, as chip_smoke.py compares them. Prints, per term count, the worst
difference and how many lanes exceed the bf16 tolerance of 1e-2.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

LANES = (276, 293, 403, 490)
H, D = 32, 64
TOL = 1e-2


def split(p: torch.Tensor, terms: int) -> torch.Tensor:
    """p as the sum of ``terms`` bf16 terms: each the rounded remainder
    of the ones before."""
    out, rest = torch.zeros_like(p), p.clone()
    for _ in range(terms):
        t = rest.to(torch.bfloat16).float()
        out += t
        rest -= t
    return out


def lane_errors(rng, L: int, term_counts) -> dict[int, float]:
    q, k, v = (torch.from_numpy(rng.standard_normal((L, H, D))).bfloat16().float()
               for _ in range(3))
    s = torch.einsum("thd,shd->hts", q * D**-0.5, k)
    mask = torch.tril(torch.ones(L, L, dtype=torch.bool))
    s = torch.where(mask, s, torch.tensor(-1e30))
    p = torch.where(mask, torch.exp(s - s.amax(-1, keepdim=True)), torch.tensor(0.0))
    l = p.sum(-1, keepdim=True).double()

    def out(weights):
        o = torch.einsum("hts,shd->htd", weights.double(), v.double()) / l
        return o.float().bfloat16().float()

    plain = out(p)
    return {n: (out(split(p, n)) - plain).abs().max().item() for n in term_counts}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--trials", type=int, default=6)
    ap.add_argument("--terms", type=int, nargs="+", default=[1, 2, 3])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    rng = np.random.default_rng(args.seed)
    errs: dict[int, list[float]] = {n: [] for n in args.terms}
    for _ in range(args.trials):
        for L in LANES:
            for n, e in lane_errors(rng, L, args.terms).items():
                errs[n].append(e)
    for n, e in errs.items():
        print(json.dumps({"terms": n, "lanes": len(e), "max_abs_err": max(e),
                          "lanes_over_tol": sum(x > TOL for x in e), "tol": TOL}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
