"""The unified step's batch extents (port of the shape rules in
dynamo_tpu/engine/compile_cache.py).

The port compiles nothing per shape, but the budget ladder is still the
set of flat-batch extents a unified dispatch can have: batches snap UP
onto it, which keeps the set of shapes the kernels see small and makes
both packages pad a batch identically.
"""

from __future__ import annotations


def _bucket(n: int, minimum: int = 16) -> int:
    """Next power-of-two bucket ≥ n."""
    b = minimum
    while b < n:
        b *= 2
    return b


def token_budget(n: int, cap: int, minimum: int = 16) -> int:
    """Snap a unified batch's token count UP onto the budget ladder
    {minimum, 2*minimum, ..., bucket(cap)}."""
    return min(_bucket(max(n, 1), minimum=minimum), _bucket(cap, minimum=minimum))


def budget_ladder(cap: int, minimum: int = 16) -> list[int]:
    """Every budget the unified path can dispatch."""
    out = []
    b = minimum
    top = _bucket(cap, minimum=minimum)
    while b <= top:
        out.append(b)
        b *= 2
    return out
