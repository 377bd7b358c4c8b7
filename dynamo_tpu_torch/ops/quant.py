"""Weight access sites (port of the unquantized arms of
dynamo_tpu/ops/quant.py ``qdot``/``embed_lookup``/``tied_head_mm``).

Every matmul on the unified path goes through these three functions, as
in the reference, so the weight-quantization slice (ROADMAP queue A7)
changes only this module. Until then a quantized ``{"q", "s"}`` weight
raises ``NotImplementedError``.
"""

from __future__ import annotations

import torch


def _plain(w):
    if isinstance(w, dict):
        raise NotImplementedError(
            "quantized {'q','s'} weights arrive with the weight-quant "
            "slice of the port (ROADMAP queue A7)"
        )
    return w


def qdot(x: torch.Tensor, w) -> torch.Tensor:
    """``x @ w`` with ``w`` in the reference's ``[in, out]`` layout."""
    return x @ _plain(w)


def embed_lookup(embed, token_ids: torch.Tensor) -> torch.Tensor:
    """Embedding-table row gather."""
    return _plain(embed)[token_ids]


def tied_head_mm(h: torch.Tensor, embed) -> torch.Tensor:
    """``h @ embed.T`` (tied lm_head)."""
    return h @ _plain(embed).T
