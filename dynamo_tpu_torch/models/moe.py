"""Routed-experts MLP (port of dynamo_tpu/models/moe.py): a top-k router
(softmax, or sigmoid with a selection bias and group-limited choice) and
two formulations of the expert SwiGLUs.

- ``dense`` runs every expert on every token and weighs the outputs by
  the router's gates (zero off each token's top-k): exact, and at a
  decode-size token count no slower than dispatching, since either way
  the step reads every expert's weights once.
- ``capacity`` gathers each expert's tokens into a fixed ``[E, C, D]``
  buffer, C = ceil(T·k/E · capacity_factor), and runs only those rows.
  Each (token, expert) pair ranks by its arrival in the flattened
  ``[T·k]`` list; pairs ranked C or later drop (contribute zero), the
  reference's overflow rule. Pad rows of a budget-padded batch come last
  in that order, so they only ever drop themselves.
- ``auto`` is capacity at 16 experts or more, and dense below that or
  when the batch is too small for C to stay clear of collisions
  (``auto_capacity_ok``).

The JAX package computes the experts with XLA einsums, not a Pallas
kernel; here they are batched matrix products (``ops/quant.py``
``expert_mm``: the weights' dtype in, float32 out; ``expert_mm_f32``
for ``w_down``, whose float32 input stays float32; quantized stacked
weights, scaled per (expert, out), go through the wq_gemm kernel with
the experts as its batch). Every shape follows
from T, a host integer fixed per budget rung, so a dispatch never reads
the card back and a CUDA graph captures either formulation.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F

from dynamo_tpu_torch.ops.quant import expert_mm, expert_mm_f32, weight_dtype

# Dense runs E/topk times the selected FLOPs; capacity pays the gather
# and scatter. E=16 is the reference's crossover.
AUTO_CAPACITY_MIN_EXPERTS = 16


@dataclass(frozen=True)
class MoeConfig:
    hidden_size: int = 64
    intermediate_size: int = 128   # per expert
    num_experts: int = 8
    num_experts_per_tok: int = 2
    # Router scoring: "softmax" (Mixtral, DeepSeek-V2) or "sigmoid"
    # (DeepSeek-V3/R1, with a per-expert selection bias).
    gating: str = "softmax"
    norm_topk_prob: bool = True
    routed_scaling_factor: float = 1.0
    # Group-limited selection: experts split into n_group groups, and
    # only the topk_group best groups stay eligible.
    n_group: int = 1
    topk_group: int = 1
    dispatch: str = "auto"         # "dense" | "capacity" | "auto"
    capacity_factor: float = 2.0

    @property
    def resolved_dispatch(self) -> str:
        """The expert-count half of the ``auto`` rule (``moe_mlp`` adds
        the token-count half, ``auto_capacity_ok``)."""
        if self.dispatch == "auto":
            return (
                "capacity"
                if self.num_experts >= AUTO_CAPACITY_MIN_EXPERTS
                else "dense"
            )
        return self.dispatch

    def auto_capacity_ok(self, num_tokens: int) -> bool:
        """``auto`` takes capacity only with >= 2 routed pairs per expert,
        so C stays clear of collision range; an explicit "capacity"
        bypasses this."""
        return num_tokens * self.num_experts_per_tok >= 2 * self.num_experts

    def uses_capacity(self, num_tokens: int) -> bool:
        """The formulation a call over ``num_tokens`` rows takes."""
        return self.resolved_dispatch == "capacity" and (
            self.dispatch != "auto" or self.auto_capacity_ok(num_tokens)
        )

    def capacity(self, num_tokens: int) -> int:
        """C, each expert's rows in the capacity formulation."""
        return max(1, int(math.ceil(
            num_tokens * self.num_experts_per_tok / self.num_experts
            * self.capacity_factor
        )))


def _top_k(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(values, indices) of the k largest along the last axis, ties to
    the lower index (``jax.lax.top_k``'s order)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def moe_router(params: dict, x: torch.Tensor, cfg: MoeConfig) -> torch.Tensor:
    """Top-k routing → dense float32 gates [T, E], nonzero only on each
    token's selected experts.

    softmax: probs over all experts, top-k by prob, optionally
    renormalized over the selection. sigmoid: probs = sigmoid(logits);
    the SELECTION ranks probs + ``router_bias``, the WEIGHTS are the raw
    probs of the selected experts, renormalized, then scaled by
    ``routed_scaling_factor``."""
    logits = x.float() @ params["w_router"].float()
    if cfg.gating == "sigmoid":
        probs = torch.sigmoid(logits)
        sel = probs + params["router_bias"].float() if "router_bias" in params else probs
    else:
        probs = torch.softmax(logits, dim=-1)
        sel = probs
    if cfg.n_group > 1:
        # Group-limited eligibility: V3/R1 (sigmoid) score a group by the
        # sum of its top-2 biased scores, V2 (softmax) by its max.
        T, E = sel.shape
        per = E // cfg.n_group
        grouped = sel.reshape(T, cfg.n_group, per)
        if cfg.gating == "sigmoid":
            group_scores = torch.topk(grouped, min(2, per), dim=-1).values.sum(-1)
        else:
            group_scores = grouped.amax(dim=-1)
        _, keep = _top_k(group_scores, cfg.topk_group)
        group_mask = torch.zeros_like(group_scores).scatter_(1, keep, 1.0)
        sel = torch.where(
            group_mask.repeat_interleave(per, dim=-1) > 0, sel, -torch.inf
        )
    _, topi = _top_k(sel, cfg.num_experts_per_tok)
    gates_k = torch.gather(probs, 1, topi)
    if cfg.norm_topk_prob:
        gates_k = gates_k / torch.clamp(gates_k.sum(-1, keepdim=True), min=1e-20)
    gates_k = gates_k * cfg.routed_scaling_factor
    return torch.zeros_like(logits).scatter_(1, topi, gates_k)


def _experts(params: dict, buf: torch.Tensor) -> torch.Tensor:
    """The stacked SwiGLUs over per-expert rows ``buf`` [E, N, D] →
    float32 [E, N, D]. The rows go to the weights' dtype for the gate
    and up products (the reference's input is in that dtype); the
    activation ``h`` stays float32 into ``w_down``, as in the reference
    (``expert_mm_f32``)."""
    buf = buf.to(weight_dtype(params["w_down"]))
    h = F.silu(expert_mm(buf, params["w_gate"])) * expert_mm(buf, params["w_up"])
    return expert_mm_f32(h, params["w_down"])


def moe_mlp(params: dict, x: torch.Tensor, cfg: MoeConfig) -> torch.Tensor:
    """x [T, D] → float32 [T, D] through the top-k routed experts, by
    the formulation ``cfg.uses_capacity(T)`` picks."""
    if cfg.uses_capacity(x.shape[0]):
        return _moe_mlp_capacity(params, x, cfg)
    gates = moe_router(params, x, cfg)                            # [T, E]
    E = cfg.num_experts
    out = _experts(params, x[None].expand(E, *x.shape))           # [E, T, D]
    return torch.einsum("etd,te->td", out, gates)


def _moe_mlp_capacity(params: dict, x: torch.Tensor, cfg: MoeConfig) -> torch.Tensor:
    """The capacity formulation (see the module docstring): scatter the
    routed pairs to ``[E, C, D]``, one batched SwiGLU, gather the
    weighted results back. C depends on T only."""
    T, D = x.shape
    E, k = cfg.num_experts, cfg.num_experts_per_tok
    gates = moe_router(params, x, cfg)
    gate_vals, expert_idx = _top_k(gates, k)                      # [T, k]
    C = cfg.capacity(T)

    flat_e = expert_idx.reshape(-1)                               # [T*k]
    onehot = (flat_e[:, None] == torch.arange(E, device=x.device)).to(torch.int32)
    # Each pair's rank within its expert, in arrival order.
    pos = ((torch.cumsum(onehot, dim=0) - onehot) * onehot).sum(-1)
    keep = pos < C
    slot = torch.where(keep, pos, C)                              # C: the drop row
    buf = x.new_zeros((E, C + 1, D))
    buf[flat_e, slot] = x.repeat_interleave(k, dim=0)
    out_e = _experts(params, buf[:, :C])                          # [E, C, D]
    y = out_e[flat_e, torch.clamp(pos, max=C - 1)]                # [T*k, D]
    y = torch.where(keep[:, None], y, 0.0)
    return (y.reshape(T, k, D) * gate_vals[:, :, None]).sum(dim=1)
