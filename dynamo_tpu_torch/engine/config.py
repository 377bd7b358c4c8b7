"""Engine configuration (port of dynamo_tpu/engine/config.py).

The fields the port serves keep the reference's names and defaults.
The reference's other serving features are fields too, so that
``validate()`` can refuse them by name instead of ignoring them; each
arrives with a later slice (ROADMAP queue A).
"""

from __future__ import annotations

import logging
from dataclasses import dataclass, field

import torch

from dynamo_tpu_torch.models.config import ModelConfig

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
# One H100's device memory: the weights of a model served on one card
# must fit in it.
CARD_BYTES = 80e9


@dataclass
class EngineConfig:
    model: ModelConfig
    dtype: str = "bfloat16"
    block_size: int = 16
    num_blocks: int = 512            # device KV blocks (block 0 is trash)
    max_num_seqs: int = 8            # decode batch slots
    max_model_len: int = 512         # context limit per sequence
    prefill_chunk: int = 512         # max (padded) tokens per raw prefill call
    prefill_batch: int = 4           # prompts prefilling at once
    watermark: float = 0.05          # keep this fraction of blocks free
    enable_prefix_caching: bool = True
    seed: int = 0
    # Unified dispatches in flight before the oldest is forced: dispatch
    # N+1 feeds on dispatch N's device-resident tokens, so issuing never
    # waits on a fetch.
    pipeline_depth: int = 2
    # Max tokens per unified dispatch; batches snap UP onto the ladder
    # {16, 32, ..., bucket(unified_token_budget)} (compile_cache.py).
    unified_token_budget: int = 256
    # Prefill tokens one sequence may take per step while decode lanes
    # share it — and the budget slice reserved for prefill when prompts
    # wait. With coloc="adaptive" only the starting quantum.
    unified_prefill_quantum: int = 64
    # SLO-aware co-location (engine/coloc.py). itl_slo_ms is the decode
    # inter-token-latency target each retired unified dispatch is
    # measured against (0 = no target: no violation accounting, no
    # adaptation). coloc="static" keeps unified_prefill_quantum;
    # "adaptive" runs the AIMD loop, floored at coloc_min_quantum.
    # Adaptation is pure composition: no graph is keyed by the quantum.
    itl_slo_ms: float = 0.0
    coloc: str = "static"
    coloc_min_quantum: int = 16
    # int8 KV blocks with per-(block, kv head) float32 scales (ops/quant.py
    # quantize_kv_write); served by the unified step only.
    kv_quant: str | None = None
    # Prompt-lookup speculative decoding on the unified step: each greedy
    # decode lane drafts up to this many tokens from its own history and
    # verifies them as a draft-verify span of the same step program (the
    # accept-prefix law and the bonus sample run inside it). 0 = off.
    speculative_k: int = 0
    # Auto-gate: below this many delivered tokens per spec step over a
    # window, fall back to plain decode; re-probe after
    # speculative_probe_steps plain steps with a short probe window.
    speculative_break_even: float = 1.4
    speculative_window: int = 128
    speculative_probe_steps: int = 1024
    speculative_probe_window: int = 16
    # Frequency/presence penalties and per-token logprobs run through the
    # unified_full variant (one program at the top budget rung), taken
    # only by batches that need it. False refuses such requests.
    sampling_extras: bool = True
    # Where the shape manifest (the shapes serving executed) is saved on
    # stop and read by warmup; None = no manifest.
    shape_manifest_path: str | None = None
    # Readiness while the hot program set is captured: "hold" parks
    # admission until warmup has made it; "degraded" serves at once and
    # flags it (served_unwarmed; each program then captures at first use,
    # counted in mid_traffic_compiles_total).
    warmup_gate: str = "degraded"
    # Overload bounds on the engine waiting list (0 = unbounded): past
    # max_waiting the oldest waiter finishes with FinishReason.SHED;
    # waiters older than max_queue_delay_s seconds finish the same way.
    max_waiting: int = 0
    max_queue_delay_s: float = 0.0
    # Flight recorder (engine/flight_recorder.py): bounded ring of
    # per-dispatch records served by /debug/steps and dumped to
    # flight_record_dir (or $DYNTPU_FLIGHT_DIR) when the engine loop
    # faults.
    flight_record_capacity: int = 512
    flight_record_dir: str | None = None
    # Disaggregation (decode side): the longest a sequence admitted for
    # remote prefill waits for its KV before it degrades to local
    # recompute.
    remote_kv_timeout_s: float = 30.0
    # KVBM adaptive onboard gate: skip a host-tier hit when moving its
    # bytes (measured onboard rate) is predicted slower than recomputing
    # them (measured prefill rate); re-probe every 32nd skip.
    kvbm_adaptive_gate: bool = True
    # G4 peer tier (block_manager/peer.py): the longest a request admitted
    # for prefill stays PARKED waiting for a fleet peer's pull to land its
    # missing prefix blocks in G2. Past it the request proceeds by local
    # recompute (counted in degraded_requests_total) while the pull keeps
    # running and warms the tier for the next request. Much tighter than
    # remote_kv_timeout_s: a pull is a TTFT optimisation, not a
    # correctness dependency like disagg's inbound KV.
    kvbm_peer_timeout_s: float = 2.0

    # -- reference features the port refuses (validate) --------------------
    quant: str | None = None
    weight_quant: str | None = None
    mesh_shape: dict[str, int] = field(default_factory=dict)
    kv_sp: bool = False
    # Serve image requests (llm/multimodal.py): warmup also makes the
    # unified_mm program, the soft-prompt variant of the step.
    multimodal: bool = False

    @property
    def max_blocks_per_seq(self) -> int:
        return (self.max_model_len + self.block_size - 1) // self.block_size

    @property
    def torch_dtype(self) -> torch.dtype:
        return DTYPES[self.dtype]

    _KV_QUANT_MODES = (None, "int8")
    _WARMUP_GATES = ("hold", "degraded")
    _COLOC_MODES = ("static", "adaptive")

    def validate(self) -> None:
        if self.speculative_k < 0 or self.speculative_k > self.block_size:
            raise ValueError(
                f"speculative_k={self.speculative_k} must be in "
                f"[0, block_size={self.block_size}]"
            )
        if self.warmup_gate not in self._WARMUP_GATES:
            raise ValueError(
                f"warmup_gate={self.warmup_gate!r} not in "
                f"{self._WARMUP_GATES}"
            )
        if self.speculative_probe_window < 1:
            raise ValueError(
                f"speculative_probe_window={self.speculative_probe_window} "
                f"must be >= 1"
            )
        if self.coloc not in self._COLOC_MODES:
            raise ValueError(
                f"coloc={self.coloc!r} not in {self._COLOC_MODES}"
            )
        if self.itl_slo_ms < 0:
            raise ValueError(
                f"itl_slo_ms={self.itl_slo_ms} must be >= 0 (0 = no SLO)"
            )
        if self.coloc == "adaptive":
            if self.itl_slo_ms <= 0:
                raise ValueError(
                    "coloc='adaptive' requires itl_slo_ms > 0 — the "
                    "feedback loop needs a decode ITL target to hold"
                )
            if not 1 <= self.coloc_min_quantum <= self.unified_token_budget:
                raise ValueError(
                    f"coloc_min_quantum={self.coloc_min_quantum} must "
                    f"be in [1, unified_token_budget]"
                )
        if self.kv_quant not in self._KV_QUANT_MODES:
            raise ValueError(
                f"kv_quant={self.kv_quant!r} is not served: the modes are "
                f"{self._KV_QUANT_MODES}"
            )
        if self.kv_quant and self.kv_sp:
            raise ValueError(
                "conflicting flags kv_quant + kv_sp: kv_quant does not "
                "support the striped (sequence-parallel) KV cache"
            )
        refused = [
            (self.quant or self.weight_quant, "weight quantization"),
            (self.mesh_shape, "a device mesh"),
            (self.kv_sp, "kv_sp"),
        ]
        for on, what in refused:
            if on:
                raise ValueError(
                    f"{what} is not served by this slice of the port"
                )
        if self.dtype in DTYPES:
            weight_bytes = self.model.param_count() * DTYPES[self.dtype].itemsize
            if weight_bytes > CARD_BYTES:
                raise ValueError(
                    f"model {self.model.name}: {weight_bytes / 1e9:.1f} GB of "
                    f"{self.dtype} weights exceed one {CARD_BYTES / 1e9:.0f} GB "
                    "card: not served by this slice of the port (a model "
                    "sharded over cards is the parallel slice, ROADMAP A4)"
                )
        if not self.kvbm_peer_timeout_s > 0:
            raise ValueError(
                f"kvbm_peer_timeout_s={self.kvbm_peer_timeout_s} must be > 0 "
                "(a parked request needs a deadline to resume by)"
            )
        if self.max_waiting < 0 or self.max_queue_delay_s < 0:
            raise ValueError(
                "max_waiting and max_queue_delay_s must be >= 0 "
                "(0 = unbounded)"
            )
        if self.dtype not in DTYPES:
            raise ValueError(f"dtype={self.dtype!r} not in {list(DTYPES)}")
        if self.num_blocks < self.max_blocks_per_seq + 1:
            raise ValueError(
                f"num_blocks={self.num_blocks} cannot hold even one "
                f"max-length sequence ({self.max_blocks_per_seq} blocks)"
            )
        if self.pipeline_depth < 1:
            raise ValueError("pipeline_depth must be >= 1")
        if self.unified_token_budget < 16:
            raise ValueError(
                f"unified_token_budget={self.unified_token_budget} "
                f"must be >= 16 (one minimum bucket)"
            )
        if not 1 <= self.unified_prefill_quantum <= self.unified_token_budget:
            raise ValueError(
                f"unified_prefill_quantum={self.unified_prefill_quantum} "
                f"must be in [1, unified_token_budget]"
            )
        # Every budget rung must be reachable by some span combination;
        # small-context configs clamp the budget down to the largest
        # reachable rung instead of erroring (the reference's rule).
        reachable = (
            (self.max_num_seqs + self.prefill_batch) * (self.max_model_len - 1)
        )
        if self.unified_token_budget > reachable:
            if reachable < 16:
                raise ValueError(
                    f"no reachable unified budget rung: (max_num_seqs + "
                    f"prefill_batch) * (max_model_len - 1) = {reachable} "
                    f"< 16; raise the slot/context limits"
                )
            clamped = 16
            while clamped * 2 <= reachable:
                clamped *= 2
            logging.getLogger(__name__).warning(
                "unified_token_budget=%d exceeds the largest fillable "
                "batch (%d); clamped to the %d-token rung",
                self.unified_token_budget, reachable, clamped,
            )
            self.unified_token_budget = clamped
            self.unified_prefill_quantum = min(
                self.unified_prefill_quantum, self.unified_token_budget
            )
        if self.speculative_k + 1 > self.unified_token_budget // 2:
            # compose_unified keeps decode at least half the budget; a
            # k+1-row verify span must fit inside that share.
            raise ValueError(
                f"speculative_k={self.speculative_k} needs "
                f"unified_token_budget >= {2 * (self.speculative_k + 1)} "
                f"(a k+1-row verify span must fit in decode's half of "
                f"the budget)"
            )
