"""Worker selection: the KV-aware cost function (port of
dynamo_tpu/llm/kv_router/scheduler.py).

Per candidate worker:

    logit = overlap_weight * overlap_blocks * block_size / isl
            - gpu_cache_usage
            - normalized_waiting
            [- transfer_cost_weight * transfer_s / max_transfer_s]

pick the max, break ties at random, then bump the winner's predicted
load so back-to-back requests don't stampede one worker. The bracketed
term (``KvRouterConfig.network_aware``, ``--route-network-aware``)
prices the time to land each candidate's non-overlapping prefix blocks
over its advertised ingest rate, or ``default_link_gbps`` where it
advertises none; every candidate's cost is in its route record.
"""

from __future__ import annotations

import logging
import random
from dataclasses import dataclass, field

from dynamo_tpu_torch.llm.kv_router.metrics_aggregator import ProcessedEndpoints

logger = logging.getLogger(__name__)

#: KV bytes per token of the llama3.2-1b layout: K and V × 16 layers ×
#: 8 kv heads × 64 dims × 2 B (bf16) = 32 KiB.
KV_BYTES_PER_TOKEN = 2 * 16 * 8 * 64 * 2

#: Pinned host→device copy rate of a batch of llama3.2-1b KV blocks
#: (64 blocks of 16 tokens, 32 MiB per copy), GB/s: 51.23 measured by
#: chip_smoke.py's fleet phase (``kv_route`` leg, ``h2d_kv_rate``) on an
#: NVIDIA H100 80GB HBM3 at a 700.00 W power limit.
H2D_KV_GBPS = 51.23


@dataclass
class KvRouterConfig:
    overlap_score_weight: float = 2.0
    gpu_cache_usage_weight: float = 1.0
    waiting_requests_weight: float = 1.0
    block_size: int = 16
    sharded_indexer_shards: int = 0  # >0: use KvIndexerSharded
    # Network-aware selection: price each candidate by the time to move
    # the non-overlapping prefix blocks onto it, over the worker's
    # advertised ingest rate (``ForwardPassMetrics.kvbm_link_g2g1_bps``,
    # host→device onboard). Normalized against the worst candidate so
    # it stays commensurate with the other O(1) terms.
    network_aware: bool = False
    transfer_cost_weight: float = 1.0
    # KV bytes per 16-token block of the llama3.2-1b layout. Only the
    # ratio across candidates moves a decision; the absolute value
    # scales the audited transfer_ms.
    block_bytes: int = 16 * KV_BYTES_PER_TOKEN
    # Fallback link for a worker that advertises no rate (the port's
    # workers have no KVBM yet, so all of them): the measured pinned
    # host→device rate above.
    default_link_gbps: float = H2D_KV_GBPS


@dataclass
class SchedulingDecision:
    worker_id: int
    overlap_blocks: int
    logit: float
    # EVERY candidate's score, not just the winner's — the route-audit
    # record needs the full field to explain why a worker lost. Each entry:
    # {"worker", "logit", "overlap_blocks", "usage", "waiting"}.
    candidates: list[dict] = field(default_factory=list)


class DefaultWorkerSelector:
    def __init__(self, cfg: KvRouterConfig | None = None, seed: int | None = None):
        self.cfg = cfg or KvRouterConfig()
        self._rng = random.Random(seed)
        # Predicted-load bump: worker -> extra active blocks assumed until
        # the next metrics scrape overwrites it.
        self._predicted_blocks: dict[int, int] = {}

    def on_metrics(self) -> None:
        """A fresh scrape landed — predicted deltas are now baked in."""
        self._predicted_blocks.clear()

    def select(
        self,
        endpoints: ProcessedEndpoints,
        overlaps: dict[int, int],
        isl: int,
    ) -> SchedulingDecision | None:
        cfg = self.cfg
        best: list[SchedulingDecision] = []
        if not endpoints.metrics:
            return None
        max_waiting = max(
            (m.num_requests_waiting for m in endpoints.metrics.values()),
            default=0,
        )
        # Network-aware transfer estimate (two passes: the term is
        # normalized against the WORST candidate so a uniformly fast or
        # uniformly slow fleet shifts every logit equally — only link/
        # overlap ASYMMETRY moves the decision).
        transfer_s: dict[int, float] = {}
        if cfg.network_aware:
            isl_blocks = (isl + cfg.block_size - 1) // cfg.block_size
            for wid, m in endpoints.metrics.items():
                missing = max(isl_blocks - overlaps.get(wid, 0), 0)
                link_bps = (
                    getattr(m, "kvbm_link_g2g1_bps", 0.0)
                    or cfg.default_link_gbps * 1e9
                )
                # Price bytes at the worker's advertised KV block
                # precision (kvbm_kv_quant_ratio): cfg.block_bytes is the
                # bf16 layout.
                ratio = getattr(m, "kvbm_kv_quant_ratio", 1.0) or 1.0
                transfer_s[wid] = (
                    missing * cfg.block_bytes * ratio / max(link_bps, 1.0)
                )
        t_max = max(transfer_s.values(), default=0.0)
        candidates: list[dict] = []
        for wid, m in endpoints.metrics.items():
            overlap = overlaps.get(wid, 0)
            total = max(m.kv_total_blocks, 1)
            usage = (
                m.kv_active_blocks + self._predicted_blocks.get(wid, 0)
            ) / total
            waiting = m.num_requests_waiting / max(max_waiting, 1)
            logit = (
                cfg.overlap_score_weight * overlap * cfg.block_size / max(isl, 1)
                - cfg.gpu_cache_usage_weight * usage
                - cfg.waiting_requests_weight * waiting
            )
            cand = {
                "worker": wid,
                "logit": round(logit, 6),
                "overlap_blocks": overlap,
                "usage": round(usage, 4),
                "waiting": round(waiting, 4),
            }
            if cfg.network_aware and t_max > 0:
                term = cfg.transfer_cost_weight * transfer_s[wid] / t_max
                logit -= term
                cand["transfer_ms"] = round(1000.0 * transfer_s[wid], 3)
                cand["transfer_term"] = round(term, 6)
                cand["logit"] = round(logit, 6)
            candidates.append(cand)
            d = SchedulingDecision(wid, overlap, logit)
            if not best or d.logit > best[0].logit + 1e-9:
                best = [d]
            elif abs(d.logit - best[0].logit) <= 1e-9:
                best.append(d)
        if not best:
            return None
        decision = self._rng.choice(best)
        decision.candidates = candidates
        # Bump predicted load by the blocks this request will occupy.
        new_blocks = max(
            (isl - decision.overlap_blocks * cfg.block_size + cfg.block_size - 1)
            // cfg.block_size,
            0,
        )
        self._predicted_blocks[decision.worker_id] = (
            self._predicted_blocks.get(decision.worker_id, 0) + new_blocks
        )
        return decision
