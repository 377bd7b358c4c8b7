"""Router-plane wire types (port of dynamo_tpu/llm/kv_router/protocols.py).

Per-worker forward-pass load metrics and KV-cache stored/removed/cleared
events, with the reference's fields and wire dicts: the port's codec
(runtime/transports/wire.py) packs them into the bytes the JAX package's
``msgpack`` does. Block identity is the chained *sequence hash* of
llm/tokens.py — in the port, 64-bit BLAKE2b, so a port fleet and a JAX
fleet never share a hash space.

``ForwardPassMetrics`` keeps every field of the reference; a field of a
subsystem the port does not have yet (the KVBM's ``kvbm_*``, the
``weight_quant_*`` policy, the remote-prefill degradation count) is
never set by the port's engine and stays at its default.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any


@dataclass
class ForwardPassMetrics:
    """Per-worker load snapshot, served on ``load_metrics``."""

    request_active_slots: int = 0
    request_total_slots: int = 0
    kv_active_blocks: int = 0
    kv_total_blocks: int = 0
    num_requests_waiting: int = 0
    gpu_cache_usage_perc: float = 0.0
    gpu_prefix_cache_hit_rate: float = 0.0
    data_parallel_rank: int = 0
    # Speculative decoding: delivered tokens per spec step (0.0 without
    # speculative_k), whether the auto-gate has it on, drafted and
    # accepted draft tokens.
    spec_tokens_per_step: float = 0.0
    spec_active: int = 0
    spec_drafted_tokens_total: int = 0
    spec_accepted_tokens_total: int = 0
    # Program lifecycle: programs made under traffic (0 on a warmed
    # worker), their stall, readiness, the warm tail, warmup's count.
    mid_traffic_compiles_total: int = 0
    compile_stall_ms_total: float = 0.0
    engine_ready: int = 0
    warm_tail_pending: int = 0
    warmup_programs_total: int = 0
    # Unified step: per-phase token split and the last batch fill.
    unified_step_tokens_decode_total: int = 0
    unified_step_tokens_prefill_total: int = 0
    batch_fill_ratio: float = 0.0
    # Co-location controller (engine/coloc.py): quantum, decode ITL
    # estimates against the SLO, violations, deferrals, prefill backlog.
    coloc_quantum: int = 0
    itl_ema_ms: float = 0.0
    itl_p95_ms: float = 0.0
    itl_headroom_ms: float = 0.0
    itl_slo_violations_total: int = 0
    coloc_prefill_deferrals_total: int = 0
    prefill_backlog_tokens: int = 0
    # Robustness: degraded completions (remote prefill; none in the
    # port yet), injected faults, transport retries.
    degraded_requests_total: int = 0
    faults_injected_total: int = 0
    retries_total: int = 0
    # Failover plane and the engine thread's heartbeat age.
    failover_total: int = 0
    failover_success_total: int = 0
    workers_marked_dead_total: int = 0
    last_dispatch_age_s: float = 0.0
    # Overload: sheds, expired deadlines, draining (routers stop
    # picking a draining worker).
    shed_requests_total: int = 0
    deadline_exceeded_total: int = 0
    draining: int = 0
    # SLO classes: waiting depth and sheds per class.
    num_waiting_interactive: int = 0
    num_waiting_batch: int = 0
    shed_interactive_total: int = 0
    shed_batch_total: int = 0
    # Observability: traces reaped by the TTL sweep, dispatches recorded.
    abandoned_traces_total: int = 0
    flight_steps_total: int = 0
    # KV observatory: blocks this worker actually reused, per tier,
    # cumulative (the router's route records carry the prediction).
    kv_reused_device_blocks_total: int = 0   # G1 prefix-cache hits
    kv_reused_host_blocks_total: int = 0     # G2 host-tier onboards
    kv_reused_disk_blocks_total: int = 0     # G3-origin blocks (promoted)
    kv_reused_peer_blocks_total: int = 0     # G4-origin blocks (peer pulls)
    # KVBM tier telemetry (not in the port yet: defaults).
    kvbm_onboard_skips: int = 0
    kvbm_onboard_bps: float = 0.0
    kvbm_host_registered: int = 0
    kvbm_host_usage: float = 0.0
    kvbm_disk_registered: int = 0
    kvbm_disk_usage: float = 0.0
    kvbm_host_evictions_total: int = 0
    kvbm_disk_evictions_total: int = 0
    kvbm_host_stored_blocks_total: int = 0
    kvbm_host_hit_blocks_total: int = 0
    kvbm_host_miss_blocks_total: int = 0
    kvbm_promoted_blocks_total: int = 0
    kvbm_promotions_requested_total: int = 0
    kvbm_offloaded_blocks_total: int = 0
    kvbm_link_g1g2_bps: float = 0.0   # device→host store rate
    kvbm_link_g2g3_bps: float = 0.0   # host→disk offload rate
    kvbm_link_g3g2_bps: float = 0.0   # disk→host promotion rate
    kvbm_link_g2g1_bps: float = 0.0   # host→device onboard rate
    # KV-block precision: stored-KV bytes ratio against the compute
    # dtype (the network-aware selector prices transfers with it), and
    # the quantized share per tier.
    kvbm_kv_quant_ratio: float = 1.0
    kvbm_quant_host_density: float = 0.0
    kvbm_quant_disk_density: float = 0.0
    kvbm_quant_bytes_saved_total: int = 0
    # Weight precision (not in the port yet: defaults).
    weight_quant_active: float = 0.0
    weight_quant_bytes_saved: float = 0.0
    weight_quant_density: float = 0.0
    # G4 peer tier (not in the port yet: defaults).
    kvbm_g4_pulls_total: int = 0
    kvbm_g4_pull_bytes_total: int = 0
    kvbm_g4_pull_fallbacks_total: int = 0
    kvbm_link_peer_bps: float = 0.0   # peer→host pull rate
    # Integrity envelope (not in the port yet: defaults).
    kvbm_integrity_failures_total: int = 0
    kvbm_integrity_failures_host: int = 0
    kvbm_integrity_failures_disk: int = 0
    kvbm_integrity_failures_peer: int = 0
    kvbm_integrity_failures_frame: int = 0
    kvbm_scrub_scanned_total: int = 0
    kvbm_scrub_detected_total: int = 0

    def to_wire(self) -> dict[str, Any]:
        return self.__dict__.copy()

    @staticmethod
    def from_wire(d: dict[str, Any]) -> "ForwardPassMetrics":
        m = ForwardPassMetrics()
        for k in m.__dict__:
            if k in d:
                setattr(m, k, d[k])
        return m


@dataclass
class KvCacheEventData:
    """stored / removed / cleared, plus ``worker_dead`` — the mark-dead
    broadcast (kv_router/router.py ``note_worker_dead``): the router
    replica that observed a worker death shares it on the event plane,
    so every sibling replica prunes the corpse's radix blocks and drops
    its load snapshot within one apply."""

    kind: str                 # "stored" | "removed" | "cleared" | "worker_dead"
    block_hashes: list[int] = field(default_factory=list)   # sequence hashes
    parent_hash: int | None = None              # stored: parent of first block
    token_ids: list[list[int]] | None = None    # stored: per-block tokens

    def to_wire(self) -> dict[str, Any]:
        return {
            "kind": self.kind,
            "block_hashes": self.block_hashes,
            "parent_hash": self.parent_hash,
            "token_ids": self.token_ids,
        }

    @staticmethod
    def from_wire(d: dict[str, Any]) -> "KvCacheEventData":
        return KvCacheEventData(
            kind=d["kind"],
            block_hashes=list(d.get("block_hashes") or []),
            parent_hash=d.get("parent_hash"),
            token_ids=d.get("token_ids"),
        )


@dataclass
class RouterEvent:
    """A KV event attributed to a worker.

    ``published_unix`` is the publisher's wall clock at broadcast — the
    indexer's ``recv - published_unix`` is the publish→apply lag, the
    staleness axis the route-audit loop measures (same NTP-level
    assumption as ``deadline_unix`` / the trace clock-offset hint).
    None on legacy frames and replayed recordings (no lag recorded)."""

    worker_id: int
    event: KvCacheEventData
    published_unix: float | None = None

    def to_wire(self) -> dict[str, Any]:
        return {
            "worker_id": self.worker_id,
            "event": self.event.to_wire(),
            "published_unix": self.published_unix,
        }

    @staticmethod
    def from_wire(d: dict[str, Any]) -> "RouterEvent":
        return RouterEvent(
            worker_id=d["worker_id"],
            event=KvCacheEventData.from_wire(d["event"]),
            published_unix=d.get("published_unix"),
        )


KV_EVENT_PLANE = "kv_events"
KV_METRICS_ENDPOINT = "load_metrics"

#: Hit-rate plane payloads (wire dicts), joined by trace id:
#:   kind="predicted"  router-side, at decision time: worker_id,
#:                     overlap_blocks, isl_blocks, trace, request id
#:   kind="actual"     engine-side, at admission: per-tier reused block
#:                     counts (device/host/disk/peer), trace, request id
#: Frames without a "kind" field are predicted records.
KV_HIT_RATE_PLANE = "kv-hit-rate"

#: Registry re-announce plane: a (possibly empty) dict broadcast here
#: asks every worker to re-publish its resident block hashes as
#: ``stored`` events. Named for wire compatibility; the port's workers
#: do not answer it until the KVBM slice.
KV_REANNOUNCE_PLANE = "kv_reannounce"
