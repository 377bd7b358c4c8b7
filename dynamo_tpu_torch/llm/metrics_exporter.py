"""Standalone metrics exporter: worker load metrics → Prometheus text
(port of dynamo_tpu/llm/metrics_exporter.py).

It rides the KvMetricsAggregator (the plane the KV router reads) and
serves ``/metrics`` and ``/health`` over the port's standard-library
HTTP server. Launch: ``python -m dynamo_tpu_torch metrics
--control-plane ADDR [--namespace dynamo] [--component torch]``.

Push mode, for networks a scraper cannot reach: with ``push_url`` the
exporter also POSTs the same text body to ``{push_url}/metrics/job/{job}``
every ``push_interval_s`` (the Prometheus PushGateway protocol), over
the port's standard-library HTTP client.

A planner sharing the process exports its gauges here too
(``PLANNER_OBS``: scale decisions, pool sizes, the last decision's
age), as ``dyntpu_planner_*`` series.
"""

from __future__ import annotations

import asyncio
import logging
from urllib.parse import urlsplit

from dynamo_tpu_torch.llm.discovery import ModelManager
from dynamo_tpu_torch.llm.http_client import fetch
from dynamo_tpu_torch.llm.http_service import (
    HttpService,
    _json_response,
    _text_response,
)
from dynamo_tpu_torch.llm.kv_router.metrics_aggregator import KvMetricsAggregator
from dynamo_tpu_torch.planner.obs import PLANNER_OBS

logger = logging.getLogger(__name__)

_GAUGES = (
    ("request_active_slots", "Active request slots"),
    ("request_total_slots", "Total request slots"),
    ("kv_active_blocks", "Active KV blocks"),
    ("kv_total_blocks", "Total KV blocks"),
    ("num_requests_waiting", "Requests waiting"),
    ("gpu_cache_usage_perc", "KV cache usage fraction"),
    ("gpu_prefix_cache_hit_rate", "Prefix cache hit rate"),
    ("spec_tokens_per_step", "Delivered tokens per speculative step"),
    ("spec_active", "Speculative decoding currently enabled (auto-gate)"),
    ("spec_drafted_tokens_total", "Draft tokens fed to unified verify spans"),
    ("spec_accepted_tokens_total", "Draft tokens accepted by the verify law"),
    ("mid_traffic_compiles_total", "Programs made under traffic (CUDA graphs captured)"),
    ("compile_stall_ms_total", "Total first-execution compile stall ms"),
    ("warmup_programs_total", "Programs compiled by warmup (budget ladder)"),
    ("unified_step_tokens_decode_total", "Decode tokens via unified steps"),
    ("unified_step_tokens_prefill_total", "Prefill tokens via unified steps"),
    ("batch_fill_ratio", "Unified batch fill (real tokens / budget)"),
    ("coloc_quantum", "Live prefill quantum (coloc controller)"),
    ("itl_ema_ms", "Decode inter-token-latency EMA, ms"),
    ("itl_p95_ms", "Decode inter-token-latency windowed p95, ms"),
    ("itl_headroom_ms", "ITL slack vs the SLO (negative = violating)"),
    ("itl_slo_violations_total", "Dispatches over the decode ITL SLO"),
    ("coloc_prefill_deferrals_total", "Prefill admissions deferred by coloc"),
    ("prefill_backlog_tokens", "Un-prefilled prompt tokens queued"),
    ("engine_ready", "Hot shape set compiled (0 = still warming)"),
    ("warm_tail_pending", "Background warmup shapes still queued"),
    ("degraded_requests_total", "Requests completed via a degraded path"),
    ("faults_injected_total", "Injected faults fired (chaos drills)"),
    ("retries_total", "Transport retries across all seams"),
    ("failover_total", "Mid-stream failover attempts (worker death)"),
    ("failover_success_total", "Failovers that completed the request"),
    ("workers_marked_dead_total", "Workers evicted by the mark-dead fast path"),
    ("last_dispatch_age_s", "Seconds since the engine thread's last pass"),
    ("shed_requests_total", "Requests shed by bounded queues/admission"),
    ("shed_interactive_total", "Interactive-class requests shed"),
    ("shed_batch_total", "Batch-class requests shed (should lead)"),
    ("num_waiting_interactive", "Interactive-class requests waiting"),
    ("num_waiting_batch", "Batch-class requests waiting"),
    ("deadline_exceeded_total", "Work cancelled past its deadline"),
    ("draining", "Worker draining (1 = refusing new work)"),
    ("abandoned_traces_total", "Request traces reaped by the TTL sweep"),
    ("flight_steps_total", "Engine dispatches recorded by the flight ring"),
    # KV observatory: actual reuse per tier (the engine-side half of the
    # predicted-vs-actual loop) and the block manager's tier telemetry.
    ("kv_reused_device_blocks_total", "Blocks reused from the G1 prefix cache"),
    ("kv_reused_host_blocks_total", "Blocks onboarded from the G2 host tier"),
    ("kv_reused_disk_blocks_total", "Reused blocks that originated on G3 disk"),
    ("kvbm_host_registered", "Host-tier (G2) registered blocks"),
    ("kvbm_host_usage", "Host-tier (G2) occupancy fraction"),
    ("kvbm_disk_registered", "Disk-tier (G3) registered blocks"),
    ("kvbm_disk_usage", "Disk-tier (G3) occupancy fraction"),
    ("kvbm_host_evictions_total", "Host-tier LRU evictions"),
    ("kvbm_disk_evictions_total", "Disk-tier LRU evictions"),
    ("kvbm_host_stored_blocks_total", "Blocks stored into the host tier"),
    ("kvbm_host_hit_blocks_total", "Host-tier prefix-match block hits"),
    ("kvbm_host_miss_blocks_total", "Host-tier prefix-match block misses"),
    ("kvbm_promoted_blocks_total", "Blocks promoted disk->host (G3->G2)"),
    ("kvbm_promotions_requested_total", "Disk promotion requests issued"),
    ("kvbm_offloaded_blocks_total", "Blocks offloaded host->disk (G2->G3)"),
    ("kvbm_onboard_skips", "Host onboards skipped by the adaptive gate"),
    ("kvbm_onboard_bps", "Host->HBM onboard rate EMA, bytes/s (engine)"),
    ("kvbm_link_g1g2_bps", "Device->host store rate EMA, bytes/s"),
    ("kvbm_link_g2g3_bps", "Host->disk offload rate EMA, bytes/s"),
    ("kvbm_link_g3g2_bps", "Disk->host promotion rate EMA, bytes/s"),
    ("kvbm_link_g2g1_bps", "Host->HBM onboard rate EMA, bytes/s"),
    ("kvbm_kv_quant_ratio", "Stored-KV bytes ratio vs compute dtype (G1)"),
    ("kvbm_quant_host_density", "Quantized fraction of G2 stored blocks"),
    ("kvbm_quant_disk_density", "Quantized fraction of G3 stored blocks"),
    ("kvbm_quant_bytes_saved_total", "Bytes saved by int8 KV packing"),
    # Weight precision: the per-matmul policy's resident footprint.
    ("weight_quant_active", "Per-matmul weight-quant policy armed (0/1)"),
    ("weight_quant_bytes_saved", "HBM bytes the quantized weight tree saves"),
    ("weight_quant_density", "Quantized fraction of resident weight bytes"),
    # G4 peer tier: fleet pulls priced against recompute, and the
    # peer-link rate EMA behind the pricing.
    ("kv_reused_peer_blocks_total", "Reused blocks that arrived via G4 peer pull"),
    ("kvbm_g4_pulls_total", "Completed G4 peer block pulls"),
    ("kvbm_g4_pull_bytes_total", "Bytes pulled from fleet peers (G4)"),
    ("kvbm_g4_pull_fallbacks_total", "G4 pulls degraded to local recompute"),
    ("kvbm_link_peer_bps", "Peer pull rate EMA, bytes/s (G4 link)"),
    # Integrity envelope: checksum failures per trust boundary and the
    # G3 scrubber's sweep counters.
    ("kvbm_integrity_failures_total", "KV blocks failing checksum, all tiers"),
    ("kvbm_integrity_failures_host", "Checksum failures at G2 host onboard"),
    ("kvbm_integrity_failures_disk", "Checksum failures on G3 disk reads"),
    ("kvbm_integrity_failures_peer", "Checksum failures on G4 peer pulls"),
    ("kvbm_integrity_failures_frame", "Checksum failures on disagg KV frames"),
    ("kvbm_scrub_scanned_total", "Disk blocks scanned by the G3 scrubber"),
    ("kvbm_scrub_detected_total", "Corrupt disk blocks the scrubber caught"),
)


class _ExporterServer(HttpService):
    """``/metrics`` and ``/health`` of one exporter."""

    _ROUTES = {
        "/metrics": ("GET", "_metrics"),
        "/health": ("GET", "_health"),
    }

    def __init__(self, exporter: "MetricsExporter") -> None:
        super().__init__(ModelManager(), host=exporter.host, port=exporter.port)
        self._exporter = exporter

    async def _metrics(self, _req, _w):
        return _text_response(200, self._exporter.render())

    async def _health(self, _req, _w):
        return _json_response({
            "status": "healthy",
            "workers": [
                f"{w:x}" for w in self._exporter.aggregator.endpoints.worker_ids
            ],
        })


class MetricsExporter:
    def __init__(
        self,
        drt,
        namespace: str = "dynamo",
        component: str = "torch",
        host: str = "0.0.0.0",
        port: int = 9091,
        interval_s: float = 1.0,
        push_url: str | None = None,
        push_interval_s: float = 15.0,
        push_job: str = "dynamo_tpu",
    ) -> None:
        self._drt = drt
        self._component = drt.namespace(namespace).component(component)
        self._labels = f'namespace="{namespace}",component="{component}"'
        self.host = host
        self.port = port
        self.interval_s = interval_s
        self.push_url = push_url.rstrip("/") if push_url else None
        self.push_interval_s = push_interval_s
        self.push_job = push_job
        self.push_count = 0     # successful pushes
        self.push_errors = 0
        self.aggregator: KvMetricsAggregator | None = None
        self._server: _ExporterServer | None = None
        self._push_task: asyncio.Task | None = None

    async def start(self) -> "MetricsExporter":
        self.aggregator = await KvMetricsAggregator(
            self._drt, self._component, interval_s=self.interval_s
        ).start()
        self._server = _ExporterServer(self)
        await self._server.start()
        self.port = self._server.port
        logger.info("metrics exporter on %s:%d", self.host, self.port)
        if self.push_url:
            self._push_task = asyncio.ensure_future(self._push_loop())
            logger.info(
                "push mode: %s every %.1fs", self.push_url, self.push_interval_s
            )
        return self

    async def _push_loop(self) -> None:
        """Periodic PushGateway-protocol POST of the rendered body. Push
        failures are counted and logged, never fatal — the pull endpoint
        keeps serving either way."""
        url = urlsplit(f"{self.push_url}/metrics/job/{self.push_job}")
        port = url.port or (443 if url.scheme == "https" else 80)
        while True:
            await asyncio.sleep(self.push_interval_s)
            try:
                resp = await fetch(
                    url.hostname, port, "POST", url.path,
                    data=self.render().encode(),
                    headers={"Content-Type": "text/plain"},
                    timeout=max(self.push_interval_s, 1.0),
                )
                if resp.status // 100 == 2:
                    self.push_count += 1
                else:
                    self.push_errors += 1
                    logger.warning("metrics push got HTTP %d", resp.status)
            except Exception as exc:  # noqa: BLE001 — a push failure is counted, never fatal
                self.push_errors += 1
                logger.warning("metrics push failed: %s", exc)

    def render(self) -> str:
        ep = self.aggregator.endpoints
        lines = [
            "# HELP dyntpu_worker_count Live workers being scraped",
            "# TYPE dyntpu_worker_count gauge",
            f"dyntpu_worker_count{{{self._labels}}} {len(ep.metrics)}",
        ]
        for key, help_text in _GAUGES:
            lines.append(f"# HELP dyntpu_{key} {help_text}")
            lines.append(f"# TYPE dyntpu_{key} gauge")
            for wid, m in ep.metrics.items():
                lines.append(
                    f'dyntpu_{key}{{{self._labels},worker="{wid:x}"}} '
                    f"{getattr(m, key)}"
                )
        # Planner-plane gauges of a planner sharing this process: its
        # scale decisions and pool sizes beside the worker plane.
        for key, val in PLANNER_OBS.gauges().items():
            lines.append(f"# TYPE dyntpu_{key} gauge")
            lines.append(f"dyntpu_{key}{{{self._labels}}} {val}")
        return "\n".join(lines) + "\n"

    async def stop(self) -> None:
        if self._push_task is not None:
            self._push_task.cancel()
            try:
                await self._push_task
            except asyncio.CancelledError:
                pass
        if self.aggregator is not None:
            await self.aggregator.stop()
        if self._server is not None:
            await self._server.stop()
