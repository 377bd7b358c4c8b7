"""dynamo-tpu-torch CLI (port of the ``run``, ``control-plane``,
``router``, ``metrics`` and ``planner`` subcommands of
dynamo_tpu/cli.py): launch the port from a shell.

  python -m dynamo_tpu_torch run [--in {http,text,batch:FILE,dyn://ns.comp.ep}]
                                 [--out {torch,echo_core,echo_full,dyn}]
                                 [--model-path preset:NAME|DIR|hf://ORG/NAME|FILE.gguf]
                                 [--device {cuda,cpu}] [--config FILE.yaml]
                                 [--set Section.key=value] ...
  python -m dynamo_tpu_torch control-plane [--host H] [--port P] [--token T]
  python -m dynamo_tpu_torch router --control-plane ADDR --endpoint dyn://ns.c.e
  python -m dynamo_tpu_torch metrics --control-plane ADDR [--component C]
  python -m dynamo_tpu_torch planner --control-plane ADDR --worker-cmd CMD
                                     [--two-pool --prefill-worker-cmd CMD] ...

- ``--in http``        OpenAI server; SIGINT/SIGTERM drains it (new
                       requests 503, the admitted ones finish) and exits
- ``--in text``        interactive chat against the same pipeline
- ``--in batch:FILE``  run a prompt file, print a JSON report of TTFT and
                       token rates
- ``--in dyn://ns.c.e`` worker mode: serve the engine at that endpoint,
                       register its model, then wait for SIGTERM or the
                       control-plane drain verb and drain (stop
                       admitting, deregister, finish the in-flight
                       streams): prints ``worker serving ...``,
                       ``draining``, ``drain complete``
- ``--out torch``      the port's TorchEngine (the reference's
                       ``--out tpu``), on ``--device`` (cuda unless cpu is
                       asked for); ``echo_core``/``echo_full`` echo the
                       prompt's tokens / text
- ``--out dyn``        frontend only: discover workers through the
                       control plane (``--control-plane ADDR``) and route
                       to them (``--router-mode round_robin|random|kv``),
                       failing a stream over to a sibling when its worker
                       dies mid-stream
- ``control-plane``    the standalone discovery/messaging server
- ``router``           the standalone KV router (llm/router_service.py):
                       serves ``generate`` on ``--component`` (default
                       ``router``) and forwards each request to the
                       KV-best instance of ``--endpoint``
- ``metrics``          the Prometheus exporter of the workers' load
                       metrics (llm/metrics_exporter.py; ``--push-url``
                       also pushes to a PushGateway)
- ``planner``          the auto-scaler (planner/): spawns workers from
                       ``--worker-cmd`` (``{index}`` substituted) and
                       scales them within [--min-workers, --max-workers]
                       on the queue, KV and waiting watermarks, or on a
                       ``--profile`` and an SLA; ``--two-pool`` scales a
                       prefill pool (``--prefill-worker-cmd``, on the
                       prefill queue's depth and age) and a decode pool
                       apart. Crashed workers are replaced at once;
                       SIGTERM stops the planner and leaves its workers
                       running, checkpointed in ``--state-path`` for the
                       next planner to adopt (a recycled pid is refused).

KV-aware routing (``--router-mode kv``): each worker publishes its block
pool's KV events and per-request actual reuse on the bus events plane
and serves its ``ForwardPassMetrics`` on ``load_metrics``; the frontend
builds one KvRouter per worker component (radix index, metrics
aggregator, selector; ``--route-network-aware`` adds the transfer-cost
term) and audits every decision (``/debug/routes``).

Without a control plane (``--control-plane``/``--spawn-control-plane``),
``--in http|text|batch`` with a local engine serves it in process, with
no runtime plane between the front and the engine. With one, the local
engine (unless ``--out dyn``) is served at ``--endpoint`` and registered,
and the front discovers it and every other worker through the plane.

With ``--out torch`` the engine warms up before it serves — and, as a
worker, before it registers: it makes the unified step's program set (on
the card, one CUDA graph per budget rung, greedy and sampled, plus the
spec-verify or extras variants configured) and prints ``warmup: N
programs in S s``, holding admission meanwhile; ``--no-warmup`` serves
at once and captures each program at its first use. A worker that cannot
build or launch its kernels exits non-zero and never registers.
``--max-waiting``/``--max-queue-delay-s`` bound the engine's waiting
list (the oldest waiter is shed, batch class first). ``--health-port``
gives a worker a ``/health``, ``/metrics`` and ``/debug/*`` endpoint.

SLOs and observability: ``--coloc adaptive --itl-slo-ms X`` lets the
co-location controller move the prefill quantum against a decode ITL
target (floor ``--coloc-min-quantum``); ``--default-deadline-s`` and
``--default-request-class`` apply when a client sends no
``X-Request-Timeout-Ms`` / ``X-Request-Class``, and
``--batch-watermark-scale`` makes batch requests 429 first;
``--profile-dir`` enables ``/debug/profile`` (and, on a worker, the
control-plane profile verb): ``torch.profiler`` windows exported as
Chrome traces under that directory. ``DYNTPU_TRACE=/path.jsonl`` writes
the span capture (``<path>.<pid>``) that
``python -m dynamo_tpu_torch.tools.trace_merge`` joins.

The flags the port serves keep the reference's names, destinations and
defaults, except ``--endpoint`` (``dyn://dynamo.torch.generate``), the
exporter's ``--component`` and the planner's ``--decode-component``
(``torch``: the port's workers serve that component). Flags that need what the port
does not have yet — meshes and multi-host, weight quantization — are
refused with an error that names them, never ignored. ``--model-path``
takes ``preset:NAME``, an HF checkout directory, ``hf://org/name`` (the
local hub cache) or a ``.gguf`` file; ``--config FILE.yaml`` (sections
Run, Frontend, Engine, Router; ``Common`` + ``common-configs``),
``DYNTPU_<SECTION>_<KEY>`` and ``--set Section.key=value`` layer onto
the flags as the reference layers them. The
reference's persistent XLA compile cache has no counterpart (a CUDA
graph cannot outlive its process): its flag is absent and rejected by
the parser.
"""

from __future__ import annotations

import argparse
import asyncio
import contextlib
import json
import logging
import signal
import sys
import time

logger = logging.getLogger(__name__)

DEFAULT_ENDPOINT = "dyn://dynamo.torch.generate"


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="dynamo-tpu-torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    run = sub.add_parser("run", help="serve / chat / batch")
    run.add_argument("--in", dest="input", default="http",
                     help="http | text | batch:FILE | dyn://ns.component.endpoint")
    run.add_argument("--out", dest="output", default="torch",
                     help="torch | echo_core | echo_full | dyn")
    run.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                     help="device of --out torch: cuda unless the CPU is "
                          "asked for (the plain PyTorch path)")
    run.add_argument("--model-path", default="preset:llama3.2-1b",
                     help="preset:NAME, an HF checkout directory, "
                          "hf://org/name (local hub cache) or FILE.gguf")
    run.add_argument("--model-name", default=None)
    run.add_argument("--model-type", default="chat",
                     choices=["chat", "embeddings"])
    run.add_argument("--endpoint", default=DEFAULT_ENDPOINT,
                     help="endpoint a local engine serves at")
    run.add_argument("--http-host", default="0.0.0.0")
    run.add_argument("--http-port", type=int, default=8080)
    run.add_argument("--control-plane", default=None, metavar="HOST:PORT",
                     help="join an existing control-plane server")
    run.add_argument("--spawn-control-plane", nargs="?", const="0",
                     default=None, metavar="PORT",
                     help="host a control-plane server in this process")
    run.add_argument("--router-mode", default="round_robin",
                     choices=["round_robin", "random", "kv"])
    run.add_argument("--route-network-aware", action="store_true",
                     help="KV router mode: add the transfer-cost term to the "
                          "selection score — candidates pay for moving the "
                          "non-overlapping prefix over their advertised "
                          "ingest rate")
    run.add_argument("--mesh", default=None)
    run.add_argument("--kv-sp", action="store_true")
    run.add_argument("--coordinator", default=None, metavar="HOST:PORT")
    run.add_argument("--num-nodes", type=int, default=1)
    run.add_argument("--node-rank", type=int, default=0)
    run.add_argument("--dtype", default="bfloat16",
                     help="bfloat16 | float32")
    run.add_argument("--quant", default=None, choices=["int8"],
                     help="legacy whole-model int8 weights (every matmul site; "
                          "--weight-quant int8 is its superset)")
    run.add_argument("--kv-quant", default=None, choices=["int8"],
                     help="int8 KV blocks with per-(block, kv head) scales, "
                          "read by the ragged kernel's int8 leg")
    run.add_argument("--weight-quant", default=None, metavar="POLICY",
                     help="per-matmul weight-quantization policy: 'int8' or "
                          "'fp8' for every site, or site=fmt pairs over "
                          "embedding, attn, mlp, unembed (e.g. "
                          "'attn=int8,mlp=fp8'); weights quantize as they load")
    run.add_argument("--speculative-k", type=int, default=0)
    run.add_argument("--max-num-seqs", type=int, default=32)
    run.add_argument("--max-model-len", type=int, default=2048)
    run.add_argument("--num-blocks", type=int, default=2048)
    run.add_argument("--kv-cache-block-size", type=int, default=16)
    run.add_argument("--prefill-batch", type=int, default=4)
    run.add_argument("--unified", action="store_true",
                     help="no-op: the unified step is the only engine path")
    run.add_argument("--unified-token-budget", type=int, default=256,
                     help="max tokens per unified dispatch (snapped to a "
                          "power-of-two ladder)")
    run.add_argument("--unified-prefill-quantum", type=int, default=64,
                     help="prefill tokens per sequence per unified step "
                          "while decode lanes share the batch (decode-ITL "
                          "bound); also the budget reserved for prefill; "
                          "with --coloc adaptive this is only the STARTING "
                          "quantum — the controller owns it from there")
    run.add_argument("--itl-slo-ms", type=float, default=0.0,
                     help="decode inter-token-latency target in ms the "
                          "co-location controller measures each unified "
                          "dispatch against (0 = no SLO: no violation "
                          "accounting, no adaptation)")
    run.add_argument("--coloc", choices=["static", "adaptive"], default="static",
                     help="unified-step prefill-quantum policy: static "
                          "keeps --unified-prefill-quantum hand-tuned; "
                          "adaptive runs the AIMD feedback loop against "
                          "--itl-slo-ms (grow on headroom, shrink on SLO "
                          "pressure, floor at --coloc-min-quantum) plus "
                          "phase-aware prefill admission")
    run.add_argument("--coloc-min-quantum", type=int, default=16,
                     help="adaptive-quantum floor: minimum prefill tokens "
                          "per unified step, so prefill TTFT progress never "
                          "fully starves under decode SLO pressure")
    run.add_argument("--max-prefill-backlog-tokens", type=int, default=0,
                     help="HTTP admission watermark: 429 while the engine's "
                          "un-prefilled backlog exceeds this many prompt "
                          "tokens (0 = off)")
    run.add_argument("--context-length", type=int, default=None,
                     help="override the card/engine context limit")
    run.add_argument("--no-warmup", action="store_true",
                     help="serve at once: each step program is captured at "
                          "its first use (counted in "
                          "mid_traffic_compiles_total)")
    run.add_argument("--shape-manifest", default=None, metavar="FILE.json",
                     help="shape-manifest path (records the shapes serving "
                          "executes; warmup makes that set first)")
    run.add_argument("--max-inflight", type=int, default=256,
                     help="HTTP admission gate: max concurrently admitted "
                          "requests; excess gets 429 + Retry-After")
    run.add_argument("--max-engine-waiting", type=int, default=0,
                     help="HTTP admission watermark: 429 while the engine "
                          "has this many requests queued (0 = off)")
    run.add_argument("--default-request-class", default="interactive",
                     choices=["interactive", "batch"],
                     help="SLO class assumed when the client sends no "
                          "X-Request-Class header")
    run.add_argument("--batch-watermark-scale", type=float, default=0.5,
                     help="batch-class admission watermark scale: batch "
                          "requests 429 at this fraction of every "
                          "configured watermark/cap (cheapest-first "
                          "degradation; 1.0 = class-blind)")
    run.add_argument("--default-deadline-s", type=float, default=0.0,
                     help="per-request deadline applied when the client "
                          "sends no X-Request-Timeout-Ms header (0 = "
                          "none); expired work is cancelled at every hop")
    run.add_argument("--max-waiting", type=int, default=128,
                     help="engine waiting-list depth bound: over it the "
                          "OLDEST waiter is shed with a typed error "
                          "(0 = unbounded)")
    run.add_argument("--max-queue-delay-s", type=float, default=0.0,
                     help="engine waiting-list age bound: waiters older "
                          "than this are shed (0 = unbounded)")
    run.add_argument("--drain-grace-s", type=float, default=30.0,
                     help="graceful-drain budget on SIGTERM / the "
                          "control-plane drain verb: in-flight requests "
                          "get this long to finish before exit")
    run.add_argument("--health-port", type=int, default=0,
                     help="worker-mode health/metrics HTTP port (0 = off): "
                          "/health answers 503 while warming or draining "
                          "(also serves the /debug/steps|trace|profile "
                          "surface)")
    run.add_argument("--profile-dir", default=None, metavar="DIR",
                     help="enable on-demand profiling: /debug/profile"
                          "?seconds=N and the control-plane profile verb "
                          "capture torch.profiler windows (Chrome traces) "
                          "under DIR without a restart (default "
                          "$DYNTPU_PROFILE_DIR; unset = endpoint disabled)")
    run.add_argument("--concurrency", type=int, default=32,
                     help="batch mode: in-flight request cap")
    run.add_argument("--max-tokens", type=int, default=128,
                     help="text/batch mode: generation cap per request")
    run.add_argument("--config", default=None, metavar="FILE.yaml")
    run.add_argument("--set", dest="overrides", action="append", default=[],
                     metavar="Component.key=value")
    run.add_argument("-v", "--verbose", action="store_true")

    cp = sub.add_parser("control-plane", help="standalone control plane")
    cp.add_argument("--host", default="0.0.0.0")
    cp.add_argument("--port", type=int, default=6380)
    cp.add_argument("--token", default=None)
    cp.add_argument("-v", "--verbose", action="store_true")

    mx = sub.add_parser("metrics", help="Prometheus exporter for worker load")
    mx.add_argument("--control-plane", required=True, metavar="HOST:PORT")
    mx.add_argument("--namespace", default="dynamo")
    mx.add_argument("--component", default="torch")
    mx.add_argument("--host", default="0.0.0.0")
    mx.add_argument("--port", type=int, default=9091)
    mx.add_argument("--push-url", default=None, metavar="URL",
                    help="also push to a Prometheus PushGateway at URL "
                         "(for networks a scraper cannot reach)")
    mx.add_argument("--push-interval", type=float, default=15.0)
    mx.add_argument("--push-job", default="dynamo_tpu")
    mx.add_argument("-v", "--verbose", action="store_true")

    rt = sub.add_parser("router", help="standalone KV-aware router service")
    rt.add_argument("--control-plane", required=True, metavar="HOST:PORT")
    rt.add_argument("--endpoint", required=True,
                    metavar="dyn://ns.component.endpoint",
                    help="target worker endpoint to route to")
    rt.add_argument("--component", default="router",
                    help="component name the routed endpoint is served on")
    rt.add_argument("--block-size", type=int, default=16)
    rt.add_argument("--route-network-aware", action="store_true",
                    help="add the transfer-cost term to the KV selection score")
    rt.add_argument("--replica-id", type=int, default=0,
                    help="this router replica's id: run one router process "
                         "per replica on the same --component; the id labels "
                         "the replica's route records")
    rt.add_argument("-v", "--verbose", action="store_true")

    pl = sub.add_parser("planner", help="auto-scaler (queue/KV watermarks)")
    pl.add_argument("--control-plane", required=True, metavar="HOST:PORT")
    pl.add_argument("--namespace", default="dynamo")
    pl.add_argument("--min-workers", type=int, default=1)
    pl.add_argument("--max-workers", type=int, default=4, help="card budget")
    pl.add_argument("--adjustment-interval", type=float, default=10.0)
    pl.add_argument("--metric-interval", type=float, default=1.0)
    pl.add_argument("--worker-cmd", required=True,
                    help="shell command template spawning one worker "
                         "({index} is substituted)")
    pl.add_argument("--state-path", default=None, metavar="FILE.json",
                    help="checkpoint for crash/restart resume (default "
                         "~/.dynamo_tpu/state/<namespace>.json)")
    pl.add_argument("--profile", default=None, metavar="BENCH.json",
                    help="perf profile (a bench output line with "
                         "extras.sweep) enabling SLA-driven scaling")
    pl.add_argument("--ttft-sla-ms", type=float, default=None)
    pl.add_argument("--itl-sla-ms", type=float, default=None)
    pl.add_argument("--decision-log", default=None, metavar="FILE.jsonl",
                    help="append one JSONL line per scaling decision")
    # Two-pool mode: independent prefill (queue depth/age) and decode
    # (KV use, waiting, ITL) pools; --worker-cmd spawns DECODE workers,
    # --prefill-worker-cmd prefill workers.
    pl.add_argument("--two-pool", action="store_true",
                    help="scale prefill and decode pools independently")
    pl.add_argument("--prefill-worker-cmd", default=None,
                    help="shell command template spawning one PREFILL "
                         "worker (required with --two-pool)")
    pl.add_argument("--prefill-min-workers", type=int, default=1)
    pl.add_argument("--prefill-max-workers", type=int, default=4)
    pl.add_argument("--prefill-queue-age-up-s", type=float, default=5.0,
                    help="oldest queued prefill older than this scales "
                         "the prefill pool up at ANY depth")
    pl.add_argument("--decode-component", default="torch",
                    help="component whose metrics plane scores the "
                         "decode pool")
    pl.add_argument("--decode-itl-up-ms", type=float, default=None,
                    help="decode pool scales up when the pool ITL EMA "
                         "exceeds this (off by default)")
    pl.add_argument("-v", "--verbose", action="store_true")
    return p


def refuse_unserved(args) -> None:
    """SystemExit naming the first flag this slice does not serve."""
    refusals = [
        (args.output == "tpu", "--out tpu is the JAX engine; the port's is --out torch"),
        (args.output not in ("torch", "echo_core", "echo_full", "tpu", "dyn"),
         f"bad --out {args.output!r} (torch | echo_core | echo_full | dyn)"),
        (args.input.startswith("dyn://") and args.output == "dyn",
         "--in dyn://... serves a local engine: --out dyn has none"),
        (args.mesh is not None, "--mesh: device meshes are not served yet"),
        (args.kv_sp, "--kv-sp: the striped KV cache is not served yet"),
        (args.coordinator is not None or args.num_nodes != 1 or args.node_rank != 0,
         "--coordinator/--num-nodes/--node-rank: multi-host serving is not "
         "served yet"),
        (args.model_type == "embeddings" and (args.quant or args.weight_quant),
         "--model-type embeddings serves full-precision weights: drop "
         "--quant/--weight-quant"),
        (args.speculative_k < 0, "--speculative-k must be >= 0"),
        (args.model_type == "embeddings" and args.output in ("echo_core", "echo_full"),
         "--model-type embeddings: the echo engines serve chat; embeddings "
         "need --out torch"),
    ]
    for refused, message in refusals:
        if refused:
            raise SystemExit(f"dynamo-tpu-torch: {message}")


def main(argv: list[str] | None = None) -> None:
    args = build_parser().parse_args(argv)
    logging.basicConfig(
        level=logging.DEBUG if args.verbose else logging.INFO,
        format="%(asctime)s %(levelname).1s %(name)s: %(message)s",
    )
    if args.cmd == "control-plane":
        asyncio.run(_control_plane(args))
        return
    if args.cmd == "metrics":
        asyncio.run(_metrics(args))
        return
    if args.cmd == "router":
        asyncio.run(_router(args))
        return
    if args.cmd == "planner":
        asyncio.run(_planner(args))
        return
    _apply_config(args)
    refuse_unserved(args)
    asyncio.run(_run(args))


#: config section → args attribute aliases (a section's keys are dash/
#: underscore insensitive; an unknown key of a known section is refused).
_CONFIG_SECTIONS = {
    "Run": {"in": "input", "out": "output"},
    "Frontend": {"host": "http_host", "port": "http_port"},
    "Engine": {"block_size": "kv_cache_block_size"},
    "Router": {"mode": "router_mode"},
}


def _apply_config(args) -> None:
    """Layer ``--config FILE.yaml``, the DYNTPU_* environment and ``--set``
    onto the parsed args. Precedence, highest first: ``--set
    Component.key=value`` > explicit flags > file and environment >
    defaults. "Explicit" is a value that differs from a defaults-only
    parse, so a flag repeated in the file never loses to it. The values
    then meet the same refusals as flags (``out: tpu``, say)."""
    from dynamo_tpu_torch.utils.config import load_config

    defaults = vars(build_parser().parse_args(["run"]))

    def apply(cfg, force: bool) -> None:
        for section, aliases in _CONFIG_SECTIONS.items():
            for key, val in cfg.component(section).as_dict().items():
                if section == "Engine" and key == "warmup":
                    # Engine.warmup: false == --no-warmup
                    if force or args.no_warmup == defaults["no_warmup"]:
                        args.no_warmup = not val
                    continue
                attr = aliases.get(key, key)
                if not hasattr(args, attr):
                    raise SystemExit(
                        f"dynamo-tpu-torch: --config/--set: unknown config key "
                        f"{section}.{key} (no matching --{attr.replace('_', '-')} option)"
                    )
                if force or getattr(args, attr) == defaults.get(attr):
                    setattr(args, attr, val)
        unknown = set(cfg.sections()) - set(_CONFIG_SECTIONS)
        if unknown:
            raise SystemExit(
                f"dynamo-tpu-torch: --config/--set: unknown config sections: "
                f"{', '.join(sorted(unknown))} (expected {', '.join(_CONFIG_SECTIONS)})"
            )

    sections = {s: {} for s in _CONFIG_SECTIONS}
    try:
        # File + environment: fill in what the command line did not set.
        apply(load_config(args.config, defaults=sections), force=False)
        # --set beats everything, explicit flags included.
        if args.overrides:
            apply(load_config(None, overrides=args.overrides, defaults=sections, env={}),
                  force=True)
    except (OSError, ValueError, KeyError) as exc:
        raise SystemExit(f"dynamo-tpu-torch: --config/--set: {exc}") from None


async def _control_plane(args) -> None:
    from dynamo_tpu_torch.runtime.transports.control_plane import ControlPlaneServer

    server = await ControlPlaneServer(
        host=args.host, port=args.port, token=args.token
    ).start()
    print(f"control plane on {server.address}", flush=True)
    await _wait_for_signal()
    await server.stop()


async def _metrics(args) -> None:
    from dynamo_tpu_torch.llm.metrics_exporter import MetricsExporter
    from dynamo_tpu_torch.runtime.distributed import DistributedRuntime

    drt = await DistributedRuntime.connect(args.control_plane)
    exporter = await MetricsExporter(
        drt,
        namespace=args.namespace,
        component=args.component,
        host=args.host,
        port=args.port,
        push_url=args.push_url,
        push_interval_s=args.push_interval,
        push_job=args.push_job,
    ).start()
    print(f"metrics exporter on {args.host}:{exporter.port}", flush=True)
    try:
        await _wait_for_signal()
    finally:
        await exporter.stop()
        await drt.shutdown()


async def _router(args) -> None:
    from dynamo_tpu_torch.llm.kv_router.scheduler import KvRouterConfig
    from dynamo_tpu_torch.llm.router_service import RouterService
    from dynamo_tpu_torch.runtime.distributed import DistributedRuntime

    drt = await DistributedRuntime.connect(args.control_plane)
    service = await RouterService(
        drt,
        args.endpoint,
        component_name=args.component,
        cfg=KvRouterConfig(
            block_size=args.block_size,
            network_aware=args.route_network_aware,
        ),
        replica_id=args.replica_id,
    ).start()
    print(
        f"router service at {service.endpoint_path} (replica {args.replica_id})",
        flush=True,
    )
    try:
        await _wait_for_signal()
    finally:
        await service.stop()
        await drt.shutdown()


def _planner_state_path(args) -> str:
    from pathlib import Path

    return args.state_path or str(
        Path.home() / ".dynamo_tpu" / "state" / f"{args.namespace}.json"
    )


async def _planner(args) -> None:
    """The planner until SIGTERM/SIGINT: stopping leaves its workers
    running and checkpointed in the state file, where the next planner
    adopts them."""
    from dynamo_tpu_torch.planner.planner import Planner, PlannerConfig
    from dynamo_tpu_torch.runtime.distributed import DistributedRuntime

    if args.two_pool:
        if args.profile or args.ttft_sla_ms is not None \
                or args.itl_sla_ms is not None:
            # The SLA law is single-pool: accepting the flags and
            # ignoring them would be a silent half-config.
            raise SystemExit(
                "--two-pool does not support --profile/--ttft-sla-ms/"
                "--itl-sla-ms (single-pool SLA law); use "
                "--decode-itl-up-ms and --prefill-queue-age-up-s"
            )
        await _fleet_planner(args)
        return
    has_sla = args.ttft_sla_ms is not None or args.itl_sla_ms is not None
    if bool(args.profile) != has_sla:
        raise SystemExit(
            "SLA scaling needs BOTH --profile and at least one of "
            "--ttft-sla-ms/--itl-sla-ms (got only one half; the other "
            "would be silently ignored)"
        )
    profile = None
    if args.profile:
        from dynamo_tpu_torch.planner.profiles import PerfProfile

        profile = PerfProfile.from_bench_json(args.profile)
    drt = await DistributedRuntime.connect(args.control_plane)
    planner = Planner(
        drt,
        PlannerConfig(
            namespace=args.namespace,
            min_workers=args.min_workers,
            max_workers=args.max_workers,
            adjustment_interval_s=args.adjustment_interval,
            metric_interval_s=args.metric_interval,
            state_path=_planner_state_path(args),
            ttft_sla_ms=args.ttft_sla_ms,
            itl_sla_ms=args.itl_sla_ms,
            decision_log_path=args.decision_log,
        ),
        worker_cmd=args.worker_cmd,
        profile=profile,
    )
    await planner.start()
    print("planner running", flush=True)
    try:
        await _wait_for_signal()
    finally:
        await planner.stop()
        await drt.shutdown()


async def _fleet_planner(args) -> None:
    """Two-pool mode: --worker-cmd spawns decode workers,
    --prefill-worker-cmd prefill workers; each pool runs its own law and
    hysteresis over the shared sample loop."""
    from dynamo_tpu_torch.planner.fleet import FleetPlanner, FleetPlannerConfig
    from dynamo_tpu_torch.planner.planner import SubprocessConnector
    from dynamo_tpu_torch.planner.pools import (
        DecodeLaw,
        PoolConfig,
        PrefillLaw,
        default_pools,
    )
    from dynamo_tpu_torch.runtime.distributed import DistributedRuntime

    if not args.prefill_worker_cmd:
        raise SystemExit("--two-pool requires --prefill-worker-cmd")
    drt = await DistributedRuntime.connect(args.control_plane)
    prefill_pool, decode_pool = default_pools(
        SubprocessConnector(args.prefill_worker_cmd),
        SubprocessConnector(args.worker_cmd),
        prefill_cfg=PoolConfig(
            name="prefill",
            min_workers=args.prefill_min_workers,
            max_workers=args.prefill_max_workers,
        ),
        decode_cfg=PoolConfig(
            name="decode",
            min_workers=args.min_workers,
            max_workers=args.max_workers,
        ),
        prefill_law=PrefillLaw(age_up_s=args.prefill_queue_age_up_s),
        decode_law=DecodeLaw(itl_up_ms=args.decode_itl_up_ms),
    )
    planner = FleetPlanner(
        drt,
        FleetPlannerConfig(
            namespace=args.namespace,
            decode_component=args.decode_component,
            adjustment_interval_s=args.adjustment_interval,
            metric_interval_s=args.metric_interval,
            state_path=_planner_state_path(args),
            decision_log_path=args.decision_log,
        ),
        prefill_pool,
        decode_pool,
    )
    await planner.start()
    print("fleet planner running (two-pool)", flush=True)
    try:
        await _wait_for_signal()
    finally:
        await planner.stop()
        await drt.shutdown()


async def _run(args) -> None:
    async with contextlib.AsyncExitStack() as stack:
        if args.input.startswith("dyn://"):
            drt = await start_runtime(args, stack)
            endpoint_path, engine, served = await start_worker(args, drt, stack)
            print(f"worker serving {endpoint_path}", flush=True)
            await _worker_until_drain(args, drt, endpoint_path, engine, served, stack)
            return
        if args.input == "http":
            service, engine = await start_http(args, stack)
            await _wait_for_signal()
            # Graceful drain before unwind: refuse new requests (503s,
            # /health flips), let the admitted ones finish streaming.
            await service.drain(args.drain_grace_s)
            if engine is not None:
                engine.begin_drain()
                await engine.wait_drained(args.drain_grace_s)
            return
        if args.input != "text" and not args.input.startswith("batch:"):
            raise SystemExit(f"bad --in {args.input!r}")
        manager, _ = await start_pipeline(args, stack)
        if args.input == "text":
            await _text_chat(args, manager)
        else:
            await _batch(args, manager, args.input.split(":", 1)[1])


def _push_logged(stack, fn) -> None:
    """A cleanup step whose failure is logged, not raised: teardown of
    the runtime must not turn a clean drain into a failed exit."""
    async def run() -> None:
        try:
            await fn()
        except Exception:  # noqa: BLE001 — cleanup boundary
            logger.exception("cleanup failed")

    stack.push_async_callback(run)


async def start_runtime(args, stack):
    """Step 1 of a run: the DistributedRuntime — joined to
    ``--control-plane``, to the plane ``--spawn-control-plane`` hosts in
    this process, or in process when neither is named. None when the
    run needs no runtime: a local engine behind a local front."""
    from dynamo_tpu_torch.runtime.distributed import DistributedRuntime

    needed = (
        args.input.startswith("dyn://") or args.output == "dyn"
        or args.control_plane is not None or args.spawn_control_plane is not None
    )
    if not needed:
        return None
    if args.spawn_control_plane is not None:
        from dynamo_tpu_torch.runtime.transports.control_plane import (
            ControlPlaneServer,
        )

        server = await ControlPlaneServer(port=int(args.spawn_control_plane)).start()
        _push_logged(stack, server.stop)
        print(f"control plane on {server.address}", flush=True)
        args.control_plane = server.address
    if args.control_plane:
        drt = await DistributedRuntime.connect(args.control_plane)
    else:
        drt = await DistributedRuntime.in_process()
    _push_logged(stack, drt.shutdown)
    return drt


async def start_worker(args, drt, stack):
    """Step 2 of a run: build the local engine (warmed up), serve it at
    the endpoint and register its model — only then, so no router ever
    picks a warming worker. Returns (endpoint path, the TorchEngine or
    None for echo outputs, the ServedInstance)."""
    from dynamo_tpu_torch.llm.discovery import register_llm
    from dynamo_tpu_torch.ops import kernels
    from dynamo_tpu_torch.runtime.component import EndpointId

    endpoint_path = args.input if args.input.startswith("dyn://") else args.endpoint
    eid = EndpointId.parse(endpoint_path)
    comp = drt.namespace(eid.namespace).component(eid.component)
    endpoint = comp.endpoint(eid.name)
    hooks = {}
    if args.output == "torch":
        from dynamo_tpu_torch.llm.kv_router.publisher import (
            KvEventPublisher,
            WorkerMetricsPublisher,
        )

        # KV events, actual reuse and per-pass load metrics feed the
        # KV-aware router (and the exporter) over the control plane.
        kv_pub = KvEventPublisher(drt, comp, drt.primary_lease_id)
        metrics_pub = WorkerMetricsPublisher()
        await metrics_pub.create_endpoint(comp)
        hooks = dict(on_kv_event=kv_pub.publish_engine_event,
                     on_metrics=metrics_pub.publish,
                     on_kv_actual=kv_pub.publish_hit_actual)
    engine, card, torch_engine = await _start_engine(args, stack, hooks)
    if torch_engine is not None and torch_engine.device.type == "cuda":
        if args.no_warmup:
            # Warmup launched every kernel; without it, build and load
            # them now: a worker that cannot exits before it registers.
            from dynamo_tpu_torch.ops.kernels import _build

            for name in kernels.KERNEL_SOURCES:
                await asyncio.to_thread(_build.load, name)
        # The served path's launch counts start here (worker_report).
        kernels.set_launch_counts({k: 0 for k in kernels.launch_counts()})
    served = await endpoint.serve(engine)
    await register_llm(drt, endpoint, card, model_type=card.model_type)
    print(f"model {card.name!r} registered at {endpoint_path}", flush=True)
    return endpoint_path, torch_engine, served


async def _worker_until_drain(args, drt, endpoint_path, engine, served, stack) -> None:
    """Worker mode's main loop: wait for SIGTERM/SIGINT or the
    control-plane drain verb, then drain (``_graceful_drain``) and
    return; the unwind revokes the lease. Prints the worker's kernel
    launch counts last (``worker_report``)."""
    from dynamo_tpu_torch.runtime.component import EndpointId
    from dynamo_tpu_torch.runtime.drain import watch_drain
    from dynamo_tpu_torch.utils.profiling import Profiler

    loop = asyncio.get_running_loop()
    stop = asyncio.Event()
    for sig in (signal.SIGINT, signal.SIGTERM):
        loop.add_signal_handler(sig, stop.set)
    eid = EndpointId.parse(endpoint_path)
    watch = await watch_drain(drt, eid.namespace, eid.component, stop.set)
    profiler = Profiler(base_dir=args.profile_dir)
    if profiler.configured:
        # The control-plane profile verb: a window on this worker without
        # reaching its debug endpoint (runtime/debug.py).
        from dynamo_tpu_torch.runtime.debug import watch_profile

        pwatch = await watch_profile(drt, eid.namespace, eid.component, profiler)
        stack.callback(pwatch.close)
    if args.health_port and engine is not None:
        from dynamo_tpu_torch.llm.http_service import HealthServer

        health = HealthServer(
            engine.readiness, host="0.0.0.0", port=args.health_port,
            gauges=lambda: {"ingress_requests_total": served.requests_total},
            debug=engine, profiler=profiler,
        )
        await health.start()
        _push_logged(stack, health.stop)
        print(f"worker health on http://0.0.0.0:{health.port}", flush=True)
    await stop.wait()
    watch.close()
    print("draining", flush=True)
    await _graceful_drain(engine, served, args.drain_grace_s)
    if engine is not None:
        print("worker report " + json.dumps(worker_report(engine, served)), flush=True)


def worker_report(engine, served) -> dict:
    """What a worker served: requests, unified dispatches, layers, every
    kernel launch counter since it registered and, on the card, its peak
    and reserved device memory."""
    import torch

    from dynamo_tpu_torch.ops import kernels

    report = {
        "requests": served.requests_total,
        "unified_dispatches": engine.unified_dispatches,
        "num_layers": engine.cfg.model.num_layers,
        "device": engine.device.type,
        "kernel_launches": kernels.launch_counts(),
    }
    if engine.device.type == "cuda":
        report["cuda_max_allocated_bytes"] = torch.cuda.max_memory_allocated(engine.device)
        report["cuda_reserved_bytes"] = torch.cuda.memory_reserved(engine.device)
    return report


async def _graceful_drain(engine, served, grace_s: float) -> bool:
    """The drain's in-process half: the engine stops admitting (readiness
    flips), the served instance deregisters first — routers evict now —
    then awaits its in-flight handlers, and the engine gets the rest of
    the grace to finish what is left."""
    t0 = time.monotonic()
    ok = True
    if engine is not None:
        engine.begin_drain()
    if served is not None:
        ok = await served.drain(grace_s)
    if engine is not None:
        remaining = max(1.0, grace_s - (time.monotonic() - t0))
        ok = await engine.wait_drained(remaining) and ok
    print("drain complete" if ok else "drain grace expired", flush=True)
    return ok


async def _start_frontend(args, drt, engine_ops=()):
    """ModelWatcher + ModelManager over the runtime's discovery plane (in
    KV mode with a KvRouter per worker component); waits up to 5 s for
    the first model to appear."""
    from dynamo_tpu_torch.llm.discovery import ModelManager, ModelWatcher
    from dynamo_tpu_torch.llm.kv_router.router import kv_selector_factory
    from dynamo_tpu_torch.llm.kv_router.scheduler import KvRouterConfig
    from dynamo_tpu_torch.runtime.egress import RouterMode

    mode = RouterMode(args.router_mode)
    kv_cfg = KvRouterConfig(network_aware=args.route_network_aware)
    manager = ModelManager()
    watcher = ModelWatcher(
        drt, manager, router_mode=mode, engine_ops=engine_ops,
        kv_selector_factory=(
            kv_selector_factory(drt, kv_cfg) if mode is RouterMode.KV else None
        ),
    )
    await watcher.start()
    for _ in range(50):
        if manager.models():
            break
        await asyncio.sleep(0.1)
    return manager


async def _wait_for_signal() -> None:
    loop = asyncio.get_running_loop()
    stop = asyncio.Event()
    for sig in (signal.SIGINT, signal.SIGTERM):
        loop.add_signal_handler(sig, stop.set)
    await stop.wait()
    print("shutting down", flush=True)


def _local_and_cfg(args):
    """Model card + EngineConfig for --out torch."""
    from dynamo_tpu_torch.engine.config import EngineConfig
    from dynamo_tpu_torch.llm.local_model import LocalModel

    try:
        local = LocalModel.prepare(
            args.model_path,
            name=args.model_name,
            context_length=args.context_length,
            kv_block_size=args.kv_cache_block_size,
        )
    except (ValueError, FileNotFoundError) as exc:
        raise SystemExit(f"dynamo-tpu-torch: {exc}") from None
    max_len = min(args.max_model_len, local.card.context_length)
    local.card.context_length = max_len
    ecfg = EngineConfig(
        model=local.config,
        dtype=args.dtype,
        block_size=args.kv_cache_block_size,
        num_blocks=args.num_blocks,
        max_num_seqs=args.max_num_seqs,
        max_model_len=max_len,
        prefill_batch=args.prefill_batch,
        unified_token_budget=args.unified_token_budget,
        unified_prefill_quantum=args.unified_prefill_quantum,
        itl_slo_ms=args.itl_slo_ms,
        coloc=args.coloc,
        coloc_min_quantum=args.coloc_min_quantum,
        kv_quant=args.kv_quant,
        quant=args.quant,
        weight_quant=args.weight_quant,
        speculative_k=args.speculative_k,
        shape_manifest_path=args.shape_manifest,
        # With warmup on, hold admission until the hot program set is
        # made; --no-warmup serves at once, degraded.
        warmup_gate="degraded" if args.no_warmup else "hold",
        max_waiting=args.max_waiting,
        max_queue_delay_s=args.max_queue_delay_s,
    )
    try:
        ecfg.validate()
    except ValueError as exc:
        raise SystemExit(f"dynamo-tpu-torch: {exc}") from None
    return local, ecfg


async def _start_engine(args, stack, hooks=None):
    """The local engine (torch or echo) and its card. The TorchEngine is
    started (weights built off the event loop) and, unless --no-warmup,
    warmed up (its programs made: CUDA graphs captured on the card)
    before this returns. ``hooks``: the TorchEngine's side-channel
    callbacks (``on_kv_event``, ``on_metrics``, ``on_kv_actual``)."""
    from dynamo_tpu_torch.llm.model_card import ModelDeploymentCard

    if args.output in ("echo_core", "echo_full"):
        from dynamo_tpu_torch.llm.engines import EchoEngineCore, EchoEngineFull

        engine = EchoEngineCore() if args.output == "echo_core" else EchoEngineFull()
        return engine, ModelDeploymentCard(
            name=args.model_name or args.output, model_path=None
        ), None
    if args.model_type == "embeddings":
        return await _start_embeddings(args)
    from dynamo_tpu_torch.engine.engine import TorchEngine

    if args.unified:
        logger.warning("--unified is a no-op: the unified step is the only engine path")
    local, ecfg = _local_and_cfg(args)
    # A checkout's or a GGUF's weights, read onto the device off the event
    # loop (a checkout's quantized layer by layer under a weight policy);
    # None for a preset (the runner draws random weights there, quantized
    # as they are drawn).
    params = await asyncio.to_thread(local.load_params, args.dtype, args.device,
                                     ecfg.weight_policy())
    engine = TorchEngine(ecfg, params=params, device=args.device, **(hooks or {}))
    del params
    await engine.start()
    stack.push_async_callback(engine.stop)
    if not args.no_warmup:
        t0 = time.monotonic()
        n = await engine.warmup()
        tail = engine.warm_tail_pending
        print(
            f"warmup: {n} programs in {time.monotonic() - t0:.1f}s"
            + (f" ({tail} deferred to background)" if tail else "")
            + " — engine ready",
            flush=True,
        )
    return engine, local.card, engine


async def _start_embeddings(args):
    """``--model-type embeddings``: the pooled-forward engine
    (llm/embedding.py) of the preset's weights, built off the event loop
    and, unless --no-warmup, run once; its card says ``embeddings``."""
    from dynamo_tpu_torch.llm.embedding import EmbeddingEngine

    local, _ecfg = _local_and_cfg(args)

    def build():
        engine = EmbeddingEngine(local.config, params=local.load_params(args.dtype, args.device),
                                 dtype=args.dtype, device=args.device)
        if not args.no_warmup:
            engine._run([1] * 8)
        return engine

    engine = await asyncio.to_thread(build)
    local.card.model_type = "embeddings"
    return engine, local.card, None


async def start_pipeline(args, stack, engine_ops=()):
    """(ModelManager, the local TorchEngine or None). Without a runtime
    the manager serves the local engine in process; with one (a control
    plane, or ``--out dyn``) the local engine — unless ``--out dyn`` —
    is served at ``--endpoint`` and registered, and the manager routes
    to every discovered worker. ``engine_ops`` are linked between the
    detokenizer and the engine or router (a ``Tap``, for one)."""
    from dynamo_tpu_torch.llm.discovery import ModelManager, build_serving_pipeline

    drt = await start_runtime(args, stack)
    if drt is None:
        engine, card, torch_engine = await _start_engine(args, stack)
        manager = ModelManager()
        manager.add_model(card.name, build_serving_pipeline(card, engine, engine_ops), card)
        return manager, torch_engine
    torch_engine = None
    if args.output != "dyn":
        _path, torch_engine, _served = await start_worker(args, drt, stack)
    return await _start_frontend(args, drt, engine_ops), torch_engine


async def start_http(args, stack, engine_ops=()):
    """Start the engine and the OpenAI HTTP service on this event loop
    (the loop the engine thread posts its tokens to); returns (service,
    the TorchEngine or None). Prints the ready line once both serve."""
    from dynamo_tpu_torch.llm.admission import AdmissionConfig, AdmissionController
    from dynamo_tpu_torch.llm.http_service import HttpService
    from dynamo_tpu_torch.utils.profiling import Profiler

    manager, engine = await start_pipeline(args, stack, engine_ops)
    readiness = engine.readiness if engine is not None else None
    service = HttpService(
        manager, host=args.http_host, port=args.http_port,
        readiness=readiness,
        admission=AdmissionController(
            AdmissionConfig(
                max_inflight=args.max_inflight,
                max_engine_waiting=args.max_engine_waiting,
                max_prefill_backlog_tokens=args.max_prefill_backlog_tokens,
                default_deadline_s=args.default_deadline_s,
                default_request_class=args.default_request_class,
                class_watermark_scale={
                    "interactive": 1.0, "batch": args.batch_watermark_scale,
                },
            ),
            engine_stats=readiness,
        ),
        # /debug/steps reads the local engine's flight recorder;
        # /debug/profile runs torch.profiler windows under --profile-dir.
        debug=engine,
        profiler=Profiler(base_dir=args.profile_dir),
    )
    await service.start()
    stack.push_async_callback(service.stop)
    print(
        f"OpenAI server on http://{args.http_host}:{service.port} "
        f"(models: {manager.models() or '<awaiting workers>'})",
        flush=True,
    )
    return service, engine


async def _text_chat(args, manager) -> None:
    """Interactive chat loop."""
    from dynamo_tpu_torch.llm.protocols.openai import ChatCompletionRequest
    from dynamo_tpu_torch.runtime.engine import Context

    model = manager.models()[0]
    engine = manager.get(model)
    history: list[dict] = []
    print(f"chatting with {model!r} — empty line or Ctrl-D to exit", flush=True)
    while True:
        try:
            line = await asyncio.to_thread(input, "> ")
        except (EOFError, KeyboardInterrupt):
            break
        if not line.strip():
            break
        history.append({"role": "user", "content": line})
        req = ChatCompletionRequest.model_validate({
            "model": model, "messages": history, "stream": True,
            "max_tokens": args.max_tokens,
        })
        parts: list[str] = []
        async for chunk in engine.generate(Context(req)):
            obj = chunk.model_dump(exclude_none=True) if hasattr(
                chunk, "model_dump"
            ) else chunk
            for choice in obj.get("choices", []):
                piece = (choice.get("delta") or {}).get("content")
                if piece:
                    parts.append(piece)
                    print(piece, end="", flush=True)
        print(flush=True)
        history.append({"role": "assistant", "content": "".join(parts)})


async def _batch(args, manager, path: str) -> None:
    """Prompt-file mini-benchmark: one prompt per line; prints one JSON
    report of per-request latency and aggregate token rates."""
    import numpy as np

    from dynamo_tpu_torch.llm.protocols.openai import ChatCompletionRequest
    from dynamo_tpu_torch.runtime.engine import Context

    def _read_prompts() -> list[str]:
        with open(path) as f:
            return [ln.strip() for ln in f if ln.strip()]

    prompts = await asyncio.to_thread(_read_prompts)
    if not prompts:
        raise SystemExit(f"{path} contains no prompts")
    model = manager.models()[0]
    engine = manager.get(model)
    sem = asyncio.Semaphore(args.concurrency)

    async def run_one(prompt: str):
        async with sem:
            req = ChatCompletionRequest.model_validate({
                "model": model,
                "messages": [{"role": "user", "content": prompt}],
                "stream": True,
                "max_tokens": args.max_tokens,
            })
            t0 = time.monotonic()
            first = None
            n_tokens = 0
            usage = None
            async for chunk in engine.generate(Context(req)):
                obj = chunk.model_dump(exclude_none=True) if hasattr(
                    chunk, "model_dump"
                ) else chunk
                for choice in obj.get("choices", []):
                    if (choice.get("delta") or {}).get("content"):
                        n_tokens += 1
                        if first is None:
                            first = time.monotonic() - t0
                if obj.get("usage"):
                    usage = obj["usage"]
            out = usage["completion_tokens"] if usage else n_tokens
            inp = usage["prompt_tokens"] if usage else 0
            return time.monotonic() - t0, first, inp, out

    t0 = time.monotonic()
    results = await asyncio.gather(*[run_one(p) for p in prompts])
    elapsed = time.monotonic() - t0
    ttfts = [r[1] for r in results if r[1] is not None]
    toks_in = sum(r[2] for r in results)
    toks_out = sum(r[3] for r in results)
    report = {
        "requests": len(prompts),
        "elapsed_s": round(elapsed, 2),
        "tokens_in_per_s": round(toks_in / elapsed, 1),
        "tokens_out_per_s": round(toks_out / elapsed, 1),
        "p50_ttft_ms": round(1000 * float(np.median(ttfts)), 1) if ttfts else None,
        "p95_ttft_ms": round(
            1000 * float(np.percentile(ttfts, 95)), 1
        ) if ttfts else None,
        "mean_request_s": round(
            float(np.mean([r[0] for r in results])), 2
        ),
    }
    print(json.dumps(report), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
