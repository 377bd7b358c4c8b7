"""dynamo-tpu-torch CLI (port of the ``run`` and ``control-plane``
subcommands of dynamo_tpu/cli.py): launch the port from a shell.

  python -m dynamo_tpu_torch run [--in {http,text,batch:FILE,dyn://ns.comp.ep}]
                                 [--out {torch,echo_core,echo_full,dyn}]
                                 [--model-path preset:NAME] [--device {cuda,cpu}] ...
  python -m dynamo_tpu_torch control-plane [--host H] [--port P] [--token T]

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
                       to them (``--router-mode round_robin|random``),
                       failing a stream over to a sibling when its worker
                       dies mid-stream
- ``control-plane``    the standalone discovery/messaging server

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
list (the oldest waiter is shed). ``--health-port`` gives a worker a
``/health`` and ``/metrics`` endpoint.

The flags the port serves keep the reference's names, destinations and
defaults, except ``--endpoint`` (``dyn://dynamo.torch.generate``). Flags
that need what the port does not have yet — the KV-aware router (ROADMAP
A5), meshes and multi-host, weight quantization, embeddings, layered
configs, deadlines, SLO classes, the adaptive co-location controller —
are refused with an error that names them, never ignored. Flags of the
reference that configure something the port has no counterpart for (the
persistent XLA compile cache: a CUDA graph cannot outlive its process;
profiling windows) are absent and rejected by the parser.
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
                     help="preset:NAME")
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
    run.add_argument("--mesh", default=None)
    run.add_argument("--kv-sp", action="store_true")
    run.add_argument("--coordinator", default=None, metavar="HOST:PORT")
    run.add_argument("--num-nodes", type=int, default=1)
    run.add_argument("--node-rank", type=int, default=0)
    run.add_argument("--dtype", default="bfloat16",
                     help="bfloat16 | float32")
    run.add_argument("--quant", default=None, choices=["int8"])
    run.add_argument("--kv-quant", default=None, choices=["int8"],
                     help="int8 KV blocks with per-(block, kv head) scales, "
                          "read by the ragged kernel's int8 leg")
    run.add_argument("--weight-quant", default=None, metavar="POLICY")
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
                          "while decode lanes share the batch")
    run.add_argument("--itl-slo-ms", type=float, default=0.0)
    run.add_argument("--coloc", choices=["static", "adaptive"], default="static")
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
                     choices=["interactive", "batch"])
    run.add_argument("--batch-watermark-scale", type=float, default=0.5)
    run.add_argument("--default-deadline-s", type=float, default=0.0)
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
                          "/health answers 503 while warming or draining")
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
    return p


def refuse_unserved(args) -> None:
    """SystemExit naming the first flag this slice does not serve."""
    from dynamo_tpu_torch.runtime.egress import KV_REFUSAL

    refusals = [
        (args.output == "tpu", "--out tpu is the JAX engine; the port's is --out torch"),
        (args.output not in ("torch", "echo_core", "echo_full", "tpu", "dyn"),
         f"bad --out {args.output!r} (torch | echo_core | echo_full | dyn)"),
        (args.input.startswith("dyn://") and args.output == "dyn",
         "--in dyn://... serves a local engine: --out dyn has none"),
        (args.router_mode == "kv", KV_REFUSAL),
        (args.mesh is not None, "--mesh: device meshes are not served yet"),
        (args.kv_sp, "--kv-sp: the striped KV cache is not served yet"),
        (args.coordinator is not None or args.num_nodes != 1 or args.node_rank != 0,
         "--coordinator/--num-nodes/--node-rank: multi-host serving is not "
         "served yet"),
        (args.quant is not None, "--quant: weight quantization is not served yet"),
        (args.weight_quant is not None,
         "--weight-quant: weight quantization is not served yet"),
        (args.speculative_k < 0, "--speculative-k must be >= 0"),
        (args.model_type != "chat",
         f"--model-type {args.model_type}: only chat models are served"),
        (args.default_deadline_s > 0,
         "--default-deadline-s: request deadlines are not served yet"),
        (args.default_request_class != "interactive"
         or args.batch_watermark_scale != 0.5,
         "--default-request-class/--batch-watermark-scale: SLO request "
         "classes are not served yet"),
        (args.config is not None or args.overrides,
         "--config/--set: layered configs are not served yet"),
        (args.coloc != "static",
         "--coloc adaptive: the adaptive co-location controller is not "
         "served yet"),
        (args.itl_slo_ms != 0, "--itl-slo-ms: ITL SLO accounting is not served yet"),
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
    refuse_unserved(args)
    asyncio.run(_run(args))


async def _control_plane(args) -> None:
    from dynamo_tpu_torch.runtime.transports.control_plane import ControlPlaneServer

    server = await ControlPlaneServer(
        host=args.host, port=args.port, token=args.token
    ).start()
    print(f"control plane on {server.address}", flush=True)
    await _wait_for_signal()
    await server.stop()


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
    endpoint = drt.namespace(eid.namespace).component(eid.component).endpoint(eid.name)
    engine, card, torch_engine = await _start_engine(args, stack)
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

    loop = asyncio.get_running_loop()
    stop = asyncio.Event()
    for sig in (signal.SIGINT, signal.SIGTERM):
        loop.add_signal_handler(sig, stop.set)
    eid = EndpointId.parse(endpoint_path)
    watch = await watch_drain(drt, eid.namespace, eid.component, stop.set)
    if args.health_port and engine is not None:
        from dynamo_tpu_torch.llm.http_service import HealthServer

        health = HealthServer(
            engine.readiness, host="0.0.0.0", port=args.health_port,
            gauges=lambda: {"ingress_requests_total": served.requests_total},
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
    """ModelWatcher + ModelManager over the runtime's discovery plane;
    waits up to 5 s for the first model to appear."""
    from dynamo_tpu_torch.llm.discovery import ModelManager, ModelWatcher
    from dynamo_tpu_torch.runtime.egress import RouterMode

    manager = ModelManager()
    watcher = ModelWatcher(
        drt, manager, router_mode=RouterMode(args.router_mode), engine_ops=engine_ops
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
    except ValueError as exc:
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
        kv_quant=args.kv_quant,
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


async def _start_engine(args, stack):
    """The local engine (torch or echo) and its card. The TorchEngine is
    started (weights built off the event loop) and, unless --no-warmup,
    warmed up (its programs made: CUDA graphs captured on the card)
    before this returns."""
    from dynamo_tpu_torch.llm.model_card import ModelDeploymentCard

    if args.output in ("echo_core", "echo_full"):
        from dynamo_tpu_torch.llm.engines import EchoEngineCore, EchoEngineFull

        engine = EchoEngineCore() if args.output == "echo_core" else EchoEngineFull()
        return engine, ModelDeploymentCard(
            name=args.model_name or args.output, model_path=None
        ), None
    from dynamo_tpu_torch.engine.engine import TorchEngine

    if args.unified:
        logger.warning("--unified is a no-op: the unified step is the only engine path")
    local, ecfg = _local_and_cfg(args)
    # Presets only: the runner seeds random weights on the device.
    engine = TorchEngine(ecfg, device=args.device)
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
        manager.add_model(card.name, build_serving_pipeline(card, engine, engine_ops))
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
            ),
            engine_stats=readiness,
        ),
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
