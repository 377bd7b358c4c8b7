"""dynamo-tpu-torch CLI (port of the ``run`` subcommand of
dynamo_tpu/cli.py): launch the port from a shell.

  python -m dynamo_tpu_torch run [--in {http,text,batch:FILE}]
                                 [--out {torch,echo_core,echo_full}]
                                 [--model-path preset:NAME] [--device {cuda,cpu}] ...

- ``--in http``        one-process OpenAI server on the local engine;
                       SIGINT/SIGTERM drains it (new requests 503, the
                       admitted ones finish) and exits
- ``--in text``        interactive chat against the same pipeline
- ``--in batch:FILE``  run a prompt file, print a JSON report of TTFT and
                       token rates
- ``--out torch``      the port's TorchEngine (the reference's
                       ``--out tpu``), on ``--device`` (cuda unless cpu is
                       asked for); ``echo_core``/``echo_full`` echo the
                       prompt's tokens / text

With ``--out torch`` the engine warms up before it serves: it makes the
unified step's program set (on the card, one CUDA graph per budget rung,
greedy and sampled, plus the spec-verify or extras variants configured)
and prints ``warmup: N programs in S s``, holding admission meanwhile;
``--no-warmup`` serves at once and captures each program at its first
use (``warmup_gate="degraded"``). ``--shape-manifest FILE`` records the
shapes serving executed and orders the next warmup by them;
``--speculative-k K`` turns on prompt-lookup speculative decoding.

The flags the port serves keep the reference's names, destinations and
defaults. Flags that need what the port does not have yet — the runtime
plane (``dyn://`` inputs, ``--out dyn``, control planes, routers), meshes
and multi-host, weight quantization, embeddings, layered configs,
deadlines, SLO classes, the adaptive co-location controller — are
refused with an error that names them, never ignored. Flags of the
reference that configure something the port has no counterpart for (the
persistent XLA compile cache: a CUDA graph cannot outlive its process;
the engine's bounded waiting list, worker health ports, profiling
windows) are absent and rejected by the parser.
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


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="dynamo-tpu-torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    run = sub.add_parser("run", help="serve / chat / batch")
    run.add_argument("--in", dest="input", default="http",
                     help="http | text | batch:FILE")
    run.add_argument("--out", dest="output", default="torch",
                     help="torch | echo_core | echo_full")
    run.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                     help="device of --out torch: cuda unless the CPU is "
                          "asked for (the plain PyTorch path)")
    run.add_argument("--model-path", default="preset:llama3.2-1b",
                     help="preset:NAME")
    run.add_argument("--model-name", default=None)
    run.add_argument("--model-type", default="chat",
                     choices=["chat", "embeddings"])
    run.add_argument("--http-host", default="0.0.0.0")
    run.add_argument("--http-port", type=int, default=8080)
    # Refused when set (the runtime plane arrives with its own slice).
    run.add_argument("--control-plane", default=None, metavar="HOST:PORT")
    run.add_argument("--spawn-control-plane", nargs="?", const="0",
                     default=None, metavar="PORT")
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
    run.add_argument("--drain-grace-s", type=float, default=30.0,
                     help="graceful-drain budget on SIGTERM: in-flight "
                          "requests get this long to finish before exit")
    run.add_argument("--concurrency", type=int, default=32,
                     help="batch mode: in-flight request cap")
    run.add_argument("--max-tokens", type=int, default=128,
                     help="text/batch mode: generation cap per request")
    run.add_argument("--config", default=None, metavar="FILE.yaml")
    run.add_argument("--set", dest="overrides", action="append", default=[],
                     metavar="Component.key=value")
    run.add_argument("-v", "--verbose", action="store_true")
    return p


def refuse_unserved(args) -> None:
    """SystemExit naming the first flag this slice does not serve."""
    runtime = "needs the runtime plane, which this slice of the port does not have"
    refusals = [
        (args.output == "tpu", "--out tpu is the JAX engine; the port's is --out torch"),
        (args.output == "dyn", f"--out dyn {runtime}"),
        (args.output not in ("torch", "echo_core", "echo_full", "tpu", "dyn"),
         f"bad --out {args.output!r} (torch | echo_core | echo_full)"),
        (args.input.startswith("dyn://"), f"--in dyn://... {runtime}"),
        (args.control_plane is not None, f"--control-plane {runtime}"),
        (args.spawn_control_plane is not None, f"--spawn-control-plane {runtime}"),
        (args.router_mode != "round_robin",
         f"--router-mode {args.router_mode} {runtime}: one local engine serves"),
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
    refuse_unserved(args)
    asyncio.run(_run(args))


async def _run(args) -> None:
    async with contextlib.AsyncExitStack() as stack:
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
    """(ModelManager serving the one local model, the TorchEngine or
    None for echo outputs). ``engine_ops`` are linked between the
    detokenizer and the engine (a ``Tap``, for one)."""
    from dynamo_tpu_torch.llm.discovery import ModelManager, build_serving_pipeline

    engine, card, torch_engine = await _start_engine(args, stack)
    manager = ModelManager()
    manager.add_model(card.name, build_serving_pipeline(card, engine, engine_ops))
    return manager, torch_engine


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
        f"(models: {manager.models()})",
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
