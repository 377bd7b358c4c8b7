"""A prefill worker process: a TorchEngine draining the shared prefill
queue over the control plane and pushing each prompt's KV into the
decode worker's transfer receiver (tcp or the native agent, whichever
the queue entry names). Port of the reference's prefill worker
component, as its own OS process.

    python -m dynamo_tpu_torch.examples.prefill_worker \\
        --control-plane HOST:PORT [--namespace NS] \\
        [--model-path preset:llama3.2-1b] [--dtype bfloat16] \\
        [--device cuda|cpu] [--num-blocks N] [--max-num-seqs N] \\
        [--max-model-len N] [--kv-quant int8] [--seed S] [--warmup]

Weights are random, made from ``--seed`` (the engine's seed): a decode
engine with the same preset, dtype and seed holds the same weights, so a
remote-prefilled stream equals a local one. Prints ``READY <lease>``
once it serves. On SIGTERM it finishes the item in hand, prints ``worker
report {json}`` (requests, unified dispatches, every kernel launch
counter since it started serving) and exits 0. ``--die-after-dequeue`` exits 17 right after its
first dequeue, holding the lease (the redelivery fixture).
"""

from __future__ import annotations

import argparse
import asyncio
import json
import os
import signal

from dynamo_tpu_torch.disagg import PrefillQueue, PrefillWorker
from dynamo_tpu_torch.engine.config import EngineConfig
from dynamo_tpu_torch.engine.engine import TorchEngine
from dynamo_tpu_torch.llm.local_model import LocalModel
from dynamo_tpu_torch.runtime.distributed import DistributedRuntime


class _DyingWorker(PrefillWorker):
    """Crashes hard after dequeuing, before serving: its un-acked item
    must reach another worker."""

    async def _serve_batch(self, reqs: list) -> None:
        print(f"DEQUEUED {reqs[0].get('request_id')}", flush=True)
        os._exit(17)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--control-plane", required=True)
    ap.add_argument("--namespace", default="dynamo")
    ap.add_argument("--ttl", type=float, default=2.0, help="lease TTL, seconds")
    ap.add_argument("--model-path", default="preset:tiny-test")
    ap.add_argument("--dtype", default="bfloat16")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--num-blocks", type=int, default=512)
    ap.add_argument("--max-num-seqs", type=int, default=8)
    ap.add_argument("--max-model-len", type=int, default=2048)
    ap.add_argument("--prefill-batch", type=int, default=4)
    ap.add_argument("--unified-token-budget", type=int, default=256)
    ap.add_argument("--kv-quant", default=None, choices=[None, "int8"])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--warmup", action="store_true",
                    help="capture the step programs before serving")
    ap.add_argument("--die-after-dequeue", action="store_true")
    return ap


async def main(argv: list[str] | None = None) -> None:
    args = build_parser().parse_args(argv)
    local = LocalModel.prepare(args.model_path)
    engine = TorchEngine(
        EngineConfig(
            model=local.config, dtype=args.dtype, num_blocks=args.num_blocks,
            max_num_seqs=args.max_num_seqs, max_model_len=args.max_model_len,
            prefill_batch=args.prefill_batch,
            unified_token_budget=args.unified_token_budget,
            kv_quant=args.kv_quant, seed=args.seed,
        ),
        device=args.device,
    )
    await engine.start()
    if args.warmup:
        n = await engine.warmup()
        print(f"warmup: {n} programs", flush=True)
    from dynamo_tpu_torch.ops import kernels

    # The report counts launches from here: warm passes are not served work.
    kernels.set_launch_counts({k: 0 for k in kernels.launch_counts()})
    drt = await DistributedRuntime.connect(args.control_plane, lease_ttl_s=args.ttl)
    cls = _DyingWorker if args.die_after_dequeue else PrefillWorker
    worker = cls(engine, PrefillQueue(drt, args.namespace)).start()
    stop = asyncio.Event()
    loop = asyncio.get_running_loop()
    for sig in (signal.SIGTERM, signal.SIGINT):
        loop.add_signal_handler(sig, stop.set)
    print(f"READY {drt.primary_lease_id}", flush=True)
    try:
        await stop.wait()
    finally:
        await worker.stop()
        print("worker report " + json.dumps({
            "requests": worker.served,
            "unified_dispatches": engine.unified_dispatches,
            "num_layers": engine.cfg.model.num_layers,
            "mid_traffic_compiles": engine.runner.compile_stats.mid_traffic_compiles,
            "kernel_launches": kernels.launch_counts(),
        }), flush=True)
        await engine.stop()
        await drt.shutdown()


if __name__ == "__main__":
    asyncio.run(main())
