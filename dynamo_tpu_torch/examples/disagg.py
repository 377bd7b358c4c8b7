"""Disaggregated prefill/decode deployment in one process, end to end: a
decode engine, a prefill engine, the shared queue, the conditional
disagg router and the OpenAI frontend (port of the reference's
examples/llm/disagg.py).

    python -m dynamo_tpu_torch.examples.disagg [--model-path preset:llama3.2-1b]
        [--device cuda|cpu] [--dtype bfloat16] [--port 8080]
        [--max-local-prefill-length 32] [--transport auto|device|tcp|native]
    curl localhost:8080/v1/chat/completions -H 'Content-Type: application/json' \\
      -d '{"model":"tiny-test","messages":[{"role":"user","content":"hi"}]}'

Prompts longer than ``--max-local-prefill-length`` tokens (beyond their
prefix-cache hit) prefill on the prefill engine through the queue; their
KV blocks come back over the same-process device channel (``auto`` and
``device``), or over the wire when ``tcp``/``native`` is pinned. Short
prompts stay on the decode engine. Both engines make the same random
weights from the engine seed.
"""

from __future__ import annotations

import argparse
import asyncio

from dynamo_tpu_torch.disagg import (
    DecodeOperator,
    DisaggConfig,
    DisaggRouter,
    PrefillQueue,
    PrefillWorker,
)
from dynamo_tpu_torch.engine.config import EngineConfig
from dynamo_tpu_torch.engine.engine import TorchEngine
from dynamo_tpu_torch.llm.discovery import ModelManager, ModelWatcher, register_llm
from dynamo_tpu_torch.llm.http_service import HttpService
from dynamo_tpu_torch.llm.local_model import LocalModel
from dynamo_tpu_torch.runtime.distributed import DistributedRuntime


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--model-path", default="preset:tiny-test")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--dtype", default="bfloat16")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8080)
    ap.add_argument("--max-model-len", type=int, default=256)
    ap.add_argument("--num-blocks", type=int, default=128)
    ap.add_argument("--max-local-prefill-length", type=int, default=32)
    ap.add_argument("--transport", default="auto",
                    choices=["auto", "device", "tcp", "native"])
    ap.add_argument("--no-warmup", action="store_true")
    return ap


async def main(argv: list[str] | None = None) -> None:
    args = build_parser().parse_args(argv)
    drt = await DistributedRuntime.in_process()
    local = LocalModel.prepare(args.model_path, context_length=args.max_model_len)

    def engine() -> TorchEngine:
        return TorchEngine(
            EngineConfig(model=local.config, dtype=args.dtype,
                         num_blocks=args.num_blocks, max_num_seqs=8,
                         max_model_len=local.card.context_length),
            device=args.device,
        )

    decode, prefill = engine(), engine()
    for e in (decode, prefill):
        await e.start()
        if not args.no_warmup:
            await e.warmup()

    router = await DisaggRouter(drt, "demo").start()
    await router.publish_config(DisaggConfig(
        max_local_prefill_length=args.max_local_prefill_length,
        max_prefill_queue_size=16))
    queue = PrefillQueue(drt, "demo")
    operator = await DecodeOperator(decode, queue, router, transport=args.transport).start()
    worker = PrefillWorker(prefill, queue).start()

    ep = drt.namespace("demo").component("torch").endpoint("generate")
    await ep.serve(operator)
    await register_llm(drt, ep, local.card)
    manager = ModelManager()
    await ModelWatcher(drt, manager).start()
    service = HttpService(manager, host=args.host, port=args.port,
                          readiness=decode.readiness)
    await service.start()
    print(
        f"disagg serving {local.name!r} on http://{args.host}:{service.port} "
        f"(prompts > {args.max_local_prefill_length} tokens prefill remotely; "
        f"wire transport={operator.transport}, device channel="
        f"{operator.device_receiver is not None})",
        flush=True,
    )
    try:
        await asyncio.Event().wait()
    finally:
        await worker.stop()
        await operator.stop()
        await service.stop()
        await prefill.stop()
        await decode.stop()
        await drt.shutdown()


if __name__ == "__main__":
    asyncio.run(main())
