"""Multimodal deployment in one process: an encode worker, an engine and
the OpenAI frontend over the runtime plane (port of the JAX package's
examples/multimodal/serve.py).

    python -m dynamo_tpu_torch.examples.multimodal [--model-path preset:tiny-test]
        [--device cuda|cpu] [--dtype bfloat16] [--port 8080]

Then POST a chat request whose message carries an ``image_url`` content
part with a ``data:`` URL of a base64 ``.npy`` array ([H, W, 3]); the
JAX package's examples/multimodal/client.py sends one. The encode worker
(``VisionEncodeEngine``) turns the image into patch embeddings in the
model's hidden space; the frontend's ``MultimodalPreprocessor``, built
by the model watcher from the card (``model_type="multimodal"``,
``extra.encode_endpoint``), splices them into the prompt in place of
placeholder tokens, and the engine runs them through its ``unified_mm``
program. Both workers make random weights from their seeds.
"""

from __future__ import annotations

import argparse
import asyncio
from dataclasses import dataclass

from dynamo_tpu_torch.engine.config import EngineConfig
from dynamo_tpu_torch.engine.engine import TorchEngine
from dynamo_tpu_torch.llm.discovery import ModelManager, ModelWatcher, register_llm
from dynamo_tpu_torch.llm.http_service import HttpService
from dynamo_tpu_torch.llm.local_model import LocalModel
from dynamo_tpu_torch.llm.model_card import ModelDeploymentCard
from dynamo_tpu_torch.llm.multimodal import VisionEncodeEngine
from dynamo_tpu_torch.models.vision import VisionConfig
from dynamo_tpu_torch.runtime.distributed import DistributedRuntime

ENCODE_ENDPOINT = "mm.encoder.encode"
GENERATE_ENDPOINT = "mm.torch.generate"


@dataclass
class Deployment:
    drt: DistributedRuntime
    service: HttpService

    async def stop(self) -> None:
        await self.service.stop()
        await self.drt.shutdown()


async def deploy(engine, encoder: VisionEncodeEngine, card: ModelDeploymentCard,
                 host: str = "127.0.0.1", port: int = 0, engine_ops=(),
                 placeholder_token: int = 0) -> Deployment:
    """Serve ``encoder`` and the started ``engine`` on an in-process
    runtime, register ``card`` as a multimodal model pointing at the
    encoder, and start the OpenAI server over the model watcher's
    pipeline (``engine_ops`` linked before the router, a ``Tap`` for
    one). Build the engine and the encoder before: their device work
    must not hold the loop while a lease is live."""
    drt = await DistributedRuntime.in_process()
    enc_id, gen_id = (ep.split(".") for ep in (ENCODE_ENDPOINT, GENERATE_ENDPOINT))
    await drt.namespace(enc_id[0]).component(enc_id[1]).endpoint(enc_id[2]).serve(encoder)
    gen_ep = drt.namespace(gen_id[0]).component(gen_id[1]).endpoint(gen_id[2])
    await gen_ep.serve(engine)
    card.extra.update({"encode_endpoint": ENCODE_ENDPOINT,
                       "placeholder_token": placeholder_token})
    await register_llm(drt, gen_ep, card, model_type="multimodal")
    manager = ModelManager()
    await ModelWatcher(drt, manager, engine_ops=engine_ops).start()
    while not manager.models():
        await asyncio.sleep(0.02)
    readiness = getattr(engine, "readiness", None)
    service = HttpService(manager, host=host, port=port, readiness=readiness)
    await service.start()
    return Deployment(drt, service)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--model-path", default="preset:tiny-test")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--dtype", default="bfloat16")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8080)
    ap.add_argument("--max-model-len", type=int, default=512)
    ap.add_argument("--num-blocks", type=int, default=256)
    ap.add_argument("--no-warmup", action="store_true")
    return ap


async def main(argv: list[str] | None = None) -> None:
    args = build_parser().parse_args(argv)
    local = LocalModel.prepare(args.model_path, context_length=args.max_model_len)
    engine = TorchEngine(
        EngineConfig(model=local.config, dtype=args.dtype, num_blocks=args.num_blocks,
                     max_num_seqs=4, max_model_len=local.card.context_length,
                     multimodal=True),
        device=args.device,
    )
    await engine.start()
    if not args.no_warmup:
        await engine.warmup()
    vcfg = VisionConfig.tiny_test(out_dim=local.config.hidden_size)
    encoder = await asyncio.to_thread(VisionEncodeEngine, vcfg, device=args.device)
    dep = await deploy(engine, encoder, local.card, args.host, args.port)
    print(f"multimodal serving {local.name!r} on http://{args.host}:{dep.service.port}",
          flush=True)
    try:
        await asyncio.Event().wait()
    finally:
        await dep.stop()
        await engine.stop()


if __name__ == "__main__":
    asyncio.run(main())
