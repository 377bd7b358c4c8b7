"""What the OpenAI front costs per request: the same traffic through the
engine alone, through the serving pipeline, and through the HTTP server
with the client in the server's process and in a process of its own.

    python3 dynamo_tpu_torch/tools/http_overhead.py [--rounds N]

Run from the root of a checkout; needs one CUDA device. Builds the
server as ``chip_smoke.py``'s ``http`` phase does (the CLI's
``start_http`` with ``chip_smoke.HTTP_ARGS``: llama3.2-1b in bf16 at the
full-width engine settings, random weights from seed 0), then sends
``chip_smoke.py``'s 8 serve prompts (token ids, 32 greedy tokens each,
all at once) in one warm-up round and N timed rounds, the four modes in
turn within each round (the first mode rotating), on the one warm
engine:

- ``engine``: ``TorchEngine.generate`` with a hand-built request;
- ``pipeline``: the serving pipeline (preprocessor → detokenizer →
  engine) in process, each chunk encoded as an SSE event;
- ``http_same_process``: streaming ``/v1/completions`` with the client
  on the server's event loop (as in ``chip_smoke.py``);
- ``http_client_process``: the same requests from a client process.

Times are host clocks at the consumer: TTFT from submission to the
first token, ITL between tokens, wall over the round. Prints one JSON
line per round and mode, the card's name and power limit, and a summary
line: medians per mode, and wall ms per request over ``engine``.
"""

from __future__ import annotations

import argparse
import asyncio
import contextlib
import json
import statistics
import sys
import time

import numpy as np

MODES = ("engine", "pipeline", "http_same_process", "http_client_process")
MAX_TOKENS = 32
MODEL = "llama3.2-1b"      # the model chip_smoke.HTTP_ARGS serves


def serve_prompts() -> list[list[int]]:
    """chip_smoke.py's serve prompts (seed 1, 64–512 tokens)."""
    from dynamo_tpu_torch.models.config import ModelConfig

    rng = np.random.default_rng(1)
    lens = rng.integers(64, 513, 8)
    vocab = ModelConfig.llama32_1b().vocab_size
    return [rng.integers(0, vocab, n).tolist() for n in lens]


def summary(times: list[list[float]], wall: float) -> dict:
    ttft = [t[0] for t in times]
    itl = [b - a for t in times for a, b in zip(t, t[1:])]
    return {
        "wall_s": wall, "tokens_per_s": sum(map(len, times)) / wall,
        "ttft_p50_ms": float(np.median(ttft)) * 1e3,
        "itl_p50_ms": float(np.percentile(itl, 50)) * 1e3,
        "itl_p95_ms": float(np.percentile(itl, 95)) * 1e3,
    }


async def timed_round(one, prompts) -> dict:
    """``one(prompt, t0)`` → the arrival times of a request's tokens."""
    t0 = time.perf_counter()
    times = await asyncio.gather(*[one(p, t0) for p in prompts])
    return summary(times, time.perf_counter() - t0)


async def client_round(port: int, prompts) -> dict:
    import chip_smoke as cs

    async def one(p, t0):
        body = {"model": MODEL, "prompt": p, "stream": True,
                "temperature": 0, "max_tokens": MAX_TOKENS,
                "nvext": {"ignore_eos": True}}
        sent = time.perf_counter() - t0
        resp, timed = await cs.http_stream(port, "/v1/completions", body)
        if resp.status != 200:
            raise SystemExit(f"HTTP {resp.status}: {resp.body[:300]!r}")
        return [sent + t for t in cs.stream_summary(timed)["times"]]

    return await timed_round(one, prompts)


async def engine_round(engine, prompts) -> dict:
    from dynamo_tpu_torch.llm.protocols.common import (
        PreprocessedRequest,
        SamplingOptions,
        StopConditions,
    )
    from dynamo_tpu_torch.runtime.engine import Context

    async def one(p, t0):
        pre = PreprocessedRequest(
            token_ids=p, sampling=SamplingOptions(temperature=0.0),
            stop=StopConditions(max_tokens=MAX_TOKENS, ignore_eos=True))
        return [time.perf_counter() - t0
                async for raw in engine.generate(Context(pre.to_wire()))
                if raw["token_ids"]]

    return await timed_round(one, prompts)


async def pipeline_round(pipeline, prompts) -> dict:
    from dynamo_tpu_torch.llm.protocols.openai import CompletionRequest
    from dynamo_tpu_torch.llm.protocols.sse import SseEvent
    from dynamo_tpu_torch.runtime.engine import Context

    async def one(p, t0):
        req = CompletionRequest.model_validate({
            "model": MODEL, "prompt": p, "stream": True, "temperature": 0,
            "max_tokens": MAX_TOKENS, "nvext": {"ignore_eos": True}})
        times = []
        async for chunk in pipeline.generate(Context(req)):
            SseEvent.data_json(chunk).encode()
            if chunk["choices"]:
                times.append(time.perf_counter() - t0)
        return times

    return await timed_round(one, prompts)


async def client_process_round(port: int) -> dict:
    proc = await asyncio.create_subprocess_exec(
        sys.executable, __file__, "--client", str(port),
        stdout=asyncio.subprocess.PIPE)
    out, _ = await proc.communicate()
    if proc.returncode != 0:
        raise SystemExit(f"client process exited {proc.returncode}")
    return json.loads(out.decode().splitlines()[-1])


async def main(rounds: int) -> dict:
    import chip_smoke as cs
    from dynamo_tpu_torch import cli

    args = cli.build_parser().parse_args(
        cs.HTTP_ARGS + ["--http-host", "127.0.0.1", "--http-port", "0"])
    cli.refuse_unserved(args)
    prompts = serve_prompts()
    results: dict[str, list[dict]] = {m: [] for m in MODES}
    async with contextlib.AsyncExitStack() as stack:
        service, engine = await cli.start_http(args, stack)
        pipeline = service.manager.get(MODEL)
        runs = {
            "engine": lambda: engine_round(engine, prompts),
            "pipeline": lambda: pipeline_round(pipeline, prompts),
            "http_same_process": lambda: client_round(service.port, prompts),
            "http_client_process": lambda: client_process_round(service.port),
        }
        for r in range(rounds + 1):
            for mode in MODES[r % 4:] + MODES[:r % 4]:
                res = await runs[mode]()
                if r:   # round 0 warms every path
                    results[mode].append(res)
                    print(json.dumps({"round": r, "mode": mode, **res}), flush=True)
    return {mode: {k: statistics.median(x[k] for x in rs) for k in rs[0]}
            for mode, rs in results.items()}


if __name__ == "__main__":
    sys.path.insert(0, ".")
    if len(sys.argv) > 1 and sys.argv[1] == "--client":
        print(json.dumps(asyncio.run(client_round(int(sys.argv[2]), serve_prompts()))))
        sys.exit(0)
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=5)
    medians = asyncio.run(main(ap.parse_args().rounds))
    import chip_smoke as cs

    print(cs.card_line(), flush=True)
    base = medians["engine"]["wall_s"]
    print(json.dumps({
        "medians": medians,
        "wall_ms_per_request_over_engine": {
            m: (v["wall_s"] - base) * 1e3 / 8 for m, v in medians.items()},
    }), flush=True)
