"""The port's worker mode and frontend over the runtime plane
(dynamo_tpu_torch/cli.py), on the CPU: the cases of tests/test_cli.py
(a worker process joins a frontend that hosts the control plane) and of
tests/test_chaos.py (the drain verb and SIGTERM end to end) on port
workers — TorchEngine workers on ``--device cpu`` with ``preset:
tiny-test``, echo workers, mocker workers — plus a request served through
a control plane and a worker in an interpreter where jax and msgpack
cannot be imported. Every spawned process has its own timeout and runs
with OMP_NUM_THREADS=1."""

import asyncio
import json
import os
import re
import signal
import socket
import subprocess
import sys
import time

import pytest

from dynamo_tpu_torch import cli
from dynamo_tpu_torch.engine.config import EngineConfig
from dynamo_tpu_torch.llm.http_client import fetch
from dynamo_tpu_torch.llm.protocols.common import (
    PreprocessedRequest,
    SamplingOptions,
    ShedError,
    StopConditions,
)
from dynamo_tpu_torch.mocker import MockerConfig, MockerEngine
from dynamo_tpu_torch.models.config import ModelConfig
from dynamo_tpu_torch.runtime.component import EndpointId
from dynamo_tpu_torch.runtime.distributed import DistributedRuntime
from dynamo_tpu_torch.runtime.drain import request_drain, watch_drain
from dynamo_tpu_torch.runtime.egress import PushRouter
from dynamo_tpu_torch.runtime.engine import Context
from dynamo_tpu_torch.runtime.runtime import Runtime
from dynamo_tpu_torch.runtime.transports.control_plane import ControlPlaneServer
from dynamo_tpu_torch.utils.task import spawn_tracked

pytestmark = pytest.mark.anyio

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = ["--out", "torch", "--device", "cpu", "--model-path", "preset:tiny-test",
        "--max-model-len", "64", "--num-blocks", "32", "--max-num-seqs", "4"]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class _Cli:
    """One ``python -m dynamo_tpu_torch`` process; stdout and stderr
    merged and kept."""

    def __init__(self, proc) -> None:
        self.proc = proc
        self.lines: list[str] = []

    @staticmethod
    async def spawn(*args: str, env: dict | None = None) -> "_Cli":
        full = dict(os.environ, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1", **(env or {}))
        proc = await asyncio.create_subprocess_exec(
            sys.executable, "-m", "dynamo_tpu_torch", *args,
            stdout=asyncio.subprocess.PIPE, stderr=asyncio.subprocess.STDOUT,
            env=full, cwd=REPO,
        )
        return _Cli(proc)

    async def expect(self, pattern: str, timeout: float = 60.0) -> re.Match:
        pat = re.compile(pattern)
        end = time.monotonic() + timeout
        while True:
            line = await asyncio.wait_for(
                self.proc.stdout.readline(), max(end - time.monotonic(), 0.01))
            if not line:
                raise AssertionError(f"process ended before {pattern!r}:\n"
                                     + "".join(self.lines))
            self.lines.append(line.decode())
            m = pat.search(self.lines[-1])
            if m:
                return m

    async def finish(self, timeout: float = 30.0) -> int:
        rest, _ = await asyncio.wait_for(self.proc.communicate(), timeout)
        self.lines.extend(rest.decode().splitlines(keepends=True))
        return self.proc.returncode

    async def kill(self) -> None:
        if self.proc.returncode is None:
            self.proc.kill()
            await self.proc.wait()

    @property
    def text(self) -> str:
        return "".join(self.lines)


def _wire(prompt, osl):
    return PreprocessedRequest(
        token_ids=list(prompt), sampling=SamplingOptions(temperature=0.0),
        stop=StopConditions(max_tokens=osl, ignore_eos=True),
    ).to_wire()


async def test_cli_worker_joins_frontend():
    """A frontend hosting the control plane and the HTTP service, then two
    worker processes joining it — a tiny-test TorchEngine on the CPU (its
    health port counting the requests it served) and an echo engine —
    served through the frontend; SIGTERM then drains the torch worker,
    which deregisters, reports and exits 0."""
    front = await _Cli.spawn(
        "run", "--in", "http", "--out", "dyn", "--spawn-control-plane", "0",
        "--http-host", "127.0.0.1", "--http-port", "0")
    workers = []
    try:
        addr = (await front.expect(r"control plane on ([0-9.]+:\d+)")).group(1)
        port = int((await front.expect(r"OpenAI server on http://127\.0\.0\.1:(\d+)")).group(1))
        health = _free_port()
        torch_w = await _Cli.spawn(
            "run", "--in", "dyn://dynamo.torch.generate", *TINY,
            "--control-plane", addr, "--health-port", str(health))
        echo_w = await _Cli.spawn(
            "run", "--in", "dyn://dynamo.echo.generate", "--out", "echo_core",
            "--control-plane", addr, "--model-name", "joined-echo")
        workers = [torch_w, echo_w]
        await torch_w.expect(r"warmup: \d+ programs")
        await torch_w.expect(r"model 'tiny-test' registered")
        await torch_w.expect(r"worker serving dyn://dynamo\.torch\.generate")
        await echo_w.expect(r"worker serving dyn://dynamo\.echo\.generate")
        end = time.monotonic() + 30
        while True:
            models = (await fetch("127.0.0.1", port, "GET", "/v1/models")).json()
            if sorted(m["id"] for m in models["data"]) == ["joined-echo", "tiny-test"]:
                break
            assert time.monotonic() < end, "workers never discovered"
            await asyncio.sleep(0.2)
        r = await fetch("127.0.0.1", port, "POST", "/v1/chat/completions", {
            "model": "joined-echo", "messages": [{"role": "user", "content": "ping pong"}]})
        assert r.status == 200 and "ping pong" in r.json()["choices"][0]["message"]["content"]
        r = await fetch("127.0.0.1", port, "POST", "/v1/completions", {
            "model": "tiny-test", "prompt": [1, 2, 3], "max_tokens": 5,
            "nvext": {"ignore_eos": True}})
        assert r.status == 200, r.body
        assert r.json()["usage"]["completion_tokens"] == 5
        assert r.json()["choices"][0]["finish_reason"] == "length"
        metrics = (await fetch("127.0.0.1", health, "GET", "/metrics")).body.decode()
        assert "dyntpu_worker_ingress_requests_total 1.0" in metrics
        assert "dyntpu_worker_engine_ready 1.0" in metrics

        torch_w.proc.send_signal(signal.SIGTERM)
        assert await torch_w.finish(60) == 0, torch_w.text
        assert "draining" in torch_w.text and "drain complete" in torch_w.text
        report = json.loads(re.search(r"worker report (\{.*\})", torch_w.text).group(1))
        assert report["requests"] == 1 and report["unified_dispatches"] > 0
        assert report["device"] == "cpu"
        end = time.monotonic() + 15
        while "tiny-test" in [m["id"] for m in (await fetch(
                "127.0.0.1", port, "GET", "/v1/models")).json()["data"]]:
            assert time.monotonic() < end, "drained worker's model never left"
            await asyncio.sleep(0.2)
    finally:
        front.proc.send_signal(signal.SIGTERM)
        for w in workers:
            if w.proc.returncode is None:
                w.proc.send_signal(signal.SIGTERM)
        for p in [*workers, front]:
            try:
                await p.finish(30)
            finally:
                await p.kill()


async def test_kv_router_frontend_sticks_a_repeated_prompt_to_one_worker():
    """A frontend hosting the control plane with ``--router-mode kv`` and
    two tiny-test workers on the CPU: a prompt sent three times lands on
    one worker every time (its KV events reached the frontend's radix
    index), the frontend's /debug/routes records the predicted overlap
    (0, then both full blocks) and the workers' request counts agree."""
    front = await _Cli.spawn(
        "run", "--in", "http", "--out", "dyn", "--spawn-control-plane", "0",
        "--router-mode", "kv", "--http-host", "127.0.0.1", "--http-port", "0")
    workers = []
    try:
        addr = (await front.expect(r"control plane on ([0-9.]+:\d+)")).group(1)
        port = int((await front.expect(r"OpenAI server on http://127\.0\.0\.1:(\d+)")).group(1))
        health = [_free_port(), _free_port()]
        for h in health:
            workers.append(await _Cli.spawn(
                "run", "--in", "dyn://dynamo.torch.generate", *TINY, "--no-warmup",
                "--control-plane", addr, "--health-port", str(h)))
        for w in workers:
            await w.expect(r"worker serving dyn://dynamo\.torch\.generate", 120)
        end = time.monotonic() + 30
        while "tiny-test" not in [m["id"] for m in (await fetch(
                "127.0.0.1", port, "GET", "/v1/models")).json()["data"]]:
            assert time.monotonic() < end, "workers never discovered"
            await asyncio.sleep(0.2)
        prompt = list(range(1, 41))  # 2 full 16-token blocks + a tail
        for _ in range(3):
            r = await fetch("127.0.0.1", port, "POST", "/v1/completions", {
                "model": "tiny-test", "prompt": prompt, "max_tokens": 4,
                "nvext": {"ignore_eos": True}})
            assert r.status == 200, r.body
            await asyncio.sleep(0.5)  # the worker's KV events reach the index
        routes = (await fetch("127.0.0.1", port, "GET", "/debug/routes?n=3")).json()
        recs = routes["recent"]
        assert len(recs) == 3 and len({rec["worker_id"] for rec in recs}) == 1
        assert [rec["overlap_blocks"] for rec in recs] == [0, 2, 2]
        assert routes["gauges"]["kv_router_metrics_stale"] == 0
        counts = []
        for h in health:
            text = (await fetch("127.0.0.1", h, "GET", "/metrics")).body.decode()
            m = re.search(r"^dyntpu_worker_ingress_requests_total (\S+)$", text, re.M)
            counts.append(float(m.group(1)))
        assert sorted(counts) == [0.0, 3.0]
    finally:
        for p in [*workers, front]:
            p.proc.send_signal(signal.SIGTERM)
        for p in [*workers, front]:
            try:
                await p.finish(30)
            finally:
                await p.kill()


async def test_drain_verb_end_to_end():
    """The control-plane drain verb on a port mocker worker with a
    request in flight: the stream completes, readiness flips, new work is
    refused with ShedError, the instance key is deleted."""
    front = await DistributedRuntime.in_process()
    worker = await DistributedRuntime.in_process(
        runtime=Runtime(), store=front.store, bus=front.bus)
    engine = MockerEngine(
        EngineConfig(model=ModelConfig.tiny_test(), num_blocks=64, max_num_seqs=4,
                     max_model_len=256, dtype="float32"),
        MockerConfig(decode_time_per_step_us=15000.0))
    await engine.start()
    try:
        ep = worker.namespace("chaos").component("drain").endpoint("gen")
        served = await ep.serve(engine)
        drained = asyncio.Event()

        def on_drain():
            async def run():
                assert await cli._graceful_drain(engine, served, 30.0)
                drained.set()

            spawn_tracked(run(), name="test-drain")

        await watch_drain(worker, "chaos", "drain", on_drain)
        router = await PushRouter.create(front, ep.id)
        assert len(await router.client.wait_for_instances()) == 1
        got = []

        async def consume():
            async for item in router.generate(Context(_wire(range(16), 24))):
                got.extend(item["token_ids"])

        stream = asyncio.ensure_future(consume())
        await asyncio.sleep(0.3)
        assert got and len(got) < 24
        await request_drain(front, "chaos", "drain")
        await asyncio.wait_for(drained.wait(), 30)
        await asyncio.wait_for(stream, 10)
        assert len(got) == 24
        assert engine.readiness()["state"] == "draining"
        with pytest.raises(ShedError):
            async for _ in engine.generate(Context(_wire(range(4), 2))):
                pass
        end = time.monotonic() + 3
        while router.client.instances() and time.monotonic() < end:
            await asyncio.sleep(0.02)
        assert router.client.instances() == []
    finally:
        await engine.stop()
        await worker.shutdown()
        await front.shutdown()


@pytest.mark.parametrize("how", ["drain_verb", "sigterm"])
async def test_worker_process_drains_end_to_end(how):
    """Two port worker processes (echo engines streaming one token per
    50 ms); the one serving an in-flight request is drained by the
    control-plane verb or by SIGTERM: the stream completes, its instance
    key is deleted, it prints ``drain complete`` and exits 0, and the
    sibling serves the next request."""
    server = await ControlPlaneServer().start()
    procs, leases = [], {}
    drt = None
    try:
        for _ in range(2):
            procs.append(await _Cli.spawn(
                "run", "--in", "dyn://chaos.drainw.generate", "--out", "echo_core",
                "--control-plane", server.address,
                env={"DYNTPU_TOKEN_ECHO_DELAY_MS": "50"}))
        for p in procs:
            lease = int((await p.expect(r"\(lease (0x[0-9a-f]+)\)")).group(1), 16)
            leases[lease] = p
            await p.expect(r"worker serving dyn://chaos\.drainw\.generate")
        drt = await DistributedRuntime.connect(server.address)
        router = await PushRouter.create(drt, EndpointId("chaos", "drainw", "generate"))
        end = time.monotonic() + 10
        while len(router.client.instances()) < 2:
            assert time.monotonic() < end
            await asyncio.sleep(0.05)
        ctx = Context(_wire(range(24), 24))
        got = []

        async def consume():
            async for item in router.generate(ctx):
                got.extend(item["token_ids"])

        stream = asyncio.ensure_future(consume())
        while not got:
            await asyncio.sleep(0.02)
        lease = ctx.annotations["worker_id"]
        victim = leases[lease]
        survivor = next(p for p in procs if p is not victim)
        if how == "drain_verb":
            await request_drain(drt, "chaos", "drainw", lease_id=lease)
        else:
            victim.proc.send_signal(signal.SIGTERM)
        await asyncio.wait_for(stream, 30)
        assert got == list(range(24)), got
        end = time.monotonic() + 10
        while f"{lease:x}" in "".join(await drt.store.get_prefix("instances/chaos/")):
            assert time.monotonic() < end, "drained instance never deregistered"
            await asyncio.sleep(0.05)
        assert await victim.finish(30) == 0, victim.text
        assert "draining" in victim.text and "drain complete" in victim.text
        ctx2 = Context(_wire(range(3), 3))
        assert [t async for i in router.generate(ctx2) for t in i["token_ids"]] == [0, 1, 2]
        assert leases[ctx2.annotations["worker_id"]] is survivor
        assert survivor.proc.returncode is None
    finally:
        if drt is not None:
            await drt.shutdown()
        for p in procs:
            if p.proc.returncode is None:
                p.proc.send_signal(signal.SIGTERM)
            try:
                await p.finish(30)
            finally:
                await p.kill()
        await server.stop()


BLOCKED_FLEET = r'''
import asyncio, contextlib, importlib.abc, sys

BLOCKED = ("jax", "jaxlib", "dynamo_tpu", "msgpack", "aiohttp", "pydantic",
           "httpx", "jinja2", "tokenizers", "transformers", "uvicorn")
for name in list(sys.modules):
    if name.split(".")[0] in BLOCKED:
        del sys.modules[name]


class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"blocked import of {name}")
        return None


sys.meta_path.insert(0, Block())
from dynamo_tpu_torch import cli
from dynamo_tpu_torch.llm.http_client import fetch
from dynamo_tpu_torch.runtime.transports.control_plane import ControlPlaneServer

COMMON = ["--device", "cpu", "--model-path", "preset:tiny-test",
          "--max-model-len", "64", "--num-blocks", "32", "--max-num-seqs", "4"]


async def main():
    plane = await ControlPlaneServer().start()
    async with contextlib.AsyncExitStack() as stack:
        wargs = cli.build_parser().parse_args(
            ["run", "--in", "dyn://dynamo.torch.generate", "--out", "torch",
             "--control-plane", plane.address, *COMMON])
        cli.refuse_unserved(wargs)
        drt = await cli.start_runtime(wargs, stack)
        await cli.start_worker(wargs, drt, stack)
        fargs = cli.build_parser().parse_args(
            ["run", "--in", "http", "--out", "dyn", "--control-plane", plane.address,
             "--http-host", "127.0.0.1", "--http-port", "0"])
        cli.refuse_unserved(fargs)
        service, _ = await cli.start_http(fargs, stack)
        resp = await fetch("127.0.0.1", service.port, "POST", "/v1/completions",
                           {"model": "tiny-test", "prompt": [1, 2, 3], "max_tokens": 4,
                            "nvext": {"ignore_eos": True}})
    await plane.stop()
    assert resp.status == 200, resp.body
    return resp.json()["usage"]["completion_tokens"]


assert asyncio.run(main()) == 4
leaked = [m for m in sys.modules if m.split(".")[0] in BLOCKED]
assert not leaked, leaked
print("SERVED THROUGH THE PLANE")
'''


def test_port_serves_through_a_control_plane_with_jax_and_msgpack_blocked():
    """A fresh interpreter where jax, the JAX package and msgpack cannot be
    imported: a control plane, a tiny-test worker served and registered
    through the CLI's own steps, and a frontend (``--out dyn``) that
    discovers it and answers a completion."""
    proc = subprocess.run(
        [sys.executable, "-c", BLOCKED_FLEET], cwd=REPO, capture_output=True,
        text=True, timeout=240, env=dict(os.environ, OMP_NUM_THREADS="1"),
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "SERVED THROUGH THE PLANE" in proc.stdout


def test_worker_that_cannot_reach_its_device_exits_without_registering():
    """``--out torch`` without ``--device cpu`` on a machine with no card:
    the worker exits non-zero before it serves or registers."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        addr = f"127.0.0.1:{s.getsockname()[1]}"

    async def main():
        server = await ControlPlaneServer(port=int(addr.split(":")[1])).start()
        try:
            worker = await _Cli.spawn(
                "run", "--in", "dyn://dynamo.torch.generate", "--out", "torch",
                "--model-path", "preset:tiny-test", "--control-plane", server.address)
            rc = await worker.finish(120)
            store = await DistributedRuntime.connect(server.address)
            keys = await store.store.get_prefix("")
            await store.shutdown()
            return rc, worker.text, keys
        finally:
            await server.stop()

    rc, text, keys = asyncio.run(main())
    assert rc != 0 and "device='cpu'" in text
    assert "worker serving" not in text and "registered" not in text
    assert not [k for k in keys if k.startswith(("instances/", "models/"))]
