"""The port's disaggregated prefill/decode (dynamo_tpu_torch/disagg) on the
CPU: the cases of tests/test_disagg.py and the disagg cases of
tests/test_multiprocess.py on port engines (heterogeneous-TP pairs wait
for the port's parallel slice) — a decode engine admits, a prefill
engine computes, the KV streams over the device channel, the C++ agent
or TCP into the decode engine's blocks, and the greedy continuation is
the local run's token for token, which is the JAX engine's too.
Tiny-test in float32, weights carried across with ``params_from_jax``
(the prefill worker processes make theirs from the engine seed, as the
decode engine in those cases does). The wire: the port's frames decode
with ``msgpack`` to what the JAX package's frames decode to, byte for
byte."""

import asyncio
import os
import pathlib
import re
import socket
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import msgpack
import numpy as np
import pytest

from dynamo_tpu.disagg import queue as j_queue
from dynamo_tpu.disagg import transfer as j_transfer
from dynamo_tpu.engine.config import EngineConfig as JEngineConfig
from dynamo_tpu.engine.engine import TpuEngine
from dynamo_tpu.llm.protocols import common as j_proto
from dynamo_tpu.models import llama as j_llama
from dynamo_tpu.models.config import ModelConfig as JCfg
from dynamo_tpu.runtime.engine import Context as JContext
from dynamo_tpu_torch.block_manager.integrity import INTEGRITY
from dynamo_tpu_torch.disagg import (
    DecodeOperator,
    DisaggConfig,
    DisaggRouter,
    PrefillQueue,
    PrefillWorker,
)
from dynamo_tpu_torch.disagg import queue as t_queue
from dynamo_tpu_torch.disagg import transfer as t_transfer
from dynamo_tpu_torch.engine.config import EngineConfig
from dynamo_tpu_torch.engine.engine import TorchEngine
from dynamo_tpu_torch.llm.http_client import fetch
from dynamo_tpu_torch.llm.protocols.common import (
    PreprocessedRequest,
    SamplingOptions,
    StopConditions,
)
from dynamo_tpu_torch.models import llama as t_llama
from dynamo_tpu_torch.models.config import ModelConfig
from dynamo_tpu_torch.runtime.distributed import DistributedRuntime
from dynamo_tpu_torch.runtime.engine import Context
from dynamo_tpu_torch.runtime.transports import wire
from dynamo_tpu_torch.runtime.transports.codec import encode_frame, read_frame
from dynamo_tpu_torch.runtime.transports.control_plane import ControlPlaneServer
from dynamo_tpu_torch.utils.faults import FAULTS

pytestmark = pytest.mark.anyio

REPO = pathlib.Path(__file__).resolve().parents[1]
JAX_CFG = JCfg.tiny_test()
PARAMS = j_llama.init_params(jax.random.PRNGKey(0), JAX_CFG, dtype=jnp.float32)
TPARAMS = t_llama.params_from_jax(jax.tree.map(np.asarray, PARAMS), device="cpu")
PROMPT = list(range(40))  # 3 blocks (2 full + partial)
WORKER_ARGS = ["--model-path", "preset:tiny-test", "--dtype", "float32", "--device", "cpu",
               "--num-blocks", "32", "--max-num-seqs", "2", "--max-model-len", "128"]


def _ecfg(**kw):
    return EngineConfig(model=ModelConfig.tiny_test(), num_blocks=32, max_num_seqs=2,
                        max_model_len=128, dtype="float32", **kw)


def _engine(params=TPARAMS, **kw) -> TorchEngine:
    return TorchEngine(_ecfg(**kw), params=params, device="cpu")


def _req(prompt, max_tokens=6):
    return PreprocessedRequest(
        token_ids=prompt, sampling=SamplingOptions(temperature=0.0),
        stop=StopConditions(max_tokens=max_tokens, ignore_eos=True),
    )


async def _generate(engine, prompt, max_tokens=6):
    toks = []
    async for item in engine.generate(Context(_req(prompt, max_tokens).to_wire())):
        toks += item["token_ids"]
    return toks


async def _local(prompt, params=TPARAMS, max_tokens=6, **kw):
    eng = _engine(params, **kw)
    await eng.start()
    try:
        return await _generate(eng, prompt, max_tokens)
    finally:
        await eng.stop()


async def _jax_local(prompt, max_tokens=6):
    eng = TpuEngine(JEngineConfig(model=JAX_CFG, num_blocks=32, max_num_seqs=2,
                                  max_model_len=128, dtype="float32"), params=PARAMS)
    await eng.start()
    req = j_proto.PreprocessedRequest(
        token_ids=prompt, sampling=j_proto.SamplingOptions(temperature=0.0),
        stop=j_proto.StopConditions(max_tokens=max_tokens, ignore_eos=True))
    toks = []
    async for item in eng.generate(JContext(req.to_wire())):
        toks += item["token_ids"]
    await eng.stop()
    return toks


def _router(max_local=16, queue=8):
    dis = DisaggRouter.__new__(DisaggRouter)
    dis.cfg = DisaggConfig(max_local_prefill_length=max_local, max_prefill_queue_size=queue)
    return dis


class _Pair:
    """A decode engine, a prefill engine and the queue between them, in
    this process."""

    async def start(self, transport, params=TPARAMS, staging_slots=64, **kw):
        self.drt = await DistributedRuntime.in_process()
        self.queue = PrefillQueue(self.drt, "test")
        self.decode = _engine(params, **kw)
        self.prefill = _engine(params, **kw)
        await self.decode.start()
        await self.prefill.start()
        self.op = await DecodeOperator(self.decode, self.queue, _router(),
                                       transport=transport,
                                       staging_slots=staging_slots).start()
        self.pw = PrefillWorker(self.prefill, self.queue).start()
        return self

    async def stop(self):
        await self.pw.stop()
        await self.op.stop()
        await self.decode.stop()
        await self.prefill.stop()
        await self.drt.shutdown()


def test_disagg_decision():
    r = _router(100, 4)
    assert r.prefill_remote(500, 0.0, 0)
    assert not r.prefill_remote(50, 0.0, 0)          # short prompt
    assert not r.prefill_remote(500, 0.9, 0)         # high prefix hit rate
    assert not r.prefill_remote(500, 0.0, 10)        # queue backed up


async def test_disagg_config_watch():
    drt = await DistributedRuntime.in_process()
    router = await DisaggRouter(drt, "ns").start()
    assert router.cfg.max_local_prefill_length == 512
    await router.publish_config(DisaggConfig(max_local_prefill_length=64))
    router2 = await DisaggRouter(drt, "ns").start()
    assert router2.cfg.max_local_prefill_length == 64
    await router.publish_config(DisaggConfig(max_local_prefill_length=32))
    await asyncio.sleep(0.05)
    assert router2.cfg.max_local_prefill_length == 32
    await drt.shutdown()


@pytest.mark.parametrize("transport", ["tcp", "native", "device"])
async def test_remote_prefill_roundtrip_matches_local(transport):
    """The remote-prefilled stream is the local one token for token (and
    the JAX engine's); the pinned transport carried every block."""
    expected = await _local(PROMPT)
    assert expected == await _jax_local(PROMPT)
    pair = await _Pair().start(transport)
    op = pair.op
    try:
        if transport == "device":
            assert op.device_receiver is not None
        else:
            assert op.transport == transport
            assert op.device_receiver is None  # pinned wire path
        toks = await _generate(op, PROMPT)
        assert toks == expected
        assert op.remote_count == 1 and op.local_count == 0
        assert pair.pw.served == 1
        carried = op.device_receiver if transport == "device" else op.receiver
        assert carried.blocks_received == 3
        if transport == "device":
            assert op.receiver.blocks_received == 0
        # The prefill engine's waves ran the step programs; the decode
        # engine took no prefill dispatch for the remote request.
        assert pair.prefill.unified_prefill_tokens == len(PROMPT)
        assert pair.decode.unified_prefill_tokens == 0

        short = await _generate(op, list(range(8)))  # short prompt stays local
        assert op.local_count == 1 and len(short) == 6
    finally:
        await pair.stop()


async def test_int8_pair_ships_packed_rows_over_tcp():
    """An int8-KV pair over tcp: the frames are packed rows (int8 data +
    scale sidecar) and the stream equals the local int8 engine's."""
    expected = await _local(PROMPT, kv_quant="int8")
    pair = await _Pair().start("tcp", kv_quant="int8")
    try:
        assert await _generate(pair.op, PROMPT) == expected
        assert pair.op.receiver.blocks_received == 3
        lay = pair.decode.runner._quant_layout()
        assert pair.op.receiver.bytes_received == 3 * lay.block_bytes
    finally:
        await pair.stop()


async def test_staging_pressure_degrades_to_tcp_not_local():
    """A transfer the native staging arena cannot fund stays REMOTE over
    the staging-free tcp wire, not silently local."""
    expected = await _local(PROMPT)
    pair = await _Pair().start("auto", staging_slots=2)  # 3 blocks > 2 slots
    op = pair.op
    try:
        await op.device_receiver.stop()  # force the wire path
        op.device_receiver = None
        assert op.transport == "native" and op.tcp_receiver is not None
        assert await _generate(op, PROMPT) == expected
        assert op.remote_count == 1 and op.local_count == 0
        assert pair.pw.served == 1
        assert op.tcp_receiver.blocks_received == 3 and op.receiver.blocks_received == 0
    finally:
        await pair.stop()


async def test_lost_frame_degrades_to_local_recompute():
    """A block frame dropped on the wire leaves a hole in the completeness
    ledger: the decode engine recomputes locally instead of decoding over
    stale KV — the stream is still the local one, and the request counts
    as degraded."""
    expected = await _local(PROMPT)
    pair = await _Pair().start("tcp")
    try:
        FAULTS.arm("disagg.recv", "drop", times=1)
        assert await _generate(pair.op, PROMPT) == expected
        assert pair.decode.readiness()["degraded_requests_total"] == 1
    finally:
        FAULTS.clear()
        await pair.stop()


async def test_corrupt_frame_is_dropped_and_recomputed():
    """A frame corrupted after its CRC was stamped is refused at the
    receiver (integrity ledger: one ``frame`` failure) and the request
    recomputes locally, byte-identical."""
    expected = await _local(PROMPT)
    INTEGRITY.reset()
    pair = await _Pair().start("tcp")
    try:
        FAULTS.arm("kvbm.corrupt_frame", "flip", times=1)
        assert await _generate(pair.op, PROMPT) == expected
        assert INTEGRITY.snapshot()["integrity_failures_frame"] == 1
        assert pair.decode.degraded_requests == 1
    finally:
        FAULTS.clear()
        INTEGRITY.reset()
        await pair.stop()


async def test_explicit_native_transport_raises_when_the_agent_cannot_build(monkeypatch):
    """``transport="native"`` whose agent fails to build raises; ``auto``
    resolves to tcp, as the reference documents."""
    from dynamo_tpu_torch.native import transfer as nt

    monkeypatch.setattr(nt, "_lib", lambda: None)
    drt = await DistributedRuntime.in_process()
    eng = _engine()
    try:
        with pytest.raises(RuntimeError, match="native transfer agent unavailable"):
            await DecodeOperator(eng, PrefillQueue(drt, "t"), _router(),
                                 transport="native").start()
        op = await DecodeOperator(eng, PrefillQueue(drt, "t"), _router(),
                                  transport="auto").start()
        assert op.transport == "tcp" and op.device_receiver is not None
        await op.stop()
    finally:
        await drt.shutdown()


async def test_tcp_receiver_rejects_unauthenticated_peer():
    landed = []
    recv = await t_transfer.KvReceiver(
        on_block=lambda r, i, d: landed.append((r, i)),
        on_finish=lambda r, t: landed.append(("finish", r)),
    ).start()
    block = np.ones((2, 4), np.float32)
    bad = t_transfer.KvSender()
    with pytest.raises((ConnectionError, asyncio.IncompleteReadError, OSError)):
        await bad.send_blocks(recv.address, "r1", [block], 7, auth="00" * 16)
    await bad.close()
    assert landed == []
    good = t_transfer.KvSender()
    await good.send_blocks(recv.address, "r1", [block], 7, auth=recv.auth)
    await good.close()
    assert ("finish", "r1") in landed
    await recv.stop()


async def test_native_receiver_rejects_unauthenticated_peer():
    from dynamo_tpu_torch.native import transfer as nt

    assert nt.available(), "g++ builds the agent on the CPU too"
    server = nt.TransferServer()
    arena = np.zeros(64, np.uint8)
    server.register(7, arena)
    bad = nt.TransferClient("127.0.0.1", server.port, b"\x00" * 16)
    try:
        bad.write(7, 0, np.full(8, 0xAB, np.uint8))
        bad.notify(1, b"x")
    except ConnectionError:
        pass
    bad.close()
    await asyncio.sleep(0.05)
    assert server.poll() is None
    assert not arena.any()
    good = nt.TransferClient("127.0.0.1", server.port, server.token)
    good.write(7, 0, np.full(8, 0xCD, np.uint8))
    good.notify(2, b"ok")
    for _ in range(100):
        ev = server.poll()
        if ev is not None:
            break
        await asyncio.sleep(0.01)
    assert ev == (2, b"ok")
    assert (arena[:8] == 0xCD).all()
    good.close()
    server.close()


async def test_queue_age_sla_signal():
    from dynamo_tpu_torch.runtime.transports.bus import InProcQueue

    q = InProcQueue()
    assert await q.oldest_age_s() == 0.0
    await q.enqueue(b"stuck")
    await asyncio.sleep(0.15)
    age = await q.oldest_age_s()
    assert age >= 0.15
    item_id, _ = await q.dequeue_leased(lease_s=30.0)
    assert await q.depth() == 0
    assert await q.oldest_age_s() >= age
    await q.nack(item_id)
    assert await q.oldest_age_s() >= age
    assert (await q.stats())[0] == 1
    router = DisaggRouter.__new__(DisaggRouter)
    router.cfg = DisaggConfig(max_local_prefill_length=10, max_prefill_queue_size=16,
                              max_prefill_queue_age_s=0.5)
    assert router.prefill_remote(1000, 0.0, queue_size=1, queue_age_s=0.1)
    assert not router.prefill_remote(1000, 0.0, queue_size=1, queue_age_s=0.9)


# ---------------------------------------------------------------------------
# the wire, against msgpack and the JAX package's frames
# ---------------------------------------------------------------------------


class _Writer:
    def __init__(self) -> None:
        self.buf = bytearray()

    def write(self, b: bytes) -> None:
        self.buf += b

    async def drain(self) -> None:
        pass

    def close(self) -> None:
        pass


def _acked_reader(pack) -> asyncio.StreamReader:
    r = asyncio.StreamReader()
    r.feed_data(encode_frame(pack({"ok": True})))
    return r


async def _frames(raw: bytes) -> list[tuple[dict, bytes]]:
    r = asyncio.StreamReader()
    r.feed_data(bytes(raw))
    r.feed_eof()
    out = []
    while True:
        try:
            h, p = await read_frame(r)
        except asyncio.IncompleteReadError:
            return out
        out.append((msgpack.unpackb(h), p))


@pytest.mark.parametrize("kind", ["float32", "bfloat16"])
async def test_tcp_frames_equal_the_jax_packages(kind):
    """The port's KV frames (headers packed by the standard-library codec)
    are the JAX package's (packed by msgpack) byte for byte: a bfloat16
    block goes out as its uint16 bits in both (the JAX sender views its
    ml_dtypes array so; the port holds the bits already)."""
    import ml_dtypes

    rng = np.random.default_rng(3)
    vals = rng.standard_normal((2, 2, 4, 2, 8)).astype(np.float32)
    if kind == "float32":
        mine = theirs = [vals[0], vals[1]]
    else:
        theirs = [v.astype(ml_dtypes.bfloat16) for v in vals]
        mine = [t.view(np.uint16) for t in theirs]
    out = {}
    for name, mod, blocks, pack in (("port", t_transfer, mine, wire.packb),
                                    ("jax", j_transfer, theirs, msgpack.packb)):
        sender = mod.KvSender()
        w = _Writer()
        sender._conns["x:1"] = (_acked_reader(pack), w)
        await sender._send_locked("x:1", "req-1", blocks, 11, start_idx=1,
                                  auth="ab" * 16, trace_id="t" * 32)
        out[name] = bytes(w.buf)
    assert out["port"] == out["jax"]
    frames = await _frames(out["port"])
    assert [h["kind"] for h, _ in frames] == ["block", "block", "finish"]
    assert frames[0][0]["dtype"] == ("<f4" if kind == "float32" else "<u2")
    assert frames[1][0]["idx"] == 2 and frames[2][0]["first_token"] == 11


async def test_queue_entries_equal_the_jax_packages():
    """A prefill-queue entry enqueued by the port is the JAX package's
    entry byte for byte, and each side dequeues the other's."""
    entry = {"request_id": "r-9", "token_ids": list(range(300)),
             "sampling": {"temperature": 0.0, "seed": None, "top_p": 1.0},
             "request_class": "batch", "transport": "tcp",
             "transfer_address": "127.0.0.1:5555", "transfer_auth": "cd" * 16,
             "layout": {"num_layers": 2, "head_dim": 16, "dtype": "float32",
                        "kv_quant": None, "checksum": "crc32-v1"},
             "start_block": 1, "staging_slots": [65536 + 3, 131072], "deadline_unix": 1.7e9,
             "enqueued_unix": 1760000000.25, "attempts": 2}
    got = {}
    for name, mod in (("port", t_queue), ("jax", j_queue)):
        sent = []
        q = mod.PrefillQueue.__new__(mod.PrefillQueue)

        class _Q:
            async def enqueue(self, payload):
                sent.append(payload)

            async def dequeue_leased(self, timeout_s, lease_s):
                return 1, sent[0]

        q._queue = _Q()
        q.max_depth = q.max_age_s = 0
        await q.enqueue(entry)
        got[name] = sent[0]
        assert (await q.dequeue())[1] == entry
    assert got["port"] == got["jax"] == msgpack.packb(entry)


def test_native_completion_meta_equals_msgpack():
    """The native sender's completion notification (block list, shape,
    dtype, CRCs) is what msgpack packs."""
    meta = {"req": "r-1", "first_token": 42, "blocks": [[1, 65537], [2, 65538]],
            "shape": [2, 2, 16, 2, 16], "dtype": "<f4", "crcs": [4294967295, 17]}
    assert wire.packb(meta) == msgpack.packb(meta)
    assert wire.unpackb(msgpack.packb(meta)) == meta


# ---------------------------------------------------------------------------
# prefill workers in processes of their own
# ---------------------------------------------------------------------------


async def _spawn_worker(addr: str, *extra: str):
    env = dict(os.environ, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1")
    proc = await asyncio.create_subprocess_exec(
        sys.executable, "-m", "dynamo_tpu_torch.examples.prefill_worker",
        "--control-plane", addr, "--namespace", "test", *WORKER_ARGS, *extra,
        stdout=asyncio.subprocess.PIPE, stderr=asyncio.subprocess.STDOUT,
        env=env, cwd=str(REPO),
    )
    lines = []
    while True:
        line = await asyncio.wait_for(proc.stdout.readline(), 120)
        if not line:
            raise AssertionError("prefill worker died before READY:\n" + "".join(lines))
        lines.append(line.decode())
        if lines[-1].startswith("READY "):
            return proc


@pytest.fixture
async def plane():
    server = await ControlPlaneServer().start()
    frontend = await DistributedRuntime.connect(server.address)
    procs = []

    async def spawn(*extra):
        proc = await _spawn_worker(server.address, *extra)
        procs.append(proc)
        return proc

    yield server, frontend, spawn
    for proc in procs:
        if proc.returncode is None:
            proc.kill()
        await proc.wait()
    await frontend.shutdown()
    await server.stop()


@pytest.mark.parametrize("transport", ["tcp", "native"])
async def test_cross_process_disagg_roundtrip(plane, transport):
    """Remote prefill in a separate process: the continuation equals a
    local run's, and the worker's report counts its dispatches."""
    server, frontend, spawn = plane
    expected = await _local(PROMPT, params=None)
    proc = await spawn()
    decode = _engine(params=None)
    await decode.start()
    op = await DecodeOperator(decode, PrefillQueue(frontend, "test"), _router(),
                              transport=transport).start()
    try:
        assert op.transport == transport
        assert await _generate(op, PROMPT) == expected
        assert op.remote_count == 1 and op.local_count == 0
        assert op.receiver.blocks_received == 3
    finally:
        await op.stop()
        await decode.stop()
    proc.terminate()
    out, _ = await asyncio.wait_for(proc.communicate(), 60)
    assert proc.returncode == 0
    report = re.search(r"worker report (\{.*\})", out.decode())
    assert report and '"requests": 1' in report.group(1)


async def test_prefill_worker_death_after_dequeue_redelivers(plane):
    """A prefill worker that dies after dequeuing (before pushing KV) does
    not lose the request: its connection death returns the leased item,
    a later worker takes it, and the stream completes as a local run's."""
    server, frontend, spawn = plane
    expected = await _local(PROMPT, params=None)
    dying = await spawn("--die-after-dequeue")
    decode = _engine(params=None)
    await decode.start()
    op = await DecodeOperator(decode, PrefillQueue(frontend, "test"), _router(),
                              transport="tcp").start()
    try:
        stream = asyncio.ensure_future(_generate(op, PROMPT))
        await asyncio.wait_for(dying.wait(), 30)
        assert dying.returncode == 17
        assert not stream.done(), "stream must still be pending, not failed"
        await spawn()
        assert await asyncio.wait_for(stream, 60) == expected
        assert op.remote_count == 1 and op.local_count == 0
    finally:
        await op.stop()
        await decode.stop()


async def test_disagg_example_serves_long_and_short_prompts():
    """``python -m dynamo_tpu_torch.examples.disagg`` on the CPU: a long
    prompt prefills remotely, a short one locally, both answer 200."""
    env = dict(os.environ, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1")
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    proc = await asyncio.create_subprocess_exec(
        sys.executable, "-m", "dynamo_tpu_torch.examples.disagg", "--device", "cpu",
        "--dtype", "float32", "--port", str(port), "--no-warmup",
        stdout=asyncio.subprocess.PIPE, stderr=asyncio.subprocess.STDOUT,
        env=env, cwd=str(REPO),
    )
    try:
        line = await asyncio.wait_for(proc.stdout.readline(), 120)
        assert b"disagg serving" in line, line
        end = time.monotonic() + 30
        while True:
            models = await fetch("127.0.0.1", port, "GET", "/v1/models")
            if models.status == 200 and models.json()["data"]:
                break
            assert time.monotonic() < end
            await asyncio.sleep(0.1)
        for prompt in (list(range(1, 60)), [1, 2, 3]):
            r = await fetch("127.0.0.1", port, "POST", "/v1/completions", {
                "model": "tiny-test", "prompt": prompt, "max_tokens": 4,
                "nvext": {"ignore_eos": True}})
            assert r.status == 200, r.body
            assert r.json()["usage"]["completion_tokens"] == 4
    finally:
        proc.kill()
        await proc.wait()


BLOCKED_DISAGG = r'''
import asyncio, importlib.abc, sys

BLOCKED = ("jax", "jaxlib", "dynamo_tpu", "msgpack", "ml_dtypes")
for name in list(sys.modules):
    if name.split(".")[0] in BLOCKED:
        del sys.modules[name]


class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"blocked import of {name}")
        return None


sys.meta_path.insert(0, Block())
from dynamo_tpu_torch.block_manager import KvbmConfig, KvBlockManager, KvLayoutConfig
from dynamo_tpu_torch.disagg import (DecodeOperator, DisaggConfig, DisaggRouter,
                                     PrefillQueue, PrefillWorker)
from dynamo_tpu_torch.engine.config import EngineConfig
from dynamo_tpu_torch.engine.engine import TorchEngine
from dynamo_tpu_torch.llm.protocols.common import (
    PreprocessedRequest, SamplingOptions, StopConditions)
from dynamo_tpu_torch.models.config import ModelConfig
from dynamo_tpu_torch.runtime.distributed import DistributedRuntime
from dynamo_tpu_torch.runtime.engine import Context


async def main():
    cfg = EngineConfig(model=ModelConfig.tiny_test(), dtype="float32", num_blocks=32,
                       max_num_seqs=2, max_model_len=128)
    kvbm = await KvBlockManager(KvbmConfig(layout=KvLayoutConfig.for_engine(cfg, None),
                                           host_blocks=8)).start()
    drt = await DistributedRuntime.in_process()
    decode = TorchEngine(cfg, device="cpu", block_manager=kvbm)
    prefill = TorchEngine(cfg, device="cpu")
    await decode.start(); await prefill.start()
    router = DisaggRouter(drt, cfg=DisaggConfig(max_local_prefill_length=16))
    out = []
    for start, transport in ((0, "device"), (1, "tcp")):
        queue = PrefillQueue(drt, transport)
        op = await DecodeOperator(decode, queue, router, transport=transport).start()
        pw = PrefillWorker(prefill, queue).start()
        pre = PreprocessedRequest(token_ids=list(range(start, start + 40)),
                                  sampling=SamplingOptions(temperature=0.0),
                                  stop=StopConditions(max_tokens=4, ignore_eos=True))
        toks = [t async for item in op.generate(Context(pre.to_wire()))
                for t in item["token_ids"]]
        assert op.remote_count == 1 and len(toks) == 4, (transport, toks)
        out.append(toks)
        await pw.stop(); await op.stop()
    await kvbm.drain_offers()
    assert kvbm.stats()["host_registered"] == 4
    await decode.stop(); await prefill.stop(); await kvbm.stop(); await drt.shutdown()
    return out


a, b = asyncio.run(main())
leaked = [m for m in sys.modules if m.split(".")[0] in BLOCKED]
assert not leaked, leaked
print("DISAGG", a)
'''


def test_disagg_serves_with_jax_and_msgpack_blocked():
    """In a fresh interpreter with jax, the JAX package, msgpack and
    ml_dtypes dropped and blocked: a remote-prefilled request over the
    device channel and over tcp, with a KVBM on the decode engine."""
    proc = subprocess.run([sys.executable, "-c", BLOCKED_DISAGG], cwd=REPO,
                          capture_output=True, text=True, timeout=240,
                          env=dict(os.environ, OMP_NUM_THREADS="2"))
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "DISAGG" in proc.stdout
