"""The port's ``planner`` subcommand end to end on the CPU: a real
``python -m dynamo_tpu_torch planner`` process over a control plane,
with ``sleep 600`` workers (tests/test_fleet_planner.py's contract,
driven through the CLI as the JAX package's verify recipe drives it):
the two-pool scale-up on queued prefill work while the decode pool
holds, the crash path when a worker is SIGKILLed (shell and child),
SIGTERM leaving the workers running and checkpointed, and a restart
that adopts the live pids and refuses a recycled one. Every test runs
under its own time limit and kills every worker it started."""

from __future__ import annotations

import asyncio
import contextlib
import json
import os
import re
import signal
import sys
import time

import pytest

from dynamo_tpu_torch import cli
from dynamo_tpu_torch.planner.planner import _proc_start_ticks
from dynamo_tpu_torch.runtime.distributed import DistributedRuntime
from dynamo_tpu_torch.runtime.transports.control_plane import ControlPlaneServer

pytestmark = pytest.mark.anyio

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LIMIT_S = 90.0


class _Planner:
    """One planner process, its output (stdout and stderr) in a file: the
    workers it spawns inherit that output, so a pipe would stay open
    after the planner exits."""

    def __init__(self, proc, log) -> None:
        self.proc = proc
        self.log = log

    @staticmethod
    async def spawn(log, *args: str) -> "_Planner":
        with open(log, "ab") as out:
            proc = await asyncio.create_subprocess_exec(
                sys.executable, "-m", "dynamo_tpu_torch", "planner", *args,
                stdout=out, stderr=asyncio.subprocess.STDOUT,
                env=dict(os.environ, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1"), cwd=REPO)
        return _Planner(proc, log)

    async def expect(self, pattern: str, timeout: float = 30.0) -> re.Match:
        pat = re.compile(pattern, re.M)
        end = time.monotonic() + timeout
        while True:
            m = pat.search(self.text)
            if m:
                return m
            if self.proc.returncode is not None:
                raise AssertionError(f"planner ended before {pattern!r}:\n{self.text}")
            assert time.monotonic() < end, f"no {pattern!r} in {timeout} s:\n{self.text}"
            await asyncio.sleep(0.02)

    async def stop(self) -> int:
        self.proc.send_signal(signal.SIGTERM)
        return await asyncio.wait_for(self.proc.wait(), 30)

    async def kill(self) -> None:
        if self.proc.returncode is None:
            self.proc.kill()
            await self.proc.wait()

    @property
    def text(self) -> str:
        try:
            with open(self.log, errors="replace") as f:
                return f.read()
        except FileNotFoundError:
            return ""


def _state(path) -> dict:
    return json.loads(open(path).read())


def _pool_pids(path, pool: str) -> list[int]:
    return [w["pid"] for w in _state(path)["pools"][pool]["workers"]]


def _alive(pid: int) -> bool:
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] != "Z"
    except (FileNotFoundError, IndexError):
        return False


def _kill_groups(pids) -> None:
    """SIGKILL each worker's process group (its shell and its child)."""
    for pid in set(pids):
        with contextlib.suppress(ProcessLookupError, PermissionError):
            os.killpg(pid, signal.SIGKILL)


async def _until(cond, what: str, timeout: float = 20.0) -> float:
    t0 = time.monotonic()
    while not cond():
        assert time.monotonic() - t0 < timeout, f"timed out: {what}"
        await asyncio.sleep(0.02)
    return time.monotonic() - t0


def _spawned_pids(planner: _Planner, state) -> set[int]:
    pids: set[int] = set()
    with contextlib.suppress(Exception):
        st = _state(state)
        for slice_ in st.get("pools", {}).values():
            pids |= {w["pid"] for w in slice_["workers"]}
        pids |= {w["pid"] for w in st.get("workers", [])}
    pids |= {int(m) for m in re.findall(r"worker (\d+) died", planner.text)}
    return pids


async def test_cli_two_pool_scale_up_crash_heal_and_sigterm(tmp_path):
    async def body():
        server = await ControlPlaneServer(host="127.0.0.1", port=0).start()
        client = await DistributedRuntime.connect(server.address)
        state, dlog = tmp_path / "s.json", tmp_path / "d.jsonl"
        planner = await _Planner.spawn(
            tmp_path / "planner.log", "--control-plane", server.address, "--two-pool",
            "--worker-cmd", "sleep 600 # decode-{index}",
            "--prefill-worker-cmd", "sleep 600 # prefill-{index}",
            "--metric-interval", "0.1", "--adjustment-interval", "0.5",
            "--state-path", str(state), "--decision-log", str(dlog))
        seen: set[int] = set()
        try:
            await planner.expect(r"fleet planner running \(two-pool\)")
            assert len(_pool_pids(state, "prefill")) == 1
            assert len(_pool_pids(state, "decode")) == 1
            queue = client.bus.work_queue("dynamo.prefill_queue")
            for i in range(8):
                await queue.enqueue(b"job%d" % i)
            await _until(lambda: state.exists() and len(_pool_pids(state, "prefill")) == 2,
                         "the prefill pool never scaled up")
            decisions = [json.loads(line) for line in dlog.read_text().splitlines()]
            assert any(d["pool"] == "prefill" and d["decision"] == "up" for d in decisions)
            assert all(d["decision"] == "hold" for d in decisions if d["pool"] == "decode")
            assert len(_pool_pids(state, "decode")) == 1

            # Crash heal: the decode worker's shell and child SIGKILLed.
            victim = _pool_pids(state, "decode")[0]
            seen |= _spawned_pids(planner, state)
            t_kill = time.monotonic()
            os.killpg(victim, signal.SIGKILL)
            await planner.expect(
                rf"worker {victim} died — replacing immediately \(crash path, no drain\)")
            gap = time.monotonic() - t_kill
            assert gap < 5.0, gap
            await _until(lambda: _pool_pids(state, "decode") not in ([victim], []),
                         "the state file never carried the replacement")
            fresh = _pool_pids(state, "decode")[0]
            assert fresh != victim and _alive(fresh)

            # SIGTERM: the planner exits and its workers stay, checkpointed.
            seen |= _spawned_pids(planner, state)
            while await queue.dequeue(timeout_s=0.05):
                pass
            assert await planner.stop() == 0
            kept = _pool_pids(state, "prefill") + _pool_pids(state, "decode")
            assert kept and all(_alive(p) for p in kept)
            assert all(w["started"] == _proc_start_ticks(w["pid"])
                       for pool in _state(state)["pools"].values() for w in pool["workers"])
        finally:
            seen |= _spawned_pids(planner, state)
            _kill_groups(seen)
            await planner.kill()
            _kill_groups(_spawned_pids(planner, state))
            await client.shutdown()
            await server.stop()

    await asyncio.wait_for(body(), LIMIT_S)


async def test_cli_resume_adopts_live_pids_and_refuses_a_recycled_one(tmp_path):
    async def body():
        server = await ControlPlaneServer(host="127.0.0.1", port=0).start()
        state = tmp_path / "s.json"
        args = ("--control-plane", server.address, "--min-workers", "2", "--max-workers", "3",
                "--worker-cmd", "sleep 600 # w-{index}", "--metric-interval", "0.1",
                "--adjustment-interval", "30", "--state-path", str(state))
        first = await _Planner.spawn(tmp_path / "first.log", *args)
        seen: set[int] = set()
        second = None
        try:
            await first.expect(r"^planner running")
            pids = [w["pid"] for w in _state(state)["workers"]]
            assert len(pids) == 2 and all(_alive(p) for p in pids)
            assert await first.stop() == 0
            seen |= set(pids)
            assert all(_alive(p) for p in pids)
            # Recycle one identity: its start time no longer matches.
            st = _state(state)
            st["workers"][0]["started"] += 12345
            state.write_text(json.dumps(st))
            second = await _Planner.spawn(tmp_path / "second.log", *args)
            await second.expect(r"^planner running")
            await second.expect(rf"pid {pids[0]} was recycled .*not adopting")
            await second.expect(r"resumed 1 worker\(s\)")
            now = [w["pid"] for w in _state(state)["workers"]]
            seen |= set(now)
            assert now[0] == pids[1] and pids[0] not in now and len(now) == 2
            # The refused pid's process was not touched: still running.
            assert _alive(pids[0])
            assert st["connector"]["count"] == 2 and _state(state)["connector"]["count"] == 3
            assert await second.stop() == 0
        finally:
            for p in (first, second):
                if p is not None:
                    seen |= _spawned_pids(p, state)
            _kill_groups(seen)
            for p in (first, second):
                if p is not None:
                    await p.kill()
            await server.stop()

    await asyncio.wait_for(body(), LIMIT_S)


async def test_cli_planner_refuses_half_configs():
    parse = cli.build_parser().parse_args
    base = ["planner", "--control-plane", "127.0.0.1:1", "--worker-cmd", "w"]
    with pytest.raises(SystemExit, match="two-pool"):
        await cli._planner(parse(base + ["--two-pool", "--prefill-worker-cmd", "p",
                                         "--ttft-sla-ms", "100"]))
    with pytest.raises(SystemExit, match="requires --prefill-worker-cmd"):
        await cli._planner(parse(base + ["--two-pool"]))
    with pytest.raises(SystemExit, match="BOTH --profile"):
        await cli._planner(parse(base + ["--ttft-sla-ms", "100"]))
    with pytest.raises(SystemExit, match="BOTH --profile"):
        await cli._planner(parse(base + ["--profile", "x.json"]))


def test_cli_planner_flags_parse_as_the_reference():
    from dynamo_tpu.cli import build_parser as j_parser

    argv = ["planner", "--control-plane", "x:1", "--worker-cmd", "dec {index}", "--two-pool",
            "--prefill-worker-cmd", "pf {index}", "--decode-itl-up-ms", "25",
            "--prefill-max-workers", "3", "--decode-component", "decode"]
    assert vars(cli.build_parser().parse_args(argv)) == vars(j_parser().parse_args(argv))
