"""``chip_smoke.py``'s planner phase (phase 11), or its aggregated leg
alone, several times in one process on the card, to see how often it
passes and why it fails.

    cd <checkout> && python3 dynamo_tpu_torch/tools/planner_repeat.py
        [-n 4] [--leg phase|aggregated] [--watch] [--timeline]

Builds the kernels, makes the serve's weights from its seed (the workers
make the same ones) and runs the leg ``-n`` times, each through
``chip_smoke``'s own code. Prints ``ITER i ok|FAILED seconds ...`` per
run (the aggregated leg's decisions, the workers it retired under load
and the seconds from the stop to the scale-down) and the processes left
after each (``LEFT [...]``; none is expected). Exits 1 if a run failed.

- ``--watch``: this process and every process of the leg run under
  ``stallwatch.py`` (event-loop stalls and their stacks on stderr).
- With ``--watch`` or ``--timeline`` the children's output and the leg's
  temporary directories are kept under ``chiprun_out/planner_repeat/``.
- ``--timeline`` (aggregated leg): the workers get health ports, and each
  client request's send and end times and TTFT, and each worker's
  waiting, running and ingress gauges every 0.1 s, are written to
  ``timeline.json`` in the leg's kept directory.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import os
import re
import runpy
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
sys.path.insert(0, ROOT)
OUT = os.path.join(ROOT, "chiprun_out", "planner_repeat")
WATCH = os.path.join(HERE, "stallwatch.py")


def keep_outputs(cs) -> None:
    """The leg's temporary directories and its children's output are
    kept under ``OUT``."""
    os.makedirs(OUT, exist_ok=True)
    kill = cs.Child.kill

    async def kill_and_keep(self):
        await kill(self)
        if self.proc is not None:
            name = f"child-{self.name.replace(' ', '_')}-{self.proc.pid}.log"
            with open(os.path.join(OUT, name), "w") as f:
                f.writelines(f"{t:.3f} {text}" for t, text in self.lines)

    cs.Child.kill = kill_and_keep
    mkdtemp, rmtree = cs.tempfile.mkdtemp, cs.shutil.rmtree
    cs.tempfile.mkdtemp = lambda prefix="": mkdtemp(prefix=prefix, dir=OUT)
    cs.shutil.rmtree = lambda path, *a, **k: (
        None if str(path).startswith(OUT) else rmtree(path, *a, **k))


def watch_processes(cs) -> None:
    """Every process the leg starts runs under the stall watch."""
    worker_cmd = cs.worker_cmd
    cs.worker_cmd = lambda tmp, tag, argv: worker_cmd(tmp, tag, [WATCH] + argv)

    async def start(self):
        self.t_spawn = time.monotonic()
        self.proc = await asyncio.create_subprocess_exec(
            sys.executable, WATCH, "-m", self.module, *self.argv,
            stdout=asyncio.subprocess.PIPE, stderr=asyncio.subprocess.STDOUT, cwd=ROOT,
            env=None if self.env is None else {**os.environ, **self.env})
        self._reader = asyncio.ensure_future(self._read())
        return self

    cs.Child.start = start


GAUGES = ("num_requests_waiting", "num_requests_running", "gpu_cache_usage_perc",
          "ingress_requests_total")


def record_timeline(cs, rec: dict) -> None:
    """Client request times and worker gauges into ``rec`` (see the
    module docstring)."""
    cs.HTTP_ARGS += ["--health-port", "2910{index}"]

    async def client(self):
        while not self._stop.is_set():
            i = self._n
            self._n += 1
            t0 = time.monotonic()
            try:
                r = await self.send(i, self.prompts[i % len(self.prompts)])
            except (Exception, cs.GateFailed) as exc:
                rec["requests"].append([i, t0, time.monotonic(), None, repr(exc)[:200]])
                self.errors.append(repr(exc))
                return
            self.results.append(r)
            rec["requests"].append([i, t0, time.monotonic(), r.get("ttft_ms"), r.get("status")])

    async def sample(stop: asyncio.Event):
        from dynamo_tpu_torch.llm.http_client import fetch

        ports: dict[str, int] = {}
        pat = re.compile(rf"^dyntpu_worker_({'|'.join(GAUGES)}) (\S+)$", re.M)
        while not stop.is_set():
            for name in sorted(os.listdir(rec["dir"])):
                if name.endswith(".log") and name not in ports:
                    with open(os.path.join(rec["dir"], name), errors="replace") as f:
                        m = re.search(r"worker health on http://\S+:(\d+)", f.read())
                    if m:
                        ports[name] = int(m.group(1))
            for name, port in ports.items():
                try:
                    body = (await asyncio.wait_for(
                        fetch("127.0.0.1", port, "GET", "/metrics"), 1.0)).body.decode()
                except (OSError, asyncio.TimeoutError):
                    continue
                rec["gauges"].append([name, time.monotonic(),
                                      {k: float(v) for k, v in pat.findall(body)}])
            await asyncio.sleep(0.1)

    start, stop, cancel = cs.ClosedLoop.start, cs.ClosedLoop.stop, cs.ClosedLoop.cancel

    def start_(self):
        rec["t0"] = time.monotonic()
        self._client = client.__get__(self)
        start(self)
        self._stop_sampling = asyncio.Event()
        self._sampler = asyncio.ensure_future(sample(self._stop_sampling))
        return self

    async def end_sampling(self):
        self._stop_sampling.set()
        await asyncio.gather(self._sampler, return_exceptions=True)

    async def stop_(self):
        await end_sampling(self)
        return await stop(self)

    async def cancel_(self):
        await end_sampling(self)
        await cancel(self)

    cs.ClosedLoop.start, cs.ClosedLoop.stop, cs.ClosedLoop.cancel = start_, stop_, cancel_


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("-n", type=int, default=4)
    ap.add_argument("--leg", choices=("phase", "aggregated"), default="phase")
    ap.add_argument("--watch", action="store_true")
    ap.add_argument("--timeline", action="store_true")
    args = ap.parse_args()
    if args.timeline and args.leg != "aggregated":
        ap.error("--timeline needs --leg aggregated")
    import torch

    import chip_smoke as cs
    from dynamo_tpu_torch.models import llama

    if args.watch or args.timeline:
        keep_outputs(cs)
    if args.watch:
        runpy.run_path(WATCH, run_name="stallwatch")   # watches this process
        watch_processes(cs)
    rec: dict = {}
    if args.timeline:
        record_timeline(cs, rec)
    cs.become_subreaper()
    rc = 0
    try:
        cs.run_phase("build", cs.phase_build)
        cfg = cs.full_width_config()
        g = torch.Generator(device="cuda")
        g.manual_seed(cfg.seed)
        params = llama.init_params(cfg.model, g, dtype=torch.bfloat16, device="cuda")
        m = cfg.model
        for i in range(args.n):
            t0 = time.monotonic()
            rec.update({"requests": [], "gauges": [], "t0": None})
            tmp = None if args.leg == "phase" else cs.tempfile.mkdtemp(
                prefix="chip_smoke_planner_")
            rec["dir"] = tmp
            try:
                if args.leg == "phase":
                    cs.run_phase("planner", cs.phase_planner, m.vocab_size, params)
                    note = ""
                else:
                    r = cs.run_phase("planner", cs.aggregated_leg, tmp, m, params, m.vocab_size)
                    note = (f" retired {r['retired_under_load']} decisions {r['decisions']} "
                            f"stop_to_down {r['load_stop_to_down_s']:.2f}")
                print(f"ITER {i} ok {time.monotonic() - t0:.1f} s{note}", flush=True)
            except BaseException as exc:  # noqa: BLE001 — counted, the next run goes on
                rc = 1
                print(f"ITER {i} FAILED {time.monotonic() - t0:.1f} s "
                      f"{cs.failure_record(exc)}", flush=True)
            finally:
                if args.timeline:
                    with open(os.path.join(tmp, "timeline.json"), "w") as f:
                        json.dump(rec, f)
                if tmp is not None:
                    cs.shutil.rmtree(tmp, ignore_errors=True)
            print("LEFT", cs.stop_leftovers(), flush=True)
    finally:
        print("LEFT at end", cs.stop_leftovers(), flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
