"""Fleet simulator: xPyD topology projection on the calibrated mocker
(port of dynamo_tpu/planner/simulate.py).

Replays a workload through the mocker's per-phase cost model
(mocker/engine.py ``MockerConfig``) on a virtual clock — no sleeping,
no scheduler noise, deterministic — so 1P1D / 2P1D / 2P2D
disaggregated topologies project against aggregated baselines in
milliseconds of real time.

Pricing (planner/calibration.py derives the constants from the
recorded H100 run; the tests hold the single-worker simulation of that
run's headline to 10 %):

- prefill batch: ``HOST_OVERHEAD + prefill_dispatch_base +
  Σ (isl·per_token + isl²·quadratic)`` — the fused prefill a
  PrefillWorker drains in batches;
- decode step:  ``HOST_OVERHEAD + decode_base + lanes·per_lane``;
- KV handoff:   the fixed cost + ``isl·KV_BYTES_PER_TOKEN`` over the
  decode worker's link (heterogeneous links model network-aware
  selection).

The simulator also models elasticity: a decode worker can start
DRAINING mid-run (``drain_decode_at``) — it takes no new selections and
finishes everything already routed to it; the run must end with no
request dropped.

Scheduling policy: aggregated workers run prefill-priority phase
alternation with per-step decode pricing (``mode="batch"``) or
co-located quanta (``mode="coloc"``); disagg decode workers admit up to
``max_num_seqs`` lanes between steps. The logic is the JAX package's,
line for line: the tests hold both simulators to equal results.
"""

from __future__ import annotations

import heapq
import itertools
from dataclasses import dataclass, field

from dynamo_tpu_torch.mocker.engine import MockerConfig
from dynamo_tpu_torch.planner import calibration as cal


@dataclass
class SimRequest:
    arrival_s: float
    isl: int
    osl: int
    # filled by the simulation
    ttft_s: float | None = None
    done_s: float | None = None
    decode_worker: int | None = None
    dropped: bool = False


def synth_workload(
    n: int, isl: int, osl: int, rate_rps: float = 0.0
) -> list[SimRequest]:
    """``rate_rps`` 0 = all-at-once burst (the bench.py shape); >0 =
    uniform open arrivals."""
    gap = 1.0 / rate_rps if rate_rps > 0 else 0.0
    return [SimRequest(arrival_s=i * gap, isl=isl, osl=osl) for i in range(n)]


@dataclass
class SimConfig:
    mocker: MockerConfig = field(default_factory=cal.calibrated_mocker_config)
    host_overhead_us: float = field(default_factory=lambda: cal.HOST_OVERHEAD_US)
    # The host time a PREFILL batch adds, where it differs from a decode
    # step's (None = ``host_overhead_us``, the JAX package's one term):
    # on the port's pipelined engine a device-bound prefill dispatch
    # hides most of its host work, a host-bound decode step does not.
    prefill_host_overhead_us: float | None = field(
        default_factory=lambda: cal.PREFILL_HOST_OVERHEAD_US)
    prefill_batch: int = 16
    max_num_seqs: int = 64
    handoff_fixed_us: float = field(default_factory=lambda: cal.HANDOFF_FIXED_US)
    kv_bytes_per_token: int = cal.KV_BYTES_PER_TOKEN
    # KV precision of the simulated fleet: "int8" scales the handoff byte term by the packed
    # int8 ratio (~0.502), so xPyD projections for quantized fleets
    # price the halved prefill→decode transfers.
    kv_quant: str | None = None
    # WEIGHT precision of the simulated fleet: "int8" scales every dispatch base — the weight
    # pass standalone prefill and decode steps both pay — by the
    # calibration weight-bytes term (calibration.weight_bytes_per_step),
    # so xPyD / NetKV projections for int8-weight fleets price the
    # ~halved per-dispatch weight streaming. None = bf16 baseline
    # (every base unchanged).
    weight_quant: str | None = None
    # Network-aware selection trade-off: one queued-ahead request is
    # worth about one decode dispatch of delay.
    load_penalty_s: float = 0.025

    def weight_pass_s(self, base_us: float) -> float:
        """A dispatch base (= its weight pass) repriced at the fleet's
        weight precision: the calibration bytes term scales the base by
        quantized/bf16 streamed bytes (~0.501 for int8; exactly 1.0 at
        None, so bf16 projections are byte-identical to before the term
        existed)."""
        if self.weight_quant is None:
            return base_us / 1e6
        ratio = (
            cal.weight_bytes_per_step(self.weight_quant)
            / cal.WEIGHT_BYTES_PER_STEP
        )
        return base_us * ratio / 1e6

    def prefill_batch_cost_s(self, isls: list[int]) -> float:
        m = self.mocker
        us = (self.host_overhead_us if self.prefill_host_overhead_us is None
              else self.prefill_host_overhead_us)
        s = self.weight_pass_s(m.prefill_dispatch_base_us)
        for isl in isls:
            us += m.prefill_time_per_token_us * isl
            us += m.prefill_quadratic_us * isl * isl
        return s + us / 1e6

    def decode_step_cost_s(self, lanes: int) -> float:
        m = self.mocker
        return self.weight_pass_s(m.decode_time_per_step_us) + (
            self.host_overhead_us
            + m.decode_time_per_lane_us * lanes
        ) / 1e6

    def handoff_s(self, isl: int, link_gbps: float) -> float:
        bytes_ = isl * self.kv_bytes_per_token
        if self.kv_quant == "int8":
            bytes_ *= cal.kv_quant_bytes_ratio()
        return self.handoff_fixed_us / 1e6 + bytes_ / (link_gbps * 1e9)


@dataclass
class SimResult:
    topology: str
    chips: int
    elapsed_s: float
    tok_s: float
    tok_s_per_chip: float
    p50_ttft_ms: float
    p95_ttft_ms: float
    itl_p50_ms: float
    itl_p95_ms: float
    itl_max_ms: float
    dropped: int
    completed: int
    per_decode_worker: list[int] = field(default_factory=list)
    # When a drain_decode_at event fired: the simulated time the
    # draining worker went EMPTY (finished everything routed to it) —
    # None means it never completed its drain within the run.
    decode_drained_at_s: float | None = None

    def to_wire(self) -> dict:
        return {
            "topology": self.topology,
            "chips": self.chips,
            "elapsed_s": round(self.elapsed_s, 3),
            "tok_s": round(self.tok_s, 1),
            "tok_s_per_chip": round(self.tok_s_per_chip, 1),
            "p50_ttft_ms": round(self.p50_ttft_ms, 1),
            "p95_ttft_ms": round(self.p95_ttft_ms, 1),
            "itl_p50_ms": round(self.itl_p50_ms, 2),
            "itl_p95_ms": round(self.itl_p95_ms, 2),
            "itl_max_ms": round(self.itl_max_ms, 2),
            "dropped": self.dropped,
            "completed": self.completed,
            "per_decode_worker": self.per_decode_worker,
            "decode_drained_at_s": (
                round(self.decode_drained_at_s, 3)
                if self.decode_drained_at_s is not None else None
            ),
        }


def _pct(xs: list[float], q: float) -> float:
    if not xs:
        return 0.0
    s = sorted(xs)
    pos = (len(s) - 1) * q
    lo = int(pos)
    hi = min(lo + 1, len(s) - 1)
    return s[lo] + (s[hi] - s[lo]) * (pos - lo)


def _result(
    topology: str, chips: int, reqs: list[SimRequest],
    gaps_ms: list[float] | None = None,
    per_worker: list[int] | None = None,
) -> SimResult:
    done = [r for r in reqs if r.done_s is not None and not r.dropped]
    dropped = sum(1 for r in reqs if r.dropped)
    elapsed = max((r.done_s for r in done), default=0.0)
    out_tokens = sum(r.osl for r in done)
    ttfts = [1000.0 * r.ttft_s for r in done if r.ttft_s is not None]
    tok_s = out_tokens / elapsed if elapsed > 0 else 0.0
    gaps_ms = gaps_ms or []
    return SimResult(
        topology=topology,
        chips=chips,
        elapsed_s=elapsed,
        tok_s=tok_s,
        tok_s_per_chip=tok_s / max(chips, 1),
        p50_ttft_ms=_pct(ttfts, 0.50),
        p95_ttft_ms=_pct(ttfts, 0.95),
        itl_p50_ms=_pct(gaps_ms, 0.50),
        itl_p95_ms=_pct(gaps_ms, 0.95),
        itl_max_ms=max(gaps_ms, default=0.0),
        dropped=dropped,
        completed=len(done),
        per_decode_worker=per_worker or [],
    )


# ---------------------------------------------------------------------------
# aggregated (both phases on every chip)


def _deliver(active: list[list], t: float, gaps_ms: list[float]) -> list[list]:
    """One decode token to every active lane at time ``t``; records the
    per-lane inter-token gap (lane[2] = last delivery time — prefill
    stalls between deliveries surface here as ITL spikes)."""
    still = []
    for lane in active:
        lane[1] -= 1
        gaps_ms.append(1000.0 * (t - lane[2]))
        lane[2] = t
        if lane[1] <= 0:
            lane[0].done_s = t
        else:
            still.append(lane)
    return still


def _run_aggregated_one(
    cfg: SimConfig, reqs: list[SimRequest], gaps_ms: list[float]
) -> None:
    """One aggregated worker: prefill-priority phase alternation —
    pending prompts prefill in fused batches first (bounded by the
    admission cap), decode steps run otherwise. Maximum throughput; decode lanes STALL for whole prefill batches (the ITL
    percentiles make that visible — the SLO problem co-location and
    disaggregation both exist to fix)."""
    reqs = sorted(reqs, key=lambda r: r.arrival_s)
    t = 0.0
    idx = 0
    pending: list[SimRequest] = []
    active: list[list] = []  # [req, remaining_tokens, last_token_t]
    while idx < len(reqs) or pending or active:
        while idx < len(reqs) and reqs[idx].arrival_s <= t + 1e-12:
            pending.append(reqs[idx])
            idx += 1
        if not pending and not active:
            t = reqs[idx].arrival_s
            continue
        room = cfg.max_num_seqs - len(active)
        take = min(len(pending), cfg.prefill_batch, max(room, 0))
        if take > 0:
            batch, pending = pending[:take], pending[take:]
            t += cfg.prefill_batch_cost_s([r.isl for r in batch])
            for r in batch:
                r.ttft_s = t
                if r.osl <= 1:
                    r.done_s = t
                else:
                    active.append([r, r.osl - 1, t])
            continue
        t += cfg.decode_step_cost_s(len(active))
        active = _deliver(active, t, gaps_ms)


def _run_coloc_one(
    cfg: SimConfig, reqs: list[SimRequest], gaps_ms: list[float],
    quantum: int,
) -> None:
    """One aggregated worker in SLO-holding CO-LOCATED mode (the
    unified step's shape, mocker ``unified_step`` pricing): every
    dispatch carries all decode lanes plus up to ``quantum`` prefill
    tokens chunked off the head of the prompt queue — decode never
    stalls longer than one dispatch, and prefill pays the quantum tax
    (the dispatch base amortizes over ``quantum`` tokens instead of a
    full fused batch — exactly the efficiency a dedicated prefill pool
    recovers)."""
    reqs = sorted(reqs, key=lambda r: r.arrival_s)
    t = 0.0
    idx = 0
    pending: list[list] = []      # [req, prefilled_tokens]
    active: list[list] = []       # [req, remaining, last_token_t]
    while idx < len(reqs) or pending or active:
        while idx < len(reqs) and reqs[idx].arrival_s <= t + 1e-12:
            pending.append([reqs[idx], 0])
            idx += 1
        if not pending and not active:
            t = reqs[idx].arrival_s
            continue
        ptoks = 0
        finishing: list[SimRequest] = []
        if len(active) < cfg.max_num_seqs:
            for ent in pending:
                if ptoks >= quantum:
                    break
                req, done_toks = ent
                take = min(quantum - ptoks, req.isl - done_toks)
                ent[1] += take
                ptoks += take
                if ent[1] >= req.isl:
                    finishing.append(req)
        pending = [e for e in pending if e[1] < e[0].isl]
        m = cfg.mocker
        t += cfg.weight_pass_s(m.decode_time_per_step_us) + (
            cfg.host_overhead_us
            + m.decode_time_per_lane_us * len(active)
            + m.prefill_time_per_token_us * ptoks
        ) / 1e6
        for r in finishing:
            r.ttft_s = t
            if r.osl <= 1:
                r.done_s = t
            else:
                active.append([r, r.osl - 1, t])
        if active:
            # Finishing lanes joined AFTER this dispatch's deliveries —
            # deliver only to lanes that were active going in.
            joined = {id(r) for r in finishing}
            carried = [ln for ln in active if id(ln[0]) not in joined]
            delivered = _deliver(carried, t, gaps_ms)
            active = delivered + [ln for ln in active if id(ln[0]) in joined]


def simulate_aggregated(
    cfg: SimConfig,
    workload: list[SimRequest],
    n_workers: int = 1,
    mode: str = "batch",           # "batch" | "coloc"
    quantum: int = 64,
) -> SimResult:
    """N aggregated chips, requests round-robined at arrival (the
    baseline every disagg topology is judged against). ``mode="batch"``
    maximizes throughput with fused prefill batches that stall decode;
    ``mode="coloc"`` holds decode ITL by chunking prefill into
    ``quantum``-token co-located slices (the SLO-respecting baseline —
    what a production aggregated fleet actually runs)."""
    shards: list[list[SimRequest]] = [[] for _ in range(n_workers)]
    for i, r in enumerate(sorted(workload, key=lambda r: r.arrival_s)):
        shards[i % n_workers].append(r)
    gaps_ms: list[float] = []
    for shard in shards:
        if mode == "coloc":
            _run_coloc_one(cfg, shard, gaps_ms, quantum)
        else:
            _run_aggregated_one(cfg, shard, gaps_ms)
    tag = "coloc" if mode == "coloc" else "AGG"
    return _result(f"{n_workers}x{tag}", n_workers, workload, gaps_ms)


# ---------------------------------------------------------------------------
# disaggregated (xP yD)


class _DecodeSim:
    def __init__(self, idx: int, link_gbps: float) -> None:
        self.idx = idx
        self.link_gbps = link_gbps
        self.buffer: list[SimRequest] = []   # landed, not yet admitted
        self.active: list[list] = []         # [req, remaining]
        self.assigned = 0                    # routed but not finished
        self.busy = False
        self.draining = False
        self.drained_at: float | None = None
        self.served = 0

    @property
    def load(self) -> int:
        return self.assigned


def simulate_xpyd(
    cfg: SimConfig,
    workload: list[SimRequest],
    n_prefill: int,
    n_decode: int,
    decode_links_gbps: list[float] | None = None,
    selector: str = "plain",            # "plain" | "netaware"
    drain_decode_at: tuple[float, int] | None = None,
) -> SimResult:
    """xP yD: ``n_prefill`` chips drain a shared FIFO prefill queue in
    fused batches; each prompt's KV hands off over ITS decode worker's
    link; decode chips run pure decode steps. The decode worker is
    chosen at ingress (as the real DecodeOperator does):

    - ``plain``: least outstanding requests (the load-only score);
    - ``netaware``: least ``handoff_s + load · load_penalty_s`` — the
      NetKV-style transfer-cost term (llm/kv_router/scheduler.py is the
      production twin of this policy).

    ``drain_decode_at=(t, idx)`` starts draining decode worker ``idx``
    at simulated time ``t``: no new selections, everything already
    routed finishes — zero dropped requests is the elasticity gate.
    """
    links = list(decode_links_gbps or [cal.HANDOFF_GBPS] * n_decode)
    if len(links) != n_decode:
        raise ValueError("decode_links_gbps must have n_decode entries")
    decode = [_DecodeSim(i, links[i]) for i in range(n_decode)]
    pf_free = [0.0] * n_prefill
    queue: list[SimRequest] = []
    gaps_ms: list[float] = []
    seq = itertools.count()
    events: list[tuple] = []   # (time, seq, kind, payload)

    def push(t: float, kind: str, payload) -> None:
        heapq.heappush(events, (t, next(seq), kind, payload))

    def select_worker(req: SimRequest, t: float) -> _DecodeSim | None:
        live = [w for w in decode if not w.draining]
        if not live:
            return None
        if selector == "netaware":
            return min(
                live,
                key=lambda w: (
                    cfg.handoff_s(req.isl, w.link_gbps)
                    + w.load * cfg.load_penalty_s,
                    w.idx,
                ),
            )
        return min(live, key=lambda w: (w.load, w.idx))

    def kick_prefill(t: float) -> None:
        for i in range(n_prefill):
            if pf_free[i] <= t + 1e-12 and queue:
                take = min(len(queue), cfg.prefill_batch)
                batch = [queue.pop(0) for _ in range(take)]
                cost = cfg.prefill_batch_cost_s([r.isl for r in batch])
                pf_free[i] = t + cost
                push(t + cost, "pf_done", (i, batch))

    def start_decode(w: _DecodeSim, t: float) -> None:
        if w.busy:
            return
        room = cfg.max_num_seqs - len(w.active)
        while w.buffer and room > 0:
            r = w.buffer.pop(0)
            if r.osl <= 1:
                r.done_s = t
                w.assigned -= 1
                w.served += 1
                continue
            w.active.append([r, r.osl - 1, t])
            room -= 1
        if not w.active:
            if w.draining and not w.buffer and w.assigned == 0:
                w.drained_at = t
            return
        w.busy = True
        push(t + cfg.decode_step_cost_s(len(w.active)), "dec_done", w)

    for r in sorted(workload, key=lambda r: r.arrival_s):
        push(r.arrival_s, "arrive", r)
    if drain_decode_at is not None:
        push(drain_decode_at[0], "drain", drain_decode_at[1])

    while events:
        t, _, kind, payload = heapq.heappop(events)
        if kind == "arrive":
            req = payload
            w = select_worker(req, t)
            if w is None:
                req.dropped = True
                continue
            req.decode_worker = w.idx
            w.assigned += 1
            queue.append(req)
            kick_prefill(t)
        elif kind == "pf_done":
            _i, batch = payload
            for req in batch:
                w = decode[req.decode_worker]
                push(t + cfg.handoff_s(req.isl, w.link_gbps), "land", req)
            kick_prefill(t)
        elif kind == "land":
            req = payload
            req.ttft_s = t   # first token travels with the handoff
            w = decode[req.decode_worker]
            w.buffer.append(req)
            start_decode(w, t)
        elif kind == "dec_done":
            w = payload
            w.busy = False
            before = len(w.active)
            w.active = _deliver(w.active, t, gaps_ms)
            finished = before - len(w.active)
            w.assigned -= finished
            w.served += finished
            start_decode(w, t)
        elif kind == "drain":
            w = decode[payload]
            w.draining = True
            # Anything queued toward it still lands and finishes —
            # drain ≠ kill. An already-
            # empty worker is drained on the spot (no later event
            # would re-check it).
            if not w.active and not w.buffer and w.assigned == 0:
                w.drained_at = t

    chips = n_prefill + n_decode
    res = _result(
        f"{n_prefill}P{n_decode}D", chips, workload, gaps_ms,
        per_worker=[w.served for w in decode],
    )
    res.decode_drained_at_s = next(
        (w.drained_at for w in decode if w.draining), None
    )
    return res


def calibrated_headline(calibration=None) -> SimResult:
    """The calibrated single-worker simulation of a calibration record's
    headline (``calibration.CALIBRATION`` by default): its requests, all
    at once, on one worker of the recorded engine's slots, prefilled in
    fused batches of the engine's admission width (``prefill_batch``:
    the recorded engine admits that many prompts at a time, and they
    fit its token budget beside every decode lane, so none splits)."""
    c = calibration or cal.CALIBRATION
    head, eng = c.headline, c.engine
    cfg = SimConfig(
        mocker=cal.calibrated_mocker_config(c),
        host_overhead_us=c.host_overhead_us,
        prefill_host_overhead_us=c.prefill_host_overhead_us,
        handoff_fixed_us=c.handoff_fixed_us,
        prefill_batch=int(eng["prefill_batch"]),
        max_num_seqs=int(eng["max_num_seqs"]),
    )
    wl = synth_workload(int(head["num_requests"]), int(head["isl"]), int(head["osl"]))
    return simulate_aggregated(cfg, wl, 1)
