"""Mocker: a device-free simulated engine (port of
dynamo_tpu/mocker/engine.py).

The mocker is the real TorchEngine with the ModelRunner swapped for a
cost-model simulator (``MockerEngine._build_runner``): everything above
the runner — continuous batching, prefix cache, preemption, the bounded
waiting list, drain, metrics — is the serving code path, run at
simulation speed and on no device. Fleet tests (routing, failover,
drain) run on it.

Cost model: a unified dispatch sleeps ``decode_time_per_step_us`` (the
weight pass every step streams) + ``decode_time_per_lane_us`` per decode
lane + ``prefill_time_per_token_us`` per prefill token (+ the quadratic
term); the optional bytes terms price KV reads and weight passes against
``decode_hbm_gbps``. The two explicit knobs keep the reference mocker's
defaults (500 µs per step, 2 µs per prefill token). The terms the JAX
package defaults from its TPU calibration (``prefill_quadratic_us``,
``kv_bytes_per_token``, ``decode_hbm_gbps``, ``weight_bytes_per_step``)
default to 0 here — off; ``planner.calibration.calibrated_mocker_config()``
prices every term from the recorded H100 run instead. No TPU number
enters the port.

Clock: every sleep is also charged to the runner's ``charged_clock``,
which the engine reads for the co-location controller's ITL samples
(``TorchEngine._clock``). A sample is then exactly the cost the model
charged the dispatch, whatever the host's scheduling noise added to the
sleep: the controller sees the simulated chip, not the CPU the test
shares. Everything else keeps wall time.

``deterministic_tokens``: every sampled token is a pure affine function
of (previous token, its position) — ``det_next_token`` — so any worker
resuming from (last token, length), as a failover replay of prompt +
emitted tokens does, continues the stream one uninterrupted worker would
have produced.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np

from dynamo_tpu_torch.engine.compile_cache import (
    CompileStats,
    WarmupPlanMixin,
    _bucket,
    graph_key,
    token_budget,
)
from dynamo_tpu_torch.engine.config import EngineConfig
from dynamo_tpu_torch.engine.engine import TorchEngine
from dynamo_tpu_torch.engine.runner import _serves_variant, _unified_warm_lanes

#: Fake top alternatives per token reported by an extras dispatch.
_SIM_LOGPROBS = 8


@dataclass
class MockerConfig:
    """Cost model and token law of the simulated runner."""

    prefill_time_per_token_us: float = 2.0   # linear term
    prefill_quadratic_us: float = 0.0        # * len^2 (off; calibrated: planner/calibration.py)
    decode_time_per_step_us: float = 500.0   # per dispatch (weight pass)
    decode_time_per_lane_us: float = 0.0     # per decode lane per step
    prefill_dispatch_base_us: float = 0.0    # per standalone prefill call
    # Bytes terms (0 = off): a decode lane reads its context's KV, a
    # dispatch its weights, at decode_hbm_gbps; with weight bytes on,
    # they replace the flat dispatch bases.
    decode_hbm_gbps: float = 0.0
    kv_bytes_per_token: float = 0.0
    kv_bytes_ratio: float = 1.0
    weight_bytes_per_step: float = 0.0
    weight_bytes_ratio: float = 1.0
    vocab_size: int = 32000
    seed: int = 0
    # Closed-form greedy stream (see the module docstring); off: seeded
    # RNG tokens.
    deterministic_tokens: bool = False
    # G4 peer-link cost model: the rate, in GB/s, a mocker worker's
    # PeerBlockServer paces fleet pulls at (its ``serve_link_gbps``; 0 =
    # unpaced). tools/g4_bench.py sets it to the calibrated HANDOFF_GBPS so
    # the pull-vs-recompute price meets a transfer time of that link.
    peer_link_gbps: float = 0.0


def det_next_token(prev_tok, next_pos, vocab: int, positional: bool = True):
    """The deterministic-token closed form: next token = affine hash of
    (previous token[, its position]), in int64."""
    prev = np.asarray(prev_tok, np.int64)
    if not positional:
        return (prev * 1103515245 + 7) % vocab
    pos = np.asarray(next_pos, np.int64)
    return (prev * 1103515245 + pos * 12345 + 7) % vocab


class _SimOut:
    """UnifiedOut lookalike: host arrays, always ready."""

    def __init__(self, last, toks2d, counts, logprobs) -> None:
        self.last = last
        self._toks2d = toks2d
        self._counts = counts
        self._logprobs = logprobs

    def ready(self) -> bool:
        return True

    def tokens(self) -> np.ndarray:
        return self.last

    def spec(self):
        return None if self._toks2d is None else (self._toks2d, self._counts)

    def logprobs(self):
        return self._logprobs


class _SimRunner(WarmupPlanMixin):
    """ModelRunner lookalike: sleeps per the cost model, emits
    pseudo-tokens deterministic in (seed, inputs), and counts programs
    as the runner does (warmed, or made mid-traffic)."""

    def __init__(self, cfg: EngineConfig, sim: MockerConfig) -> None:
        self.cfg = cfg
        self.sim = sim
        self._rng = np.random.default_rng(sim.seed)
        self.compile_stats = CompileStats()
        self.last_logprobs = None
        self._charged_s = 0.0
        # Simulated per-block KV bytes (8 floats a block) so the KVBM and
        # disagg paths can check byte fidelity without a device.
        self._fake_kv: dict[int, np.ndarray] = {}

    # -- block IO (the real runner's batched forms, on the fake bytes) ------
    def gather_block(self, block_idx: int) -> np.ndarray:
        return self._fake_kv.get(block_idx, np.full(8, block_idx, np.float32))

    def scatter_block(self, block_idx: int, data) -> None:
        self._fake_kv[block_idx] = np.asarray(data)

    def gather_many(self, block_idxs) -> np.ndarray:
        return np.stack([self.gather_block(b) for b in block_idxs])

    # No device: the "device snapshot" and the asynchronous host copy are
    # the same host array.
    gather_many_device = gather_many
    gather_many_async = gather_many

    def scatter_many(self, block_idxs, datas) -> None:
        for b, d in zip(block_idxs, datas):
            self.scatter_block(b, d)

    def scatter_many_device(self, block_idxs, data) -> None:
        self.scatter_many(block_idxs, data)

    @property
    def kv_bytes_ratio(self) -> float:
        """The advertised stored-KV precision ratio, as the real runner's."""
        if self.cfg.kv_quant != "int8":
            return 1.0
        from dynamo_tpu_torch.block_manager.config import KvLayoutConfig

        lay = KvLayoutConfig.for_engine(self.cfg)
        return lay.block_bytes / lay.unquantized_block_bytes

    def charged_clock(self) -> float:
        """Seconds of simulated work charged so far (the engine's
        coloc clock)."""
        return self._charged_s

    def _charge(self, us: float) -> None:
        """Sleep ``us`` microseconds and charge them to the clock."""
        self._charged_s += us / 1e6
        time.sleep(us / 1e6)

    @property
    def unified_slots(self) -> int:
        return self.cfg.max_num_seqs + self.cfg.prefill_batch

    def _make_program(self, kind: str, t: int, greedy: bool) -> None:
        with self.compile_stats.program(graph_key(kind, t, greedy)):
            pass

    def _warm_op(self, spec):
        """The sim twin of ModelRunner._warm_op: marks the spec's greedy
        and sampled programs made."""
        cfg = self.cfg
        kind, t = spec[0], spec[1]
        if not _serves_variant(cfg, kind):
            return None
        if not _unified_warm_lanes(t, self.unified_slots, cfg.max_model_len,
                                   [0], (0.0, 0, 1.0)):
            return None
        return lambda: [self._make_program(kind, t, g) for g in (True, False)]

    # -- cost model ---------------------------------------------------------
    def _prefill_cost_us(self, n: int) -> float:
        return (self.sim.prefill_time_per_token_us * n
                + self.sim.prefill_quadratic_us * n * n)

    def _weight_pass_us(self, base_us: float) -> float:
        """The dispatch's weight pass: bytes-priced when that term is on
        (replacing the flat base), else the base scaled by the precision
        ratio."""
        sim = self.sim
        if sim.weight_bytes_per_step > 0 and sim.decode_hbm_gbps > 0:
            return (sim.weight_bytes_per_step * sim.weight_bytes_ratio
                    / (sim.decode_hbm_gbps * 1e9) * 1e6)
        return base_us * sim.weight_bytes_ratio

    def _kv_read_us(self, ctx_tokens: float) -> float:
        if self.sim.decode_hbm_gbps <= 0:
            return 0.0
        nbytes = ctx_tokens * self.sim.kv_bytes_per_token * self.sim.kv_bytes_ratio
        return nbytes / (self.sim.decode_hbm_gbps * 1e9) * 1e6

    def _det_next(self, prev_tok, next_pos):
        return det_next_token(prev_tok, next_pos, self.sim.vocab_size)

    def _rand_token(self) -> int:
        return int(self._rng.integers(0, self.sim.vocab_size))

    # -- phase-split entry points ----------------------------------------------
    def prefill(self, new_tokens, block_ids, prefix_len, sampling, mm_embeds=None) -> int:
        n = len(new_tokens)
        self._charge(self._weight_pass_us(self.sim.prefill_dispatch_base_us)
                     + self._prefill_cost_us(n))
        if self.sim.deterministic_tokens and n:
            return int(self._det_next(new_tokens[-1], prefix_len + n))
        return self._rand_token()

    def prefill_batch(self, lanes) -> list[int]:
        self._charge(self._weight_pass_us(self.sim.prefill_dispatch_base_us))
        out = []
        for toks, _blocks, prefix, _samp in lanes:
            self._charge(self._prefill_cost_us(len(toks)))
            out.append(
                int(self._det_next(toks[-1], prefix + len(toks)))
                if self.sim.deterministic_tokens and toks
                else self._rand_token()
            )
        return out

    def decode(self, token_ids, positions, block_tables, context_lens,
               slot_mapping, temp, top_k, top_p, seed=None) -> np.ndarray:
        self._charge(self._weight_pass_us(self.sim.decode_time_per_step_us))
        if self.sim.deterministic_tokens:
            return self._det_next(
                np.asarray(token_ids), np.asarray(positions) + 1
            ).astype(np.int32)
        return self._rng.integers(0, self.sim.vocab_size, len(token_ids)).astype(np.int32)

    def decode_multi(self, token_ids, positions, block_tables, context_lens,
                     temp, top_k, top_p, num_steps: int, seed=None) -> np.ndarray:
        active = int(np.sum(np.asarray(context_lens) > 0))
        ctx_total = float(np.sum(np.maximum(np.asarray(context_lens), 0)))
        kv_us = sum(self._kv_read_us(ctx_total + active * s) for s in range(num_steps))
        self._charge((self._weight_pass_us(self.sim.decode_time_per_step_us)
                      + self.sim.decode_time_per_lane_us * len(token_ids))
                     * num_steps + kv_us)
        if self.sim.deterministic_tokens:
            prev = np.asarray(token_ids, np.int64)
            pos = np.asarray(positions, np.int64)
            out = np.zeros((num_steps, len(prev)), np.int32)
            for s in range(num_steps):
                prev = self._det_next(prev, pos + 1 + s)
                out[s] = prev.astype(np.int32)
            return out
        return self._rng.integers(
            0, self.sim.vocab_size, (num_steps, len(token_ids))
        ).astype(np.int32)

    # -- the unified step -----------------------------------------------------
    def unified_step(self, lanes, feed=None, draft_lens=None, extras=None,
                     mm=None) -> _SimOut:
        """Sim twin of ModelRunner.unified_step: one mixed dispatch priced
        per phase (weight pass + each decode lane's KV read + the prefill
        tokens, draft rows priced as prefill tokens), counted on the
        budget ladder as the runner counts its programs. Under
        ``deterministic_tokens`` a verify span accepts exactly the drafts
        that match the closed-form chain, so the delivered tokens are the
        chain whatever the drafts were. An ``mm`` dispatch is the
        unified_mm program at the top rung, priced as the extras one."""
        cfg = self.cfg
        dls = list(draft_lens) if draft_lens else [0] * len(lanes)
        dls += [0] * (len(lanes) - len(dls))
        total = sum(len(t) for t, _, _, _ in lanes)
        drafted = sum(dls)
        decode = [
            (t, prefix) for (t, _, prefix, _), dl in zip(lanes, dls)
            if len(t) - dl == 1
        ]
        prefill_tokens = total - len(decode) - drafted
        decode_ctx = sum(prefix + len(t) for t, prefix in decode)
        if mm is not None and any(mm):
            kind, T = "unified_mm", _bucket(cfg.unified_token_budget)
        elif extras is not None:
            kind, T = "unified_full", _bucket(cfg.unified_token_budget)
        else:
            kind, T = "unified", token_budget(total, cfg.unified_token_budget)
        greedy = all(s[0] <= 0 for _, _, _, s in lanes)
        self._make_program(kind, T, greedy)
        self.compile_stats.record_serving(kind, T)
        self._charge(self._weight_pass_us(self.sim.decode_time_per_step_us)
                     + self.sim.decode_time_per_lane_us * len(decode)
                     + self._kv_read_us(decode_ctx)
                     + self._prefill_cost_us(prefill_tokens + drafted))
        S = self.unified_slots
        K = max(1, cfg.speculative_k)
        last = np.zeros(S, np.int32)
        toks2d = np.zeros((S, K + 1), np.int32)
        counts = np.zeros(S, np.int32)
        if feed is not None:
            prev_toks, prev_row, use_prev = feed
        for i, (toks, _blocks, prefix, _samp) in enumerate(lanes):
            dl = dls[i]
            if not toks:
                continue
            fed_last = toks[-1 - dl] if dl else toks[-1]
            if feed is not None and bool(use_prev[i]):
                # The feed replaces a decode span's token with the previous
                # dispatch's sample for that sequence.
                fed_last = int(np.asarray(prev_toks)[int(prev_row[i])])
            if not self.sim.deterministic_tokens:
                last[i] = toks2d[i, 0] = self._rand_token()
                counts[i] = 1
                continue
            base_pos = prefix + len(toks) - dl  # index of the next token
            acc = 0
            prev = fed_last
            for j in range(dl):
                want = int(self._det_next(prev, base_pos + j))
                if toks[len(toks) - dl + j] != want:
                    break
                acc += 1
                prev = want
            delivered = []
            prev = fed_last
            for j in range(acc + 1):
                prev = int(self._det_next(prev, base_pos + j))
                delivered.append(prev)
            counts[i] = len(delivered)
            toks2d[i, : len(delivered)] = delivered
            last[i] = delivered[-1]
        if extras is not None:
            lp = (np.full(S, -0.5, np.float32),
                  np.tile(last[:, None], (1, _SIM_LOGPROBS)).astype(np.int32),
                  np.full((S, _SIM_LOGPROBS), -0.5, np.float32))
            return _SimOut(last, None, None, lp)
        if cfg.speculative_k > 0:
            return _SimOut(last, toks2d, counts, None)
        return _SimOut(last, None, None, None)


class MockerEngine(TorchEngine):
    """TorchEngine with a simulated runner — the fleet testbed. Runs on
    no device (``device`` defaults to the CPU and nothing is placed on
    it). The co-location controller, per-phase admission, the flight
    recorder and the tracer are the engine's own."""

    def __init__(self, cfg: EngineConfig, sim: MockerConfig | None = None,
                 **kwargs) -> None:
        kwargs.setdefault("device", "cpu")
        super().__init__(cfg, **kwargs)
        self._sim = sim or MockerConfig()

    def _build_runner(self) -> None:
        self.runner = _SimRunner(self.cfg, self._sim)
        self._clock = self.runner.charged_clock
