"""ModelRunner: device state, the unified step and the phase-split
entry points (port of dynamo_tpu/engine/runner.py: the plain ``unified``
variant, ``prefill``, ``prefill_batch``, ``decode``, ``decode_multi``).

Owns the params and the paged KV cache on the device. ``unified_step``
runs ONE ragged dispatch mixing decode lanes and chunked-prefill quanta
in a flat token batch, with sampling in the same step, so only the
sampled token ids leave the device. The KV cache is allocated at the
model's TRUE head dim (the TPU package pads it to 128 lanes for its
kernels; the CUDA kernels need no padding) and updated in place. With
``kv_quant="int8"`` it holds int8 blocks and the runner keeps their
per-(layer, K/V, block, kv head) scales as state beside it.

The phase-split entry points run the prefill and decode kernels; the
serving engine does not use them (it serves through ``unified_step``),
they serve parity tests, bring-up tools and the parallel slice. Like the
reference's phase programs they read the cache in its compute dtype, so
they refuse an int8 cache.

Not in this slice: the spec/extras/multimodal program variants, weight
quantization, meshes, and block IO for KVBM/disagg (ROADMAP queue A).
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from dynamo_tpu_torch import resolve_device
from dynamo_tpu_torch.engine.compile_cache import _bucket, token_budget
from dynamo_tpu_torch.engine.config import EngineConfig
from dynamo_tpu_torch.models import llama
from dynamo_tpu_torch.ops.sampling import sample_tokens, token_logprobs


class UnifiedOut:
    """One unified dispatch's outputs. ``last`` [S] int32 stays on the
    device — span s's sampled token, the next dispatch's device feed. A
    copy to host memory is enqueued behind the step; ``ready()`` polls
    it and ``tokens()`` waits for it."""

    def __init__(self, last: torch.Tensor, host: torch.Tensor, event) -> None:
        self.last = last
        self._host = host
        self._event = event

    def ready(self) -> bool:
        return self._event is None or self._event.query()

    def tokens(self) -> np.ndarray:
        if self._event is not None:
            self._event.synchronize()
        return self._host.numpy()


def _params_to(params: Any, device: torch.device, dtype: torch.dtype):
    if isinstance(params, dict):
        return {k: _params_to(v, device, dtype) for k, v in params.items()}
    if isinstance(params, list):
        return [_params_to(v, device, dtype) for v in params]
    return params.to(device=device, dtype=dtype)


class ModelRunner:
    def __init__(
        self,
        cfg: EngineConfig,
        params=None,
        device: str | torch.device | None = None,
        rng_seed: int = 0,
    ) -> None:
        self.cfg = cfg
        m = cfg.model
        self.device = resolve_device(device)
        self.dtype = cfg.torch_dtype
        if params is None:
            g = torch.Generator(device=self.device)
            g.manual_seed(rng_seed)
            params = llama.init_params(m, g, dtype=self.dtype, device=self.device)
        else:
            params = _params_to(params, self.device, self.dtype)
        self.params = params
        # KV storage dtype: int8 blocks + f32 scales under kv_quant; the
        # compute (activations, q, dequantized pages) stays in `dtype`.
        self.kv_quant = cfg.kv_quant
        self.kv_dtype = torch.int8 if cfg.kv_quant == "int8" else self.dtype
        kv_shape = (cfg.num_blocks * cfg.block_size, m.num_kv_heads, m.head_dim)
        self.kv_caches = [
            (
                torch.zeros(kv_shape, dtype=self.kv_dtype, device=self.device),
                torch.zeros(kv_shape, dtype=self.kv_dtype, device=self.device),
            )
            for _ in range(m.num_layers)
        ]
        # Per-(layer, K/V, block, head) scales; zero = empty block (the
        # write law resets a block's scale when its first slot is written).
        self.kv_scales = None
        if cfg.kv_quant == "int8":
            self.kv_scales = torch.zeros(
                (m.num_layers, 2, cfg.num_blocks, m.num_kv_heads),
                dtype=torch.float32, device=self.device,
            )
        self.last_logprobs = None
        self._step = 0

    @property
    def unified_slots(self) -> int:
        """Metadata rows per unified dispatch: every decode slot plus
        every concurrently-prefilling sequence can own a span."""
        return self.cfg.max_num_seqs + self.cfg.prefill_batch

    def _next_key(self) -> tuple[int, int]:
        """Per-step sampling stream key (engine seed, step counter);
        seeded lanes never consume it (ops/sampling.py lane_keys)."""
        self._step += 1
        return self.cfg.seed & 0xFFFFFFFF, self._step & 0xFFFFFFFF

    def _to_device(self, arr: np.ndarray) -> torch.Tensor:
        """One host→device copy; staged through pinned memory on CUDA so
        the copy is asynchronous (the caching host allocator keeps the
        staging buffer alive until the copy has run)."""
        if self.device.type != "cuda":
            return torch.from_numpy(arr)
        staged = torch.empty(arr.shape, dtype=torch.from_numpy(arr).dtype,
                             pin_memory=True)
        staged.numpy()[...] = arr
        return staged.to(self.device, non_blocking=True)

    def unified_step(
        self,
        lanes: list[tuple[list[int], list[int], int, tuple]],
        feed: tuple | None = None,
    ) -> UnifiedOut:
        """ONE ragged dispatch for a mixed prefill+decode batch.

        ``lanes``: [(new_tokens, block_ids, prefix_len, sampling), ...] —
        span s of the flat batch is lane s's tokens; a decode lane is a
        single token, a prefill quantum its chunk. Total tokens snap UP to
        the budget ladder (compile_cache.token_budget).

        ``feed``: optional (prev_toks [S] device tensor, prev_row [S],
        use_prev [S]) — decode lanes whose token was sampled by the
        previous dispatch read it on the DEVICE from its old metadata row
        instead of a host round trip."""
        cfg = self.cfg
        S = self.unified_slots
        MB = cfg.max_blocks_per_seq
        if len(lanes) > S:
            raise ValueError(f"{len(lanes)} lanes > {S} metadata rows")
        total = sum(len(t) for t, _, _, _ in lanes)
        T = token_budget(total, cfg.unified_token_budget)
        if total > T:
            raise ValueError(
                f"{total} tokens exceed the unified budget "
                f"{cfg.unified_token_budget}"
            )

        # All int32 metadata in ONE buffer, one host→device copy.
        sizes = [("token_ids", T), ("token_pos", T), ("slot_mapping", T),
                 ("token_seq", T), ("block_tables", S * MB), ("q_start", S),
                 ("q_len", S), ("kv_len", S), ("row_start", S),
                 ("top_k", S), ("seed", S), ("prev_row", S), ("use_prev", S)]
        meta = np.zeros(sum(n for _, n in sizes), np.int32)
        view, o = {}, 0
        for name, n in sizes:
            view[name] = meta[o:o + n]
            o += n
        view["token_pos"][:] = -1                  # -1 = padding row
        view["seed"][:] = -1                       # -1 = unseeded
        block_tables = view["block_tables"].reshape(S, MB)
        fmeta = np.zeros(2 * S, np.float32)        # temperature, top_p
        temp, top_p = fmeta[:S], fmeta[S:]
        top_p[:] = 1.0
        bs = cfg.block_size
        cursor = 0
        for s, (new_tokens, block_ids, prefix, sampling) in enumerate(lanes):
            n = len(new_tokens)
            pos = np.arange(prefix, prefix + n)
            rows = slice(cursor, cursor + n)
            view["row_start"][s] = cursor
            view["q_start"][s] = prefix
            view["q_len"][s] = n
            view["kv_len"][s] = prefix + n
            block_tables[s, : len(block_ids)] = block_ids
            view["token_ids"][rows] = new_tokens
            view["token_pos"][rows] = pos
            view["token_seq"][rows] = s
            view["slot_mapping"][rows] = block_tables[s, pos // bs] * bs + pos % bs
            # (temperature, top_k, top_p, seed); seed -1 = unseeded
            temp[s], view["top_k"][s], top_p[s], view["seed"][s] = sampling
            cursor += n
        prev_toks = None
        if feed is not None:
            prev_toks, prev_row, use_prev = feed
            view["prev_row"][:] = prev_row
            view["use_prev"][:] = use_prev
        all_greedy = bool((temp <= 0.0).all())

        dmeta = self._to_device(meta)
        dfloat = self._to_device(fmeta)
        d, o = {}, 0
        for name, n in sizes:
            d[name] = dmeta[o:o + n]
            o += n
        d_tables = d["block_tables"].view(S, MB)
        token_ids = d["token_ids"]
        if prev_toks is not None and isinstance(prev_toks, torch.Tensor):
            token_ids = _feed_tokens(
                token_ids, d["row_start"], d["use_prev"], d["prev_row"],
                prev_toks,
            )
        logits = llama.unified(
            cfg.model, self.params, self.kv_caches, token_ids, d["token_pos"],
            d["slot_mapping"], d["token_seq"], d_tables, d["q_start"],
            d["q_len"], d["kv_len"], d["row_start"], cfg.block_size,
            kv_scales=self.kv_scales,
        )
        if self.kv_scales is not None:
            logits, self.kv_scales = logits
        toks = sample_tokens(
            logits, self._next_key(), dfloat[:S], d["top_k"], dfloat[S:],
            seed=d["seed"], sample_pos=d["kv_len"], all_greedy=all_greedy,
        )
        toks = torch.where(d["q_len"] > 0, toks, 0).to(torch.int32)
        if self.device.type != "cuda":
            return UnifiedOut(toks, toks, None)
        host = torch.empty(S, dtype=torch.int32, pin_memory=True)
        host.copy_(toks, non_blocking=True)
        event = torch.cuda.Event()
        event.record()
        return UnifiedOut(toks, host, event)

    # -- phase-split entry points ---------------------------------------------
    def _phase_program(self, name: str) -> None:
        if self.kv_quant:
            raise ValueError(
                f"{name} reads the KV cache in its compute dtype and does "
                f"not serve kv_quant={self.kv_quant!r}: an int8 cache is "
                "served by unified_step only (as in the reference)"
            )

    def _pad_table(self, block_ids: list[int]) -> np.ndarray:
        table = np.zeros(self.cfg.max_blocks_per_seq, np.int32)
        table[: len(block_ids)] = block_ids
        return table

    def slot_of(self, block_ids: list[int], position: int) -> int:
        bs = self.cfg.block_size
        return block_ids[position // bs] * bs + position % bs

    def _sampler(self, temp, top_k, top_p, seed=None):
        """``sample(logits, sample_pos) -> [B] tokens`` over per-lane host
        sampling arrays, copied to the device once; each call takes the
        next step key. Whether every lane is greedy is known on the host,
        so sampling never syncs."""
        temp = np.asarray(temp, np.float32)
        if seed is None:
            seed = np.full(len(temp), -1, np.int32)
        args = [self._to_device(np.asarray(a, dt)) for a, dt in (
            (temp, np.float32), (top_k, np.int32), (top_p, np.float32),
            (seed, np.int32),
        )]
        greedy = bool((temp <= 0.0).all())

        def sample(logits, sample_pos):
            return sample_tokens(
                logits, self._next_key(), *args[:3], seed=args[3],
                sample_pos=sample_pos, all_greedy=greedy,
            )

        return sample

    def prefill(
        self,
        new_tokens: list[int],
        block_ids: list[int],
        prefix_len: int,
        sampling: tuple,
    ) -> int:
        """Run one sequence's prefill (the suffix after any prefix-cache
        hit); returns the first sampled token. ``sampling`` is (temp,
        top_k, top_p[, seed]); ``last_logprobs`` holds its logprobs."""
        self._phase_program("prefill")
        T = _bucket(len(new_tokens))
        if T > _bucket(max(1, self.cfg.prefill_chunk)):
            raise ValueError(
                f"prefill chunk of {len(new_tokens)} tokens exceeds "
                f"prefill_chunk={self.cfg.prefill_chunk}; feed the prompt "
                f"in chunks of at most prefill_chunk tokens"
            )
        token_ids = np.zeros(T, np.int32)
        token_ids[: len(new_tokens)] = new_tokens
        slot_mapping = np.zeros(T, np.int32)  # padding → trash block 0
        for i in range(len(new_tokens)):
            slot_mapping[i] = self.slot_of(block_ids, prefix_len + i)
        lens = np.array([prefix_len, prefix_len + len(new_tokens)], np.int32)
        dlens = self._to_device(lens)
        logits = llama.prefill(
            self.cfg.model, self.params, self.kv_caches,
            self._to_device(token_ids),
            self._to_device(self._pad_table(block_ids)),
            self._to_device(slot_mapping), dlens[0], dlens[1],
            self.cfg.block_size,
        )[None]
        sample = self._sampler(*([x] for x in _norm_sampling(sampling)))
        tok = sample(logits, dlens[1:])
        self.last_logprobs = token_logprobs(logits, tok)
        return int(tok[0])

    def prefill_batch(
        self, lanes: list[tuple[list[int], list[int], int, tuple]]
    ) -> list[int]:
        """Fused prefill of N lanes: [(new_tokens, block_ids, prefix_len,
        sampling), ...]. Returns one sampled token per lane. The lane
        count snaps UP to a power-of-two bucket (at least 2) and T to ONE
        shared bucket, as in the reference."""
        self._phase_program("prefill_batch")
        n_real = len(lanes)
        N = _bucket(max(n_real, 1), minimum=2)
        T = _bucket(max(len(t) for t, _, _, _ in lanes))
        token_ids = np.zeros((N, T), np.int32)
        block_tables = np.zeros((N, self.cfg.max_blocks_per_seq), np.int32)
        slot_mapping = np.zeros((N, T), np.int32)  # padding → trash block 0
        lens = np.zeros((2, N), np.int32)          # prefix_len, total_len
        for i, (new_tokens, block_ids, prefix, _) in enumerate(lanes):
            token_ids[i, : len(new_tokens)] = new_tokens
            block_tables[i, : len(block_ids)] = block_ids
            for j in range(len(new_tokens)):
                slot_mapping[i, j] = self.slot_of(block_ids, prefix + j)
            lens[:, i] = prefix, prefix + len(new_tokens)
        samp = [_norm_sampling(s) for *_, s in lanes]
        samp += [(0.0, 0, 1.0, -1)] * (N - n_real)  # idle lanes: greedy
        dlens = self._to_device(lens)
        logits = llama.prefill_batch(
            self.cfg.model, self.params, self.kv_caches,
            self._to_device(token_ids), self._to_device(block_tables),
            self._to_device(slot_mapping), dlens[0], dlens[1],
            self.cfg.block_size,
        )
        toks = self._sampler(*zip(*samp))(logits, dlens[1])
        self.last_logprobs = token_logprobs(logits, toks)
        return toks[:n_real].tolist()

    def decode(
        self,
        token_ids: np.ndarray,      # [B] int32
        positions: np.ndarray,      # [B] int32
        block_tables: np.ndarray,   # [B, max_blocks] int32
        context_lens: np.ndarray,   # [B] int32 (0 = inactive)
        slot_mapping: np.ndarray,   # [B] int32
        temp: np.ndarray,
        top_k: np.ndarray,
        top_p: np.ndarray,
        seed: np.ndarray | None = None,
    ) -> np.ndarray:
        """One decode step for the batch; returns the sampled tokens [B]."""
        self._phase_program("decode")
        ctx = self._to_device(np.asarray(context_lens, np.int32))
        logits = llama.decode(
            self.cfg.model, self.params, self.kv_caches,
            self._to_device(np.asarray(token_ids, np.int32)),
            self._to_device(np.asarray(positions, np.int32)),
            self._to_device(np.asarray(block_tables, np.int32)), ctx,
            self._to_device(np.asarray(slot_mapping, np.int32)),
            self.cfg.block_size,
        )
        return self._sampler(temp, top_k, top_p, seed)(logits, ctx).cpu().numpy()

    def decode_multi(
        self,
        token_ids: np.ndarray,      # [B]
        positions: np.ndarray,      # [B]
        block_tables: np.ndarray,   # [B, max_blocks]
        context_lens: np.ndarray,   # [B] (0 = inactive)
        temp: np.ndarray,
        top_k: np.ndarray,
        top_p: np.ndarray,
        num_steps: int,
        seed: np.ndarray | None = None,
    ) -> np.ndarray:
        """``num_steps`` decode steps issued back to back on the device:
        each step's token, slot and positions are computed there from the
        last, so nothing is read back inside the loop; one copy returns
        the tokens [num_steps, B]. Callers must have pre-grown block
        tables to cover position + num_steps - 1. Each step samples with
        its own key from the runner's counter (the reference folds the
        step index into one key)."""
        self._phase_program("decode_multi")
        B = len(positions)
        bs = self.cfg.block_size
        tables = self._to_device(np.asarray(block_tables, np.int32))
        tok = self._to_device(np.asarray(token_ids, np.int32))
        pos = self._to_device(np.asarray(positions, np.int32))
        ctx = self._to_device(np.asarray(context_lens, np.int32))
        sample = self._sampler(temp, top_k, top_p, seed)
        rows = torch.arange(B, device=self.device)
        last_col = tables.shape[1] - 1
        out = []
        for _ in range(num_steps):
            active = ctx > 0
            p = torch.clamp(pos, min=0)
            col = torch.clamp(p // bs, max=last_col).long()
            slot = torch.where(active, tables[rows, col] * bs + p % bs, 0)
            logits = llama.decode(
                self.cfg.model, self.params, self.kv_caches, tok, pos,
                tables, ctx, slot, bs,
            )
            tok = torch.where(active, sample(logits, ctx), 0).to(torch.int32)
            out.append(tok)
            inc = active.to(torch.int32)
            pos, ctx = pos + inc, ctx + inc
        return torch.stack(out).cpu().numpy()


def _norm_sampling(sampling) -> tuple[float, int, float, int]:
    """Accept both (temp, top_k, top_p) and (temp, top_k, top_p, seed)
    lane-sampling tuples; seed -1 = unseeded."""
    if len(sampling) == 3:
        t, k, p = sampling
        return t, k, p, -1
    return tuple(sampling)


def _feed_tokens(token_ids, row_start, use_prev, prev_row, prev_toks):
    """Substitute ONLY the feeding lanes' rows: idle lanes share
    row_start 0, so a plain scatter would let a stale placeholder clobber
    a real lane's token. Non-feeding lanes aim at an extra row past the
    batch, which is dropped."""
    T = token_ids.shape[0]
    rows = torch.where(use_prev > 0, row_start, T).long()
    ext = torch.cat([token_ids, token_ids.new_zeros(1)])
    ext[rows] = prev_toks[prev_row.long()].to(ext.dtype)
    return ext[:T]
