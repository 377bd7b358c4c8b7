"""ModelRunner: device state + the unified step (port of the plain
``unified`` variant of dynamo_tpu/engine/runner.py).

Owns the params and the paged KV cache on the device. ``unified_step``
runs ONE ragged dispatch mixing decode lanes and chunked-prefill quanta
in a flat token batch, with sampling in the same step, so only the
sampled token ids leave the device. The KV cache is allocated at the
model's TRUE head dim (the TPU package pads it to 128 lanes for its
kernels; the CUDA kernel needs no padding) and updated in place.

Not in this slice: the spec/extras/multimodal program variants, weight
and KV quantization, meshes, and block IO for KVBM/disagg (ROADMAP
queue A).
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from dynamo_tpu_torch import resolve_device
from dynamo_tpu_torch.engine.compile_cache import token_budget
from dynamo_tpu_torch.engine.config import EngineConfig
from dynamo_tpu_torch.models import llama
from dynamo_tpu_torch.ops.sampling import sample_tokens


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
        kv_shape = (cfg.num_blocks * cfg.block_size, m.num_kv_heads, m.head_dim)
        self.kv_caches = [
            (
                torch.zeros(kv_shape, dtype=self.dtype, device=self.device),
                torch.zeros(kv_shape, dtype=self.dtype, device=self.device),
            )
            for _ in range(m.num_layers)
        ]
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
        )
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
