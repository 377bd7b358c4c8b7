"""ModelRunner: device state, the unified step's program family and the
phase-split entry points (port of dynamo_tpu/engine/runner.py: the
``unified``, spec-verify, ``unified_full`` and ``unified_mm`` variants,
their warmup, ``prefill``, ``prefill_batch``, ``decode``,
``decode_multi``).

Owns the params and the paged KV cache on the device. ``unified_step``
runs ONE ragged dispatch mixing decode lanes, chunked-prefill quanta and
speculative draft-verify spans in a flat token batch, with sampling in
the same step, so only the sampled token ids leave the device. The KV
cache is allocated at the model's TRUE head dim (the TPU package pads it
to 128 lanes for its kernels; the CUDA kernels need no padding) and
updated in place. With ``kv_quant="int8"`` it holds int8 blocks and the
runner keeps their per-(layer, K/V, block, kv head) scales beside it.

The step's program family, one program per (variant, budget rung,
greedy | sampled):

- **unified** on every rung of the budget ladder. On a speculative
  engine (``speculative_k > 0``) the same ladder is the spec-verify
  program: per-span verify logits, the greedy accept-prefix law and the
  bonus sample all run inside it.
- **unified_full**, one program at the top rung: frequency/presence
  penalties over the per-slot ``[max_num_seqs, vocab]`` count buffer,
  with logprob outputs. Taken only by batches that need it.
- **unified_mm**, one program at the top rung on a multimodal engine
  (``cfg.multimodal``): the ``unified_full`` program plus the soft-prompt
  splice (models/llama.py ``embeds``), so mm and extras lanes co-batch.
  Taken by every dispatch whose prefill quanta carry image rows.

Every per-dispatch input lives in static buffers, one set per (variant,
rung): one int32 block holding the metadata, the sampling parameters
(floats viewed in place), the step's sampling key, drafts and extras
rows, plus the feed buffer the previous dispatch's tokens are copied
into; ``unified_mm`` adds a float32 ``[T, D]`` embeddings buffer (its
row mask rides in the int32 block). The host fills pinned staging
copies and enqueues one copy into each before a dispatch. On the card
each program is a CUDA graph of the step body (``_body``) captured over
those buffers, and every
dispatch replays one: ``warmup`` captures the plan of
engine/compile_cache.py ahead of traffic, after an eager warm pass of the
body that writes only trash block 0 (so lazy kernel setup happens outside
the capture); a program not captured yet is captured at its first use and
counted as a mid-traffic compile. A capture that fails raises. The eager
body is what the CPU runs, what the warm pass runs, and what
``unified_step_eager`` runs for comparison with the replays.

The phase-split entry points run the prefill and decode kernels; the
serving engine does not use them (it serves through ``unified_step``),
they serve parity tests, bring-up tools and the parallel slice. Like the
reference's phase programs they read the cache in its compute dtype, so
they refuse an int8 cache.

Block IO (the KVBM tiers and disaggregation): batched gathers and
in-place scatters of whole blocks and their int8 scale rows
(ops/kv_copy.py), on the engine thread's stream, so a gather follows the
step that wrote its blocks and a scatter precedes the replay that reads
them. Host block bytes are numpy: bfloat16 as its uint16 bit pattern.

Weight quantization (``cfg.weight_quant`` or the legacy ``cfg.quant``)
lives in the params tree: quantized sites hold ``{"q", "s"}`` dicts and
every product of the step body dispatches on the value (ops/quant.py;
the card's arm is the wq_gemm kernel), so warmup captures the same
programs with or without it.

Not in this port yet: meshes (ROADMAP queue A).
"""

from __future__ import annotations

import contextlib
import gc
import threading
from typing import Any

import numpy as np
import torch

from dynamo_tpu_torch import resolve_device
from dynamo_tpu_torch.engine.compile_cache import (
    CompileStats,
    WarmupPlanMixin,
    _bucket,
    graph_key,
    token_budget,
)
from dynamo_tpu_torch.engine.config import EngineConfig
from dynamo_tpu_torch.models import llama
from dynamo_tpu_torch.ops import kernels, kv_copy
from dynamo_tpu_torch.ops.quant import is_quantized, quant_tree_stats, quantize_params_policy
from dynamo_tpu_torch.ops.sampling import (
    apply_penalties,
    sample_tokens,
    token_logprobs,
)


class UnifiedOut:
    """One unified dispatch's outputs. ``last`` [S] int32 stays on the
    device — span s's (final) sampled token, the next dispatch's device
    feed; on the card it is the program's output buffer, which its next
    replay overwrites, so its reader (the next dispatch's feed copy) is
    enqueued before that. A copy of every output to host memory is
    enqueued behind the step; ``ready()`` polls it, the readers wait for
    it. ``spec()`` gives the spec contract (emitted [S, K+1], counts
    [S]) on a speculative engine's ladder, ``logprobs()`` the extras
    variant's (chosen [S], top ids [S, MAX_LOGPROBS], top logprobs)."""

    def __init__(self, last, ints, floats, event, spec_k: int) -> None:
        self.last = last
        self._ints = ints
        self._floats = floats
        self._event = event
        self._spec_k = spec_k
        self._S = last.shape[0]

    def ready(self) -> bool:
        return self._event is None or self._event.query()

    def _wait(self) -> None:
        if self._event is not None:
            self._event.synchronize()

    def tokens(self) -> np.ndarray:
        self._wait()
        return self._ints[: self._S].numpy()

    def spec(self) -> tuple[np.ndarray, np.ndarray] | None:
        if not self._spec_k:
            return None
        self._wait()
        S, R = self._S, self._spec_k + 1
        ints = self._ints.numpy()
        return ints[S : S + S * R].reshape(S, R), ints[S + S * R : S + S * R + S]

    def logprobs(self) -> tuple[np.ndarray, np.ndarray, np.ndarray] | None:
        if self._floats is None:
            return None
        self._wait()
        S = self._S
        floats = self._floats.numpy()
        ids = self._ints.numpy()[S:].reshape(S, -1)
        return floats[:S], ids, floats[S:].reshape(S, -1)


def _params_to(params: Any, device: torch.device, dtype: torch.dtype):
    if is_quantized(params):
        # int8/e4m3 data keeps its storage dtype; the scales take the model's.
        return {"q": params["q"].to(device=device),
                "s": params["s"].to(device=device, dtype=dtype)}
    if isinstance(params, dict):
        return {k: _params_to(v, device, torch.float32 if k in llama.FLOAT32_KEYS else dtype)
                for k, v in params.items()}
    if isinstance(params, list):
        return [_params_to(v, device, dtype) for v in params]
    return params.to(device=device, dtype=dtype)


def _unified_warm_lanes(
    t: int, max_lanes: int, max_model_len: int, trash_table, sampling,
) -> list[tuple]:
    """Spans that fill a warm dispatch to exactly budget ``t``, split into
    model-length-bounded spans across the metadata rows; every write
    lands in trash block 0. [] when S spans cannot fill the rung (it is
    unreachable at run time too)."""
    lanes = []
    remaining = t
    while remaining > 0 and len(lanes) < max_lanes:
        n = min(remaining, max_model_len - 1)
        lanes.append(([1] * n, trash_table, 0, sampling))
        remaining -= n
    if remaining > 0:
        return []
    return lanes


class _StepBuffers:
    """The static inputs of one (variant, rung) program: ONE int32 block
    (metadata, sampling rows with the floats viewed in place, the key,
    drafts, extras rows, the mm row mask), copied from the host once per
    dispatch, the feed buffer ``prev`` the previous dispatch's tokens are
    copied into on the device, and for ``unified_mm`` the float32
    soft-prompt rows ``embeds`` [T, D], copied in once per dispatch."""

    def __init__(self, kind: str, T: int, S: int, MB: int, K: int,
                 device: torch.device, hidden: int = 0) -> None:
        ints = [("token_ids", T), ("token_pos", T), ("slot_mapping", T),
                ("token_seq", T), ("block_tables", S * MB), ("q_start", S),
                ("q_len", S), ("kv_len", S), ("row_start", S), ("top_k", S),
                ("seed", S), ("prev_row", S), ("use_prev", S), ("key", 2)]
        floats = [("temp", S), ("top_p", S)]
        if kind == "unified" and K:
            ints += [("draft_len", S), ("drafts", S * K)]
        if kind in ("unified_full", "unified_mm"):
            ints += [("span_slot", S), ("counts_add", S), ("reset", S)]
            floats += [("freq", S), ("pres", S)]
        if kind == "unified_mm":
            ints += [("embed_mask", T)]
        self.kind, self.T, self.S, self.MB, self.K = kind, T, S, MB, K
        self.fields: dict[str, tuple[int, int, bool]] = {}
        o = 0
        for group, is_float in ((ints, False), (floats, True)):
            for name, n in group:
                self.fields[name] = (o, n, is_float)
                o += n
        self.size = o
        self.block = torch.zeros(o, dtype=torch.int32, device=device)
        self.prev = torch.zeros(S, dtype=torch.int32, device=device)
        self.dev = self._views(self.block)
        self.embeds = None
        if kind == "unified_mm":
            self.embeds = torch.zeros((T, hidden), dtype=torch.float32, device=device)

    def _views(self, block) -> dict:
        """Named views into an int32 block (a tensor or its numpy twin),
        the float rows viewed as float32 in place."""
        f32 = torch.float32 if isinstance(block, torch.Tensor) else np.float32
        return {name: block[o:o + n].view(f32) if is_float else block[o:o + n]
                for name, (o, n, is_float) in self.fields.items()}

    def host(self, pinned: bool) -> tuple[torch.Tensor, dict]:
        """A zeroed staging block and its numpy views, with the padding
        defaults: position -1, unseeded, top_p 1, no count-buffer slot."""
        staged = torch.zeros(self.size, dtype=torch.int32, pin_memory=pinned)
        view = self._views(staged.numpy())
        view["token_pos"][:] = -1
        view["seed"][:] = -1
        view["top_p"][:] = 1.0
        if "span_slot" in view:
            view["span_slot"][:] = -1
        return staged, view

    def host_embeds(self, pinned: bool) -> torch.Tensor | None:
        """A zeroed staging copy of ``embeds`` (None without one)."""
        if self.embeds is None:
            return None
        return torch.zeros(self.embeds.shape, dtype=torch.float32, pin_memory=pinned)


# The cycle collector is held off while any runner captures a graph: a
# collection mid-capture, in the capturing thread or another, can destroy
# a dead engine's CUDA graphs inside the capture, which invalidates it.
_GC_HOLD = {"count": 0, "was_enabled": True}
_GC_LOCK = threading.Lock()


@contextlib.contextmanager
def gc_held():
    """Automatic garbage collection off until the last concurrent holder
    leaves, then back to what it was."""
    with _GC_LOCK:
        if _GC_HOLD["count"] == 0:
            _GC_HOLD["was_enabled"] = gc.isenabled()
            gc.disable()
        _GC_HOLD["count"] += 1
    try:
        yield
    finally:
        with _GC_LOCK:
            _GC_HOLD["count"] -= 1
            if _GC_HOLD["count"] == 0 and _GC_HOLD["was_enabled"]:
                gc.enable()


class _Program:
    """One step program: on the card its CUDA graph, the output buffers
    the graph writes, and the kernel launches it makes per replay."""

    def __init__(self, graph=None, outs=None, launches=None) -> None:
        self.graph = graph
        self.outs = outs
        self.launches = launches or {}


class ModelRunner(WarmupPlanMixin):
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
        # Weight quantization: random weights quantize as they are drawn,
        # a given tree site by site (weights a loader already quantized
        # are kept). The step body dispatches on each weight's value, so
        # the program set is the same with or without a policy.
        policy = cfg.weight_policy()
        if params is None:
            g = torch.Generator(device=self.device)
            g.manual_seed(rng_seed)
            params = llama.init_params(m, g, dtype=self.dtype, device=self.device,
                                       policy=policy)
        else:
            params = _params_to(params, self.device, self.dtype)
            if policy is not None:
                params = quantize_params_policy(params, policy, tie_embed=m.tie_word_embeddings)
        self.params = params
        # The weight-quant gauges: whether a per-matmul policy is armed,
        # the resident bytes saved against the tree in `dtype`, and the
        # quantized fraction of the parameters (shapes and dtypes only).
        self.weight_quant_active = 1.0 if cfg.weight_quant and policy is not None else 0.0
        self.weight_quant_bytes_saved = 0.0
        self.weight_quant_density = 0.0
        if policy is not None:
            saved, density = quant_tree_stats(params, self.dtype.itemsize)
            self.weight_quant_bytes_saved = float(saved)
            self.weight_quant_density = float(density)
        # KV storage dtype: int8 blocks + f32 scales under kv_quant; the
        # compute (activations, q, dequantized pages) stays in `dtype`.
        self.kv_quant = cfg.kv_quant
        self.kv_dtype = torch.int8 if cfg.kv_quant == "int8" else self.dtype
        # MLA caches one shared [latent ‖ k_pe] entry per token: 1 head of
        # kv_lora_rank + qk_rope_head_dim.
        kv_shape = (cfg.num_blocks * cfg.block_size, m.num_cache_heads,
                    m.kv_cache_head_dim)
        self.kv_caches = [
            (
                torch.zeros(kv_shape, dtype=self.kv_dtype, device=self.device),
                torch.zeros(kv_shape, dtype=self.kv_dtype, device=self.device),
            )
            for _ in range(m.num_layers)
        ]
        # Per-(layer, K/V, block, head) scales; zero = empty block (the
        # write law resets a block's scale when its first slot is
        # written). Updated IN PLACE by the step body, so every captured
        # graph reads and writes the same storage.
        self.kv_scales = None
        if cfg.kv_quant == "int8":
            self.kv_scales = torch.zeros(
                (m.num_layers, 2, cfg.num_blocks, m.num_cache_heads),
                dtype=torch.float32, device=self.device,
            )
        self.last_logprobs = None
        self._step = 0
        self.compile_stats = CompileStats()
        self._buffers: dict[tuple[str, int], _StepBuffers] = {}
        self._programs: dict[str, _Program] = {}
        # Penalty count buffer ([max_num_seqs, vocab] output-token
        # counts), made with the first unified_full program.
        self._counts = None
        self._graph_pool = None
        self._side_stream = None
        self._cuda = self.device.type == "cuda"

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
        if not self._cuda:
            return torch.from_numpy(arr)
        staged = torch.empty(arr.shape, dtype=torch.from_numpy(arr).dtype,
                             pin_memory=True)
        staged.numpy()[...] = arr
        return staged.to(self.device, non_blocking=True)

    def ensure_counts(self) -> torch.Tensor:
        """The [max_num_seqs, vocab] output-token count buffer of the
        penalties path."""
        if self._counts is None:
            self._counts = torch.zeros(
                (self.cfg.max_num_seqs, self.cfg.model.vocab_size),
                dtype=torch.int32, device=self.device,
            )
        return self._counts

    # -- the unified step -----------------------------------------------------
    def _variant(self, total: int, extras, mm) -> tuple[str, int]:
        cfg = self.cfg
        if mm is not None and any(mm):
            # One program at the TOP rung: mm batches pad there, and carry
            # the extras operands so extras lanes ride along.
            return "unified_mm", _bucket(cfg.unified_token_budget)
        if extras is not None:
            # One program at the TOP rung: extras batches pad there.
            return "unified_full", _bucket(cfg.unified_token_budget)
        return "unified", token_budget(total, cfg.unified_token_budget)

    def _step_buffers(self, kind: str, T: int) -> _StepBuffers:
        b = self._buffers.get((kind, T))
        if b is None:
            b = _StepBuffers(kind, T, self.unified_slots,
                             self.cfg.max_blocks_per_seq,
                             self.cfg.speculative_k, self.device,
                             self.cfg.model.hidden_size)
            self._buffers[(kind, T)] = b
        return b

    def _stage(
        self, b: _StepBuffers, lanes, key, draft_lens=None, extras=None,
        feed_rows=None, mm=None,
    ) -> tuple[tuple, bool]:
        """Fill the staging copies for ``lanes``; returns them (the block,
        and the embeddings or None) and whether every lane is greedy (the
        host-side branch of the step body)."""
        cfg = self.cfg
        S, MB, bs = b.S, b.MB, cfg.block_size
        if len(lanes) > S:
            raise ValueError(f"{len(lanes)} lanes > {S} metadata rows")
        staged, view = b.host(self._cuda)
        block_tables = view["block_tables"].reshape(S, MB)
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
            (view["temp"][s], view["top_k"][s], view["top_p"][s],
             view["seed"][s]) = _norm_sampling(sampling)
            cursor += n
        if feed_rows is not None:
            view["prev_row"][:], view["use_prev"][:] = feed_rows
        view["key"][:] = np.array(key, np.uint32).view(np.int32)
        if draft_lens is not None:
            if "draft_len" not in view:
                raise ValueError("draft_lens need cfg.speculative_k > 0")
            drafts = view["drafts"].reshape(S, b.K)
            for s, dl in enumerate(draft_lens):
                if dl:
                    view["draft_len"][s] = dl
                    drafts[s, :dl] = lanes[s][0][-dl:]
        if extras is not None:
            n = len(lanes)
            view["span_slot"][:n] = extras["slots"]
            view["counts_add"][:n] = extras["counts_add"]
            view["reset"][:n] = extras["reset"]
            view["freq"][:n] = extras["freq"]
            view["pres"][:n] = extras["pres"]
        embeds = b.host_embeds(self._cuda)
        if mm is not None:
            _stage_mm(embeds.numpy(), view["embed_mask"], view["row_start"],
                      view["q_len"], mm)
        return (staged, embeds), bool((view["temp"] <= 0.0).all())

    def _load(self, b: _StepBuffers, staged: tuple, prev_toks=None) -> None:
        """Enqueue the staged copies into the static buffers, and the
        feed's device tokens into ``prev`` (stream-ordered, so the
        producing dispatch has written them and no later replay has
        overwritten them yet)."""
        block, embeds = staged
        b.block.copy_(block, non_blocking=True)
        if embeds is not None:
            b.embeds.copy_(embeds, non_blocking=True)
        if prev_toks is not None:
            b.prev.copy_(prev_toks, non_blocking=True)

    def _body(self, b: _StepBuffers, greedy: bool):
        """The step program over the static buffers ``b``: feed, forward,
        K/V writes (int8 scales written back in place), sampling, and the
        variant's laws. Returns (ints, floats): every output packed into
        one int32 and one float32 (or None) tensor, so a dispatch copies
        them out in one or two copies."""
        cfg, d = self.cfg, b.dev
        S = b.S
        token_ids = _feed_tokens(
            d["token_ids"], d["row_start"], d["use_prev"], d["prev_row"], b.prev,
        )
        spec = b.kind == "unified" and b.K > 0
        mm = b.kind == "unified_mm"
        out = llama.unified(
            cfg.model, self.params, self.kv_caches, token_ids, d["token_pos"],
            d["slot_mapping"], d["token_seq"], d["block_tables"].view(S, b.MB),
            d["q_start"], d["q_len"], d["kv_len"], d["row_start"],
            cfg.block_size, kv_scales=self.kv_scales,
            draft_len=d["draft_len"] if spec else None,
            verify_rows=b.K + 1 if spec else 1,
            embeds=b.embeds if mm else None,
            embed_mask=d["embed_mask"] > 0 if mm else None,
        )
        logits = out
        if self.kv_scales is not None:
            logits, new_scales = out
            self.kv_scales.copy_(new_scales)
        samp = dict(key=d["key"], temperature=d["temp"], top_k=d["top_k"],
                    top_p=d["top_p"], seed=d["seed"], all_greedy=greedy)
        if spec:
            return self._spec_law(b, logits, samp), None
        if b.kind in ("unified_full", "unified_mm"):
            return self._extras_law(b, logits, token_ids, samp)
        toks = sample_tokens(logits, sample_pos=d["kv_len"], **samp)
        return torch.where(d["q_len"] > 0, toks, 0).to(torch.int32), None

    def _spec_law(self, b, logits, samp) -> torch.Tensor:
        """Greedy accept-prefix over [S, K+1, V] verify logits: only
        greedy lanes with real drafts accept; the bonus token samples at
        row ``acc``, position ``kv_len - draft_len + acc``. Plain spans
        (draft_len 0) reduce exactly to the plain program. Packs (bonus
        [S], emitted [S, K+1], counts [S])."""
        d, K = b.dev, b.K
        q_len, dlen = d["q_len"], d["draft_len"]
        drafts = d["drafts"].view(b.S, K)
        greedy = torch.argmax(logits, dim=-1).to(torch.int32)        # [S, K+1]
        offs_k = torch.arange(K, device=logits.device)
        matches = (drafts == greedy[:, :K]) & (offs_k[None, :] < dlen[:, None])
        lead = torch.cumprod(matches.to(torch.int32), dim=1).sum(dim=1)
        eligible = (q_len > 0) & (dlen > 0) & (samp["temperature"] <= 0.0)
        acc = torch.where(eligible, lead, 0)                         # [S]
        at_acc = torch.gather(
            logits, 1, acc.long()[:, None, None].expand(-1, 1, logits.shape[-1])
        )[:, 0]                                                      # [S, V]
        bonus = sample_tokens(at_acc, sample_pos=d["kv_len"] - dlen + acc, **samp)
        bonus = torch.where(q_len > 0, bonus, 0).to(torch.int32)
        offs = torch.arange(K + 1, device=logits.device)[None, :]
        dpad = torch.cat([drafts, drafts.new_zeros(b.S, 1)], dim=1)  # [S, K+1]
        emitted = torch.where(
            offs < acc[:, None], dpad,
            torch.where(offs == acc[:, None], bonus[:, None], 0),
        )
        counts = torch.where(q_len > 0, acc + 1, 0)
        return torch.cat([bonus, emitted.reshape(-1), counts]).to(torch.int32)

    def _extras_law(self, b, logits, token_ids, samp):
        """Penalties over the per-slot count buffer, then sampling and
        logprobs. Reset first (a re-slotted sequence inherits a stale
        row), then count each decode span's FED token. Packs (toks [S],
        top ids [S, MAX_LOGPROBS]) and (chosen [S], top logprobs)."""
        d = b.dev
        counts = self.ensure_counts()
        B, V = counts.shape
        T = token_ids.shape[0]
        q_len, span_slot = d["q_len"], d["span_slot"]
        slot_clip = torch.clamp(span_slot, 0, B - 1).long()
        valid = (span_slot >= 0) & (span_slot < B) & (q_len > 0)
        rs = torch.zeros(B, dtype=torch.int32, device=counts.device)
        rs.scatter_add_(0, slot_clip, ((d["reset"] > 0) & valid).to(torch.int32))
        counts.masked_fill_((rs > 0)[:, None], 0)
        fed = token_ids[torch.clamp(d["row_start"], 0, T - 1).long()].long()
        add = (d["counts_add"] > 0) & valid
        counts.view(-1).scatter_add_(0, slot_clip * V + fed, add.to(torch.int32))
        pen = apply_penalties(logits, counts[slot_clip], d["freq"], d["pres"])
        toks = sample_tokens(pen, sample_pos=d["kv_len"], **samp)
        clp, tids, tlps = token_logprobs(pen, toks)
        toks = torch.where(q_len > 0, toks, 0).to(torch.int32)
        return (torch.cat([toks, tids.reshape(-1)]).to(torch.int32),
                torch.cat([clp, tlps.reshape(-1)]).float())

    def _program(self, kind: str, T: int, greedy: bool) -> _Program:
        """The (kind, T, greedy) program, made at first need: an eager
        warm pass of the body over warm lanes (trash block 0 only), then,
        on the card, the capture of the body into a CUDA graph. Counted
        as warmed inside warmup, as a mid-traffic compile outside it."""
        key = graph_key(kind, T, greedy)
        prog = self._programs.get(key)
        if prog is not None:
            return prog
        cfg = self.cfg
        b = self._step_buffers(kind, T)
        sampling = (0.0, 0, 1.0, -1) if greedy else (1.0, 0, 1.0, -1)
        lanes = _unified_warm_lanes(
            T, self.unified_slots, cfg.max_model_len,
            [0] * cfg.max_blocks_per_seq, sampling,
        )
        extras = mm = None
        if kind in ("unified_full", "unified_mm"):
            self.ensure_counts()
            n = len(lanes)
            extras = {"slots": [0] * n, "counts_add": [False] * n,
                      "reset": [False] * n, "freq": [0.0] * n, "pres": [0.0] * n}
        if kind == "unified_mm":
            mm = [[(0, np.zeros((1, cfg.model.hidden_size), np.float32))]]
        staged, _ = self._stage(b, lanes, (cfg.seed, 0), extras=extras, mm=mm)
        with self.compile_stats.program(key):
            if not self._cuda:
                self._load(b, staged)
                self._body(b, greedy)
                prog = _Program()
            else:
                prog = self._capture(b, staged, greedy)
        self._programs[key] = prog
        return prog

    def _capture(self, b: _StepBuffers, staged, greedy: bool) -> _Program:
        if self._side_stream is None:
            self._side_stream = torch.cuda.Stream(self.device)
            self._graph_pool = torch.cuda.graph_pool_handle()
        side, main = self._side_stream, torch.cuda.current_stream(self.device)
        # The warm pass on the capture stream, after every dispatch already
        # enqueued (it writes trash block 0 and the int8 scales): the
        # kernel library's first-use setup (its second stream, its
        # shared-memory attributes) and cuBLAS's workspace for this stream
        # happen here, outside the capture.
        side.wait_stream(main)
        with torch.cuda.stream(side):
            self._load(b, staged)
            self._body(b, greedy)
        main.wait_stream(side)
        torch.cuda.synchronize(self.device)
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(self.device)
        before = kernels.launch_counts()
        graph = torch.cuda.CUDAGraph()
        with gc_held(), torch.cuda.graph(graph, pool=self._graph_pool, stream=side,
                                         capture_error_mode="thread_local"):
            outs = self._body(b, greedy)
        after = kernels.launch_counts()
        # Nothing ran during the capture: the wrappers' counts move to the
        # graph, which adds them back once per replay.
        kernels.set_launch_counts(before)
        self.compile_stats.graphs_captured += 1
        self.compile_stats.graph_pool_bytes += max(
            torch.cuda.memory_reserved(self.device) - reserved, 0)
        return _Program(graph, outs, {k: after[k] - before[k] for k in after})

    def unified_step(
        self,
        lanes: list[tuple[list[int], list[int], int, tuple]],
        feed: tuple | None = None,
        draft_lens: list[int] | None = None,
        extras: dict | None = None,
        mm: list | None = None,
    ) -> UnifiedOut:
        """ONE ragged dispatch for a mixed prefill+decode batch; on the
        card it replays the program's captured graph.

        ``lanes``: [(new_tokens, block_ids, prefix_len, sampling), ...] —
        span s of the flat batch is lane s's tokens; a decode lane is a
        single token, a prefill quantum its chunk, a draft-verify span
        the fed token plus its drafts. Total tokens snap UP to the
        budget ladder (compile_cache.token_budget).

        ``feed``: optional (prev_toks [S] device tensor, prev_row [S],
        use_prev [S]) — decode lanes whose token was sampled by the
        previous dispatch read it on the DEVICE from its old metadata row
        instead of a host round trip.

        ``draft_lens``: per-lane count of DRAFT tokens in the lane's tail
        (needs cfg.speculative_k > 0); ``UnifiedOut.spec()`` carries the
        accepted drafts and bonus.

        ``extras``: {"slots", "counts_add", "reset", "freq", "pres"}
        per-lane lists — the unified_full variant at the top rung;
        ``UnifiedOut.logprobs()`` carries its logprobs.

        ``mm``: per-lane multimodal segment lists ((chunk-relative
        offset, [n, D] float32 array) pairs, None for text lanes) — the
        unified_mm variant at the top rung, which also takes ``extras``."""
        return self._dispatch(lanes, feed, draft_lens, extras, mm, program=True)

    def unified_step_eager(self, lanes, feed=None, draft_lens=None, extras=None,
                           mm=None):
        """``unified_step`` through the eager body, never a replay and
        never counted as a program: the reference the replays are held
        against. The serving engine never calls it."""
        return self._dispatch(lanes, feed, draft_lens, extras, mm, program=False)

    def _dispatch(self, lanes, feed, draft_lens, extras, mm, program: bool) -> UnifiedOut:
        total = sum(len(t) for t, _, _, _ in lanes)
        kind, T = self._variant(total, extras, mm)
        if kind != "unified_mm":
            mm = None
        if total > T:
            raise ValueError(
                f"{total} tokens exceed the unified budget "
                f"{self.cfg.unified_token_budget}"
            )
        b = self._step_buffers(kind, T)
        prev_toks = feed_rows = None
        if feed is not None:
            prev_toks, prev_row, use_prev = feed
            feed_rows = (prev_row, use_prev)
        staged, greedy = self._stage(
            b, lanes, self._next_key(), draft_lens, extras, feed_rows, mm,
        )
        prog = self._program(kind, T, greedy) if program else None
        self._load(b, staged, prev_toks)
        self.compile_stats.record_serving(kind, T)
        if prog is not None and prog.graph is not None:
            prog.graph.replay()
            kernels.add_launch_counts(prog.launches)
            ints, floats = prog.outs
        else:
            ints, floats = self._body(b, greedy)
        spec_k = b.K if kind == "unified" else 0
        if not self._cuda:
            return UnifiedOut(ints[: b.S], ints, floats, None, spec_k)
        # Replays copy their outputs out in stream order: the next replay
        # of this graph is enqueued after these copies.
        ints_host = torch.empty(ints.shape, dtype=torch.int32, pin_memory=True)
        ints_host.copy_(ints, non_blocking=True)
        floats_host = None
        if floats is not None:
            floats_host = torch.empty(floats.shape, dtype=torch.float32,
                                      pin_memory=True)
            floats_host.copy_(floats, non_blocking=True)
        event = torch.cuda.Event()
        event.record()
        return UnifiedOut(ints[: b.S], ints_host, floats_host, event, spec_k)

    # -- block IO (KVBM tiers, disaggregation) -------------------------------
    def _block_shape(self, n: int | None = None) -> tuple:
        m = self.cfg.model
        shape = (m.num_layers, 2, self.cfg.block_size, m.num_cache_heads,
                 m.kv_cache_head_dim)
        return shape if n is None else (n, *shape)

    def _normalize_block_host(self, data) -> np.ndarray:
        """Host block bytes → the cache dtype's host representation:
        same-width bytes are reinterpreted (uint16 ↔ bfloat16), other
        widths convert by value. The one rule every host scatter shares."""
        return kv_copy.to_numpy(kv_copy.from_numpy(np.asarray(data), self.kv_dtype))

    def gather_many(self, block_idxs) -> np.ndarray:
        """N blocks to host: [N, L, 2, bs, H, D] (waits for this copy)."""
        return kv_copy.gather_blocks(self.kv_caches, block_idxs, self.cfg.block_size)

    def gather_many_device(self, block_idxs) -> torch.Tensor:
        """N blocks as one device snapshot [N, L, 2, bs, H, D] (the
        device channel's payload; no host sync)."""
        return kv_copy.gather_blocks_device(
            self.kv_caches, block_idxs, self.cfg.block_size)

    def gather_many_async(self, block_idxs) -> kv_copy.HostCopy:
        """N blocks copied to pinned host memory asynchronously; the
        offload path hands this to the KVBM pump, whose worker thread
        waits on the copy's event."""
        return kv_copy.HostCopy(self.gather_many_device(block_idxs))

    def prepare_blocks_host(self, datas) -> np.ndarray:
        """Validate and normalize N host block payloads into the stacked
        [N, L, 2, bs, H, D] scatter layout without touching the device:
        a bad row raises here, before any cache write."""
        shape = self._block_shape()
        return np.stack([self._normalize_block_host(d).reshape(shape) for d in datas])

    def onboard_staging(self, n: int):
        """On the card: a pinned host tensor of ``n`` blocks in the cache
        dtype and its host bytes as [n, row elements] numpy — the G2 tier
        copies its rows straight into it (``match_host(out=...)``) and one
        asynchronous copy moves them to the device
        (``scatter_many_prepared`` takes the tensor). None on the CPU."""
        if not self._cuda:
            return None
        t = torch.empty(self._block_shape(n), dtype=self.kv_dtype, pin_memory=True)
        return t, kv_copy.to_numpy(t).reshape(n, -1)

    def scatter_many_prepared(self, block_idxs, rows) -> None:
        """Write N prepared rows (host numpy, or a pinned host tensor from
        ``onboard_staging``) into their blocks, in place."""
        kv_copy.scatter_blocks(self.kv_caches, block_idxs, self.cfg.block_size, rows)

    def scatter_many(self, block_idxs, datas) -> None:
        self.scatter_many_prepared(block_idxs, self.prepare_blocks_host(datas))

    def scatter_many_device(self, block_idxs, data: torch.Tensor) -> None:
        """Write N blocks from a device snapshot [N, ...] in place."""
        kv_copy.scatter_blocks(
            self.kv_caches, block_idxs, self.cfg.block_size,
            data.reshape(self._block_shape(len(block_idxs))))

    def scatter_block(self, block_idx: int, data) -> None:
        """One block from host bytes (the wire frames' form) or a device
        tensor. Under int8 KV host bytes are the PACKED row (int8 data +
        scale sidecar): the scale row is written alongside."""
        if isinstance(data, torch.Tensor):
            self.scatter_many_device([block_idx], data[None])
        elif self.kv_quant:
            from dynamo_tpu_torch.block_manager import quant as bq

            q, scales = bq.unpack_block(data, self._quant_layout())
            self.set_block_scales([block_idx], scales[None])
            self.scatter_many_prepared([block_idx], q[None])
        else:
            self.scatter_many([block_idx], [data])

    def timing_event(self):
        """A timing event recorded now on the card, to bracket block IO
        (``start.elapsed_time(end)`` is readable once ``end.query()``);
        None on the CPU, where the IO is synchronous and the host clock
        times it."""
        if not self._cuda:
            return None
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    @property
    def kv_bytes_ratio(self) -> float:
        """Stored-KV bytes per token relative to the compute dtype: 1.0
        unquantized, about 0.5 under int8 (the scale sidecar adds 4 B
        per (layer, K/V, head) per block)."""
        if not self.kv_quant:
            return 1.0
        lay = self._quant_layout()
        return lay.block_bytes / lay.unquantized_block_bytes

    def _quant_layout(self):
        """This runner's G1 block as a quantized KvLayoutConfig — the
        packed-row wire and tier format of its blocks."""
        from dynamo_tpu_torch.block_manager.config import KvLayoutConfig

        return KvLayoutConfig.for_engine(self.cfg)

    def gather_scales_device(self, block_idxs) -> torch.Tensor:
        """[N, L, 2, kvH] scale rows of N blocks (device copy)."""
        return kv_copy.gather_scales_device(self.kv_scales, block_idxs)

    def gather_scales_async(self, block_idxs) -> kv_copy.HostCopy:
        return kv_copy.HostCopy(self.gather_scales_device(block_idxs))

    def set_block_scales(self, block_idxs, rows) -> None:
        """Write N blocks' scale rows ([N, L, 2, kvH], host or device) in
        place."""
        kv_copy.scatter_scales(self.kv_scales, block_idxs, rows)

    def export_block_rows(self, block_idxs) -> list[np.ndarray]:
        """N int8 blocks as PACKED host rows (int8 data + f32 scale
        sidecar) — the form disagg frames and the KVBM tiers move."""
        from dynamo_tpu_torch.block_manager import quant as bq

        layout = self._quant_layout()
        batch = self.gather_many(block_idxs)
        scales = kv_copy.gather_scales(self.kv_scales, block_idxs)
        return [bq.pack_block(batch[i], scales[i], layout)
                for i in range(len(block_idxs))]

    def import_host_rows(self, rows, layout):
        """Quantized tier or wire rows → (scatter-ready data, scale rows or
        None): an int8 cache takes the packed bytes as they are; a
        bf16/f32 cache dequantizes on the host. Validates before any
        cache write."""
        from dynamo_tpu_torch.block_manager import quant as bq

        unpacked = [bq.unpack_block(r, layout) for r in rows]
        if self.kv_quant:
            return (np.stack([q for q, _ in unpacked]),
                    np.stack([s for _, s in unpacked]))
        deq = [bq.dequantize_kv_block_host(q, s) for q, s in unpacked]
        return self.prepare_blocks_host(deq), None

    # -- warmup ---------------------------------------------------------------
    def warmup(self, manifest=None) -> int:
        """Make the serving program set off the clock, in the order of
        ``warmup_plan``: every budget rung (the spec-verify program on a
        speculative engine), the extras program and, on a multimodal
        engine, the mm program at the top rung, each greedy and sampled. Writes land in trash block 0 only; the real
        cache entries and the allocator are untouched. Returns the number
        of programs made (graphs captured on the card)."""
        hot, tail = self.warmup_plan(manifest)
        return self.run_warm_ops(hot + tail)

    def _warm_op(self, spec):
        """One shape spec → the call that makes its two programs (greedy
        and sampled), or None for a variant this engine does not serve or
        a rung S spans cannot fill."""
        cfg = self.cfg
        kind, t = spec[0], spec[1]
        if not _serves_variant(cfg, kind):
            return None
        if not _unified_warm_lanes(t, self.unified_slots, cfg.max_model_len,
                                   [0], (0.0, 0, 1.0)):
            return None
        return lambda: [self._program(kind, t, g) for g in (True, False)]

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
        mm_embeds: list[tuple[int, np.ndarray]] | None = None,
    ) -> int:
        """Run one sequence's prefill (the suffix after any prefix-cache
        hit); returns the first sampled token. ``sampling`` is (temp,
        top_k, top_p[, seed]); ``last_logprobs`` holds its logprobs.
        ``mm_embeds``: multimodal soft-prompt segments, (offset in
        ``new_tokens``, [n, D] float32 array) pairs whose rows replace the
        placeholder tokens' embeddings."""
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
        mm_kw = {}
        if mm_embeds:
            embeds = np.zeros((T, self.cfg.model.hidden_size), np.float32)
            mask = np.zeros(T, np.int32)
            _stage_mm(embeds, mask, [0], [len(new_tokens)], [mm_embeds])
            mm_kw = {"embeds": self._to_device(embeds),
                     "embed_mask": self._to_device(mask) > 0}
        logits = llama.prefill(
            self.cfg.model, self.params, self.kv_caches,
            self._to_device(token_ids),
            self._to_device(self._pad_table(block_ids)),
            self._to_device(slot_mapping), dlens[0], dlens[1],
            self.cfg.block_size, **mm_kw,
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


def _serves_variant(cfg: EngineConfig, kind: str) -> bool:
    """Whether an engine of ``cfg`` makes programs of ``kind``."""
    return (kind == "unified"
            or (kind == "unified_full" and cfg.sampling_extras)
            or (kind == "unified_mm" and cfg.multimodal))


def _stage_mm(embeds: np.ndarray, mask: np.ndarray, row_start, q_len, mm) -> None:
    """Scatter per-lane mm segments ((lane-relative offset, [n, D])
    pairs) into the flat soft-prompt rows and their mask; a segment's
    rows past its lane's span are dropped (the rest of the image lands
    in the sequence's next chunk)."""
    for s, segs in enumerate(mm):
        for off, seg in segs or ():
            w = min(len(seg), max(0, int(q_len[s]) - off))
            if w <= 0 or off < 0:
                continue
            r0 = int(row_start[s]) + off
            embeds[r0:r0 + w] = seg[:w]
            mask[r0:r0 + w] = 1


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
