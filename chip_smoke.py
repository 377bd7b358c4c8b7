"""Chip smoke test of the PyTorch/CUDA port (dynamo_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, one JSON line each; any failure exits non-zero without the final
``ok`` line:

1. build      — compile every CUDA kernel of the port from csrc/ with
                nvcc, one nvcc per source, all started together.
2. kernel     — each kernel against its plain PyTorch version at
                llama3.2-1b shapes (H=32, kvH=8, D=64, bs=16); the main
                case of each is timed beside the plain version, one SDPA
                call over the K/V gathered dense, and the bound:
                ragged (SDPA over the spans padded, each span's keys
                gathered once), caches in q's dtype: decode-only,
                prefill with a prefix hit, a mixed T=256 batch,
                spec-verify spans of 2, 4 and 8 rows, decode at the
                longest context a 64-column table holds (many splits),
                windows that leave whole splits and tile chunks behind,
                spans that end mid-tile next to the next span's rows,
                float32; ragged, int8 caches: the same kinds of case,
                int8 + window + spec among them; both legs at block size
                4 and every head-dim template (16-256, 96 with G = 1, 3,
                16); each bf16 call must launch the tensor-core tile and
                the split path, each f32 call the walk and the split path;
                decode (split-KV + merge): the phase-split run's 4
                lanes (phase 7) at its first, middle and last step,
                timed at the middle one; 8 lanes (contexts 1–600) and an
                idle lane in bf16 and f32, windowed; 1 lane at the
                longest context a 64-column table holds (windows that
                leave whole splits behind); 32 lanes with idle ones
                (2 splits); 40 lanes (1 split, no merge); head dims
                16–256, G = 3 and 16, block size 4; a striped sp=4
                scan (with splits) whose shards' stats merge to the
                unstriped call; each case's (splits, pages) printed;
                prefill (bf16 on the tensor-core entry, f32 on the
                walk): the phase-split run's prefill_batch (4 whole
                prompts padded to T=512), timed; 4 lanes of T=256 with
                prefix hits, padded rows and an idle lane, windowed,
                f32; T=512 behind prefixes that put causal and window
                edges inside chunks; block size 4; every head-dim
                template (16–256, 96) with G = 1, 3, 4, 8, 16; striped
                sp=4.
3. tiny       — tiny-test in float32: 3 concurrent greedy requests through
                TorchEngine.generate equal the port's reference_forward
                continuation on the card; an int8-KV engine keeps a greedy
                match rate >= 0.7 against them; ModelRunner.prefill_batch
                + decode_multi equal reference_forward too.
4. serve      — the main path at full width: a llama3.2-1b TorchEngine in
                bf16 (random weights from a seed) warms up — one CUDA
                graph per program of the warmup plan, 5 budget rungs and
                the extras program, each greedy and sampled; graphs,
                capture seconds and pool bytes reported — then serves 8
                concurrent requests through generate(), every dispatch a
                replay, none captured mid-traffic; the ragged wrapper
                must have launched num_layers times per unified dispatch
                (a replay adds its graph's launches), each call on the
                tensor-core tile and the split path; every
                stream is fed back through the no-cache reference_forward
                (finite logits of shape [T, V]; argmax agreement and the
                log-probability gap of each disagreement reported).
5. profile    — 8 more requests on the same engine under torch.profiler:
                device time by kernel and the device's busy share.
   graphs     — the serve's dispatches (recorded) through two fresh
                runners on its weights: one replays its graphs, one runs
                the eager step body; the sampled tokens of every dispatch
                and, at the end, the K/V bytes outside trash block 0 must
                be identical; then wall, host and device ms per dispatch
                and the busy share of each, pipelined two deep, in turns.
6. serve_int8 — the same 8 requests through an int8-KV engine: the int8
                leg must have launched num_layers times per dispatch,
                on the same paths;
                then its own profile, as in 5, and graphs_int8 (scales
                compared too).
   spec       — speculative_k=4 against 0 on the 8 prompts and 2 of
                repeated n-grams, in float32 (streams byte-identical) and
                in bf16 (both engines' streams held to the no-cache
                reference: greedy batching differs, so bf16 ties may fall
                either way); drafts and accepted drafts (> 0), tokens per
                step, verify spans of 2-5 rows, every ragged call on its
                dtype's paths.
7. http       — the OpenAI server at full width, built in process through
                the CLI's own path (``run --out torch --model-path
                preset:llama3.2-1b``, the serve's engine settings) with a
                Tap on each request's engine token ids: 8 concurrent
                streaming /v1/completions of the serve's prompts (token
                ids, 32 tokens, greedy, ignore_eos), 2 aggregated chat
                completions, /v1/models, /health, /metrics. Every reply
                200; usage and the Tap count 32 tokens with finish
                "length"; the streamed text is the toy tokenizer's
                incremental decode of the tapped ids; the ragged wrapper
                launched num_layers times per dispatch on the tile and
                split paths; the tapped streams pass the teacher-forced
                gates of phase 8. Client-side TTFT, ITL (from SSE arrival
                times) and tokens/s beside the serve's; /metrics carries
                the capture gauges. Then extras: for 2 more prompts a
                completion with logprobs and the same with penalties, and
                a chat with top_logprobs (the top-rung extras program):
                each chosen-token logprob within FIRST_LOGPROB_TOL of the
                no-cache reference's (penalized reference for the
                penalized ones), the streams through its teacher-forced
                gates, a penalized stream unlike its plain one. Then a drain with
                one request in flight (it completes; a new request gets
                503), and one ``run --in batch:FILE`` subprocess whose
                JSON report is parsed.
   observe    — the OpenAI server again (the CLI's own path, the serve's
                settings, quantum 256), with the tracer writing a JSONL
                capture, the flight recorder on and a profile directory.
                Server A, ``--coloc static``: 4 interactive streams (64-token
                prompts, 192 greedy tokens) give the decode ITL p50 at the
                client; itl_slo_ms = 1.5 × that, printed; the same streams
                again with a burst of 4 batch prompts of 896 tokens (8
                tokens each) sent mid-decode; then the serve profile's wall
                ms per dispatch with the tracer and the flight recorder on
                and swapped for no-op stand-ins, in turns. Server B,
                ``--coloc adaptive --itl-slo-ms`` that SLO: the same burst
                leg. Server C, an SLO 10% above the decode-only EMA (at
                1.5× the H100's 256-row dispatch may never pressure the
                controller; this one does): the same leg; then, under the
                same traffic, a request with
                ``X-Request-Timeout-Ms: 1`` sent while the burst holds every
                slot, and a /debug/profile?seconds=1 window. Reported: client
                ITL p50/p95 over each burst, the quantum trajectory from
                /debug/steps, itl_slo_violations_total. Gates: every reply
                200, full-length streams held to the no-cache reference as
                in phase 8; no capture mid-traffic; on every leg the
                quantum starts at 256, never goes below 16, stays put on
                the static leg, and on an adaptive leg falls only after
                its itl_slo_violations_total rose (a 2 ms poll of the
                controller; the compose-time EMA peak is reported); the
                tight leg's must fall; one flight
                record per unified dispatch; the 1 ms request answers 504
                and deadline_exceeded_total grows by one; the profile's
                Chrome trace names the ragged kernel; /metrics carries the
                new counters and the trace histograms; the port's
                trace_merge --assert-complete passes on the capture; the
                ragged wrapper launched 16 × the phase's dispatches.
8. phases     — the phase-split entry points at full width on the serve's
                weights: prefill_batch of 4 prompts (64–512 tokens), then
                decode_multi of 32 steps; the prefill kernel launches
                num_layers times per call, all on the tensor-core entry,
                the decode wrapper num_layers times per step; the
                streams fed back through the no-cache
                reference_forward must agree with its argmax (where they
                do not, as near ties), and prefill_batch's first-token
                log-probabilities must match it; token-match rate
                against the unified serve.
9. fleet      — the runtime plane at full width, through the CLI's own
                paths: a ``control-plane --port 0`` process; the frontend
                ``run --in http --out dyn --control-plane ADDR`` built in
                this process (as the http phase builds its server) with a
                Tap on the token ids and serving worker the router
                delivers; worker processes ``run --in
                dyn://dynamo.torch.generate --out torch --model-path
                preset:llama3.2-1b`` with the serve's engine settings and
                a ``--health-port``, each warmed up (its CUDA graphs
                captured) before it serves and registers. Legs: serve — two
                bf16 workers; 8 concurrent streaming /v1/completions of
                the serve's prompts (token ids, 32 greedy tokens,
                ignore_eos): every reply 200, usage and the Tap count 32
                tokens with finish "length", round robin splits them 4
                and 4 (each worker's /metrics), the streams pass phase
                8's teacher-forced gates; token-match rate against the
                http phase's streams; kv_route — a second in-process
                frontend with ``--router-mode kv`` on the same two
                workers: 4 groups × 3 requests, each group sharing a
                384-token prefix (24 blocks), each request its own
                64-token suffix (prompts from the seed), 32 greedy tokens;
                each group's first request, then (the router's indexer
                settled: nothing pending, radix size steady) the 8 later
                ones at once: every later request on its group's first
                worker; 12 route records at /debug/routes, overlap 0 on
                the firsts and 24 on the later ones; the workers'
                kv_reused_device_blocks_total +192; the route-audit join
                (tools/route_audit.py) of the router's records with the
                workers' actual-reuse records off the hit-rate plane
                exact; the router's metrics not stale; the streams
                through phase 8's teacher-forced gates. Then the same
                traffic shape (fresh prefixes) through the round-robin
                frontend, reported only (reuse, TTFT p50); one more
                group through a ``router`` subprocess (RouterService:
                all 3 on one worker, 48 blocks reused, the streams
                through the teacher-forced gates); a ``metrics``
                subprocess's /metrics carries both workers' reuse
                gauges; both subprocesses exit 0 on SIGTERM; and the
                pinned host→device copy rate of 64 KV blocks (the
                router's default_link_gbps) is measured; drain verb —
                one 256-token stream in
                flight on a worker, ``request_drain`` on its lease: the
                stream completes, the instance key is deleted, the next
                request is served by the other worker, the drained worker
                prints "drain complete" and exits 0; SIGTERM — the same on
                the last worker (the request after it finds no worker:
                404 or 503); each drained worker's report line: its ragged
                wrapper launched num_layers times per dispatch, every call
                on the tile and split paths, and its peak device memory;
                failover — two float32 workers: one 4-token prompt for 64
                greedy tokens served uninterrupted, then again, SIGKILL
                to the serving worker once 8 tokens reached the client:
                the stream ends with 64 tokens, finish "length",
                byte-identical to the uninterrupted one, FailoverStats
                counts one WorkerDiedError success, the survivor drains
                on SIGTERM (walk and split paths) and exits 0. Reported:
                worker startup (spawn → "worker serving") and discovery
                (spawn → the instance key's PUT at a watch), client TTFT,
                ITL (p50, p95, and per serving worker) and tok/s beside
                the http phase's, the gap at the client across the kill.
                Every process has its own timeouts and is killed at the
                end of the phase, whatever happened.

10. disagg    — disaggregated prefill/decode and the KVBM tiers on
                llama3.2-1b (max_model_len 2048), with the phase's own
                prompts from seeds: per leg 4 long prompts (1024–1536
                tokens) that go remote (DisaggConfig(max_local_prefill_
                length=512)) and 4 short ones (64–256) that stay local,
                32 greedy tokens each. Legs: device — a decode and a
                prefill engine in this process, the device channel (the
                same prompts served locally first, for the TTFT they
                are compared with); kvbm — an engine with a
                KvBlockManager (a G2 host tier, a G3 disk tier in a
                temporary directory): 8 prompts sharing two 512-token
                prefixes cold, then the device cache cleared and served
                again twice (the adaptive gate's first decisions, then
                with its estimates), the onboarded blocks read back from
                the device cache equal the offered rows by CRC, then G2
                spilled and two touches that promote from G3 (envelope
                verified, no integrity failure); tcp and native — the
                prefill engine in a worker process
                (``dynamo_tpu_torch.examples.prefill_worker``), each
                transport pinned; int8 — an int8-KV pair over tcp
                (packed rows, scales included, by their byte count).
                Gates on every leg: 4 remote, 4 local; the pinned
                transport's receiver carried every block and no other
                did; no integrity failure and no degraded request; the
                device leg's received blocks equal the sent ones by CRC;
                the ragged wrapper launched num_layers times per unified
                dispatch of this process's engines (the prefill worker's
                report: the same of its own, and nothing captured
                mid-traffic), tile and split paths; the streams through
                phase 8's teacher-forced gates. Reported: TTFT p50 of
                the remote and local requests, kv_transfer span p50/p95
                and GB/s per transport, host→device onboard GB/s, TTFT
                cold against host hit, the gate's probes and skips.

Each path's launch counts are set to 0 just before it and read just
after. Then the card's name and power limit, the kernels line, and the
last line ``{"ok": true, "device": {...}}``. Imports nothing of JAX or
of the JAX package. Needs one CUDA device.
"""

from __future__ import annotations

import asyncio
import contextlib
import dataclasses
import gc
import io
import json
import logging
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12     # H100 SXM HBM3
PEAK_FLOPS = {                # H100 SXM dense peaks
    torch.bfloat16: 989e12,   # tensor cores
    torch.float32: 67e12,     # outside the tensor cores
}
KERNEL_TOL = {torch.bfloat16: 1e-2, torch.float32: 1e-4}
DEVICE = "cuda"
H, KVH, D, BS = 32, 8, 64, 16        # llama3.2-1b attention shapes
G = H // KVH
SP = 4                               # kv_sp shards emulated on one card
PHASE_LANES = 4                      # lanes of the full-width phase-split run
# The full-width phase-split run against the no-cache reference, fed the
# run's own tokens: argmax agreement; where the argmax differs, the run's
# token must be a near tie in the reference's log-probabilities; and the
# first token's log-probability from prefill_batch against the reference.
# Random bf16 weights give near-flat logits: the reference's top two
# tokens lie a median ~0.025 nats apart, and bf16 rounding moves a
# log-probability by a few thousandths, so a flipped argmax within 0.02
# nats is a tie and a wrong token is not.
PHASES_AGREEMENT = 0.9
NEAR_TIE_NATS = 0.02
FIRST_LOGPROB_TOL = 0.02


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def device_ms(fn, iters: int) -> float:
    """Device time of one fn() call: `iters` calls captured in a CUDA
    graph and replayed, so the host's launch overhead is not counted."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()                                   # warm up outside capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(3):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (3 * iters)


def host_ms(fn, iters: int) -> float:
    """Wall time per back-to-back fn() call as issued from Python: the
    larger of the host's launch cost and the device time."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / iters


def bound(nbytes: int, flops: int, dtype) -> tuple[float, str]:
    """(ms, what bounds it): the larger of the bytes over the HBM rate
    and the operations over the peak rate of their type."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def max_err(got, want) -> float:
    return (got.float() - want.float()).abs().max().item()


def check(phase: str, case: str, errs: dict, tol: float, **extra) -> float:
    """Emit one case's errors against its plain version; fail if any is
    over the tolerance or not finite."""
    flag = extra.pop("ok", True)
    worst = max(errs.values())
    ok = bool(np.isfinite(worst)) and worst <= tol and flag
    emit({"phase": phase, "case": case, **errs, "tol": tol, **extra, "ok": ok})
    if not ok:
        raise SystemExit(f"{phase} case {case} disagrees with the plain version")
    return worst


def t_(a):
    return torch.from_numpy(np.asarray(a)).to(DEVICE)


def timing(case: str, kernel, plain, library, lib_want, nbytes, flops, dtype,
           kernel_iters=20) -> dict:
    """Time a main case: kernel, plain version and library call on the
    same inputs, beside the bound computed from this run's inputs."""
    kernel_ms = device_ms(kernel, iters=kernel_iters)
    plain_ms = device_ms(plain, iters=2)
    lib_got, lib_mask = library()
    lib_err = max_err(lib_got[lib_mask], lib_want[lib_mask])
    library_ms = device_ms(library, iters=5)
    bound_ms, bound_by = bound(nbytes, flops, dtype)
    out = {"phase": "kernel_timing", "case": case, "kernel_ms": kernel_ms,
           "kernel_host_ms": host_ms(kernel, iters=50), "plain_ms": plain_ms,
           "library_ms": library_ms, "library_max_abs_err": lib_err,
           "bound_ms": bound_ms, "bound_by": bound_by, "bytes": nbytes,
           "flops": flops, "bound_share": bound_ms / kernel_ms}
    emit(out)
    return out


# -- phase 1 -----------------------------------------------------------------
def phase_build() -> None:
    from dynamo_tpu_torch.ops.kernels import (
        KERNEL_SOURCES,
        _build,
        paged_decode_attention,
        paged_prefill_attention,
        ragged_attention,
    )

    t0 = time.monotonic()
    reports = _build.build_all(KERNEL_SOURCES)
    for module in (ragged_attention, paged_decode_attention, paged_prefill_attention):
        module.build()
    emit({"phase": "build", "kernels": KERNEL_SOURCES,
          "build_s": round(time.monotonic() - t0, 3),
          "nvcc_s": {name: float(text.rsplit("nvcc seconds:", 1)[1])
                     for name, text in reports.items()},
          "ptxas": ptxas_summary(reports)})


def ptxas_summary(reports: dict) -> dict:
    """{kernel<template args>: [registers, spill store bytes]} from the
    compiler's -Xptxas -v report, the mangled names cut to their core."""
    import re

    out, entry = {}, None
    for text in reports.values():
        for line in text.splitlines():
            if "Compiling entry function" in line:
                name = line.split("'")[1]
                m = re.search(r"\d+([a-z_]+_kernel)I(.*?)E+v", name)
                entry = f"{m.group(1)}<{m.group(2)}>" if m else name
                out[entry] = [0, 0]
            elif entry and "spill stores" in line:
                out[entry][1] = int(re.search(r"(\d+) bytes spill stores", line).group(1))
            elif entry and "registers" in line:
                out[entry][0] = int(re.search(r"Used (\d+) registers", line).group(1))
    return out


# -- phase 2: shared inputs --------------------------------------------------
def make_cache(rng, num_blocks, dtype, kvh=KVH, d=D, bs=BS):
    """Random paged K/V caches; an int8 cache comes with per-(block, kv
    head) scales."""
    shape = (num_blocks * bs, kvh, d)
    if dtype == torch.int8:
        k, v = (t_(rng.integers(-127, 128, shape).astype(np.int8)) for _ in range(2))
        ks, vs = (t_(rng.uniform(0.002, 0.02, (num_blocks, kvh)).astype(np.float32))
                  for _ in range(2))
        return dict(k=k, v=v, ks=ks, vs=vs)
    return dict(k=t_(rng.standard_normal(shape)).to(dtype),
                v=t_(rng.standard_normal(shape)).to(dtype))


def dense_kv(c):
    """The caches in q's dtype (int8 pages dequantized by their scales),
    for the library yardstick."""
    if "ks" not in c:
        return c["k"], c["v"]
    bs = c["k"].shape[0] // c["ks"].shape[0]
    return tuple(
        (c[n].float() * c[s].repeat_interleave(bs, 0)[:, :, None]).to(c["q"].dtype)
        for n, s in (("k", "ks"), ("v", "vs"))
    )


def disjoint_tables(rng, rows, max_blocks, num_blocks):
    ids = rng.permutation(np.arange(1, num_blocks))[: rows * max_blocks]
    return ids.reshape(rows, max_blocks).astype(np.int32)


def striped_tables(rng, rows, max_blocks, num_blocks, sp=SP):
    """Tables under the striped allocator: logical page i lives on shard
    i % sp, whose blocks are [r*nb/sp, (r+1)*nb/sp)."""
    local = num_blocks // sp
    pools = [list(rng.permutation(np.arange(r * local + 1, (r + 1) * local)))
             for r in range(sp)]
    tables = np.zeros((rows, max_blocks), np.int32)
    for b in range(rows):
        for i in range(max_blocks):
            tables[b, i] = pools[i % sp].pop()
    return tables


def gather_dense(k, v, tables, L, bs=BS):
    """Each row's first L keys gathered dense, heads repeated for GQA:
    [rows, H, L, D] — the library yardstick's input, built once."""
    keys = torch.arange(L, device=DEVICE)
    slots = tables.long()[:, keys // bs] * bs + keys % bs        # [rows, L]
    return tuple(x[slots].permute(0, 2, 1, 3).repeat_interleave(G, dim=1)
                 for x in (k, v))


# -- phase 2a: ragged ----------------------------------------------------------
def make_case(rng, spans, T, dtype, num_blocks=1024, max_blocks=48,
              dims=(H, KVH, D, BS), kv_dtype=None, gap=0):
    """Random paged caches and a flat batch for spans [(q_start, q_len)],
    packed from row 0 with ``gap`` unowned rows before each span; each
    span gets its own disjoint blocks."""
    h, kvh, d, bs = dims
    S = len(spans)
    c = make_cache(rng, num_blocks, kv_dtype or dtype, kvh, d, bs)
    tables = disjoint_tables(rng, S, max_blocks, num_blocks)
    q_start = np.array([a for a, _ in spans], np.int32)
    q_len = np.array([b for _, b in spans], np.int32)
    row_start = np.zeros(S, np.int32)
    token_seq = np.zeros(T, np.int32)
    token_pos = np.full(T, -1, np.int32)
    cursor = 0
    for s, (qs, ql) in enumerate(spans):
        cursor += gap
        row_start[s] = cursor
        token_seq[cursor:cursor + ql] = s
        token_pos[cursor:cursor + ql] = np.arange(qs, qs + ql)
        cursor += ql
    assert cursor <= T
    assert max(qs + ql for qs, ql in spans) <= max_blocks * bs
    c.update(
        q=t_(rng.standard_normal((T, h, d))).to(dtype), tables=t_(tables),
        q_start=t_(q_start), q_len=t_(q_len), kv_len=t_(q_start + q_len),
        row_start=t_(row_start), token_seq=t_(token_seq),
        token_pos=t_(token_pos), spans=spans, bs=bs,
    )
    return c


def run_kernel(c, window=0):
    """The wrapper's call; a bf16 call must launch the tensor-core tile and
    the split path, an f32 call the walk and the split path."""
    from dynamo_tpu_torch.ops.kernels.ragged_attention import (
        ragged_paged_attention_cuda as fn,
    )

    before = (fn.launches_tc, fn.launches_walk, fn.launches_split)
    out = fn(
        c["q"], c["k"], c["v"], c["tables"], c["q_start"], c["q_len"],
        c["kv_len"], c["row_start"], c["bs"], window=window,
        k_scales=c.get("ks"), v_scales=c.get("vs"),
    )
    bf16 = c["q"].dtype == torch.bfloat16
    moved = tuple(b - a for a, b in zip(before, (fn.launches_tc, fn.launches_walk,
                                                 fn.launches_split)))
    if moved != (int(bf16), int(not bf16), 1):
        raise SystemExit(f"ragged {c['q'].dtype} call launched the paths {moved}")
    return out


def run_plain(c, window=0):
    from dynamo_tpu_torch.ops.attention import ragged_paged_attention

    return ragged_paged_attention(
        c["q"], c["k"], c["v"], c["tables"], c["token_seq"], c["token_pos"],
        c["bs"], window, k_scales=c.get("ks"), v_scales=c.get("vs"),
    )


def ragged_work(c, window=0):
    """(bytes, flops) the function must move and do on these inputs:
    each span's visible K/V (and, for int8, its pages' scales) read once,
    q read once, out written once."""
    el_q, el_kv = c["q"].element_size(), c["k"].element_size()
    T = c["q"].shape[0]
    kv_bytes, flops = 0, 0
    for qs, ql in c["spans"]:
        if ql == 0:
            continue
        first = max(0, qs - window + 1) if window else 0
        kv_bytes += (qs + ql - first) * KVH * D * el_kv * 2
        if "ks" in c:
            kv_bytes += (-(-(qs + ql) // BS) - first // BS) * KVH * 4 * 2
        for pos in range(qs, qs + ql):
            lo = max(0, pos - window + 1) if window else 0
            flops += 4 * (pos + 1 - lo) * H * D
    io = 2 * T * H * D * el_q + c["tables"].numel() * 4 + 4 * 4 * len(c["spans"])
    return kv_bytes + io, flops


def ragged_library(c, window=0):
    """One scaled_dot_product_attention call over the spans padded — a
    yardstick only (the port never calls it): q [S, H, Qmax, D]; each
    span's visible keys gathered ONCE, [S, H, Lmax, D], the GQA heads
    repeated outside the timed call; a boolean mask with each row's
    causal, context and window bound (a row that sees nothing sees key 0,
    and is not compared). Returns (the call, giving (out [S, Qmax, H, D],
    owned rows [S, Qmax]), the flat rows [S, Qmax] its rows stand for)."""
    import torch.nn.functional as F

    T = c["q"].shape[0]
    Qmax = max(ql for _, ql in c["spans"])
    L = max(qs + ql for qs, ql in c["spans"])
    i = torch.arange(Qmax, device=DEVICE)
    rows = (c["row_start"].long()[:, None] + i).clamp(max=T - 1)          # [S, Qmax]
    owned = i[None, :] < c["q_len"].long()[:, None]
    qd = c["q"][rows].permute(0, 2, 1, 3).contiguous()                     # [S, H, Qmax, D]
    kd, vd = gather_dense(*dense_kv(c), c["tables"], L, c["bs"])
    keys = torch.arange(L, device=DEVICE)
    pos = c["q_start"].long()[:, None] + i                                  # [S, Qmax]
    mask = (keys <= pos[..., None]) & (keys < c["kv_len"].long()[:, None, None])
    if window:
        mask &= keys > pos[..., None] - window
    mask = (mask | (~mask.any(-1, keepdim=True) & (keys == 0)))[:, None]   # [S, 1, Qmax, L]
    return (lambda: (F.scaled_dot_product_attention(qd, kd, vd, attn_mask=mask)
                     .permute(0, 2, 1, 3), owned)), rows


def phase_ragged() -> tuple[dict, dict]:
    """Each case against the plain version, unowned rows exactly zero;
    the mixed T=256 batch (the serve's budget: 8 decode spans at contexts
    100–600, prefill spans of 64, 64 and 100 rows, an idle span) timed
    for both legs beside the fair per-span SDPA call. Every bf16 call
    must launch the tile and the split path, every f32 call the walk and
    the split path."""
    rng = np.random.default_rng(0)
    bf16, f32, int8 = torch.bfloat16, torch.float32, torch.int8
    decode = [(c - 1, 1) for c in (64, 130, 257, 300, 411, 512, 600, 1)]
    mixed = [(c - 1, 1) for c in (100, 180, 250, 333, 420, 480, 530, 600)] + [
        (0, 64), (128, 64), (32, 100), (0, 0)
    ]
    spec = [(300, 4), (50, 1), (0, 10), (0, 0)]
    # Spec-verify spans of 2, 4 and 8 rows (8 is past SPLIT_ROWS: the tile).
    spec_rows = [(700, 2), (333, 4), (900, 8), (511, 1), (0, 3), (0, 0)]
    # The longest context a 64-column table holds (many splits).
    long_decode = [(1023, 1), (0, 0), (640, 1)]
    # Spans that end mid-tile right before the next span's rows (37 and 45
    # rows x G = 4: 20 and 52 vectors into their last tile).
    trap = [(5, 37), (40, 3), (0, 45), (77, 1), (200, 130), (11, 5)]
    # With window 100: decode spans whose early splits lie wholly behind
    # it, a prefill span whose first chunks do, spec spans at long context.
    behind = [(1023, 1), (600, 100), (899, 4), (300, 8), (960, 2), (0, 0)]
    main = (H, KVH, D, BS)
    # (name, spans, T, q dtype, window, dims, kv dtype, make_case keywords)
    cases = [
        ("decode_only", decode, 16, bf16, 0, main, None, {}),
        ("prefill_prefix_hit", [(0, 128), (64, 100)], 256, bf16, 0, main, None, {}),
        ("mixed_T256", mixed, 256, bf16, 0, main, None, {}),
        ("spec_verify_4rows", spec, 16, bf16, 0, main, None, {}),
        ("spec_2_4_8rows", spec_rows, 32, bf16, 0, main, None, dict(max_blocks=64)),
        ("decode_ctx1024", long_decode, 8, bf16, 0, main, None, dict(max_blocks=64)),
        ("decode_ctx1024_w100", long_decode, 8, bf16, 100, main, None,
         dict(max_blocks=64)),
        ("trap_mid_tile_gaps", trap, 256, bf16, 0, main, None, dict(gap=3)),
        ("windowed_mixed", mixed, 256, bf16, 128, main, None, {}),
        ("window_behind_w100", behind, 160, bf16, 100, main, None, dict(max_blocks=64)),
        ("mixed_f32", mixed, 256, f32, 0, main, None, {}),
        ("spec_window_f32", behind, 160, f32, 100, main, None, dict(max_blocks=64)),
        ("int8_decode_only", decode, 16, bf16, 0, main, int8, {}),
        ("int8_mixed_T256", mixed, 256, bf16, 0, main, int8, {}),
        ("int8_windowed_mixed", mixed, 256, bf16, 128, main, int8, {}),
        ("int8_spec_verify_4rows", spec, 16, bf16, 0, main, int8, {}),
        ("int8_spec_2_4_8rows_w100", spec_rows, 32, bf16, 100, main, int8,
         dict(max_blocks=64)),
        ("int8_window_behind_w100", behind, 160, bf16, 100, main, int8,
         dict(max_blocks=64)),
        ("int8_trap_mid_tile_gaps", trap, 256, bf16, 0, main, int8, dict(gap=3)),
        ("int8_mixed_f32", mixed, 256, f32, 0, main, int8, {}),
        ("int8_spec_window_f32", behind, 160, f32, 100, main, int8, dict(max_blocks=64)),
    ]
    # Block size 4, and every head-dim template of the tile (16..256, 96 on
    # the 128 template) and of the walk, with G = 1, 2, 3, 4, 8, 16, on a
    # shorter mixed batch with a spec span.
    short = [(99, 1), (179, 1), (0, 64), (32, 100), (60, 3), (0, 0)]
    cases += [("bs4" + kv, [(150, 1), (0, 40), (60, 3), (100, 70), (0, 0)], 128, dt, w,
               (H, KVH, D, 4), kvd, dict(max_blocks=64))
              for dt in (bf16, f32) for kvd, kv in ((None, ""), (int8, "_int8"))
              for w in (0, 30)]
    for dims in [(4, 2, 16, 4), (8, 4, 32, 16), (8, 8, 96, 16), (24, 8, 96, 16),
                 (32, 2, 96, 16), (32, 8, 128, 16), (16, 2, 256, 16)]:
        for dt in (bf16, f32):
            for kv in (None, int8):
                name = "shape_H%d_kvH%d_D%d_bs%d" % dims + ("_int8" if kv else "")
                mb = 64 if dims[3] == 4 else 48
                cases.append((name, short, 256, dt, 0, dims, kv, dict(max_blocks=mb)))
    worst = {"plain": 0.0, "int8": 0.0}
    kept = {}
    for name, spans, T, dtype, window, dims, kv, kw in cases:
        c = make_case(rng, spans, T, dtype, dims=dims, kv_dtype=kv, **kw)
        got = run_kernel(c, window)
        want = run_plain(c, window)
        torch.cuda.synchronize()
        unowned = c["token_pos"] < 0
        pad_zero = bool((got[unowned] == 0).all().item())
        err = check("kernel", "ragged_" + name, {"max_abs_err": max_err(got, want)},
                    KERNEL_TOL[dtype], ok=pad_zero, dtype=str(dtype).split(".")[-1],
                    kv_dtype=str(kv or dtype).split(".")[-1], T=T,
                    spans=len(spans), window=window, H_kvH_D_bs=list(dims),
                    splits_pages=ragged_plan(c, window),
                    unowned_rows_zero=pad_zero)
        if dtype == bf16:
            leg = "int8" if kv else "plain"
            worst[leg] = max(worst[leg], err)
        if name in ("mixed_T256", "int8_mixed_T256"):
            kept[name] = c
    out = []
    for name in ("mixed_T256", "int8_mixed_T256"):
        c = kept[name]
        nbytes, flops = ragged_work(c)
        library, rows = ragged_library(c)
        out.append(timing(
            "ragged_" + name, lambda c=c: run_kernel(c), lambda c=c: run_plain(c),
            library, run_plain(c)[rows], nbytes, flops, torch.bfloat16,
        ))
    out[0]["max_abs_err"], out[1]["max_abs_err"] = worst["plain"], worst["int8"]
    return out[0], out[1]


def ragged_plan(c, window=0) -> list:
    """The split path's (splits, pages per split) for this case, as its
    wrapper computes it."""
    from dynamo_tpu_torch.ops.kernels.ragged_attention import call_split_plan

    return list(call_split_plan(c["q"], c["k"], c["tables"], c["bs"], window))


def contiguous_tables(lens, steps, max_blocks, bs=BS):
    """Each lane's blocks laid end to end from block 1, covering its
    prompt and `steps` more tokens: the phase-split run's block tables.
    Returns (per-lane block lists, [lanes, max_blocks] int32 table)."""
    blocks, nxt = [], 1
    for n in lens:
        need = -(-(n + steps + 1) // bs)
        blocks.append(list(range(nxt, nxt + need)))
        nxt += need
    table = np.zeros((len(lens), max_blocks), np.int32)
    for i, b in enumerate(blocks):
        table[i, :len(b)] = b
    return blocks, table


# -- phase 2b: decode ----------------------------------------------------------
def decode_case(rng, ctxs, dtype, striped=False, num_blocks=1024, max_blocks=48,
                tables=None, dims=(H, KVH, D, BS)):
    h, kvh, d, bs = dims
    c = make_cache(rng, num_blocks, dtype, kvh, d, bs)
    rows = len(ctxs)
    if tables is None:
        tables = (striped_tables if striped else disjoint_tables)(
            rng, rows, max_blocks, num_blocks)
    c.update(q=t_(rng.standard_normal((rows, h, d))).to(dtype), tables=t_(tables),
             ctx=t_(np.asarray(ctxs, np.int32)), ctxs=list(ctxs),
             local=num_blocks // SP, bs=bs)
    return c


def decode_kernel(c, window=0, **kw):
    from dynamo_tpu_torch.ops.kernels.paged_decode_attention import (
        paged_decode_attention_cuda,
    )

    return paged_decode_attention_cuda(
        c["q"], c["k"], c["v"], c["tables"], c["ctx"], c["bs"], window=window, **kw)


def decode_plain(c, window=0, **kw):
    from dynamo_tpu_torch.ops.attention import paged_decode_attention

    return paged_decode_attention(
        c["q"], c["k"], c["v"], c["tables"], c["ctx"], c["bs"], window, **kw)


def decode_plan(c, window=0, page_stride=1) -> list:
    """The kernel's (splits, pages per split) for this case, as its
    wrapper computes it."""
    from dynamo_tpu_torch.ops.kernels.paged_decode_attention import call_split_plan

    return list(call_split_plan(c["q"], c["k"], c["tables"], c["bs"], window, page_stride))


def shard_of(c, r):
    """Shard r's view of a striped case: its LOCAL cache slice and
    compacted stripe, and its page offset as a [1] int32 on the card."""
    from dynamo_tpu_torch.ops.attention import stripe_tables

    local = c["local"]
    sl = slice(r * local * BS, (r + 1) * local * BS)
    return dict(c, k=c["k"][sl], v=c["v"][sl],
                tables=stripe_tables(c["tables"], r, SP, local)), dict(
        page_offset=torch.tensor([r], dtype=torch.int32, device=DEVICE),
        page_stride=SP, with_stats=True)


def check_striped(phase, case, c, kernel, plain, window, tol, **extra):
    """Each shard's kernel call (out, m, l) against its plain version
    (l relative to max(l, 1): it sums up to hundreds of terms), and the
    merged shards against the unstriped kernel call and the unstriped
    plain version."""
    from dynamo_tpu_torch.ops.attention import merge_stats

    parts, errs = [], {"out": 0.0, "m": 0.0, "l_rel": 0.0}
    for r in range(SP):
        sc, kw = shard_of(c, r)
        got, want = kernel(sc, window, **kw), plain(sc, window, **kw)
        parts.append(got)
        errs["out"] = max(errs["out"], max_err(got[0], want[0]))
        errs["m"] = max(errs["m"], max_err(got[1], want[1]))
        rel = ((got[2] - want[2]).abs() / want[2].clamp(min=1.0)).max().item()
        errs["l_rel"] = max(errs["l_rel"], rel)
    # The unstriped calls with stats too: float32 out, as the merge's.
    merged = merge_stats(parts)
    whole = kernel(c, window, with_stats=True)[0]
    errs["merged_vs_unstriped_kernel"] = max_err(merged, whole)
    errs["merged_vs_unstriped_plain"] = max_err(
        merged, plain(c, window, with_stats=True)[0])
    return check(phase, case, errs, tol, shards=SP, window=window, **extra)


def decode_work(c):
    el = c["q"].element_size()
    keys = sum(c["ctxs"])
    nbytes = keys * KVH * D * el * 2 + 2 * c["q"].numel() * el + c["tables"].numel() * 4
    return nbytes, 4 * keys * H * D


def decode_library(c):
    import torch.nn.functional as F

    L = max(c["ctxs"])
    kd, vd = gather_dense(c["k"], c["v"], c["tables"], L)
    keys = torch.arange(L, device=DEVICE)
    mask = keys[None, :] < c["ctx"][:, None]
    mask = (mask | (c["ctx"][:, None] == 0) & (keys == 0)[None, :])[:, None, None, :]
    qd = c["q"][:, :, None, :]
    owned = c["ctx"] > 0
    return lambda: (F.scaled_dot_product_attention(qd, kd, vd, attn_mask=mask)[:, :, 0, :],
                    owned)


def phase_decode(lens, steps) -> dict:
    """The main case is the phase-split run's own: its lanes (prompts of
    `lens` tokens, contiguous tables of the full-width config's width),
    checked at its first, middle and last decode step and timed at the
    middle one. Then 8 lanes of contexts 1–600 with an idle lane (bf16
    and f32, windowed) and a striped sp=4 scan as further checks."""
    rng = np.random.default_rng(1)
    bf16, tol = torch.bfloat16, KERNEL_TOL
    ecfg = full_width_config()
    _, table = contiguous_tables(lens, steps, ecfg.max_blocks_per_seq)
    worst, main = 0.0, None
    for step in (0, steps // 2, steps - 1):
        c = decode_case(rng, [n + 1 + step for n in lens], bf16,
                        num_blocks=ecfg.num_blocks, tables=table)
        worst = max(worst, check(
            "kernel", f"decode_phases_step{step}",
            {"max_abs_err": max_err(decode_kernel(c), decode_plain(c))}, tol[bf16],
            lanes=len(lens), contexts=c["ctxs"], max_blocks=table.shape[1]))
        if step == steps // 2:
            main = c
    ctxs = [1, 64, 130, 257, 300, 411, 512, 600, 0]     # 8 lanes + an idle lane
    lanes32 = [int(x) for x in rng.integers(1, 385, 32)]
    lanes32[5] = lanes32[17] = 0                         # idle lanes
    # (name, contexts, dtypes, windows, make_cache/tables keywords): the
    # split kernel at one split (40 lanes fill the card), two (32 lanes),
    # many (1 lane at the longest context a 64-column table holds, with a
    # window that leaves whole splits behind), and the other head shapes
    # (head dims 16..256, G = 3 and G = 16, block size 4).
    cases = [
        ("", ctxs, (bf16, torch.float32), (0, 128), {}),
        ("_b1_ctx1024", [1024], (bf16,), (0, 128, 100), dict(max_blocks=64)),
        ("_b32", lanes32, (bf16, torch.float32), (0, 128), dict(max_blocks=24)),
        ("_b40", [int(x) for x in rng.integers(0, 385, 40)], (bf16,), (0,),
         dict(max_blocks=24)),
    ]
    short = [1, 77, 130, 300, 0]
    for dims in [(4, 2, 16, 4), (24, 8, 96, 16), (32, 8, 128, 16), (16, 2, 256, 16),
                 (32, 2, 64, 16)]:
        mb = 96 if dims[3] == 4 else 24
        cases.append(("_H%d_kvH%d_D%d_bs%d" % dims, short, (bf16, torch.float32), (0, 40),
                      dict(dims=dims, max_blocks=mb)))
    for name, cx, dtypes, windows, kw in cases:
        for dtype in dtypes:
            c = decode_case(rng, cx, dtype, **kw)
            for window in windows:
                got, want = decode_kernel(c, window), decode_plain(c, window)
                idle = [i for i, n in enumerate(cx) if n == 0]
                idle_zero = bool((got[idle] == 0).all().item()) if idle else True
                err = check("kernel", f"decode{name}_{str(dtype)[6:]}_w{window}",
                            {"max_abs_err": max_err(got, want)}, tol[dtype],
                            ok=idle_zero, lanes=len(cx), max_context=max(cx),
                            window=window, splits_pages=decode_plan(c, window),
                            H_kvH_D_bs=list(kw.get("dims", (H, KVH, D, BS))),
                            idle_lanes_zero=idle_zero)
                if dtype == bf16:
                    worst = max(worst, err)
    c = decode_case(rng, ctxs, bf16, striped=True)
    for window in (0, 128):
        check_striped("kernel", f"decode_striped_sp{SP}", c, decode_kernel,
                      decode_plain, window, tol[bf16],
                      splits_pages=decode_plan(shard_of(c, 0)[0], window, SP))
    nbytes, flops = decode_work(main)
    out = timing(f"decode_phases_{len(lens)}lanes_step{steps // 2}_bf16",
                 lambda: decode_kernel(main), lambda: decode_plain(main),
                 decode_library(main), decode_plain(main), nbytes, flops, bf16)
    out["max_abs_err"] = worst
    return out


# -- phase 2c: prefill -------------------------------------------------------
def prefill_case(rng, lanes, T, dtype, striped=False, num_blocks=1024, max_blocks=48,
                 tables=None, dims=(H, KVH, D, BS)):
    h, kvh, d, bs = dims
    c = make_cache(rng, num_blocks, dtype, kvh, d, bs)
    N = len(lanes)
    if tables is None:
        tables = (striped_tables if striped else disjoint_tables)(
            rng, N, max_blocks, num_blocks)
    c.update(q=t_(rng.standard_normal((N, T, h, d))).to(dtype), tables=t_(tables),
             q_start=t_(np.asarray([a for a, _ in lanes], np.int32)),
             total=t_(np.asarray([b for _, b in lanes], np.int32)),
             lanes=lanes, local=num_blocks // SP, bs=bs)
    return c


def prefill_kernel(c, window=0, **kw):
    """The wrapper's call; a bf16 call must go through the tensor-core
    entry and an f32 call through the walk."""
    from dynamo_tpu_torch.ops.kernels.paged_prefill_attention import (
        paged_prefill_attention_cuda as fn,
    )

    tc0 = fn.launches_tc
    out = fn(c["q"], c["k"], c["v"], c["tables"], c["q_start"], c["total"], c["bs"],
             window=window, **kw)
    want_tc = 1 if c["q"].dtype == torch.bfloat16 else 0
    if fn.launches_tc - tc0 != want_tc:
        raise SystemExit(f"prefill {c['q'].dtype} call took the wrong entry point")
    return out


def prefill_plain(c, window=0, **kw):
    from dynamo_tpu_torch.ops.attention import paged_prefill_attention

    return paged_prefill_attention(
        c["q"], c["k"], c["v"], c["tables"], c["q_start"], c["total"], c["bs"],
        window=window, **kw)


def prefill_work(c):
    el = c["q"].element_size()
    T = c["q"].shape[1]
    keys, flops = 0, 0
    for qs, total in c["lanes"]:
        if total == 0:
            continue
        keys += total
        flops += sum(4 * min(qs + t + 1, total) * H * D for t in range(T))
    nbytes = keys * KVH * D * el * 2 + 2 * c["q"].numel() * el + c["tables"].numel() * 4
    return nbytes, flops


def prefill_library(c):
    import torch.nn.functional as F

    T = c["q"].shape[1]
    L = max(total for _, total in c["lanes"])
    kd, vd = gather_dense(c["k"], c["v"], c["tables"], L)
    keys = torch.arange(L, device=DEVICE)
    qpos = c["q_start"][:, None] + torch.arange(T, device=DEVICE)   # [N, T]
    mask = (keys[None, None, :] <= qpos[:, :, None]) & (
        keys[None, None, :] < c["total"][:, None, None])
    mask = mask | (~mask.any(-1, keepdim=True) & (keys == 0))
    qd = c["q"].permute(0, 2, 1, 3)                                  # [N, H, T, D]
    owned = (c["total"] > 0)[:, None].expand(-1, T)
    return lambda: (F.scaled_dot_product_attention(
        qd, kd, vd, attn_mask=mask[:, None]).permute(0, 2, 1, 3), owned)


def phase_prefill(lens, steps) -> dict:
    """The main case is the phase-split run's prefill_batch: its lanes
    (whole prompts of `lens` tokens, no prefix), padded as the runner
    pads them (lanes and T to power-of-two buckets), on its contiguous
    tables; checked and timed. Then 4 lanes of T=256 with prefix hits,
    padded rows and an idle lane (bf16 and f32, windowed) and a striped
    sp=4 scan as further checks."""
    from dynamo_tpu_torch.engine.compile_cache import _bucket

    rng = np.random.default_rng(2)
    bf16 = torch.bfloat16
    ecfg = full_width_config()
    N, T = _bucket(len(lens), minimum=2), _bucket(max(lens))
    _, table = contiguous_tables(lens, steps, ecfg.max_blocks_per_seq)
    table = np.concatenate([table, np.zeros((N - len(lens), table.shape[1]), np.int32)])
    main = prefill_case(rng, [(0, n) for n in lens] + [(0, 0)] * (N - len(lens)), T,
                        bf16, num_blocks=ecfg.num_blocks, tables=table)
    worst = check("kernel", f"prefill_phases_{N}lanes_T{T}",
                  {"max_abs_err": max_err(prefill_kernel(main), prefill_plain(main))},
                  KERNEL_TOL[bf16], lanes=len(lens), T=T, prompt_lens=list(lens),
                  max_blocks=table.shape[1])
    # A whole prompt, a prefix hit, a prefix hit with padded rows, idle.
    lanes = [(0, 256), (128, 384), (64, 264), (0, 0)]
    # (name, lanes, T, dtypes, windows, keywords): the tile's causal and
    # window edges inside 64-key chunks (T=512 behind prefixes that are
    # no multiple of 64, windows of 100), block size 4, and every head
    # dim template (16..256, 96 on the 128 template) with G = 1, 3, 4,
    # 8, 16.
    cases = [
        ("", lanes, 256, (bf16, torch.float32), (0, 128), {}),
        ("_T512_prefix", [(37, 549), (200, 700), (5, 300), (0, 0)], 512, (bf16,),
         (0, 100), {}),
        ("_bs4", lanes, 256, (bf16, torch.float32), (0, 100),
         dict(dims=(H, KVH, D, 4), max_blocks=96)),
    ]
    for dims in [(4, 2, 16, 16), (8, 8, 64, 16), (24, 8, 96, 16), (32, 8, 128, 16),
                 (16, 2, 256, 16), (32, 2, 64, 16)]:
        cases.append(("_H%d_kvH%d_D%d_bs%d" % dims, lanes, 256, (bf16,), (0, 100),
                      dict(dims=dims)))
    for name, ln, rows, dtypes, windows, kw in cases:
        for dtype in dtypes:
            c = prefill_case(rng, ln, rows, dtype, **kw)
            for window in windows:
                got, want = prefill_kernel(c, window), prefill_plain(c, window)
                idle_zero = bool((got[-1] == 0).all().item())
                err = check("kernel", f"prefill{name}_{str(dtype)[6:]}_w{window}",
                            {"max_abs_err": max_err(got, want)}, KERNEL_TOL[dtype],
                            ok=idle_zero, lanes=len(ln), T=rows, window=window,
                            H_kvH_D_bs=list(kw.get("dims", (H, KVH, D, BS))),
                            idle_lane_zero=idle_zero)
                if dtype == bf16:
                    worst = max(worst, err)
    c = prefill_case(rng, lanes, 256, bf16, striped=True)
    for window in (0, 128):
        check_striped("kernel", f"prefill_striped_sp{SP}", c, prefill_kernel,
                      prefill_plain, window, KERNEL_TOL[bf16])
    nbytes, flops = prefill_work(main)
    out = timing(f"prefill_phases_{N}lanes_T{T}_bf16", lambda: prefill_kernel(main),
                 lambda: prefill_plain(main), prefill_library(main),
                 prefill_plain(main), nbytes, flops, bf16)
    out["max_abs_err"] = worst
    return out


# -- phases 3 to 7 -----------------------------------------------------------
async def serve(engine, prompts, max_tokens):
    """Submit every prompt at once through generate(); returns
    (streams, finish reasons, ttft seconds, wall seconds)."""
    from dynamo_tpu_torch.llm.protocols.common import (
        EngineOutput,
        PreprocessedRequest,
        SamplingOptions,
        StopConditions,
    )
    from dynamo_tpu_torch.runtime.engine import Context

    t0 = time.monotonic()

    async def one(p):
        pre = PreprocessedRequest(
            token_ids=p, sampling=SamplingOptions(temperature=0.0),
            stop=StopConditions(max_tokens=max_tokens, ignore_eos=True),
        )
        toks, finish, first = [], None, None
        async for raw in engine.generate(Context(pre.to_wire())):
            out = EngineOutput.from_wire(raw)
            if out.token_ids and first is None:
                first = time.monotonic() - t0
            toks.extend(out.token_ids)
            finish = out.finish_reason or finish
        return toks, finish, first

    results = await asyncio.gather(*[one(p) for p in prompts])
    wall = time.monotonic() - t0
    return (
        [r[0] for r in results], [r[1] for r in results],
        [r[2] for r in results], wall,
    )


async def serve_once(ecfg, params, prompts, max_tokens):
    from dynamo_tpu_torch.engine.engine import TorchEngine

    engine = TorchEngine(ecfg, params=params, device=DEVICE)
    await engine.start()
    try:
        streams, *_ = await serve(engine, prompts, max_tokens)
    finally:
        await engine.stop()
    return streams


def greedy_reference(cfg, params, prompt, n):
    from dynamo_tpu_torch.models import llama

    toks = list(prompt)
    out = []
    for _ in range(n):
        logits = llama.reference_forward(
            cfg, params, torch.tensor(toks, device=DEVICE)
        )
        nxt = int(torch.argmax(logits[-1]).item())
        toks.append(nxt)
        out.append(nxt)
    return out


def teacher_forced(cfg, params, prompts, streams) -> dict:
    """The no-cache reference (reference_forward) over each prompt and
    its stream, fed the stream's own tokens: finite logits of shape
    [T, V]; how often its argmax is the stream's next token; where it is
    not, how far the stream's token lies below the reference's top in
    log-probability (a near tie shows rounding, a wide gap a fault);
    the median gap between the reference's top two tokens, for scale;
    and the reference's log-probability of each stream's first token."""
    from dynamo_tpu_torch.models import llama

    hits, n, gaps, top2, first_lp = 0, 0, [], [], []
    finite = shape_ok = True
    for p, s in zip(prompts, streams):
        seq = torch.tensor(p + s, device=DEVICE)
        logits = llama.reference_forward(cfg, params, seq)
        finite &= bool(torch.isfinite(logits).all().item())
        shape_ok &= tuple(logits.shape) == (len(seq), cfg.vocab_size)
        lp = torch.log_softmax(logits[len(p) - 1:-1].float(), dim=-1)
        want = seq[len(p):].long()
        chosen = lp[torch.arange(len(s), device=DEVICE), want]
        best, arg = lp.max(dim=-1)
        hit = arg == want
        hits += int(hit.sum().item())
        n += len(s)
        gaps += (best - chosen)[~hit].tolist()
        two = lp.topk(2, dim=-1).values
        top2 += (two[:, 0] - two[:, 1]).tolist()
        first_lp.append(chosen[0].item())
    return {
        "logits_finite": finite, "logits_shape_ok": shape_ok,
        "greedy_agreement_vs_no_cache_reference": hits / max(n, 1),
        "disagreements": len(gaps),
        "max_logprob_gap_at_disagreement": max(gaps, default=0.0),
        "median_top2_logprob_gap": float(np.median(top2)),
        "first_token_ref_logprob": first_lp,
    }


def match_rate(a_streams, b_streams) -> float:
    pairs = [(x, y) for a, b in zip(a_streams, b_streams) for x, y in zip(a, b)]
    return sum(x == y for x, y in pairs) / max(len(pairs), 1)


def phase_split(runner, prompts, steps):
    """prefill_batch of the prompts, then decode_multi of ``steps`` steps
    on contiguous blocks; returns (per-prompt streams of steps + 1
    tokens, timings)."""
    B = len(prompts)
    blocks, table = contiguous_tables(
        [len(p) for p in prompts], steps, runner.cfg.max_blocks_per_seq,
        runner.cfg.block_size)
    lanes = [(p, b, 0, (0.0, 0, 1.0)) for p, b in zip(prompts, blocks)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    first = runner.prefill_batch(lanes)
    t1 = time.perf_counter()
    lens = np.asarray([len(p) for p in prompts], np.int32)
    zeros = np.zeros(B, np.float32)
    multi = runner.decode_multi(
        np.asarray(first, np.int32), lens, table, lens + 1, zeros,
        np.zeros(B, np.int32), zeros + 1.0, num_steps=steps,
    )
    t2 = time.perf_counter()
    streams = [[first[i]] + [int(row[i]) for row in multi] for i in range(B)]
    return streams, {"prefill_batch_ms": (t1 - t0) * 1e3,
                     "decode_multi_ms": (t2 - t1) * 1e3,
                     "decode_ms_per_step": (t2 - t1) * 1e3 / steps}


async def phase_tiny() -> None:
    from dynamo_tpu_torch.engine.config import EngineConfig
    from dynamo_tpu_torch.engine.engine import TorchEngine
    from dynamo_tpu_torch.engine.runner import ModelRunner
    from dynamo_tpu_torch.models import llama
    from dynamo_tpu_torch.models.config import ModelConfig

    cfg = ModelConfig.tiny_test()
    g = torch.Generator(device=DEVICE)
    g.manual_seed(0)
    params = llama.init_params(cfg, g, dtype=torch.float32, device=DEVICE)
    ecfg = EngineConfig(
        model=cfg, dtype="float32", block_size=4, num_blocks=64,
        max_num_seqs=4, max_model_len=128, unified_token_budget=64,
        unified_prefill_quantum=16,
    )
    engine = TorchEngine(ecfg, params=params, device=DEVICE)
    await engine.start()
    prompts = [[3, 1, 4, 1, 5], [2, 7, 1, 8], list(range(1, 41))]
    n = 8
    try:
        streams, finishes, _, _ = await serve(engine, prompts, n)
    finally:
        await engine.stop()
    want = [greedy_reference(cfg, params, p, n) for p in prompts]
    ok = streams == want
    emit({"phase": "tiny", "model": cfg.name, "dtype": "float32",
          "prompt_lens": [len(p) for p in prompts],
          "quantum": ecfg.unified_prefill_quantum, "streams_equal_reference": ok,
          "dispatches": engine.unified_dispatches})
    if not ok:
        raise SystemExit(f"tiny engine streams {streams} != reference {want}")

    int8 = await serve_once(dataclasses.replace(ecfg, kv_quant="int8"), params,
                            prompts, n)
    rate = match_rate(int8, want)
    emit({"phase": "tiny_int8", "model": cfg.name, "kv_quant": "int8",
          "greedy_match_rate_vs_unquantized": rate, "gate": 0.7, "ok": rate >= 0.7})
    if rate < 0.7:
        raise SystemExit(f"tiny int8 serve matched {rate:.2f} < 0.7")

    runner = ModelRunner(ecfg, params=params, device=DEVICE)
    split, _ = phase_split(runner, prompts, n - 1)
    ok = split == want
    emit({"phase": "tiny_phases", "model": cfg.name, "dtype": "float32",
          "prefill_batch_decode_multi_equal_reference": ok})
    if not ok:
        raise SystemExit(f"tiny prefill_batch + decode_multi {split} != {want}")


def full_width_config(**kw):
    from dynamo_tpu_torch.engine.config import EngineConfig
    from dynamo_tpu_torch.models.config import ModelConfig

    return EngineConfig(**{
        "model": ModelConfig.llama32_1b(), "dtype": "bfloat16", "block_size": 16,
        "num_blocks": 1024, "max_num_seqs": 8, "max_model_len": 1024,
        "prefill_batch": 4, "unified_token_budget": 256,
        "unified_prefill_quantum": 64, "seed": 0, **kw,
    })


async def serve_full(ecfg, prompts, max_tokens, phase, profile_prompts=None):
    """Serve at full width with the ragged kernel's launches counted over
    exactly this serve; returns (result line, engine, streams)."""
    from dynamo_tpu_torch.engine.engine import TorchEngine
    from dynamo_tpu_torch.llm.protocols.common import FinishReason
    from dynamo_tpu_torch.ops.kernels.ragged_attention import (
        ragged_paged_attention_cuda as fn,
    )
    from dynamo_tpu_torch.ops.kernels.ragged_attention import reset_counts

    cfg = ecfg.model
    # Random weights from torch.Generator(seed=ecfg.seed) on the card.
    engine = TorchEngine(ecfg, device=DEVICE)
    await engine.start()
    profile = None
    try:
        capture = await warm_up(engine)
        recorded = record_dispatches(engine.runner)
        reset_counts()
        streams, finishes, ttft, wall = await serve(engine, prompts, max_tokens)
        recorded.stop()
        capture["mid_traffic_compiles_total"] = mid_traffic(engine)
        launches = fn.launches
        paths = {"tc": fn.launches_tc, "split": fn.launches_split, "walk": fn.launches_walk}
        dispatches = engine.unified_dispatches
        prefill_tokens = engine.unified_prefill_tokens
        decode_tokens = engine.unified_decode_tokens
        if profile_prompts is not None:
            profile = await profile_serve(engine, profile_prompts, max_tokens)
            profile["of"] = phase
    finally:
        await engine.stop()
    full = all(len(s) == max_tokens for s in streams) and all(
        f is FinishReason.LENGTH for f in finishes
    )
    in_vocab = all(0 <= t < cfg.vocab_size for s in streams for t in s)
    # The served model's logits on every request, recomputed without the
    # cache and fed the streams' own tokens.
    ref = teacher_forced(cfg, engine.runner.params, prompts, streams)
    ref.pop("first_token_ref_logprob")
    total = sum(len(s) for s in streams)
    result = {
        "phase": phase, "model": cfg.name, "dtype": ecfg.dtype,
        "kv_quant": ecfg.kv_quant, "requests": len(prompts),
        "prompt_lens": [len(p) for p in prompts],
        "max_tokens": max_tokens, "generated_tokens": total,
        "wall_s": wall, "tokens_per_s": total / wall,
        "ttft_p50_ms": float(np.median(ttft)) * 1e3,
        "ttft_max_ms": max(ttft) * 1e3,
        "unified_dispatches": dispatches,
        "prefill_tokens": prefill_tokens, "decode_tokens": decode_tokens,
        "kernel_launches": launches, "kernel_launches_by_path": paths,
        "num_layers": cfg.num_layers, "capture": capture,
        "streams_full_length": full, "tokens_in_vocab": in_vocab, **ref,
    }
    emit(result)
    if profile is not None:
        emit(profile)
    check_capture(phase, capture)
    if launches != cfg.num_layers * dispatches or dispatches == 0:
        raise SystemExit(
            f"{phase}: kernel launched {launches} times for {dispatches} "
            f"dispatches x {cfg.num_layers} layers"
        )
    # bf16 q: every call runs the multi-row spans on the tensor-core tile
    # and the one-row spans on the split path; the f32 walk never runs.
    if paths != {"tc": launches, "split": launches, "walk": 0}:
        raise SystemExit(f"{phase}: ragged paths launched {paths} for {launches} calls")
    if not (full and in_vocab and ref["logits_finite"] and ref["logits_shape_ok"]):
        raise SystemExit(f"{phase}: served streams failed their checks")
    result["recorded"] = recorded.calls
    return result, engine, streams


async def warm_up(engine) -> dict:
    """``engine.warmup()`` (one CUDA graph per program of the plan) and
    what it made: graphs, the seconds of their warm passes and captures,
    the pool's bytes."""
    t0 = time.monotonic()
    programs = await engine.warmup()
    wall = time.monotonic() - t0
    return {"warmup_programs": programs, "warmup_wall_s": wall,
            **engine.runner.compile_stats.capture_snapshot()}


def mid_traffic(engine) -> int:
    return engine.runner.compile_stats.snapshot()["mid_traffic_compiles_total"]


def check_capture(phase: str, capture: dict) -> None:
    """After a full warmup every dispatch replays a graph captured ahead
    of traffic: none is captured mid-traffic."""
    if capture["graphs_captured"] != capture["warmup_programs"] or not capture[
            "graphs_captured"]:
        raise SystemExit(f"{phase}: {capture['graphs_captured']} graphs captured "
                         f"for {capture['warmup_programs']} warmup programs")
    if capture["mid_traffic_compiles_total"]:
        raise SystemExit(f"{phase}: {capture['mid_traffic_compiles_total']} "
                         f"mid-traffic captures after warmup: "
                         f"{capture['mid_traffic_keys']}")


class record_dispatches:
    """Records every ``unified_step`` call of a runner (copies of its
    lanes, feed rows, drafts and extras) until ``stop()``; the ``graphs``
    and ``spec`` phases replay and inspect them."""

    def __init__(self, runner) -> None:
        self.runner, self.calls = runner, []
        step = runner.unified_step

        def recording(lanes, feed=None, draft_lens=None, extras=None):
            fed = None if feed is None else (
                feed[0] is not None, np.array(feed[1]), np.array(feed[2]))
            self.calls.append((
                [(list(t), list(b), p, tuple(smp)) for t, b, p, smp in lanes],
                fed, None if draft_lens is None else list(draft_lens),
                None if extras is None else {k: list(v) for k, v in extras.items()},
            ))
            return step(lanes, feed=feed, draft_lens=draft_lens, extras=extras)

        runner.unified_step = recording

    def stop(self) -> None:
        del self.runner.unified_step


async def profile_serve(engine, prompts, max_tokens) -> dict:
    """Serve `prompts` under torch.profiler; device time by kernel name
    and the busy share of the profiled wall."""
    from torch.profiler import ProfilerActivity, profile

    d0 = engine.unified_dispatches
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        *_, wall = await serve(engine, prompts, max_tokens)
        torch.cuda.synchronize()
    by_kernel: dict[str, float] = {}
    for e in prof.events():   # device-side events only: kernels and copies
        if str(e.device_type).endswith("CUDA"):
            name = e.name[:48]
            by_kernel[name] = by_kernel.get(name, 0.0) + e.time_range.elapsed_us() / 1e3
    busy = sum(by_kernel.values())
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:8]
    n = engine.unified_dispatches - d0
    return {
        "phase": "profile", "dispatches": n, "profiled_wall_ms": wall * 1e3,
        "device_busy_ms": busy, "device_busy_share": busy / (wall * 1e3),
        "wall_ms_per_dispatch": wall * 1e3 / n,
        "device_ms_per_dispatch": busy / n,
        "top_kernels_ms": [[k, v, v / busy] for k, v in top],
    }


def cache_difference(a, b, bs: int) -> str | None:
    """Where two runners' KV caches (bytes) or int8 scales differ outside
    trash block 0, or None."""
    for li, ((ka, va), (kb, vb)) in enumerate(zip(a.kv_caches, b.kv_caches)):
        for name, x, y in (("k", ka, kb), ("v", va, vb)):
            if x.dtype != torch.int8:
                x, y = x.view(torch.int16), y.view(torch.int16)
            rows = (x[bs:] != y[bs:]).reshape(x.shape[0] - bs, -1).any(dim=1)
            if bool(rows.any()):
                slot = int(rows.nonzero()[0]) + bs
                return f"layer {li} {name} cache, slot {slot} (block {slot // bs})"
    if a.kv_scales is not None:
        ne = a.kv_scales[:, :, 1:] != b.kv_scales[:, :, 1:]
        if bool(ne.any()):
            li, kv, blk, h = (int(x) for x in ne.nonzero()[0])
            return f"scales layer {li} {'kv'[kv]}, block {blk + 1} head {h}"
    return None


def replay_recorded(runner, step, recorded, depth: int = 2):
    """Issue the recorded dispatches through ``step`` pipelined ``depth``
    deep, each fed by the previous one's device tokens; returns (tokens
    per dispatch, wall s, host s spent inside ``step``)."""
    torch.cuda.synchronize()
    prev, inflight, toks, host = None, [], [], 0.0
    t0 = time.perf_counter()
    for lanes, fed, draft_lens, extras in recorded:
        h0 = time.perf_counter()
        feed = None if fed is None else (prev if fed[0] else None, fed[1], fed[2])
        out = step(lanes, feed=feed, draft_lens=draft_lens, extras=extras)
        host += time.perf_counter() - h0
        prev = out.last
        inflight.append(out)
        if len(inflight) >= depth:
            toks.append(inflight.pop(0).tokens().copy())
    while inflight:
        toks.append(inflight.pop(0).tokens().copy())
    return toks, time.perf_counter() - t0, host


def profiled_device_ms(fn) -> float:
    """Sum of the card's kernel and copy times while ``fn`` runs
    (torch.profiler; kernels inside graph replays included)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.time_range.elapsed_us() / 1e3 for e in prof.events()
               if str(e.device_type).endswith("CUDA"))


def phase_graphs(params, recorded, kv_quant, phase) -> dict:
    """The serve's dispatches through two runners on the serve's weights
    with caches that start equal: one replays its captured graphs, the
    other runs the eager step body. Every dispatch's sampled tokens, and
    in the end the K/V bytes and int8 scales outside trash block 0, must
    be identical; then wall, host and device ms per dispatch of each,
    in turns (graph, eager, eager, graph), and the device's busy share."""
    from dynamo_tpu_torch.engine.runner import ModelRunner

    ecfg = full_width_config(kv_quant=kv_quant)
    graph = ModelRunner(ecfg, params=params, device=DEVICE)
    eager = ModelRunner(ecfg, params=params, device=DEVICE)
    graph.warmup()
    programs = graph.compile_stats.capture_snapshot()["graphs_captured"]
    got = replay_recorded(graph, graph.unified_step, recorded, depth=1)[0]
    want = replay_recorded(eager, eager.unified_step_eager, recorded, depth=1)[0]
    torch.cuda.synchronize()
    token_mismatch = [i for i, (a, b) in enumerate(zip(got, want))
                      if not np.array_equal(a, b)]
    where = cache_difference(graph, eager, ecfg.block_size)
    legs = {"graph": (graph, graph.unified_step), "eager": (eager, eager.unified_step_eager)}
    timed: dict[str, dict[str, list]] = {k: {} for k in legs}
    for name in ("graph", "eager", "eager", "graph"):
        runner, step = legs[name]
        _, wall, host = replay_recorded(runner, step, recorded)
        n = len(recorded)
        timed[name].setdefault("wall_ms_per_dispatch", []).append(wall * 1e3 / n)
        timed[name].setdefault("host_ms_per_dispatch", []).append(host * 1e3 / n)
    for name, (runner, step) in legs.items():
        holder = {}

        def run(runner=runner, step=step):
            holder["wall"] = replay_recorded(runner, step, recorded)[1]

        dev = profiled_device_ms(run)
        n = len(recorded)
        timed[name]["device_ms_per_dispatch"] = dev / n
        timed[name]["profiled_wall_ms_per_dispatch"] = holder["wall"] * 1e3 / n
        timed[name]["device_busy_share"] = dev / (holder["wall"] * 1e3)
    summary = {
        name: {k: (float(np.median(v)) if isinstance(v, list) else v)
               for k, v in t.items()} for name, t in timed.items()}
    result = {
        "phase": phase, "model": ecfg.model.name, "dtype": ecfg.dtype,
        "kv_quant": kv_quant, "dispatches": len(recorded),
        "graphs_captured": programs,
        "tokens_identical": not token_mismatch,
        "dispatches_with_token_mismatch": token_mismatch[:8],
        "kv_bytes_and_scales_identical_outside_trash_block": where is None,
        "first_difference": where, **summary,
        "runs": timed,
    }
    emit(result)
    if token_mismatch or where is not None:
        raise SystemExit(f"{phase}: replays differ from the eager body "
                         f"(dispatches {token_mismatch[:8]}; {where})")
    del graph, eager
    torch.cuda.empty_cache()
    return result


def repeated_prompts(rng, vocab) -> list[list[int]]:
    """Two prompts built of repeated n-grams, so prompt lookup drafts."""
    a = rng.integers(0, vocab, 6).tolist()
    b = rng.integers(0, vocab, 11).tolist()
    return [a * 16, b * 9]


async def spec_leg(dtype, k, prompts, max_tokens) -> dict:
    """One llama3.2-1b engine in ``dtype`` with ``speculative_k=k``, warmed
    up, serving ``prompts``: its streams, launches by path, capture and
    the draft-verify spans it issued."""
    from dynamo_tpu_torch.engine.engine import TorchEngine
    from dynamo_tpu_torch.ops.kernels.ragged_attention import (
        ragged_paged_attention_cuda as fn,
    )
    from dynamo_tpu_torch.ops.kernels.ragged_attention import reset_counts

    engine = TorchEngine(full_width_config(speculative_k=k, dtype=dtype), device=DEVICE)
    await engine.start()
    try:
        capture = await warm_up(engine)
        recorded = record_dispatches(engine.runner)
        reset_counts()
        d0 = engine.unified_dispatches
        streams, _, _, wall = await serve(engine, prompts, max_tokens)
        recorded.stop()
        capture["mid_traffic_compiles_total"] = mid_traffic(engine)
        ready = engine.readiness()
        return {
            "streams": streams, "params": engine.runner.params,
            "dispatches": engine.unified_dispatches - d0, "wall_s": wall,
            "kernel_launches": fn.launches,
            "paths": {"tc": fn.launches_tc, "split": fn.launches_split,
                      "walk": fn.launches_walk},
            "capture": capture,
            "verify_rows": [1 + dl for _, _, dls, _ in recorded.calls
                            for dl in (dls or []) if dl],
            "drafted_tokens": ready["spec_drafted_tokens_total"],
            "accepted_tokens": ready["spec_accepted_tokens_total"],
            "tokens_per_step": ready["spec_tokens_per_step"],
            "spec_active_at_end": ready["spec_active"],
        }
    finally:
        await engine.stop()


async def phase_spec(prompts, max_tokens) -> dict:
    """A speculative_k=4 engine against a speculative_k=0 one on the same
    weights and prompts, in float32 and in bf16. Greedy decoding is
    batch-invariant only up to rounding: speculation changes how tokens
    are batched (the verify rows, pipeline depth 1), so a near tie in the
    logits can fall either way. In float32 a tie within rounding is rare
    enough that the streams must be byte-identical; in bf16 (ulp 0.0039
    at these logits, median top-two gap 0.023 nats) both engines' streams
    are held to the no-cache reference instead: agreement >=
    PHASES_AGREEMENT, every disagreement a near tie. Both legs: drafts
    accepted, every ragged call launched on its dtype's paths (bf16: tile
    and split; float32: walk and split), verify spans of 2-5 rows."""
    k = 4
    cfg = full_width_config().model
    L = cfg.num_layers
    result = {"phase": "spec", "model": cfg.name, "speculative_k": k,
              "requests": len(prompts), "max_tokens": max_tokens}
    failures = []
    for dtype, long_path in (("float32", "walk"), ("bfloat16", "tc")):
        legs = {kk: await spec_leg(dtype, kk, prompts, max_tokens) for kk in (0, k)}
        spec, plain = legs[k], legs[0]
        rows = spec.pop("verify_rows")
        plain.pop("verify_rows")
        identical = spec["streams"] == plain["streams"]
        first_diff = next(((i, j) for i, (a, b) in enumerate(
            zip(spec["streams"], plain["streams"])) for j, (x, y) in enumerate(zip(a, b))
            if x != y), None)
        leg = {
            "streams_identical_to_speculative_k_0": identical,
            "token_match_rate_vs_speculative_k_0": match_rate(spec["streams"],
                                                              plain["streams"]),
            "first_difference": first_diff,
            "verify_span_rows": {str(r): rows.count(r) for r in sorted(set(rows))},
            **{key: spec[key] for key in ("drafted_tokens", "accepted_tokens",
                                          "tokens_per_step", "spec_active_at_end")},
        }
        params = spec.pop("params")
        plain.pop("params")
        if dtype == "bfloat16":
            for name, run in (("spec", spec), ("plain", plain)):
                ref = teacher_forced(cfg, params, prompts, run["streams"])
                leg[f"reference_{name}"] = {key: ref[key] for key in (
                    "greedy_agreement_vs_no_cache_reference",
                    "max_logprob_gap_at_disagreement")}
                if (ref["greedy_agreement_vs_no_cache_reference"] < PHASES_AGREEMENT
                        or ref["max_logprob_gap_at_disagreement"] > NEAR_TIE_NATS):
                    failures.append(f"{dtype} {name} streams vs the reference {ref}")
        elif not identical:
            failures.append(f"{dtype}: streams differ from speculative_k=0 at {first_diff}")
        for name, run in (("spec", spec), ("plain", plain)):
            run.pop("streams")
            leg[name] = run
            n = run["dispatches"]
            want = {"tc": 0, "split": L * n, "walk": 0, long_path: L * n}
            if run["kernel_launches"] != L * n or run["paths"] != want:
                failures.append(f"{dtype} {name}: ragged launches {run['kernel_launches']}, "
                                f"paths {run['paths']} for {n} dispatches")
            try:
                check_capture(f"spec {dtype} {name}", run["capture"])
            except SystemExit as exc:
                failures.append(str(exc))
        if not leg["accepted_tokens"] > 0 or not rows or not all(
                2 <= r <= k + 1 for r in rows):
            failures.append(f"{dtype}: accepted {leg['accepted_tokens']}, "
                            f"verify spans {rows[:16]}")
        result[dtype] = leg
    result["gates"] = {"float32": "streams byte-identical",
                       "bfloat16": {"agreement_min": PHASES_AGREEMENT,
                                    "gap_max": NEAR_TIE_NATS}}
    emit(result)
    if failures:
        raise SystemExit("spec: " + "; ".join(failures))
    return result


def reference_logprobs(cfg, params, prompt, stream, freq=0.0, pres=0.0) -> dict:
    """The no-cache reference fed ``stream``: at each generated position
    the log-softmax of its logits after the penalties over the tokens
    generated before it; its log-probability of each stream token, its
    argmax agreement, and the widest gap at a disagreement."""
    from dynamo_tpu_torch.models import llama

    seq = torch.tensor(prompt + stream, device=DEVICE)
    logits = llama.reference_forward(cfg, params, seq)[len(prompt) - 1:-1].float()
    want = seq[len(prompt):].long()
    onehot = torch.nn.functional.one_hot(want, cfg.vocab_size).float()
    before = torch.cumsum(onehot, dim=0) - onehot             # counts before i
    lp = torch.log_softmax(logits - freq * before - pres * (before > 0).float(), -1)
    chosen = lp[torch.arange(len(stream), device=DEVICE), want]
    best, arg = lp.max(dim=-1)
    hit = arg == want
    return {"logprobs": chosen.tolist(), "agreement": float(hit.float().mean()),
            "max_gap": float((best - chosen)[~hit].max()) if bool((~hit).any()) else 0.0}


async def phase_extras(port, engine, tapped, prompts, max_tokens) -> dict:
    """Sampling extras through the OpenAI server, for two of the serve's
    prompts: a completion with ``logprobs``, the completion again with
    frequency/presence penalties (``logprobs`` too), and one chat with
    ``top_logprobs``. Every chosen-token logprob must match the no-cache
    reference's within FIRST_LOGPROB_TOL (bf16 logits); the plain streams,
    and apart from them the penalized ones against the penalized
    reference, must pass the teacher-forced gate of the serves (pooled
    agreement >= PHASES_AGREEMENT, every disagreement a near tie); a
    penalized stream must differ from its plain one."""
    from dynamo_tpu_torch.llm.http_client import fetch
    from dynamo_tpu_torch.ops.kernels.ragged_attention import (
        ragged_paged_attention_cuda as fn,
    )
    from dynamo_tpu_torch.ops.kernels.ragged_attention import reset_counts

    cfg, params = engine.cfg.model, engine.runner.params
    greedy = {"model": cfg.name, "temperature": 0, "max_tokens": max_tokens,
              "nvext": {"ignore_eos": True}}
    freq, pres = 1.5, 0.5
    chat = [{"role": "user", "content": "Paged attention keeps each sequence's keys "
             "and values in fixed blocks; a block table maps positions to blocks, "
             "so prefix caching can share the blocks of a common prompt."}]
    requests = []
    for i, p in enumerate(prompts):
        requests += [(f"logprobs_{i}", "/v1/completions", {"prompt": p, "logprobs": 5}),
                     (f"penalized_{i}", "/v1/completions", {
                         "prompt": p, "logprobs": 1, "frequency_penalty": freq,
                         "presence_penalty": pres})]
    requests.append(("chat_top_logprobs", "/v1/chat/completions",
                     {"messages": chat, "logprobs": True, "top_logprobs": 3}))
    saved = dict(tapped)
    reset_counts()
    d0 = engine.unified_dispatches
    runs, pooled = {}, {"plain": [0, 0, 0.0], "penalized": [0, 0, 0.0]}
    for name, path, body in requests:
        tapped.clear()
        resp = await fetch("127.0.0.1", port, "POST", path, {**greedy, **body})
        if resp.status != 200:
            raise SystemExit(f"extras: {name} answered {resp.status}: {resp.body[:300]}")
        (prompt_ids, ids), = tapped.items()
        lp = resp.json()["choices"][0]["logprobs"]
        if path.endswith("chat/completions"):
            got = [e["logprob"] for e in lp["content"]]
            tops = [[t["logprob"] for t in e["top_logprobs"]] for e in lp["content"]]
        else:
            got = lp["token_logprobs"]
            tops = [list(t.values()) if t else [] for t in lp["top_logprobs"]]
        penalized = name.startswith("penalized")
        ref = reference_logprobs(cfg, params, list(prompt_ids), ids,
                                 *((freq, pres) if penalized else (0.0, 0.0)))
        err = max(abs(a - b) for a, b in zip(got, ref["logprobs"]))
        pool = pooled["penalized" if penalized else "plain"]
        pool[0] += round(ref["agreement"] * len(ids))
        pool[1] += len(ids)
        pool[2] = max(pool[2], ref["max_gap"])
        runs[name] = {"stream": ids, "tokens": len(ids), "logprobs_returned": len(got),
                      "top_per_token": sorted({len(t) for t in tops}),
                      "max_logprob_err_vs_reference": err,
                      "agreement_vs_reference": ref["agreement"],
                      "max_gap_at_disagreement": ref["max_gap"]}
    launches, dispatches = fn.launches, engine.unified_dispatches - d0
    tapped.clear()
    tapped.update(saved)
    differs = [runs[f"penalized_{i}"]["stream"] != runs[f"logprobs_{i}"]["stream"]
               for i in range(len(prompts))]
    agreement = {k: {"agreement": hit / n, "tokens": n, "max_gap": gap}
                 for k, (hit, n, gap) in pooled.items()}
    result = {
        "phase": "extras", "model": cfg.name, "max_tokens": max_tokens,
        "frequency_penalty": freq, "presence_penalty": pres,
        "penalized_streams_differ": differs, "pooled_vs_reference": agreement,
        "unified_dispatches": dispatches, "kernel_launches": launches,
        "mid_traffic_compiles_total": mid_traffic(engine),
        "gates": {"logprob_err_max": FIRST_LOGPROB_TOL, "agreement_min": PHASES_AGREEMENT,
                  "gap_max": NEAR_TIE_NATS},
        **{name: {k: v for k, v in r.items() if k != "stream"} for name, r in runs.items()},
    }
    emit(result)
    # Completions key their alternatives by token text, and the toy
    # tokenizer decodes many ids to "", so up to k entries there.
    for name, r in runs.items():
        want_top = ([3] if name.startswith("chat") else [1] if name.startswith("pen")
                    else range(1, 6))
        if (r["tokens"] != max_tokens or r["logprobs_returned"] != max_tokens
                or not set(r["top_per_token"]) <= set(want_top)
                or r["max_logprob_err_vs_reference"] > FIRST_LOGPROB_TOL):
            raise SystemExit(f"extras: {name} failed its gates: "
                             f"{ {k: v for k, v in r.items() if k != 'stream'} }")
    for kind, a in agreement.items():
        if a["agreement"] < PHASES_AGREEMENT or a["max_gap"] > NEAR_TIE_NATS:
            raise SystemExit(f"extras: {kind} streams vs the reference {a}")
    # A stream with no repeated token is left as it was by the penalties;
    # one at least must show them at work.
    if not any(differs):
        raise SystemExit(f"extras: the penalized streams equal the plain ones {differs}")
    if launches != cfg.num_layers * dispatches or not dispatches:
        raise SystemExit(f"extras: kernel launched {launches} times for "
                         f"{dispatches} dispatches")
    if result["mid_traffic_compiles_total"]:
        raise SystemExit("extras: a program was captured mid-traffic")
    return result


HTTP_ARGS = [
    "run", "--out", "torch", "--model-path", "preset:llama3.2-1b",
    "--num-blocks", "1024", "--max-num-seqs", "8", "--max-model-len", "1024",
    "--prefill-batch", "4", "--unified-token-budget", "256",
    "--unified-prefill-quantum", "64",
]


async def http_stream(port, path, body, on_event=None):
    """POST a streaming request; (response, [(seconds since send, event)])
    for every SSE event, timed as its chunk arrived. ``on_event(t, event)``
    sees each event as it arrives."""
    from dynamo_tpu_torch.llm.http_client import fetch
    from dynamo_tpu_torch.llm.protocols.sse import decode_stream

    timed = []
    t0 = time.perf_counter()

    def got(piece: bytes) -> None:
        t = time.perf_counter() - t0
        for ev in decode_stream(piece.decode()):
            timed.append((t, ev))
            if on_event is not None:
                on_event(t, ev)

    resp = await fetch("127.0.0.1", port, "POST", path, body, on_chunk=got)
    return resp, timed


def stream_summary(timed) -> dict:
    """Text, finish, usage and the token events' arrival times of a
    streamed completion."""
    text, finish, usage, times = "", None, None, []
    for t, ev in timed:
        if ev.data == "[DONE]":
            continue
        chunk = json.loads(ev.data)
        if "error" in chunk:
            raise SystemExit(f"http: stream error {chunk}")
        for ch in chunk.get("choices", []):
            times.append(t)
            text += ch.get("text") or ""
            finish = ch.get("finish_reason") or finish
        usage = chunk.get("usage") or usage
    return {"text": text, "finish": finish, "usage": usage, "times": times}


async def phase_http(prompts, serve_streams, max_tokens, served, more_prompts) -> dict:
    """The main path through the OpenAI server: see the module docstring
    (phase 7)."""
    from dynamo_tpu_torch import cli
    from dynamo_tpu_torch.llm.http_client import fetch
    from dynamo_tpu_torch.llm.tokenizer import (
        ToyTokenizer,
        render_default_chat_template,
    )
    from dynamo_tpu_torch.ops.kernels.ragged_attention import (
        ragged_paged_attention_cuda as fn,
    )
    from dynamo_tpu_torch.ops.kernels.ragged_attention import reset_counts
    from dynamo_tpu_torch.runtime.pipeline import Tap

    args = cli.build_parser().parse_args(
        HTTP_ARGS + ["--http-host", "127.0.0.1", "--http-port", "0"])
    cli.refuse_unserved(args)
    tapped: dict[tuple, list[int]] = {}   # prompt token ids -> engine tokens
    tap = Tap(
        on_request=lambda ctx: tapped.setdefault(tuple(ctx.payload["token_ids"]), []),
        on_response=lambda ctx, item: tapped[tuple(ctx.payload["token_ids"])].extend(
            item["token_ids"]),
    )
    rng = np.random.default_rng(2)
    words = ["alpha", "beta", "gamma", "delta", "kernel", "cache", "token", "page"]
    chats = [[{"role": "user", "content": " ".join(rng.choice(words, 12))}]
             for _ in range(2)]
    greedy = {"temperature": 0, "max_tokens": max_tokens, "nvext": {"ignore_eos": True}}
    async with contextlib.AsyncExitStack() as stack:
        t_start = time.monotonic()
        service, engine = await cli.start_http(args, stack, engine_ops=(tap,))
        startup_s = time.monotonic() - t_start
        port = service.port
        cfg = engine.cfg.model
        reset_counts()
        d0 = engine.unified_dispatches
        t0 = time.perf_counter()
        streamed = await asyncio.gather(*[
            http_stream(port, "/v1/completions",
                        {"model": cfg.name, "prompt": p, "stream": True, **greedy})
            for p in prompts])
        wall = time.perf_counter() - t0
        aggregated = await asyncio.gather(*[
            fetch("127.0.0.1", port, "POST", "/v1/chat/completions",
                  {"model": cfg.name, "messages": m, **greedy}) for m in chats])
        launches = fn.launches
        paths = {"tc": fn.launches_tc, "split": fn.launches_split,
                 "walk": fn.launches_walk}
        dispatches = engine.unified_dispatches - d0
        gets = {path: await fetch("127.0.0.1", port, "GET", path)
                for path in ("/v1/models", "/health", "/metrics")}
        await phase_extras(port, engine, tapped, more_prompts, max_tokens)

        # Drain with one request in flight: it completes, a new one is
        # refused with 503, as the CLI drains on SIGTERM.
        inflight = asyncio.create_task(http_stream(
            port, "/v1/completions",
            {"model": cfg.name, "prompt": prompts[0], "stream": True, **greedy}))
        while not tapped.get(tuple(prompts[0])) or len(
                tapped[tuple(prompts[0])]) <= max_tokens:
            await asyncio.sleep(0.005)
        drain = asyncio.create_task(service.drain(60.0))
        await asyncio.sleep(0)
        refused = await fetch("127.0.0.1", port, "POST", "/v1/completions",
                              {"model": cfg.name, "prompt": [1, 2, 3], **greedy})
        drained_resp, drained_timed = await inflight
        service_drained = await drain
        engine.begin_drain()
        engine_drained = await engine.wait_drained(60.0)
        params = engine.runner.params

    statuses = ([r.status for r, _ in streamed] + [r.status for r in aggregated]
                + [r.status for r in gets.values()])
    summaries = [stream_summary(timed) for _, timed in streamed]
    tok = ToyTokenizer()
    http_streams, texts_ok = [], True
    for p, summ in zip(prompts, summaries):
        ids = tapped[tuple(p)][:max_tokens]
        http_streams.append(ids)
        stepper = tok.decode_stream()
        incremental = "".join(piece for piece in map(stepper.step, ids) if piece)
        texts_ok &= summ["text"] == incremental
    chat_prompts = [tok.encode(render_default_chat_template(
        [{"role": m[0]["role"], "content": m[0]["content"]}])) for m in chats]
    chat_streams = [tapped[tuple(p)] for p in chat_prompts]
    counts_ok = (
        all(s["usage"]["completion_tokens"] == max_tokens and s["finish"] == "length"
            and len(s["times"]) == max_tokens for s in summaries)
        and all(r.json()["usage"]["completion_tokens"] == max_tokens
                and r.json()["choices"][0]["finish_reason"] == "length"
                for r in aggregated)
        and all(len(s) == max_tokens for s in http_streams + chat_streams)
    )
    ref = teacher_forced(cfg, params, list(prompts) + chat_prompts,
                         http_streams + chat_streams)
    ref.pop("first_token_ref_logprob")
    ttft = [s["times"][0] for s in summaries]
    itl = [b - a for s in summaries for a, b in zip(s["times"], s["times"][1:])]
    drained = stream_summary(drained_timed)
    metrics_text = gets["/metrics"].body.decode()
    result = {
        "phase": "http", "model": cfg.name, "dtype": engine.cfg.dtype,
        "server_startup_s": startup_s, "requests_streamed": len(prompts),
        "requests_aggregated": len(chats), "max_tokens": max_tokens,
        "statuses": statuses, "wall_s": wall,
        "tokens_per_s": len(prompts) * max_tokens / wall,
        "client_ttft_p50_ms": float(np.median(ttft)) * 1e3,
        "client_ttft_max_ms": max(ttft) * 1e3,
        "client_itl_p50_ms": float(np.percentile(itl, 50)) * 1e3,
        "client_itl_p95_ms": float(np.percentile(itl, 95)) * 1e3,
        "in_process_serve": {"ttft_p50_ms": served["ttft_p50_ms"],
                             "ttft_max_ms": served["ttft_max_ms"],
                             "wall_s": served["wall_s"],
                             "tokens_per_s": served["tokens_per_s"]},
        "http_minus_in_process_ttft_p50_ms":
            float(np.median(ttft)) * 1e3 - served["ttft_p50_ms"],
        "http_minus_in_process_wall_ms_per_request":
            (wall - served["wall_s"]) * 1e3 / len(prompts),
        "unified_dispatches": dispatches, "kernel_launches": launches,
        "kernel_launches_by_path": paths, "num_layers": cfg.num_layers,
        "counts_ok": counts_ok, "streamed_text_is_incremental_toy_decode": texts_ok,
        "greedy_match_rate_vs_serve": match_rate(http_streams, serve_streams),
        **ref, "gates": {"agreement_min": PHASES_AGREEMENT, "gap_max": NEAR_TIE_NATS},
        "models": [m["id"] for m in gets["/v1/models"].json()["data"]],
        "metrics_has_requests_total":
            "dyntpu_http_service_requests_total" in metrics_text,
        "metrics_has_capture_gauges": all(
            f"dyntpu_http_service_{k}" in metrics_text
            for k in ("warmed_programs", "mid_traffic_compiles_total")),
        "capture": {**engine.runner.compile_stats.capture_snapshot(),
                    "mid_traffic_compiles_total": mid_traffic(engine)},
        "drain": {"inflight_status": drained_resp.status,
                  "inflight_tokens": drained["usage"]["completion_tokens"],
                  "refused_status": refused.status,
                  "service_drained": service_drained,
                  "engine_drained": engine_drained},
    }
    result["batch_cli"] = batch_cli(max_tokens=16)
    emit(result)
    result["streams"] = http_streams
    if any(code != 200 for code in statuses) or result["models"] != [cfg.name]:
        raise SystemExit(f"http: statuses {statuses}, models {result['models']}")
    if not (counts_ok and texts_ok and result["metrics_has_requests_total"]
            and result["metrics_has_capture_gauges"]):
        raise SystemExit("http: token counts, finish reasons, streamed text or "
                         "/metrics wrong")
    if result["capture"]["mid_traffic_compiles_total"] or not result["capture"][
            "graphs_captured"]:
        raise SystemExit(f"http: capture {result['capture']}")
    if launches != cfg.num_layers * dispatches or dispatches == 0:
        raise SystemExit(f"http: kernel launched {launches} times for {dispatches} "
                         f"dispatches x {cfg.num_layers} layers")
    if paths != {"tc": launches, "split": launches, "walk": 0}:
        raise SystemExit(f"http: ragged paths launched {paths} for {launches} calls")
    if not (ref["logits_finite"] and ref["logits_shape_ok"]
            and ref["greedy_agreement_vs_no_cache_reference"] >= PHASES_AGREEMENT
            and ref["max_logprob_gap_at_disagreement"] <= NEAR_TIE_NATS):
        raise SystemExit("http: streams disagree with the no-cache reference")
    d = result["drain"]
    if (d["inflight_status"], d["inflight_tokens"], d["refused_status"]) != (
            200, max_tokens, 503) or not (d["service_drained"] and d["engine_drained"]):
        raise SystemExit(f"http: drain {d}")
    return result


def batch_cli(max_tokens: int) -> dict:
    """``python -m dynamo_tpu_torch run --in batch:FILE --out torch`` in a
    subprocess, 4 prompts; returns its JSON report."""
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "prompts.txt")
        with open(path, "w") as f:
            f.write("hello there\nwhat is a kernel\npaged attention\nthe end\n")
        t0 = time.monotonic()
        proc = subprocess.run(
            [sys.executable, "-m", "dynamo_tpu_torch", *HTTP_ARGS, "--in",
             f"batch:{path}", "--max-tokens", str(max_tokens)],
            capture_output=True, text=True, timeout=300,
            cwd=os.path.dirname(os.path.abspath(__file__)),
        )
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("{")]
    if proc.returncode != 0 or not lines:
        raise SystemExit(f"batch CLI failed ({proc.returncode}):\n{proc.stderr[-3000:]}")
    report = json.loads(lines[-1])
    if report["requests"] != 4 or not report["tokens_out_per_s"] > 0:
        raise SystemExit(f"batch CLI report {report}")
    return {"report": report, "process_s": time.monotonic() - t0}


# -- phase 7b: observe ---------------------------------------------------------
OBSERVE_STREAMS = 4          # interactive streams per leg
OBSERVE_PROMPT = 64          # their prompt tokens
OBSERVE_TOKENS = 192         # their greedy tokens
OBSERVE_BURST = (4, 896, 8)  # batch prompts mid-decode: count, tokens, output
OBSERVE_QUANTUM = 256        # the static leg's quantum, the adaptive leg's start
OBSERVE_SLO_X = 1.5          # itl_slo_ms = this × the measured decode ITL p50
OBSERVE_TIGHT_X = 1.1        # the tight leg's SLO = this × the decode-only EMA
RAGGED_SYMBOLS = (b"ragged_tc_kernel", b"ragged_split_kernel")


class NullTracer:
    """Stands in for the process tracer while the A/B measures the serve
    with tracing off: every call the engine makes is a no-op."""

    abandoned_total = 0

    def __getattr__(self, name):
        return lambda *a, **kw: None

    @contextlib.contextmanager
    def span(self, *_a):
        yield


class NullFlight:
    """Stands in for the engine's flight recorder in the same A/B."""

    total_steps = 0

    def note_step(self, *_a, **_kw) -> None:
        pass


async def observe_stream(port, body, headers, events):
    """POST a streaming /v1/completions; each SSE token event is appended
    to ``events`` as (perf_counter seconds, text) as it arrives. Returns
    the response."""
    from dynamo_tpu_torch.llm.http_client import fetch
    from dynamo_tpu_torch.llm.protocols.sse import decode_stream

    def got(piece: bytes) -> None:
        t = time.perf_counter()
        for ev in decode_stream(piece.decode()):
            if ev.data == "[DONE]":
                continue
            chunk = json.loads(ev.data)
            if "error" in chunk:
                raise SystemExit(f"observe: stream error {chunk}")
            for ch in chunk.get("choices", []):
                events.append((t, ch.get("finish_reason")))

    return await fetch("127.0.0.1", port, "POST", "/v1/completions", body, headers,
                       on_chunk=got)


async def observe_leg(port, model, prompts, burst, tapped, tokens=None,
                      during_burst=None) -> dict:
    """One leg: OBSERVE_STREAMS interactive streams; once each has 32
    tokens, the batch burst (if any) is sent and ``during_burst()``
    (if any) runs beside it. Client ITL of the streams over the whole
    leg and over the burst window (burst sent → last burst response)."""
    tapped.clear()
    tokens = tokens or OBSERVE_TOKENS
    greedy = {"temperature": 0, "stream": True, "nvext": {"ignore_eos": True}}
    events = [[] for _ in prompts]
    interactive = {"X-Request-Class": "interactive"}
    streams = [asyncio.create_task(observe_stream(
        port, {"model": model, "prompt": p, "max_tokens": tokens, **greedy},
        interactive, ev)) for p, ev in zip(prompts, events)]
    extra = None
    t_burst = t_done = None
    if burst:
        while min(len(ev) for ev in events) < 32:
            if any(s.done() for s in streams):
                raise SystemExit("observe: a stream ended before the burst")
            await asyncio.sleep(0.001)
        t_burst = time.perf_counter()
        burst_events = [[] for _ in burst]
        sent = [observe_stream(
            port, {"model": model, "prompt": p, "max_tokens": OBSERVE_BURST[2], **greedy},
            {"X-Request-Class": "batch"}, ev) for p, ev in zip(burst, burst_events)]
        side = [during_burst()] if during_burst is not None else []
        *burst_resps, extra = await asyncio.gather(*sent, *(side or [_none()]))
        t_done = time.perf_counter()
    resps = await asyncio.gather(*streams)
    statuses = [r.status for r in resps] + ([r.status for r in burst_resps] if burst else [])
    if any(c != 200 for c in statuses):
        raise SystemExit(f"observe: statuses {statuses}")
    gaps_all, gaps_burst = [], []
    for ev in events:
        times = [t for t, _ in ev]
        for a, b in zip(times, times[1:]):
            gaps_all.append(b - a)
            if burst and t_burst <= b <= t_done:
                gaps_burst.append(b - a)
    out = {
        "statuses": statuses,
        "tokens": [len(ev) for ev in events],
        "itl_p50_ms": float(np.percentile(gaps_all, 50)) * 1e3,
        "itl_p95_ms": float(np.percentile(gaps_all, 95)) * 1e3,
        "streams": [list(tapped.get(tuple(p), [])) for p in prompts],
    }
    if burst:
        out.update({
            "burst_window_ms": (t_done - t_burst) * 1e3,
            "burst_itl_p50_ms": float(np.percentile(gaps_burst, 50)) * 1e3,
            "burst_itl_p95_ms": float(np.percentile(gaps_burst, 95)) * 1e3,
            "burst_itl_max_ms": max(gaps_burst) * 1e3,
            "burst_gaps": len(gaps_burst),
            "burst_streams": [list(tapped.get(tuple(p), [])) for p in burst],
            "burst_tokens": [len(ev) for ev in burst_events],
        })
    return out, extra


async def _none():
    return None


def quantum_trajectory(steps: list) -> list:
    """Run-length form of the flight records' quantum: [quantum, steps]."""
    out = []
    for rec in steps:
        if rec.get("kind") not in ("unified", "spec"):
            continue
        if out and out[-1][0] == rec["quantum"]:
            out[-1][1] += 1
        else:
            out.append([rec["quantum"], 1])
    return out


async def tracing_ab(engine, prompts, max_tokens) -> dict:
    """The serve profile's wall ms per dispatch with the tracer and the
    flight recorder on, and with both swapped for no-op stand-ins, in
    turns (on, off, on, off) on one engine."""
    from dynamo_tpu_torch.utils import tracing

    runs = []
    for on in (True, False, True, False):
        saved_tracer, saved_flight = tracing._default, engine.flight
        if not on:
            tracing._default, engine.flight = NullTracer(), NullFlight()
        try:
            prof = await profile_serve(engine, prompts, max_tokens)
        finally:
            tracing._default, engine.flight = saved_tracer, saved_flight
        runs.append({"on": on, "wall_ms_per_dispatch": prof["wall_ms_per_dispatch"],
                     "device_ms_per_dispatch": prof["device_ms_per_dispatch"],
                     "dispatches": prof["dispatches"]})
    on_ms = [r["wall_ms_per_dispatch"] for r in runs if r["on"]]
    off_ms = [r["wall_ms_per_dispatch"] for r in runs if not r["on"]]
    return {"runs": runs, "on_mean_ms": float(np.mean(on_ms)),
            "off_mean_ms": float(np.mean(off_ms)),
            "tracing_cost_ms_per_dispatch": float(np.mean(on_ms) - np.mean(off_ms))}


def scan_trace(path: str, engine_tid: int) -> dict:
    """The profile window's Chrome trace: bytes, the ragged kernel's
    symbols found, device kernel events, and CPU ops on the engine
    thread."""
    with open(path, "rb") as f:
        raw = f.read()
    doc = json.loads(raw)
    events = doc.get("traceEvents", [])
    kernels = [e for e in events if e.get("cat") == "kernel"]
    ragged = [e for e in kernels if e.get("name", "").find("ragged_") >= 0]
    engine_ops = [e for e in events if e.get("cat") == "cpu_op"
                  and e.get("tid") == engine_tid]
    return {"trace_bytes": len(raw),
            "ragged_symbols": [s.decode() for s in RAGGED_SYMBOLS if s in raw],
            "kernel_events": len(kernels), "ragged_kernel_events": len(ragged),
            "cpu_op_events": sum(1 for e in events if e.get("cat") == "cpu_op"),
            "engine_thread_cpu_ops": len(engine_ops),
            "engine_thread_op_names": sorted({e["name"] for e in engine_ops})[:6]}


def metric_value(text: str, name: str) -> float | None:
    """One gauge of the OpenAI server's /metrics text."""
    for line in text.splitlines():
        if line.startswith(f"dyntpu_http_service_{name} "):
            return float(line.split()[1])
    return None


async def watch_quantum_fall(engine, start: int, stop: asyncio.Event) -> dict:
    """Poll the controller every 2 ms until ``stop``: the violation count
    at the first sample whose quantum is below ``start``. The quantum is
    read before the count: the controller counts a sample's violation
    before it adapts, so a fall seen here has its cause counted."""
    coloc = engine.coloc
    v0 = coloc.itl_slo_violations_total
    while not stop.is_set():
        q = coloc.quantum
        v = coloc.itl_slo_violations_total
        if q < start:
            return {"violations_at_start": v0, "violations_at_first_fall": v,
                    "first_fall_quantum": q}
        await asyncio.sleep(0.002)
    return {"violations_at_start": v0, "violations_at_first_fall": None,
            "first_fall_quantum": None}


async def observe_adaptive_leg(port, engine, model, prompts, burst, tapped, slo,
                               name) -> dict:
    """The burst leg on an adaptive server; its flight records give the
    quantum trajectory and the compose-time EMA, a 2 ms poll of the
    controller whether its violation count rose before the quantum first
    fell."""
    from dynamo_tpu_torch.llm.http_client import fetch

    last = engine.debug_steps(1)
    seq0 = last[-1]["seq"] if last else 0
    stop = asyncio.Event()
    watch = asyncio.ensure_future(watch_quantum_fall(engine, engine.coloc.quantum, stop))
    try:
        leg, _ = await observe_leg(port, model, prompts, burst, tapped)
    finally:
        stop.set()
    fall = await watch
    steps = (await fetch("127.0.0.1", port, "GET", "/debug/steps?n=1024")).json()["steps"]
    recs = [r for r in steps if r["seq"] > seq0 and r["kind"] in ("unified", "spec")]
    ready = engine.readiness()
    leg.update({
        "itl_slo_ms": slo,
        "quantum_trajectory": quantum_trajectory(recs),
        "flight_records": len(recs),
        "ema_first_ms": recs[0]["itl_ema_ms"],
        "ema_peak_ms": max(r["itl_ema_ms"] for r in recs),
        "ema_crossed_slo": any(r["itl_ema_ms"] > slo for r in recs),
        **fall,
        "violations_before_first_fall": (
            fall["violations_at_first_fall"] is not None
            and fall["violations_at_first_fall"] > fall["violations_at_start"]),
        "coloc": {k: ready[k] for k in (
            "coloc_quantum", "itl_ema_ms", "itl_p95_ms", "itl_slo_violations_total",
            "coloc_prefill_deferrals_total")},
    })
    emit({"phase": "observe_leg", "leg": name, **{
        k: v for k, v in leg.items() if "streams" not in k}})
    return leg


async def phase_observe(vocab: int) -> dict:
    """Tracing, the flight recorder, deadlines, SLO classes, the
    adaptive co-location controller and the profile window on the OpenAI
    server at full width: see the module docstring (phase 7b)."""
    from dynamo_tpu_torch import cli
    from dynamo_tpu_torch.llm.http_client import fetch
    from dynamo_tpu_torch.ops.kernels.ragged_attention import (
        ragged_paged_attention_cuda as fn,
    )
    from dynamo_tpu_torch.ops.kernels.ragged_attention import reset_counts
    from dynamo_tpu_torch.runtime.pipeline import Tap
    from dynamo_tpu_torch.tools import trace_merge
    from dynamo_tpu_torch.utils.tracing import reset_tracer

    t_phase = time.monotonic()
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, vocab, OBSERVE_PROMPT).tolist()
               for _ in range(OBSERVE_STREAMS)]
    burst = [rng.integers(0, vocab, OBSERVE_BURST[1]).tolist()
             for _ in range(OBSERVE_BURST[0])]
    ab_prompts = [rng.integers(0, vocab, n).tolist() for n in rng.integers(64, 513, 8)]
    tapped: dict[tuple, list[int]] = {}
    tap = Tap(
        on_request=lambda ctx: tapped.setdefault(tuple(ctx.payload["token_ids"]), []),
        on_response=lambda ctx, item: tapped[tuple(ctx.payload["token_ids"])].extend(
            item["token_ids"]),
    )
    base = HTTP_ARGS[:-1] + [str(OBSERVE_QUANTUM), "--http-host", "127.0.0.1",
                             "--http-port", "0"]
    tmp = tempfile.mkdtemp(prefix="chip_smoke_observe_")
    capture = os.path.join(tmp, "trace.jsonl")
    profile_dir = os.path.join(tmp, "profiles")
    reset_tracer(capture)
    result: dict = {"phase": "observe"}
    legs: dict = {}
    checks = []                    # (server, flight records, dispatches)
    launches = dispatches = 0
    mid = {}

    async def start(extra, stack):
        args = cli.build_parser().parse_args(base + extra)
        cli.refuse_unserved(args)
        service, engine = await cli.start_http(args, stack, engine_ops=(tap,))
        reset_counts()
        return service.port, engine, engine.unified_dispatches, engine.flight.total_steps

    try:
        # Server A, --coloc static (quantum 256): step 1 measures the
        # decode ITL the SLO is set from; the burst leg is the control;
        # step 4's A/B runs on the same engine.
        async with contextlib.AsyncExitStack() as stack:
            port, engine, d0, f0 = await start(["--coloc", "static"], stack)
            model, cfg, params = engine.cfg.model.name, engine.cfg.model, engine.runner.params
            legs["decode_only"], _ = await observe_leg(port, model, prompts, None, tapped)
            emit({"phase": "observe_leg", "leg": "decode_only", **{
                k: v for k, v in legs["decode_only"].items() if "streams" not in k}})
            decode_p50 = legs["decode_only"]["itl_p50_ms"]
            slo = OBSERVE_SLO_X * decode_p50
            # From here the static controller measures against that SLO,
            # as `--coloc static --itl-slo-ms` would have from the start
            # (a static quantum never moves).
            engine.coloc.slo_ms = slo
            legs["static"] = await observe_adaptive_leg(
                port, engine, model, prompts, burst, tapped, slo, "static")
            mid["static"] = mid_traffic(engine)
            checks.append(("static", engine.flight.total_steps - f0,
                           engine.unified_dispatches - d0))
            # Step 4 (its "off" runs swap the flight recorder out, so the
            # record-per-dispatch check is taken before it).
            result["tracing_ab"] = await tracing_ab(engine, ab_prompts, 32)
            launches += fn.launches
            dispatches += engine.unified_dispatches - d0
        # A tight SLO in the controller's own units: 10% above its EMA of
        # the decode-only leg (where the static burst leg began). At 1.5 x
        # the decode ITL a 256-row dispatch may never pressure the SLO;
        # a burst of them pressures this one and steady decode does not,
        # so this leg shows the controller under pressure either way.
        slo_tight = OBSERVE_TIGHT_X * legs["static"]["ema_first_ms"]
        emit({"phase": "observe_slo", "decode_itl_p50_ms": decode_p50, "itl_slo_ms": slo,
              "decode_ema_ms": legs["static"]["ema_first_ms"],
              "static_ema_peak_ms": legs["static"]["ema_peak_ms"],
              "itl_slo_tight_ms": slo_tight})
        # Server B, --coloc adaptive --itl-slo-ms 1.5 x decode ITL.
        async with contextlib.AsyncExitStack() as stack:
            port, engine, d0, f0 = await start(
                ["--coloc", "adaptive", "--itl-slo-ms", f"{slo:.4f}"], stack)
            legs["adaptive"] = await observe_adaptive_leg(
                port, engine, model, prompts, burst, tapped, slo, "adaptive")
            mid["adaptive"] = mid_traffic(engine)
            checks.append(("adaptive", engine.flight.total_steps - f0,
                           engine.unified_dispatches - d0))
            launches += fn.launches
            dispatches += engine.unified_dispatches - d0
        # Server C, --coloc adaptive at the tighter SLO, with the profile
        # directory; then step 3 under the same traffic.
        async with contextlib.AsyncExitStack() as stack:
            port, engine, d0, f0 = await start(
                ["--coloc", "adaptive", "--itl-slo-ms", f"{slo_tight:.4f}",
                 "--profile-dir", profile_dir], stack)
            legs["adaptive_tight"] = await observe_adaptive_leg(
                port, engine, model, prompts, burst, tapped, slo_tight, "adaptive_tight")
            m0 = (await fetch("127.0.0.1", port, "GET", "/metrics")).body.decode()

            async def during_burst():
                # Send once the running and waiting sequences fill every
                # slot and none of the running ones is within 3 tokens of
                # its end: the 1 ms request then waits for a slot that
                # frees 2+ dispatches later, and expires in the waiting
                # list before any output.
                t0 = time.monotonic()
                while True:
                    running = list(engine.scheduler.running.values())
                    queued = len(engine.scheduler.waiting)
                    if (len(running) + queued >= engine.cfg.max_num_seqs
                            and all(len(q.output_tokens) + 3 <= q.stop.max_tokens
                                    for q in running)):
                        break
                    if time.monotonic() - t0 > 10.0:
                        raise SystemExit("observe: the burst never filled the slots")
                    await asyncio.sleep(0.0002)
                prof = asyncio.create_task(fetch(
                    "127.0.0.1", port, "GET", "/debug/profile?seconds=1"))
                late = await fetch("127.0.0.1", port, "POST", "/v1/completions", {
                    "model": model, "prompt": prompts[0][::-1], "max_tokens": 8,
                    "temperature": 0}, {"X-Request-Timeout-Ms": "1"})
                return late, await prof

            legs["deadline_profile"], (late, prof) = await observe_leg(
                port, model, prompts, burst, tapped, tokens=96,
                during_burst=during_burst)
            m1 = (await fetch("127.0.0.1", port, "GET", "/metrics")).body.decode()
            result["deadline"] = {
                "status": late.status,
                "error_type": (late.json().get("error") or {}).get("type"),
                "deadline_exceeded_total_delta":
                    metric_value(m1, "deadline_exceeded_total")
                    - metric_value(m0, "deadline_exceeded_total"),
            }
            result["metrics_has"] = {k: metric_value(m1, k) is not None for k in (
                "itl_slo_violations_total", "deadline_exceeded_total",
                "shed_interactive_total", "shed_batch_total", "coloc_quantum",
                "flight_steps_total")} | {
                "trace_histograms": "dyntpu_trace_itl_ms_bucket" in m1}
            profile = prof.json()
            result["profile"] = {"status": prof.status, **{
                k: profile.get(k) for k in ("seconds", "device_events")}}
            if prof.status == 200:
                result["profile"].update(scan_trace(profile["trace"],
                                                    engine._thread.native_id))
            mid["adaptive_tight"] = mid_traffic(engine)
            checks.append(("adaptive_tight", engine.flight.total_steps - f0,
                           engine.unified_dispatches - d0))
            launches += fn.launches
            dispatches += engine.unified_dispatches - d0
        reset_tracer(None)
        merged = trace_merge.merge_report(trace_merge.load_captures([capture]))
        result["trace_merge"] = {
            "completed_requests": merged["completed_requests"],
            "orphan_traces": len(merged["orphan_traces"]),
            "incomplete": len(merged["incomplete"]),
            "ttft_decomposition_p50_ms": {
                k: v["p50_ms"] for k, v in merged["ttft_decomposition_ms"].items()},
        }
        with contextlib.redirect_stdout(io.StringIO()):   # its report, printed in full
            result["trace_merge"]["assert_complete_exit"] = trace_merge.main(
                [capture, "--assert-complete"])
    finally:
        reset_tracer(None)
        shutil.rmtree(tmp, ignore_errors=True)
    # Every burst leg's streams held to the no-cache reference (the same
    # seed gives the three servers the same weights).
    ref_prompts, ref_streams = [], []
    full = True
    for name in ("decode_only", "static", "adaptive", "adaptive_tight"):
        leg = legs[name]
        ref_prompts += prompts
        ref_streams += leg["streams"]
        full &= all(len(s) == OBSERVE_TOKENS for s in leg["streams"])
        if "burst_streams" in leg:
            ref_prompts += burst
            ref_streams += leg["burst_streams"]
            full &= all(len(s) == OBSERVE_BURST[2] for s in leg["burst_streams"])
    ref = teacher_forced(cfg, params, ref_prompts, ref_streams)
    ref.pop("first_token_ref_logprob")
    for leg in legs.values():
        leg.pop("streams")
        leg.pop("burst_streams", None)
    result.update({
        "legs": legs, "streams_full_length": full, **ref,
        "mid_traffic_compiles_total": mid, "kernel_launches": launches,
        "unified_dispatches": dispatches, "flight_checks": checks,
        "num_layers": cfg.num_layers, "wall_s": time.monotonic() - t_phase,
    })
    emit(result)
    if not (full and ref["logits_finite"] and ref["logits_shape_ok"]
            and ref["greedy_agreement_vs_no_cache_reference"] >= PHASES_AGREEMENT
            and ref["max_logprob_gap_at_disagreement"] <= NEAR_TIE_NATS):
        raise SystemExit("observe: streams short or disagreeing with the reference")
    if any(mid.values()):
        raise SystemExit(f"observe: graphs captured mid-traffic {mid}")
    # The controller's contract on every leg: the quantum starts at 256
    # and never goes below the floor; the static one never moves; an
    # adaptive one falls only after a sample over its SLO was counted
    # (itl_slo_violations_total rose before the first fall: the EMA can
    # pass the SLO only after such a sample). The flight records' EMA is
    # taken at compose and can miss a crossing between two records, so
    # its peak is reported, not gated. The tight leg must move.
    for name in ("static", "adaptive", "adaptive_tight"):
        leg = legs[name]
        traj = [q for q, _ in leg["quantum_trajectory"]]
        moved = min(traj) < OBSERVE_QUANTUM
        if name == "static":
            ok = not moved
        else:
            ok = not moved or leg["violations_before_first_fall"]
        if not traj or traj[0] != OBSERVE_QUANTUM or min(traj) < 16 or not ok:
            raise SystemExit(
                f"observe: {name} quantum trajectory {leg['quantum_trajectory']} "
                f"(violations at start {leg['violations_at_start']}, at the first "
                f"fall {leg['violations_at_first_fall']}; compose-time EMA crossed "
                f"the SLO: {leg['ema_crossed_slo']}, peak {leg['ema_peak_ms']} ms)")
    if min(q for q, _ in legs["adaptive_tight"]["quantum_trajectory"]) >= OBSERVE_QUANTUM:
        raise SystemExit("observe: the tight SLO was never pressured")
    if any(f != d for _, f, d in checks) or not dispatches:
        raise SystemExit(f"observe: flight records vs dispatches {checks}")
    if result["trace_merge"]["assert_complete_exit"] != 0 or result["trace_merge"][
            "orphan_traces"]:
        raise SystemExit(f"observe: trace merge {result['trace_merge']}")
    d = result["deadline"]
    if (d["status"], d["error_type"], d["deadline_exceeded_total_delta"]) != (
            504, "deadline_exceeded", 1.0):
        raise SystemExit(f"observe: deadline {d}")
    if result["profile"]["status"] != 200 or not result["profile"].get("ragged_symbols"):
        raise SystemExit(f"observe: profile {result['profile']}")
    if not all(result["metrics_has"].values()):
        raise SystemExit(f"observe: /metrics {result['metrics_has']}")
    if launches != cfg.num_layers * dispatches:
        raise SystemExit(f"observe: kernel launched {launches} times for "
                         f"{dispatches} dispatches x {cfg.num_layers} layers")
    return result


def phase_phases(params, prompts, unified_streams, max_tokens) -> dict:
    """The phase-split entry points at full width on the serve's weights,
    each kernel's launches counted over exactly this run."""
    from dynamo_tpu_torch.engine.runner import ModelRunner
    from dynamo_tpu_torch.ops.kernels.paged_decode_attention import (
        paged_decode_attention_cuda,
    )
    from dynamo_tpu_torch.ops.kernels.paged_prefill_attention import (
        paged_prefill_attention_cuda,
    )

    ecfg = full_width_config()
    runner = ModelRunner(ecfg, params=params, device=DEVICE)
    paged_prefill_attention_cuda.launches = 0
    paged_prefill_attention_cuda.launches_tc = 0
    paged_decode_attention_cuda.launches = 0
    streams, times = phase_split(runner, prompts, max_tokens)
    streams = [s[:max_tokens] for s in streams]
    prefill_launches = paged_prefill_attention_cuda.launches
    prefill_launches_tc = paged_prefill_attention_cuda.launches_tc
    decode_launches = paged_decode_attention_cuda.launches
    L = ecfg.model.num_layers
    in_vocab = all(0 <= t < ecfg.model.vocab_size for s in streams for t in s)
    # prefill_batch's log-probability of each lane's first token against
    # the no-cache reference's, and every stream fed back through it.
    ref = teacher_forced(ecfg.model, params, prompts, streams)
    first_lp = runner.last_logprobs[0][: len(prompts)].tolist()
    lp_err = max(abs(a - b) for a, b in zip(first_lp, ref.pop("first_token_ref_logprob")))
    gates = {"agreement_min": PHASES_AGREEMENT, "gap_max": NEAR_TIE_NATS,
             "first_logprob_err_max": FIRST_LOGPROB_TOL}
    ok = (ref["logits_finite"] and ref["logits_shape_ok"]
          and ref["greedy_agreement_vs_no_cache_reference"] >= PHASES_AGREEMENT
          and ref["max_logprob_gap_at_disagreement"] <= NEAR_TIE_NATS
          and lp_err <= FIRST_LOGPROB_TOL)
    result = {
        "phase": "phases", "model": ecfg.model.name, "dtype": ecfg.dtype,
        "lanes": len(prompts), "prompt_lens": [len(p) for p in prompts],
        "decode_steps": max_tokens, **times,
        "prefill_kernel_launches": prefill_launches,
        "prefill_tensor_core_launches": prefill_launches_tc,
        "decode_kernel_launches": decode_launches, "num_layers": L,
        "tokens_in_vocab": in_vocab, **ref,
        "first_token_logprob_err_vs_reference": lp_err, "gates": gates,
        "token_match_rate_vs_unified_serve": match_rate(streams, unified_streams),
        "ok": ok,
    }
    emit(result)
    if (prefill_launches != L or prefill_launches_tc != L
            or decode_launches != L * max_tokens):
        raise SystemExit(
            f"phases: prefill kernel launched {prefill_launches} times, "
            f"{prefill_launches_tc} on tensor cores (want {L}), "
            f"decode kernel {decode_launches} (want {L * max_tokens})"
        )
    if not in_vocab:
        raise SystemExit("phases: tokens out of the vocabulary")
    if not ok:
        raise SystemExit("phases: streams disagree with the no-cache reference")
    return result


FLEET_ENDPOINT = "dyn://dynamo.torch.generate"
FLEET_WAIT_S = 240.0          # a worker's spawn → "worker serving" bound


class Child:
    """One subprocess of the fleet phase (``python -m dynamo_tpu_torch
    ...``): stdout and stderr merged, read line by line as they come,
    each line kept with its arrival time."""

    def __init__(self, name: str, argv: list[str], module: str = "dynamo_tpu_torch",
                 env: dict | None = None) -> None:
        self.name = name
        self.argv = argv
        self.module = module
        self.env = env
        self.proc = None
        self.lines: list[tuple[float, str]] = []
        self.t_spawn = 0.0
        self._more = asyncio.Event()
        self._reader = None

    async def start(self) -> "Child":
        self.t_spawn = time.monotonic()
        self.proc = await asyncio.create_subprocess_exec(
            sys.executable, "-m", self.module, *self.argv,
            stdout=asyncio.subprocess.PIPE, stderr=asyncio.subprocess.STDOUT,
            cwd=os.path.dirname(os.path.abspath(__file__)),
            env=None if self.env is None else {**os.environ, **self.env},
        )
        self._reader = asyncio.ensure_future(self._read())
        return self

    async def _read(self) -> None:
        while True:
            line = await self.proc.stdout.readline()
            if not line:
                break
            self.lines.append((time.monotonic(), line.decode(errors="replace")))
            self._more.set()
        self._more.set()

    def tail(self, n: int = 30) -> str:
        return "".join(text for _, text in self.lines[-n:])

    async def wait_for(self, pattern: str, timeout: float):
        """(match, arrival time) of the first line matching ``pattern``;
        fails the phase if the process ends or the time runs out first."""
        import re

        pat = re.compile(pattern)
        deadline = time.monotonic() + timeout
        seen = 0
        while True:
            for t, text in self.lines[seen:]:
                m = pat.search(text)
                if m:
                    return m, t
            seen = len(self.lines)
            if self._reader.done():
                raise SystemExit(f"fleet: {self.name} ended (rc {self.proc.returncode}) "
                                 f"before {pattern!r}:\n{self.tail()}")
            left = deadline - time.monotonic()
            if left <= 0:
                raise SystemExit(f"fleet: {self.name} gave no {pattern!r} in "
                                 f"{timeout:.0f} s:\n{self.tail()}")
            self._more.clear()
            try:
                await asyncio.wait_for(self._more.wait(), left)
            except asyncio.TimeoutError:
                pass

    async def exit_code(self, timeout: float) -> int:
        try:
            await asyncio.wait_for(self.proc.wait(), timeout)
        except asyncio.TimeoutError:
            raise SystemExit(f"fleet: {self.name} did not exit in {timeout:.0f} s:\n"
                             f"{self.tail()}") from None
        await self._reader
        return self.proc.returncode

    def signal(self, sig) -> None:
        if self.proc.returncode is None:
            self.proc.send_signal(sig)

    async def kill(self) -> None:
        if self.proc is not None and self.proc.returncode is None:
            self.proc.kill()
            await self.proc.wait()
        if self._reader is not None:
            await self._reader


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


async def spawn_workers(addr: str, n: int, dtype: str, tag: str) -> list:
    """n workers serving FLEET_ENDPOINT with the serve's engine settings,
    each with a health port; waits until each is warmed up and serving.
    Returns [(Child, lease id, health port, startup seconds)]."""
    workers = []
    for i in range(n):
        port = free_port()
        argv = [*HTTP_ARGS, "--in", FLEET_ENDPOINT, "--control-plane", addr,
                "--health-port", str(port), "--dtype", dtype]
        workers.append((await Child(f"worker {tag}{i}", argv).start(), port))
    out = []
    for child, port in workers:
        lease = int((await child.wait_for(r"\(lease (0x[0-9a-f]+)\)", FLEET_WAIT_S))[0]
                    .group(1), 16)
        _, t_serving = await child.wait_for(r"worker serving ", FLEET_WAIT_S)
        out.append((child, lease, port, t_serving - child.t_spawn))
    return out


async def instance_leases(drt) -> set[int]:
    keys = await drt.store.get_prefix("instances/dynamo/torch/generate:")
    return {int(k.rsplit(":", 1)[1], 16) for k in keys}


async def wait_leases(drt, want: set[int], timeout: float = 30.0) -> float:
    """Seconds until the discovery store holds exactly ``want``."""
    t0 = time.monotonic()
    while await instance_leases(drt) != want:
        if time.monotonic() - t0 > timeout:
            raise SystemExit(f"fleet: instances {await instance_leases(drt)} != {want}")
        await asyncio.sleep(0.02)
    return time.monotonic() - t0


async def worker_requests(port: int) -> float:
    return await worker_metric(port, "ingress_requests_total")


async def worker_metric(port: int, name: str) -> float:
    """One gauge of a worker's health-port /metrics (-1 when absent)."""
    import re

    from dynamo_tpu_torch.llm.http_client import fetch

    body = (await fetch("127.0.0.1", port, "GET", "/metrics")).body.decode()
    m = re.search(rf"^dyntpu_worker_{name} (\S+)$", body, re.M)
    return float(m.group(1)) if m else -1.0


KV_GROUPS = 4                 # kv_route leg: prefix groups
KV_PER_GROUP = 3              # requests per group (the first, then the later)
KV_PREFIX = 384               # shared prefix tokens (24 blocks of 16)
KV_SUFFIX = 64                # each request's own tokens
KV_BLOCK_BYTES = 16 * 2 * 16 * 8 * 64 * 2   # a llama3.2-1b KV block, bf16


def kv_groups(rng, vocab: int, groups: int) -> list[list[list[int]]]:
    """``groups`` × KV_PER_GROUP prompts: a shared KV_PREFIX-token prefix
    per group, a KV_SUFFIX-token suffix per request."""
    out = []
    for _ in range(groups):
        prefix = rng.integers(0, vocab, KV_PREFIX).tolist()
        out.append([prefix + rng.integers(0, vocab, KV_SUFFIX).tolist()
                    for _ in range(KV_PER_GROUP)])
    return out


def h2d_kv_rate(blocks: int = 64, iters: int = 20) -> dict:
    """Pinned host→device copy rate of a batch of llama3.2-1b KV blocks
    (CUDA events around ``iters`` non-blocking copies): the number behind
    the router's ``default_link_gbps``."""
    nbytes = blocks * KV_BLOCK_BYTES
    host = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
    dev = torch.empty(nbytes, dtype=torch.uint8, device=DEVICE)
    for _ in range(3):
        dev.copy_(host, non_blocking=True)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        dev.copy_(host, non_blocking=True)
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end) / iters
    return {"blocks": blocks, "bytes": nbytes, "ms": ms, "gbps": nbytes / ms / 1e6}


async def send_groups(port, model, groups, max_tokens, tapped, greedy, settle) -> dict:
    """Each group's first request at once; ``settle()``; then every later
    request at once. Per request: stream summary, serving workers; per
    later request, the frontend's ``route`` span (the pick, KV decision
    and hit-rate publish included) from its finished trace."""
    from dynamo_tpu_torch.utils.tracing import tracer

    async def one(p):
        resp, timed = await http_stream(port, "/v1/completions", {
            "model": model, "prompt": p, "stream": True, "max_tokens": max_tokens,
            **greedy})
        return resp, stream_summary(timed)

    firsts = [g[0] for g in groups]
    later = [p for g in groups for p in g[1:]]
    got_first = await asyncio.gather(*[one(p) for p in firsts])
    await settle()
    got_later = await asyncio.gather(*[one(p) for p in later])
    done = dict(zip(map(tuple, firsts + later), got_first + got_later))
    ok = all(r.status == 200 and s["usage"]["completion_tokens"] == max_tokens
             and s["finish"] == "length" for r, s in done.values())
    spans = {tr["id"]: tr["spans"] for tr in tracer().snapshot(1024)["recent"]}
    route_ms = [sum(sp["dur_ms"] for sp in spans.get(tapped[tuple(p)]["id"], ())
                    if sp["name"] == "route") for p in later]
    return {
        "ok": ok,
        "route_ms_later": route_ms,
        "firsts_per_worker": sorted(
            sum(tapped[tuple(f)]["workers"][0] == w for f in firsts)
            for w in {tapped[tuple(f)]["workers"][0] for f in firsts}),
        "workers": {p: tapped[p]["workers"] for p in done},
        "ttft_first_ms": [s["times"][0] * 1e3 for _, s in got_first],
        "ttft_later_ms": [s["times"][0] * 1e3 for _, s in got_later],
    }


async def kv_route_leg(addr, stack, obs, bf16, cfg, params, port, tap, tapped, greedy,
                       max_tokens, rng) -> dict:
    """The KV-aware router on the two bf16 workers: see the module
    docstring (phase 9, kv_route). ``tap`` records each request's
    tokens, serving workers and id into ``tapped`` on both frontends."""
    import re

    from dynamo_tpu_torch import cli
    from dynamo_tpu_torch.llm.http_client import fetch
    from dynamo_tpu_torch.llm.kv_router.audit import ROUTE_OBS
    from dynamo_tpu_torch.llm.kv_router.scheduler import KvRouterConfig
    from dynamo_tpu_torch.llm.protocols.common import (
        PreprocessedRequest,
        SamplingOptions,
        StopConditions,
    )
    from dynamo_tpu_torch.runtime.egress import PushRouter
    from dynamo_tpu_torch.runtime.engine import Context
    from dynamo_tpu_torch.runtime.transports import wire
    from dynamo_tpu_torch.tools import route_audit

    import signal

    t_leg = time.monotonic()
    health = {lease: hport for _, lease, hport, _ in bf16}
    children = []
    mport = free_port()
    router = await Child("router", ["router", "--control-plane", addr,
                                    "--endpoint", FLEET_ENDPOINT]).start()
    metrics = await Child("metrics", ["metrics", "--control-plane", addr, "--host",
                                      "127.0.0.1", "--port", str(mport)]).start()
    children += [router, metrics]
    try:
        # Both processes up before any traffic: their start-up (torch
        # imports) must not share the host with the timed requests.
        await router.wait_for(r"router service at dyn://dynamo\.router\.generate",
                              FLEET_WAIT_S)
        await metrics.wait_for(r"metrics exporter on", FLEET_WAIT_S)
        rate = h2d_kv_rate()
        emit({"phase": "fleet_kv_link", **rate,
              "router_default_link_gbps": KvRouterConfig().default_link_gbps})
        hits = await obs.bus.subscribe(
            obs.namespace("dynamo").component("torch").event_subject("kv-hit-rate"))
        stack.callback(hits.close)
        actuals: list[dict] = []

        async def collect():
            async for raw in hits:
                rec = wire.unpackb(raw)
                if rec.get("kind") == "actual":
                    actuals.append(rec)

        collector = asyncio.ensure_future(collect())
        stack.callback(collector.cancel)

        kv_args = cli.build_parser().parse_args([
            "run", "--in", "http", "--out", "dyn", "--control-plane", addr,
            "--router-mode", "kv", "--http-host", "127.0.0.1", "--http-port", "0"])
        cli.refuse_unserved(kv_args)
        kv_service, _ = await cli.start_http(kv_args, stack, engine_ops=(tap,))
        kv_port = kv_service.port
        await wait_model(kv_port, cfg.name)

        async def settle():
            """The router's indexer holds every first's blocks: no event
            pending and the radix size steady over 3 polls."""
            sizes = []
            t0 = time.monotonic()
            while True:
                g = ROUTE_OBS.gauges()
                sizes.append(g.get("kv_radix_blocks", 0))
                if (g.get("kv_events_pending", 1) == 0 and len(sizes) >= 3
                        and sizes[-1] == sizes[-3] > 0):
                    return
                if time.monotonic() - t0 > 30:
                    raise SystemExit(f"fleet: kv_route: the indexer never settled {g}")
                await asyncio.sleep(0.05)

        async def reused() -> dict[int, float]:
            return {lease: await worker_metric(hp, "kv_reused_device_blocks_total")
                    for lease, hp in health.items()}

        groups = kv_groups(rng, cfg.vocab_size, KV_GROUPS)
        before_reuse = await reused()
        before_routes = ROUTE_OBS.snapshot(0)["routes_total"]
        kv = await send_groups(kv_port, cfg.name, groups, max_tokens, tapped, greedy,
                               settle)
        after_reuse = await reused()
        routes = (await fetch("127.0.0.1", kv_port, "GET",
                              f"/debug/routes?n={KV_GROUPS * KV_PER_GROUP}")).json()
        await until(lambda: len(actuals) >= len(routes["recent"]), 30,
                    "kv_route: the workers' actual-reuse records")
        prompts = [p for g in groups for p in g]
        by_id = {tapped[tuple(p)]["id"]: p for p in prompts}
        firsts = {tuple(g[0]) for g in groups}
        group_of = {tuple(p): tuple(g[0]) for g in groups for p in g}
        recs = [r for r in routes["recent"] if r["id"] in by_id]
        overlap_ok = len(recs) == len(prompts) and all(
            r["overlap_blocks"] == (0 if tuple(by_id[r["id"]]) in firsts
                                    else KV_PREFIX // 16) for r in recs)
        affinity = all(
            kv["workers"][tuple(p)] == kv["workers"][group_of[tuple(p)]]
            and len(kv["workers"][tuple(p)]) == 1 for p in prompts)
        report = route_audit.join_report(recs, [a for a in actuals if a.get("trace")])
        audit_fails = route_audit.run_asserts(report, 1.0)
        reuse_delta = sum(after_reuse.values()) - sum(before_reuse.values())
        streams = [tapped[tuple(p)]["tokens"][:max_tokens] for p in prompts]
        ref = teacher_forced(cfg, params, prompts, streams)
        ref.pop("first_token_ref_logprob")

        # The same traffic's shape through the round-robin frontend (fresh
        # prefixes: the KV leg's are cached now).
        rr_groups = kv_groups(rng, cfg.vocab_size, KV_GROUPS)
        before_rr = await reused()

        async def pause():
            await asyncio.sleep(0.5)

        rr = await send_groups(port, cfg.name, rr_groups, max_tokens, tapped, greedy,
                               pause)
        after_rr = await reused()

        # One more group through the standalone router (RouterService).
        via = await PushRouter.create(obs, "dyn://dynamo.router.generate")
        await via.client.wait_for_instances(30)
        svc_group = kv_groups(rng, cfg.vocab_size, 1)[0]
        req_before = {lease: await worker_requests(hp) for lease, hp in health.items()}
        reuse_before = await reused()

        async def through_router(p):
            pre = PreprocessedRequest(
                token_ids=p, sampling=SamplingOptions(temperature=0.0),
                stop=StopConditions(max_tokens=max_tokens, ignore_eos=True))
            toks = []
            async for item in via.generate(Context(pre.to_wire())):
                toks.extend(item.get("token_ids", []))
            return toks

        svc_streams = [await through_router(svc_group[0])]
        await asyncio.sleep(1.0)   # the first's KV events reach the router process
        svc_streams += await asyncio.gather(*[through_router(p) for p in svc_group[1:]])
        req_after = {lease: await worker_requests(hp) for lease, hp in health.items()}
        reuse_after = await reused()
        svc_split = sorted(req_after[k] - req_before[k] for k in health)
        svc_reuse = sum(reuse_after.values()) - sum(reuse_before.values())
        svc_ref = teacher_forced(cfg, params, svc_group, svc_streams)
        svc_ref.pop("first_token_ref_logprob")

        # The exporter's view of both workers.
        labels = 'namespace="dynamo",component="torch"'
        want = {lease: await worker_metric(hp, "kv_reused_device_blocks_total")
                for lease, hp in health.items()}
        t0 = time.monotonic()
        while True:
            text = (await fetch("127.0.0.1", mport, "GET", "/metrics")).body.decode()
            seen = {}
            for lease in health:
                m = re.search(rf'^dyntpu_kv_reused_device_blocks_total\{{{labels},'
                              rf'worker="{lease:x}"\}} (\S+)$', text, re.M)
                seen[lease] = float(m.group(1)) if m else None
            if seen == want or time.monotonic() - t0 > 15:
                break
            await asyncio.sleep(0.2)
        exporter_ok = seen == want and f"dyntpu_worker_count{{{labels}}} 2" in text

        for child in (router, metrics):
            child.signal(signal.SIGTERM)
        exits = [await child.exit_code(30) for child in (router, metrics)]
        result = {
            "groups": KV_GROUPS, "per_group": KV_PER_GROUP, "prefix_tokens": KV_PREFIX,
            "suffix_tokens": KV_SUFFIX, "max_tokens": max_tokens,
            "h2d_kv_link": rate,
            "later_on_first_worker": affinity,
            "route_records": len(recs),
            "predicted_overlaps": [r["overlap_blocks"] for r in recs],
            "workers_reused_blocks": reuse_delta,
            "route_audit": {k: report[k] for k in (
                "routes", "actuals", "joined", "join_rate", "orphan_routes",
                "overlap_error", "staleness", "decision_ms")},
            "route_audit_failures": audit_fails,
            "metrics_stale": routes["gauges"].get("kv_router_metrics_stale"),
            "indexer": {k: routes["gauges"].get(k) for k in (
                "kv_events_applied_total", "kv_radix_blocks", "kv_event_lag_p50_ms",
                "kv_event_lag_p99_ms")},
            "ttft_later_p50_ms": float(np.median(kv["ttft_later_ms"])),
            "ttft_first_p50_ms": float(np.median(kv["ttft_first_ms"])),
            "ttft_later_ms": kv["ttft_later_ms"],
            "route_span_later_p50_ms": float(np.median(kv["route_ms_later"])),
            "firsts_per_worker": kv["firsts_per_worker"],
            "round_robin": {
                "ttft_later_ms": rr["ttft_later_ms"],
                "route_span_later_p50_ms": float(np.median(rr["route_ms_later"])),
                "firsts_per_worker": rr["firsts_per_worker"],
                "reused_blocks": sum(after_rr.values()) - sum(before_rr.values()),
                "ttft_later_p50_ms": float(np.median(rr["ttft_later_ms"])),
                "ttft_first_p50_ms": float(np.median(rr["ttft_first_ms"])),
                "later_on_first_worker": sum(
                    rr["workers"][tuple(p)] == rr["workers"][tuple(g[0])]
                    for g in rr_groups for p in g[1:]),
            },
            "router_service": {"split": svc_split, "reused_blocks": svc_reuse,
                               **svc_ref},
            "exporter_ok": exporter_ok, "exporter_values": {
                f"{k:x}": v for k, v in seen.items()},
            "subprocess_exit_codes": exits,
            **ref,
            "leg_s": time.monotonic() - t_leg,
        }
        emit({"phase": "fleet_kv_route", **result})
        gates = {
            "counts": kv["ok"] and rr["ok"],
            "affinity": affinity,
            "route_records": overlap_ok,
            "reuse_192": reuse_delta == (KV_GROUPS * (KV_PER_GROUP - 1)
                                         * KV_PREFIX // 16),
            "audit_exact": not audit_fails and report["joined"] == len(prompts)
            and report["overlap_error"]["abs_max"] == 0,
            "metrics_fresh": routes["gauges"].get("kv_router_metrics_stale") == 0,
            "agreement": ref["logits_finite"] and ref["logits_shape_ok"]
            and ref["greedy_agreement_vs_no_cache_reference"] >= PHASES_AGREEMENT
            and ref["max_logprob_gap_at_disagreement"] <= NEAR_TIE_NATS,
            "router_service": svc_split == [0.0, float(KV_PER_GROUP)]
            and svc_reuse == (KV_PER_GROUP - 1) * KV_PREFIX // 16
            and svc_ref["greedy_agreement_vs_no_cache_reference"] >= PHASES_AGREEMENT
            and svc_ref["max_logprob_gap_at_disagreement"] <= NEAR_TIE_NATS,
            "exporter": exporter_ok,
            "exits": exits == [0, 0],
        }
        if not all(gates.values()):
            raise SystemExit(f"fleet: kv_route gates {gates}")
        return result
    finally:
        for child in children:
            await child.kill()


async def worker_exit(child, timeout: float = 120.0) -> dict:
    """A drained worker's end: "drain complete", exit code 0, and its
    ``worker report`` line (requests, dispatches, launch counts, memory)."""
    import re

    _, t_done = await child.wait_for(r"^drain complete", timeout)
    rc = await child.exit_code(timeout)
    m, _ = await child.wait_for(r"^worker report (\{.*\})", 5)
    if rc != 0:
        raise SystemExit(f"fleet: {child.name} exited {rc}:\n{child.tail()}")
    report = json.loads(m.group(1))
    report["exit_code"] = rc
    report["drain_complete_s"] = t_done - child.t_spawn
    return report


def launches_ok(report: dict, walk_path: bool) -> bool:
    """The worker's ragged wrapper launched num_layers times per dispatch,
    every call on the split path and on the tile (bf16) or walk (f32)."""
    k = report["kernel_launches"]
    n = k["ragged_paged_attention_cuda.launches"]
    tile = k["ragged_paged_attention_cuda.launches_walk" if walk_path
             else "ragged_paged_attention_cuda.launches_tc"]
    other = k["ragged_paged_attention_cuda.launches_tc" if walk_path
              else "ragged_paged_attention_cuda.launches_walk"]
    return (report["unified_dispatches"] > 0 and report["device"] == "cuda"
            and n == report["num_layers"] * report["unified_dispatches"]
            and tile == n and k["ragged_paged_attention_cuda.launches_split"] == n
            and other == 0)


async def serve_prompts(port, model, prompts, max_tokens, tapped, greedy) -> dict:
    """The prompts as concurrent streaming /v1/completions through the
    frontend; the client's numbers, the tapped streams and their workers,
    and whether every count is right."""
    t0 = time.perf_counter()
    streamed = await asyncio.gather(*[
        http_stream(port, "/v1/completions",
                    {"model": model, "prompt": p, "stream": True,
                     "max_tokens": max_tokens, **greedy}) for p in prompts])
    wall = time.perf_counter() - t0
    summaries = [stream_summary(timed) for _, timed in streamed]
    served_by = [tapped[tuple(p)]["workers"] for p in prompts]
    counts_ok = (
        all(r.status == 200 for r, _ in streamed)
        and all(s["usage"]["completion_tokens"] == max_tokens and s["finish"] == "length"
                and len(s["times"]) == max_tokens for s in summaries)
        and all(len(tapped[tuple(p)]["tokens"]) == max_tokens for p in prompts))
    ttft = [s["times"][0] for s in summaries]
    itl = [b - a for s in summaries for a, b in zip(s["times"], s["times"][1:])]
    by_worker: dict[str, list[float]] = {}
    for s, w in zip(summaries, served_by):
        by_worker.setdefault(f"{w[0]:#x}", []).extend(
            b - a for a, b in zip(s["times"], s["times"][1:]))
    return {
        "wall_s": wall, "tokens_per_s": len(prompts) * max_tokens / wall,
        "client_ttft_p50_ms": float(np.median(ttft)) * 1e3,
        "client_ttft_p95_ms": float(np.percentile(ttft, 95)) * 1e3,
        "client_itl_p50_ms": float(np.percentile(itl, 50)) * 1e3,
        "client_itl_p95_ms": float(np.percentile(itl, 95)) * 1e3,
        "client_itl_by_worker_ms": {
            w: {"p50": float(np.percentile(g, 50)) * 1e3,
                "p95": float(np.percentile(g, 95)) * 1e3}
            for w, g in by_worker.items()},
        "counts_ok": counts_ok,
        "streams": [tapped[tuple(p)]["tokens"][:max_tokens] for p in prompts],
    }


class _LogTimes(logging.Handler):
    """Arrival time (perf_counter) of each record of one logger: when
    the frontend saw a worker die, when it re-dispatched."""

    def __init__(self) -> None:
        super().__init__()
        self.times: list[tuple[float, str]] = []

    def emit(self, record) -> None:
        self.times.append((time.perf_counter(), record.getMessage()))


def choice_events(timed) -> list[float]:
    out = []
    for t, ev in timed:
        if ev.data != "[DONE]" and json.loads(ev.data).get("choices"):
            out.append(t)
    return out


async def phase_fleet(prompts, max_tokens, http, params, seed: int = 1) -> dict:
    """The runtime plane on the card: see the module docstring (phase 9).
    Legs run serve, drain verb, SIGTERM (the two bf16 workers), then the
    float32 failover pair."""
    import signal

    from dynamo_tpu_torch import cli
    from dynamo_tpu_torch.llm.http_client import fetch
    from dynamo_tpu_torch.models.config import ModelConfig
    from dynamo_tpu_torch.runtime.distributed import DistributedRuntime
    from dynamo_tpu_torch.runtime.drain import request_drain
    from dynamo_tpu_torch.runtime.failover import FAILOVER
    from dynamo_tpu_torch.runtime.pipeline import Tap

    cfg = ModelConfig.llama32_1b()
    tapped: dict[tuple, dict] = {}   # prompt token ids -> tokens, workers

    def on_request(ctx):
        tapped[tuple(ctx.payload["token_ids"])] = {
            "tokens": [], "workers": [], "id": ctx.id}

    def on_response(ctx, item):
        rec = tapped[tuple(ctx.payload["token_ids"])]
        wid = ctx.annotations.get("worker_id")
        if not rec["workers"] or rec["workers"][-1] != wid:
            rec["workers"].append(wid)
        rec["tokens"].extend(item["token_ids"])

    tap = Tap(on_request, on_response)
    greedy = {"temperature": 0, "nvext": {"ignore_eos": True}}
    children: list = []
    result: dict = {"phase": "fleet", "model": cfg.name}
    cp = Child("control plane", ["control-plane", "--host", "127.0.0.1", "--port", "0"])
    children.append(cp)
    obs = None
    try:
        await cp.start()
        addr = (await cp.wait_for(r"control plane on (\S+)", 120))[0].group(1)
        obs = await DistributedRuntime.connect(addr)
        async with contextlib.AsyncExitStack() as stack:
            args = cli.build_parser().parse_args([
                "run", "--in", "http", "--out", "dyn", "--control-plane", addr,
                "--http-host", "127.0.0.1", "--http-port", "0"])
            cli.refuse_unserved(args)
            service, _ = await cli.start_http(args, stack, engine_ops=(tap,))
            port = service.port

            # -- leg 1: serve through two bf16 workers ----------------------------
            puts = await watch_puts(obs, stack)
            bf16 = await spawn_workers(addr, 2, "bfloat16", "bf16-")
            children += [w[0] for w in bf16]
            await wait_leases(obs, {w[1] for w in bf16})
            discovery = [puts[lease] - child.t_spawn for child, lease, *_ in bf16]
            await wait_model(port, cfg.name)
            served = await serve_prompts(port, cfg.name, prompts, max_tokens, tapped, greedy)
            split = [await worker_requests(w[2]) for w in bf16]
            streams = served.pop("streams")
            ref = teacher_forced(cfg, params, list(prompts), streams)
            ref.pop("first_token_ref_logprob")
            result["serve"] = {
                "workers": [{"lease": f"{lease:#x}", "startup_s": up,
                             "discovery_s": d, "requests": n}
                            for (_, lease, _, up), d, n in zip(bf16, discovery, split)],
                "requests": len(prompts), "max_tokens": max_tokens, **served,
                "http_phase": {k: http[k] for k in (
                    "tokens_per_s", "client_ttft_p50_ms", "client_itl_p50_ms",
                    "client_itl_p95_ms")},
                **ref,
                "greedy_match_rate_vs_http": match_rate(streams, http["streams"]),
                "gates": {"agreement_min": PHASES_AGREEMENT, "gap_max": NEAR_TIE_NATS},
            }
            counts_ok = served["counts_ok"]
            emit({"phase": "fleet_serve", **result["serve"]})
            if not counts_ok or sorted(split) != [4.0, 4.0]:
                raise SystemExit(f"fleet: serve counts {counts_ok}, split {split}")
            if not (ref["logits_finite"] and ref["logits_shape_ok"]
                    and ref["greedy_agreement_vs_no_cache_reference"] >= PHASES_AGREEMENT
                    and ref["max_logprob_gap_at_disagreement"] <= NEAR_TIE_NATS):
                raise SystemExit("fleet: streams disagree with the no-cache reference")

            # -- kv_route: the KV-aware router on the same two workers -------
            result["kv_route"] = await kv_route_leg(
                addr, stack, obs, bf16, cfg, params, port, tap, tapped, greedy,
                max_tokens, np.random.default_rng([seed, 9]))

            # -- legs 3 and 4: the drain verb, then SIGTERM on the last ----------
            by_lease = {w[1]: w for w in bf16}
            reports = {}
            legs = {}
            for how in ("drain_verb", "sigterm"):
                live = await instance_leases(obs)
                prompt = prompts[0 if how == "drain_verb" else 1]
                nxt = prompts[2 if how == "drain_verb" else 3]
                tapped.pop(tuple(prompt), None)
                tapped.pop(tuple(nxt), None)
                long_tokens = 256
                inflight = asyncio.ensure_future(http_stream(
                    port, "/v1/completions",
                    {"model": cfg.name, "prompt": prompt, "stream": True,
                     "max_tokens": long_tokens, **greedy}))
                await until(lambda: len(tapped.get(tuple(prompt), {}).get("tokens", [])) >= 8
                            or inflight.done(), 60, f"{how}: 8 tokens in flight")
                if inflight.done():
                    raise SystemExit(f"fleet: {how} stream ended early: {inflight.result()[0].status}")
                lease = tapped[tuple(prompt)]["workers"][0]
                child = by_lease[lease][0]
                if how == "drain_verb":
                    await request_drain(obs, "dynamo", "torch", lease_id=lease)
                else:
                    child.signal(signal.SIGTERM)
                deregistered = asyncio.ensure_future(wait_leases(obs, live - {lease}))
                resp, timed = await inflight
                t_stream_done = time.monotonic()
                summ = stream_summary(timed)
                report = await worker_exit(child)
                reports[f"{lease:#x}"] = report
                leg = {"lease": f"{lease:#x}", "inflight_status": resp.status,
                       "inflight_tokens": summ["usage"]["completion_tokens"],
                       "inflight_finish": summ["finish"],
                       "deregistered_after_s": await deregistered,
                       "exit_after_stream_s": time.monotonic() - t_stream_done,
                       "exit_code": report["exit_code"]}
                r = await fetch("127.0.0.1", port, "POST", "/v1/completions",
                                {"model": cfg.name, "prompt": nxt, "max_tokens": 8, **greedy})
                leg["next_status"] = r.status
                if how == "drain_verb":
                    leg["next_served_by"] = f"{tapped[tuple(nxt)]['workers'][0]:#x}"
                legs[how] = leg
                ok = (resp.status == 200 and leg["inflight_tokens"] == long_tokens
                      and summ["finish"] == "length")
                if how == "drain_verb":
                    ok &= r.status == 200 and tapped[tuple(nxt)]["workers"][0] != lease
                else:
                    # No instance left: the model is gone (404) or the
                    # router finds no live instance (503).
                    ok &= r.status in (404, 503)
                if not ok:
                    raise SystemExit(f"fleet: {how} leg {leg}")
                if how == "drain_verb":
                    # The same 8 requests through the one worker left: the
                    # hop's cost beside the http phase's in-process serve,
                    # without a second process on the card.
                    for p in prompts:
                        tapped.pop(tuple(p), None)
                    one = await serve_prompts(port, cfg.name, prompts, max_tokens,
                                              tapped, greedy)
                    one_streams = one.pop("streams")
                    one_ref = teacher_forced(cfg, params, list(prompts), one_streams)
                    one_ref.pop("first_token_ref_logprob")
                    result["serve_one_worker"] = {**one, **one_ref}
                    emit({"phase": "fleet_serve_one_worker", **result["serve_one_worker"]})
                    if not (one["counts_ok"] and one_ref["logits_finite"]
                            and one_ref["greedy_agreement_vs_no_cache_reference"]
                            >= PHASES_AGREEMENT
                            and one_ref["max_logprob_gap_at_disagreement"] <= NEAR_TIE_NATS):
                        raise SystemExit("fleet: one-worker serve failed its gates")
            launches = {w: launches_ok(rep, walk_path=False) for w, rep in reports.items()}
            result["drain"] = legs
            result["bf16_workers"] = reports
            emit({"phase": "fleet_drain", "legs": legs, "worker_reports": reports,
                  "launches_ok": launches})
            if not all(launches.values()):
                raise SystemExit(f"fleet: bf16 worker launches {launches}")

            # -- leg 2: failover between two float32 workers -------------------
            f32 = await spawn_workers(addr, 2, "float32", "f32-")
            children += [w[0] for w in f32]
            await wait_leases(obs, {w[1] for w in f32})
            await wait_model(port, cfg.name)
            fo_prompt, fo_tokens = [11, 22, 33, 44], 64
            body = {"model": cfg.name, "prompt": fo_prompt, "stream": True,
                    "max_tokens": fo_tokens, **greedy}
            ref_resp, ref_timed = await http_stream(port, "/v1/completions", body)
            ref_stream = list(tapped[tuple(fo_prompt)]["tokens"])
            ref_worker = tapped[tuple(fo_prompt)]["workers"]
            before = dict(FAILOVER.success_by_reason), FAILOVER.total
            eighth = asyncio.Event()
            arrivals: list[float] = []

            def on_event(t, ev):
                if ev.data != "[DONE]" and json.loads(ev.data).get("choices"):
                    arrivals.append(time.perf_counter())
                    if len(arrivals) == 8:
                        eighth.set()

            tapped.pop(tuple(fo_prompt))
            seen = _LogTimes()
            logging.getLogger("dynamo_tpu_torch.runtime.failover").addHandler(seen)
            run = asyncio.ensure_future(http_stream(port, "/v1/completions", body, on_event))
            await asyncio.wait_for(eighth.wait(), 60)
            victim_lease = tapped[tuple(fo_prompt)]["workers"][0]
            victim = next(w[0] for w in f32 if w[1] == victim_lease)
            t_kill = time.perf_counter()
            victim.signal(signal.SIGKILL)
            got_resp, got_timed = await run
            summ = stream_summary(got_timed)
            got_stream = tapped[tuple(fo_prompt)]["tokens"]
            workers_seen = tapped[tuple(fo_prompt)]["workers"]
            logging.getLogger("dynamo_tpu_torch.runtime.failover").removeHandler(seen)
            t_detect = next((t for t, msg in seen.times if "died mid-stream" in msg), None)
            before_kill = [t for t in arrivals if t <= t_kill]
            after_kill = [t for t in arrivals if t > t_kill]
            gap = (after_kill[0] - before_kill[-1]) if after_kill and before_kill else None
            succ = FAILOVER.success_by_reason.get("WorkerDiedError", 0) - before[0].get(
                "WorkerDiedError", 0)
            survivor = next(w for w in f32 if w[1] != victim_lease)
            survivor[0].signal(signal.SIGTERM)
            f32_report = await worker_exit(survivor[0])
            await victim.exit_code(30)
            result["failover"] = {
                "prompt": fo_prompt, "max_tokens": fo_tokens, "dtype": "float32",
                "workers": [{"lease": f"{lease:#x}", "startup_s": up}
                            for _, lease, _, up in f32],
                "reference_served_by": [f"{w:#x}" for w in ref_worker],
                "killed": f"{victim_lease:#x}", "tokens_before_kill": len(before_kill),
                "served_by": [f"{w:#x}" for w in workers_seen],
                "status": got_resp.status, "tokens": summ["usage"]["completion_tokens"],
                "finish": summ["finish"],
                "byte_identical_to_uninterrupted": got_stream == ref_stream,
                "failover_successes_worker_died": succ,
                "failover_attempts": FAILOVER.total - before[1],
                "gap_at_client_ms": gap * 1e3 if gap is not None else None,
                "kill_to_death_seen_ms": (t_detect - t_kill) * 1e3 if t_detect else None,
                "death_seen_to_next_token_ms": (after_kill[0] - t_detect) * 1e3
                if t_detect and after_kill else None,
                "reference_itl_p50_ms": float(np.median(np.diff(choice_events(ref_timed)))) * 1e3,
                "survivor_report": f32_report,
                "survivor_launches_ok": launches_ok(f32_report, walk_path=True),
            }
            emit({"phase": "fleet_failover", **result["failover"]})
            fo = result["failover"]
            sv = result["serve"]
            result["summary"] = {
                "worker_startup_s": [w["startup_s"] for w in sv["workers"]]
                + [w["startup_s"] for w in fo["workers"]],
                "worker_discovery_s": [w["discovery_s"] for w in sv["workers"]],
                "client_ttft_ms": {"p50": sv["client_ttft_p50_ms"],
                                   "p95": sv["client_ttft_p95_ms"],
                                   "http_phase_p50": http["client_ttft_p50_ms"]},
                "client_itl_ms": {"p50": sv["client_itl_p50_ms"],
                                  "p95": sv["client_itl_p95_ms"],
                                  "http_phase_p50": http["client_itl_p50_ms"],
                                  "http_phase_p95": http["client_itl_p95_ms"]},
                "tokens_per_s": sv["tokens_per_s"],
                "http_phase_tokens_per_s": http["tokens_per_s"],
                "one_worker": {k: result["serve_one_worker"][k] for k in (
                    "tokens_per_s", "client_ttft_p50_ms", "client_itl_p50_ms",
                    "client_itl_p95_ms")},
                "failover_gap_ms": fo["gap_at_client_ms"],
                "failover_kill_to_death_seen_ms": fo["kill_to_death_seen_ms"],
                "failover_death_seen_to_next_token_ms": fo["death_seen_to_next_token_ms"],
                "worker_cuda_max_allocated_gb": {
                    w: r.get("cuda_max_allocated_bytes", 0) / 1e9
                    for w, r in {**reports, f"{survivor[1]:#x}": f32_report}.items()},
            }
            emit({"phase": "fleet", **result["summary"]})
            if not (ref_resp.status == 200 and len(ref_stream) == fo_tokens
                    and fo["status"] == 200 and fo["tokens"] == fo_tokens
                    and fo["finish"] == "length" and fo["byte_identical_to_uninterrupted"]
                    and succ == 1 and len(workers_seen) == 2 and gap is not None
                    and fo["survivor_launches_ok"]):
                raise SystemExit(f"fleet: failover leg {fo}")
    finally:
        if obs is not None:
            await obs.shutdown()
        for child in children:
            await child.kill()
    return result


async def until(cond, timeout: float, what: str) -> None:
    t0 = time.monotonic()
    while not cond():
        if time.monotonic() - t0 > timeout:
            raise SystemExit(f"fleet: timed out waiting for {what}")
        await asyncio.sleep(0.002)


async def watch_puts(drt, stack) -> dict[int, float]:
    """{lease: arrival time of its instance key's PUT} from a watch on the
    endpoint's instances, as the frontend's router watches them."""
    from dynamo_tpu_torch.runtime.transports.store import EventKind

    watch = await drt.store.watch_prefix("instances/dynamo/torch/generate:")
    puts: dict[int, float] = {}

    async def pump():
        async for ev in watch:
            if ev.kind is EventKind.PUT:
                puts.setdefault(int(ev.key.rsplit(":", 1)[1], 16), time.monotonic())

    task = asyncio.ensure_future(pump())
    stack.callback(task.cancel)
    stack.callback(watch.cancel)
    return puts


async def wait_model(port: int, name: str, timeout: float = 30.0) -> None:
    from dynamo_tpu_torch.llm.http_client import fetch

    t0 = time.monotonic()
    while name not in [m["id"] for m in (await fetch(
            "127.0.0.1", port, "GET", "/v1/models")).json()["data"]]:
        if time.monotonic() - t0 > timeout:
            raise SystemExit(f"fleet: the frontend never listed {name}")
        await asyncio.sleep(0.05)


# -- phase 10: disaggregation and the KVBM tiers ------------------------------
DISAGG_MAX_LEN = 2048         # the disagg engines' max_model_len (1536 + 32 fits)
DISAGG_LONG = (1024, 1537)    # remote prompts: 4, tokens in [1024, 1536]
DISAGG_SHORT = (64, 257)      # local prompts: 4, tokens in [64, 256]
DISAGG_LOCAL_MAX = 512        # DisaggConfig.max_local_prefill_length
KVBM_GROUPS = 2               # the kvbm leg: prefix groups ...
KVBM_PER_GROUP = 4            # ... of 4 prompts ...
KVBM_PREFIX = 512             # ... sharing 512 tokens (32 blocks) ...
KVBM_SUFFIX = 64              # ... each with 64 of its own
WORKER_ARGS = ["--model-path", "preset:llama3.2-1b", "--max-model-len", str(DISAGG_MAX_LEN),
               "--num-blocks", "1024", "--max-num-seqs", "8", "--prefill-batch", "4",
               "--unified-token-budget", "256", "--seed", "0", "--warmup"]


def disagg_config(**kw):
    return full_width_config(max_model_len=DISAGG_MAX_LEN, **kw)


def disagg_prompts(seed: int, vocab: int) -> list[list[int]]:
    """4 long prompts (remote) then 4 short ones (local), from ``seed``."""
    rng = np.random.default_rng(seed)
    lens = list(rng.integers(*DISAGG_LONG, 4)) + list(rng.integers(*DISAGG_SHORT, 4))
    return [rng.integers(0, vocab, int(n)).tolist() for n in lens]


def stream_gates(leg: str, cfg, params, prompts, streams, finishes, max_tokens) -> dict:
    """Full-length greedy streams in the vocabulary, held to the no-cache
    reference as the phase-split run is: agreement >= 0.9, every
    disagreement a near tie."""
    from dynamo_tpu_torch.llm.protocols.common import FinishReason

    ref = teacher_forced(cfg, params, prompts, streams)
    ref.pop("first_token_ref_logprob")
    full = all(len(s) == max_tokens for s in streams) and all(
        f is FinishReason.LENGTH for f in finishes)
    in_vocab = all(0 <= t < cfg.vocab_size for s in streams for t in s)
    if not (full and in_vocab and ref["logits_finite"] and ref["logits_shape_ok"]
            and ref["greedy_agreement_vs_no_cache_reference"] >= PHASES_AGREEMENT
            and ref["max_logprob_gap_at_disagreement"] <= NEAR_TIE_NATS):
        raise SystemExit(f"disagg {leg}: streams failed their checks "
                         f"(full {full}, in vocab {in_vocab}, {ref})")
    return ref


def span_ms(path: str, name: str) -> list[float]:
    """Durations of every ``name`` span of one process's trace capture, in
    the order they were recorded."""
    from dynamo_tpu_torch.utils.recorder import Recorder

    return [float(ev["dur_ms"]) for _ts, ev in Recorder.load(path)
            if ev.get("kind") == "span" and ev.get("span") == name]


def pct(xs: list[float], q: float) -> float | None:
    return float(np.percentile(xs, q)) if xs else None


def device_crc_match(sender, receiver, prompts) -> dict:
    """Each remote prompt's full blocks: the receiving engine's bytes
    against the sending engine's (both caches hold the prompt under the
    same block hashes), by CRC. Returns counts."""
    from dynamo_tpu_torch.block_manager.integrity import block_checksum
    from dynamo_tpu_torch.llm.tokens import TokenBlockSequence

    same = total = 0
    bs = sender.cfg.block_size
    for p in prompts:
        hashes = TokenBlockSequence.from_tokens(p, block_size=bs).sequence_hashes()[
            : len(p) // bs]
        ids = [(sender.allocator._hash_to_block.get(h), receiver.allocator._hash_to_block.get(h))
               for h in hashes]
        ids = [(a, b) for a, b in ids if a is not None and b is not None]
        if not ids:
            continue
        got_a = sender.runner.gather_many([a for a, _ in ids])
        got_b = receiver.runner.gather_many([b for _, b in ids])
        for x, y in zip(got_a, got_b):
            total += 1
            same += block_checksum(x) == block_checksum(y)
    return {"blocks_compared": total, "blocks_crc_equal": same}


async def disagg_leg(name, decode, queue, transport, prompts, max_tokens, params,
                     prefill=None, worker=None) -> dict:
    """The 8 prompts through a DecodeOperator pinned to ``transport``: 4
    remote, 4 local; the receivers' counters name the transport that
    carried the blocks; the ragged kernel's launches are counted over the
    leg on this process's engines (and read from the worker's report
    when the prefill engine is a process of its own)."""
    from dynamo_tpu_torch.block_manager.integrity import INTEGRITY
    from dynamo_tpu_torch.disagg import DecodeOperator, DisaggConfig, DisaggRouter
    from dynamo_tpu_torch.ops.kernels.ragged_attention import (
        ragged_paged_attention_cuda as fn,
    )
    from dynamo_tpu_torch.ops.kernels.ragged_attention import reset_counts

    router = DisaggRouter.__new__(DisaggRouter)
    router.cfg = DisaggConfig(max_local_prefill_length=DISAGG_LOCAL_MAX,
                              max_prefill_queue_size=64)
    # Staging slots for 4 remote prompts of up to 97 blocks at once (the
    # native transport reserves one per block; 512 KiB each).
    op = await DecodeOperator(decode, queue, router, transport=transport,
                              staging_slots=512).start()
    INTEGRITY.reset()
    engines = [decode] + ([prefill] if prefill is not None else [])
    d0 = [e.unified_dispatches for e in engines]
    reset_counts()
    try:
        streams, finishes, ttft, wall = await serve(op, prompts, max_tokens)
    finally:
        await op.stop()
    launches = fn.launches
    paths = {"tc": fn.launches_tc, "split": fn.launches_split, "walk": fn.launches_walk}
    dispatches = [e.unified_dispatches - d for e, d in zip(engines, d0)]
    cfg = decode.cfg.model
    receivers = {"device": op.device_receiver, "native": op.receiver if op.transport == "native"
                 else None, "tcp": op.tcp_receiver or (op.receiver if op.transport == "tcp"
                                                      else None)}
    carried = {k: (r.blocks_received if r is not None else 0) for k, r in receivers.items()}
    nbytes = {k: (r.bytes_received if r is not None else 0) for k, r in receivers.items()}
    bs = decode.cfg.block_size
    want_blocks = sum((len(p) + bs - 1) // bs for p in prompts[:4])
    out = {
        "leg": name, "transport": transport, "remote_count": op.remote_count,
        "local_count": op.local_count, "blocks_received": carried,
        "bytes_received": nbytes, "expected_blocks": want_blocks,
        "integrity": INTEGRITY.snapshot(), "wall_s": wall,
        "ttft_remote_p50_ms": float(np.median(ttft[:4])) * 1e3,
        "ttft_local_p50_ms": float(np.median(ttft[4:])) * 1e3,
        "ttft_ms": [t * 1e3 for t in ttft],
        "unified_dispatches": dispatches, "kernel_launches": launches,
        "kernel_launches_by_path": paths,
        "mid_traffic_compiles": [mid_traffic(e) for e in engines],
        "degraded_requests": decode.degraded_requests,
    }
    if (op.remote_count, op.local_count) != (4, 4):
        raise SystemExit(f"disagg {name}: remote/local {op.remote_count}/{op.local_count}")
    if carried[transport] != want_blocks or sum(carried.values()) != want_blocks:
        raise SystemExit(f"disagg {name}: blocks carried {carried}, want {want_blocks} "
                         f"on {transport} only")
    if out["integrity"]["integrity_failures_total"] or decode.degraded_requests:
        raise SystemExit(f"disagg {name}: integrity {out['integrity']}, "
                         f"degraded {decode.degraded_requests}")
    if launches != cfg.num_layers * sum(dispatches) or 0 in dispatches:
        raise SystemExit(f"disagg {name}: ragged kernel launched {launches} times for "
                         f"{dispatches} dispatches x {cfg.num_layers} layers")
    want_paths = {"tc": launches, "split": launches, "walk": 0}
    if decode.cfg.dtype == "bfloat16" and paths != want_paths:
        raise SystemExit(f"disagg {name}: ragged paths {paths}")
    if any(out["mid_traffic_compiles"]):
        raise SystemExit(f"disagg {name}: graphs captured mid-traffic "
                         f"{out['mid_traffic_compiles']}")
    out.update(stream_gates(name, cfg, params, prompts, streams, finishes, max_tokens))
    out["streams"] = streams
    return out


async def worker_done(child, leg: str, served: int) -> dict:
    """SIGTERM a prefill worker; its report: every dispatch launched the
    ragged kernel once per layer, nothing was captured mid-traffic."""
    import json as _json
    import signal as _signal

    child.signal(_signal.SIGTERM)
    rc = await child.exit_code(120)
    m, _ = await child.wait_for(r"worker report (\{.*\})", 5)
    rep = _json.loads(m.group(1))
    launches = rep["kernel_launches"]["ragged_paged_attention_cuda.launches"]
    rep["ragged_launches"] = launches
    if (rc != 0 or rep["requests"] != served or rep["mid_traffic_compiles"]
            or launches != rep["num_layers"] * rep["unified_dispatches"]
            or not rep["unified_dispatches"]):
        raise SystemExit(f"disagg {leg}: prefill worker rc {rc}, report {rep}")
    return rep


async def kvbm_leg(vocab: int, max_tokens: int, params) -> dict:
    """An engine with a KvBlockManager (a G2 host tier, a G3 disk tier in
    a temporary directory): 8 prompts sharing two 512-token prefixes
    served cold, the device cache cleared and the prompts served again
    (the first time the adaptive gate decides, then with its estimates
    in), the onboarded blocks held to the offered rows by CRC; then the
    host tier spilled and a two-touch disk promotion brought back through
    G3 with its envelope verified."""
    from dynamo_tpu_torch.block_manager import KvbmConfig, KvBlockManager, KvLayoutConfig
    from dynamo_tpu_torch.block_manager.integrity import INTEGRITY, block_checksum
    from dynamo_tpu_torch.engine.engine import TorchEngine
    from dynamo_tpu_torch.ops.kernels.ragged_attention import (
        ragged_paged_attention_cuda as fn,
    )
    from dynamo_tpu_torch.ops.kernels.ragged_attention import reset_counts

    rng = np.random.default_rng(5)
    prompts = []
    for _ in range(KVBM_GROUPS):
        prefix = rng.integers(0, vocab, KVBM_PREFIX).tolist()
        prompts += [prefix + rng.integers(0, vocab, KVBM_SUFFIX).tolist()
                    for _ in range(KVBM_PER_GROUP)]
    ecfg = disagg_config()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_kvbm_")
    INTEGRITY.reset()
    kvbm = await KvBlockManager(KvbmConfig(
        layout=KvLayoutConfig.for_engine(ecfg, quant=None), host_blocks=256,
        disk_blocks=512, disk_path=os.path.join(tmp, "g3.kv"),
    )).start()
    engine = TorchEngine(ecfg, device=DEVICE, block_manager=kvbm)
    await engine.start()
    out: dict = {"leg": "kvbm", "prompts": len(prompts)}
    try:
        await warm_up(engine)

        async def run_pass(name):
            await engine.wait_drained(30)
            r0 = {k: engine.readiness()[k] for k in (
                "kv_reused_device_blocks_total", "kv_reused_host_blocks_total",
                "kv_reused_disk_blocks_total")}
            d0 = engine.unified_dispatches
            reset_counts()
            streams, finishes, ttft, wall = await serve(engine, prompts, max_tokens)
            await engine.wait_drained(30)
            await kvbm.drain_offers()
            rd = engine.readiness()
            dispatches = engine.unified_dispatches - d0
            if fn.launches != ecfg.model.num_layers * dispatches or not dispatches:
                raise SystemExit(f"disagg kvbm {name}: ragged kernel launched "
                                 f"{fn.launches} times for {dispatches} dispatches")
            out["ragged_launches"] = out.get("ragged_launches", 0) + fn.launches
            out[name] = {
                "ttft_p50_ms": float(np.median(ttft)) * 1e3, "wall_s": wall,
                "unified_dispatches": dispatches,
                "prefill_tokens_total": engine.unified_prefill_tokens,
                **{k: rd[k] - r0[k] for k in r0},
                "onboard_skips": engine._onboard_skips,
                "onboard_probes": engine._onboard_probes,
            }
            return streams, finishes

        cold, cold_fin = await run_pass("cold")
        stream_gates("kvbm_cold", ecfg.model, params, prompts, cold, cold_fin, max_tokens)
        offered = {h: kvbm.host_pool.get_by_hash(h).checksum
                   for h in kvbm.host_pool.registered_hashes()}
        out["offered_blocks"] = len(offered)
        # Twice with the adaptive gate deciding (its first pass probes, the
        # second has its rate estimates), then with the gate off: every
        # host hit onboards, the TTFT of a host hit against recompute.
        for name in ("host_gate_first", "host_gate", "host"):
            engine.cfg.kvbm_adaptive_gate = name != "host"
            engine.allocator.clear_reusable()
            streams, fin = await run_pass(name)
            stream_gates(f"kvbm_{name}", ecfg.model, params, prompts, streams, fin,
                         max_tokens)
        # The onboarded blocks, read back from the device cache, are the
        # rows the tier was offered (same CRC): every prompt's blocks
        # below its last full one (that one is always recomputed).
        from dynamo_tpu_torch.llm.tokens import TokenBlockSequence

        onboardable = set()
        for p in prompts:
            hs = TokenBlockSequence.from_tokens(p, block_size=16).sequence_hashes()
            onboardable.update(hs[: (len(p) - 1) // 16])
        ids = [(h, engine.allocator._hash_to_block[h]) for h in offered
               if h in onboardable and h in engine.allocator._hash_to_block]
        rows = engine.runner.gather_many([b for _, b in ids])
        same = sum(block_checksum(r) == offered[h] for (h, _), r in zip(ids, rows))
        out["device_vs_offered_crc"] = {"compared": len(ids), "equal": same}
        out["onboard_gbps"] = (engine._onboard_bps or 0.0) / 1e9
        out["prefill_tps"] = engine._prefill_tps
        # Spill G2 (LRU pressure): the prefixes live on G3 only; touch 1
        # recomputes and requests their promotion, touch 2 onboards them.
        await kvbm._g2_to_g3.drain()
        for b in kvbm.host_pool.allocate_blocks(kvbm.host_pool.num_free):
            kvbm.host_pool.release(b)
        for name in ("disk_touch1", "disk_touch2"):
            engine.allocator.clear_reusable()
            streams, fin = await run_pass(name)
            stream_gates(f"kvbm_{name}", ecfg.model, params, prompts, streams, fin,
                         max_tokens)
        st = kvbm.stats()
        out["stats"] = {k: v for k, v in st.items() if not k.startswith("quant")}
        out["integrity"] = INTEGRITY.snapshot()
    finally:
        await engine.stop()
        await kvbm.stop()
        shutil.rmtree(tmp, ignore_errors=True)
    h = out["host"]
    if (len(offered) != KVBM_GROUPS * KVBM_PREFIX // 16 + len(prompts) * KVBM_SUFFIX // 16
            or not h["kv_reused_host_blocks_total"]
            or out["device_vs_offered_crc"]["equal"] != out["device_vs_offered_crc"][
                "compared"] or not out["device_vs_offered_crc"]["compared"]
            or out["stats"]["promotions_requested_total"] == 0
            or out["stats"]["promoted_blocks_total"] == 0
            or out["integrity"]["integrity_failures_total"]):
        raise SystemExit(f"disagg kvbm: gates failed {out}")
    return out


async def phase_disagg(vocab: int, max_tokens: int, params) -> dict:
    """Disaggregated prefill/decode at full width (llama3.2-1b), over the
    three transports, an int8 pair, and the KVBM tiers: see the module
    docstring (phase 10)."""
    from dynamo_tpu_torch.disagg import PrefillQueue, PrefillWorker
    from dynamo_tpu_torch.engine.engine import TorchEngine
    from dynamo_tpu_torch.runtime.distributed import DistributedRuntime
    from dynamo_tpu_torch.runtime.transports.control_plane import ControlPlaneServer
    from dynamo_tpu_torch.utils.tracing import reset_tracer

    t_phase = time.monotonic()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_disagg_")
    trace = os.path.join(tmp, "trace.jsonl")
    result: dict = {"phase": "disagg"}
    server = await ControlPlaneServer(port=0).start()
    front = await DistributedRuntime.connect(server.address)
    # The prefill worker processes start now: their start-up overlaps
    # the in-process legs.
    workers = {
        "bf16": await Child("prefill worker bf16", [
            "--control-plane", server.address, "--namespace", "wire", *WORKER_ARGS],
            module="dynamo_tpu_torch.examples.prefill_worker",
            env={"DYNTPU_TRACE": trace}).start(),
        "int8": await Child("prefill worker int8", [
            "--control-plane", server.address, "--namespace", "wire8", "--kv-quant",
            "int8", *WORKER_ARGS], module="dynamo_tpu_torch.examples.prefill_worker",
            env={"DYNTPU_TRACE": trace}).start(),
    }
    engines = []
    try:
        # device: both engines in this process, the device channel.
        reset_tracer(trace)
        decode = TorchEngine(disagg_config(), device=DEVICE)
        prefill = TorchEngine(disagg_config(), device=DEVICE)
        engines += [decode, prefill]
        for e in (decode, prefill):
            await e.start()
            await warm_up(e)
        dev_params = decode.runner.params
        prompts = disagg_prompts(1, vocab)
        # The same prompts served locally on the decode engine first: the
        # TTFT the remote path is compared with.
        local_streams, _f, local_ttft, _w = await serve(decode, prompts, max_tokens)
        await decode.wait_drained(30)
        decode.allocator.clear_reusable()
        drt = await DistributedRuntime.in_process()
        queue = PrefillQueue(drt, "device")
        pw = PrefillWorker(prefill, queue).start()
        try:
            leg = await disagg_leg("device", decode, queue, "device", prompts, max_tokens,
                                   dev_params, prefill=prefill)
        finally:
            await pw.stop()
            await drt.shutdown()
        leg["ttft_same_prompts_local_p50_ms"] = float(np.median(local_ttft[:4])) * 1e3
        leg["match_rate_vs_local"] = match_rate(leg.pop("streams"), local_streams)
        leg["sender_vs_receiver_blocks"] = device_crc_match(prefill, decode, prompts[:4])
        c = leg["sender_vs_receiver_blocks"]
        if not c["blocks_compared"] or c["blocks_crc_equal"] != c["blocks_compared"]:
            raise SystemExit(f"disagg device: received blocks differ from sent {c}")
        result["device"] = leg
        emit({"phase": "disagg_leg", **leg})
        for e in (decode, prefill):
            await e.stop()
        engines.clear()
        del decode, prefill
        gc.collect()
        torch.cuda.empty_cache()

        # kvbm: one engine over the G2 host and G3 disk tiers.
        result["kvbm"] = await kvbm_leg(vocab, max_tokens, params)
        emit({"phase": "disagg_leg", **result["kvbm"]})
        gc.collect()
        torch.cuda.empty_cache()

        # tcp and native: the prefill engine in a worker process.
        decode = TorchEngine(disagg_config(), device=DEVICE)
        engines.append(decode)
        await decode.start()
        await warm_up(decode)
        await workers["bf16"].wait_for(r"READY \d+", FLEET_WAIT_S)
        served = 0
        for seed, transport in ((2, "tcp"), (3, "native")):
            leg = await disagg_leg(transport, decode, PrefillQueue(front, "wire"), transport,
                                   disagg_prompts(seed, vocab), max_tokens, params)
            leg.pop("streams")
            served += 4
            result[transport] = leg
            emit({"phase": "disagg_leg", **leg})
        result["worker_bf16"] = await worker_done(workers["bf16"], "bf16", served)
        await decode.stop()
        engines.clear()
        del decode
        gc.collect()
        torch.cuda.empty_cache()

        # int8: an int8-KV pair over tcp (packed rows with their scales).
        decode = TorchEngine(disagg_config(kv_quant="int8"), device=DEVICE)
        engines.append(decode)
        await decode.start()
        await warm_up(decode)
        await workers["int8"].wait_for(r"READY \d+", FLEET_WAIT_S)
        leg = await disagg_leg("int8", decode, PrefillQueue(front, "wire8"), "tcp",
                               disagg_prompts(4, vocab), max_tokens, params)
        leg.pop("streams")
        lay = decode.runner._quant_layout()
        if leg["bytes_received"]["tcp"] != leg["expected_blocks"] * lay.block_bytes:
            raise SystemExit(f"disagg int8: {leg['bytes_received']} bytes for "
                             f"{leg['expected_blocks']} packed rows of {lay.block_bytes}")
        result["int8"] = leg
        emit({"phase": "disagg_leg", **leg})
        result["worker_int8"] = await worker_done(workers["int8"], "int8", 4)
    finally:
        for e in engines:
            await e.stop()
        for w in workers.values():
            await w.kill()
        reset_tracer(None)
        await front.shutdown()
        await server.stop()
    # kv_transfer spans: the device leg's in this process's capture, the
    # wire legs' in each worker's (tcp then native in the bf16 worker's).
    per_leg = {"device": span_ms(trace, "kv_transfer")}
    bf16 = span_ms(f"{trace}.{workers['bf16'].proc.pid}", "kv_transfer")
    per_leg["tcp"], per_leg["native"] = bf16[:4], bf16[4:]
    per_leg["int8"] = span_ms(f"{trace}.{workers['int8'].proc.pid}", "kv_transfer")
    for name, s in per_leg.items():
        leg = result[name]
        leg["kv_transfer_spans"] = len(s)
        leg["kv_transfer_p50_ms"] = pct(s, 50)
        leg["kv_transfer_p95_ms"] = pct(s, 95)
        moved = sum(leg["bytes_received"].values())
        leg["kv_transfer_gbps"] = moved / (sum(s) / 1e3) / 1e9 if s else None
    shutil.rmtree(tmp, ignore_errors=True)
    if [len(s) for s in per_leg.values()] != [4, 4, 4, 4]:
        raise SystemExit(f"disagg: kv_transfer spans per leg "
                         f"{ {k: len(v) for k, v in per_leg.items()} }")
    result["wall_s"] = time.monotonic() - t_phase
    emit({"phase": "disagg", **{k: v for k, v in result.items()
                                if k not in ("device", "tcp", "native", "int8", "kvbm")},
          "summary": {n: {k: result[n].get(k) for k in (
              "ttft_remote_p50_ms", "ttft_local_p50_ms", "ttft_same_prompts_local_p50_ms",
              "kv_transfer_p50_ms", "kv_transfer_p95_ms", "kv_transfer_gbps",
              "unified_dispatches", "kernel_launches")}
              for n in ("device", "tcp", "native", "int8")}})
    return result


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader", "-i", "0"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    if not out:
        raise SystemExit("nvidia-smi reported no card")
    return out


def kernel_entry(name, source, replaces, launches, t, design, **extra) -> dict:
    return {
        "name": name, "route": "cuda", "source": source, "replaces": replaces,
        "launches": launches, "max_abs_err": t["max_abs_err"],
        "ms": t["kernel_ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"], "library_ms": t["library_ms"], "design": design,
        **extra,
    }


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False   # f32 references stay f32
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    # The full-width serves' prompts; the phase-split run takes the first
    # PHASE_LANES of them, and the decode and prefill kernels' main cases
    # are that run's.
    rng = np.random.default_rng(1)
    vocab = full_width_config().model.vocab_size
    lens = rng.integers(64, 513, 8)
    prompts = [rng.integers(0, vocab, n).tolist() for n in lens]
    more = [rng.integers(0, vocab, n).tolist() for n in lens]
    max_tokens = 32
    phase_lens = [int(n) for n in lens[:PHASE_LANES]]

    phase_build()
    t_ragged, t_int8 = phase_ragged()
    t_decode = phase_decode(phase_lens, max_tokens)
    t_prefill = phase_prefill(phase_lens, max_tokens)
    asyncio.run(phase_tiny())

    served, engine, streams = asyncio.run(serve_full(
        full_width_config(), prompts, max_tokens, "serve", profile_prompts=more))
    phase_graphs(engine.runner.params, served.pop("recorded"), None, "graphs")
    served_int8, _, streams_int8 = asyncio.run(serve_full(
        full_width_config(kv_quant="int8"), prompts, max_tokens, "serve_int8",
        profile_prompts=more))
    emit({"phase": "serve_int8_vs_bf16",
          "greedy_match_rate": match_rate(streams_int8, streams)})
    phase_graphs(engine.runner.params, served_int8.pop("recorded"), "int8",
                 "graphs_int8")
    asyncio.run(phase_spec(prompts + repeated_prompts(rng, vocab), max_tokens))
    http = asyncio.run(phase_http(prompts, streams, max_tokens, served, more[:2]))
    observe = asyncio.run(phase_observe(vocab))
    phases = phase_phases(engine.runner.params, prompts[:PHASE_LANES],
                          streams[:PHASE_LANES], max_tokens)
    # The fleet's workers are processes of their own on this card: free
    # this process's engines first, keeping the serve's weights (the
    # workers make the same ones from the same seed) for the gates.
    params = engine.runner.params
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    fleet = asyncio.run(phase_fleet(prompts, max_tokens, http, params))
    disagg = asyncio.run(phase_disagg(vocab, max_tokens, params))

    print(card, flush=True)
    ragged_src = "dynamo_tpu_torch/csrc/ragged_attention.cu"
    ragged = ("3 launches: spans of <= 4 rows split-KV over table columns "
              "(paged_split.cuh, cp.async ring) on a second stream beside the "
              "longer spans' mma.sync m16n8k16 tile of 128 query vectors "
              "(paged_attention_tc.cuh; the f32 walk for f32 q), then a merge pass "
              "that also zeroes unowned rows")
    emit({"kernels": [
        kernel_entry("ragged_paged_attention", ragged_src,
                     "dynamo_tpu/ops/pallas/ragged_attention.py:67",
                     served["kernel_launches"], t_ragged, ragged,
                     launches_by_path=served["kernel_launches_by_path"],
                     observe_launches=observe["kernel_launches"],
                     fleet_worker_launches={
                         w: r["kernel_launches"]["ragged_paged_attention_cuda.launches"]
                         for w, r in fleet["bf16_workers"].items()},
                     disagg_launches={
                         **{leg: disagg[leg]["kernel_launches"]
                            for leg in ("device", "tcp", "native")},
                         "prefill_worker": disagg["worker_bf16"]["ragged_launches"],
                         "kvbm": disagg["kvbm"]["ragged_launches"]}),
        kernel_entry("ragged_paged_attention_int8", ragged_src,
                     "dynamo_tpu/ops/pallas/ragged_attention.py:227",
                     served_int8["kernel_launches"], t_int8,
                     ragged + "; int8 pages unscaled in bf16, k scale on the f32 "
                     "scores, v scale on P", launches_by_path=served_int8[
                         "kernel_launches_by_path"],
                     disagg_launches={"tcp": disagg["int8"]["kernel_launches"],
                                      "prefill_worker": disagg["worker_int8"][
                                          "ragged_launches"]}),
        kernel_entry("paged_decode_attention",
                     "dynamo_tpu_torch/csrc/paged_decode_attention.cu",
                     "dynamo_tpu/ops/pallas/attention.py:91",
                     phases["decode_kernel_launches"], t_decode,
                     "split-KV over table columns, cp.async ring, merge kernel"),
        kernel_entry("paged_prefill_attention",
                     "dynamo_tpu_torch/csrc/paged_prefill_attention.cu",
                     "dynamo_tpu/ops/pallas/attention.py:405",
                     phases["prefill_kernel_launches"], t_prefill,
                     "bf16: mma.sync m16n8k16 tile of 128 query vectors "
                     "(paged_attention_tc.cuh); f32: the walk"),
    ]})
    emit({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }})
    return 0


if __name__ == "__main__":
    sys.exit(main())
