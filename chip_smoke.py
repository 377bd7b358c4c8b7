"""Chip smoke test of the PyTorch/CUDA port (dynamo_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, one JSON line each; any failure exits non-zero without the final
``ok`` line:

1. build    — compile every CUDA kernel of the port from csrc/ with nvcc.
2. kernel   — the ragged paged-attention kernel against its plain PyTorch
              version at llama3.2-1b shapes (H=32, kvH=8, D=64, bs=16):
              decode-only, prefill-only with a prefix hit, a mixed T=256
              batch (timed beside the plain version, SDPA and the bound),
              a 4-row spec-verify span, idle metadata and padding rows, a
              windowed batch, and a float32 batch.
3. tiny     — a tiny-test TorchEngine in float32 serves 3 concurrent
              greedy requests; streams must equal the port's own
              reference_forward greedy continuation on the card.
4. serve    — the main path at full width: a llama3.2-1b TorchEngine in
              bf16 (random weights from a seed) serves 8 concurrent
              requests through generate(); the kernel must have launched
              num_layers times per unified dispatch.
5. profile  — 8 more requests on the same engine under torch.profiler:
              device time by kernel and the device's busy share of the
              wall (both under the profiler's own overhead).

Then the card's name and power limit, the kernels line, and the last
line ``{"ok": true, "device": {...}}``. Imports nothing of JAX or of the
JAX package. Needs one CUDA device.
"""

from __future__ import annotations

import asyncio
import json
import subprocess
import sys
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12     # H100 SXM HBM3
BF16_FLOPS_PER_S = 989e12     # H100 SXM dense bf16 tensor-core peak
KERNEL_TOL = {torch.bfloat16: 1e-2, torch.float32: 1e-4}
DEVICE = "cuda"


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


# -- phase 1 -----------------------------------------------------------------
def phase_build() -> None:
    from dynamo_tpu_torch.ops.kernels import KERNEL_SOURCES, _build

    t0 = time.monotonic()
    reports = _build.build_all(KERNEL_SOURCES)
    from dynamo_tpu_torch.ops.kernels import ragged_attention

    ragged_attention.build()
    ptxas = [
        line.split("ptxas info    : ")[-1].strip()
        for text in reports.values() for line in text.splitlines()
        if "Compiling entry" in line or "registers" in line or "spill" in line
    ]
    emit({"phase": "build", "kernels": KERNEL_SOURCES,
          "build_s": round(time.monotonic() - t0, 3), "ptxas": ptxas})


# -- phase 2 -----------------------------------------------------------------
H, KVH, D, BS = 32, 8, 64, 16        # llama3.2-1b attention shapes


def make_case(rng, spans, T, dtype, num_blocks=1024, max_blocks=48,
              dims=(H, KVH, D, BS)):
    """Random paged caches and a flat batch for spans [(q_start, q_len)],
    packed from row 0; each span gets its own disjoint blocks."""
    dev = DEVICE
    h, kvh, d, bs = dims
    S = len(spans)
    k = torch.from_numpy(rng.standard_normal((num_blocks * bs, kvh, d))).to(dev, dtype)
    v = torch.from_numpy(rng.standard_normal((num_blocks * bs, kvh, d))).to(dev, dtype)
    ids = rng.permutation(np.arange(1, num_blocks))[: S * max_blocks]
    tables = ids.reshape(S, max_blocks).astype(np.int32)
    q_start = np.array([a for a, _ in spans], np.int32)
    q_len = np.array([b for _, b in spans], np.int32)
    row_start = np.zeros(S, np.int32)
    token_seq = np.zeros(T, np.int32)
    token_pos = np.full(T, -1, np.int32)
    cursor = 0
    for s, (qs, ql) in enumerate(spans):
        row_start[s] = cursor
        token_seq[cursor:cursor + ql] = s
        token_pos[cursor:cursor + ql] = np.arange(qs, qs + ql)
        cursor += ql
    assert cursor <= T
    q = torch.from_numpy(rng.standard_normal((T, h, d))).to(dev, dtype)

    def t(a):
        return torch.from_numpy(a).to(dev)

    return dict(
        q=q, k=k, v=v, tables=t(tables), q_start=t(q_start), q_len=t(q_len),
        kv_len=t(q_start + q_len), row_start=t(row_start),
        token_seq=t(token_seq), token_pos=t(token_pos), spans=spans, bs=bs,
    )


def run_kernel(c, window=0):
    from dynamo_tpu_torch.ops.kernels.ragged_attention import (
        ragged_paged_attention_cuda,
    )

    return ragged_paged_attention_cuda(
        c["q"], c["k"], c["v"], c["tables"], c["q_start"], c["q_len"],
        c["kv_len"], c["row_start"], c["bs"], window=window,
    )


def run_plain(c, window=0):
    from dynamo_tpu_torch.ops.attention import ragged_paged_attention

    return ragged_paged_attention(
        c["q"], c["k"], c["v"], c["tables"], c["token_seq"], c["token_pos"],
        c["bs"], window,
    )


def work_of(c, window=0):
    """(bytes, flops) the function must move and do on these inputs:
    each span's visible K/V read once, q read once, out written once."""
    el = c["q"].element_size()
    T = c["q"].shape[0]
    kv_bytes, flops = 0, 0
    for qs, ql in c["spans"]:
        if ql == 0:
            continue
        first = max(0, qs - window + 1) if window else 0
        kv_bytes += (qs + ql - first) * KVH * D * el * 2
        for pos in range(qs, qs + ql):
            lo = max(0, pos - window + 1) if window else 0
            flops += 4 * (pos + 1 - lo) * H * D
    io = 2 * T * H * D * el + c["tables"].numel() * 4 + 4 * 4 * len(c["spans"])
    return kv_bytes + io, flops


def library_sdpa(c):
    """One scaled_dot_product_attention call over the K/V each row sees,
    gathered dense and masked — a yardstick only (the port never calls
    it). Returns the call; the gather happens once, outside it."""
    import torch.nn.functional as F

    T = c["q"].shape[0]
    tables = c["tables"].long()
    seq = c["token_seq"].long()
    pos = c["token_pos"].long()
    L = int(c["kv_len"].max().item())
    keys = torch.arange(L, device=DEVICE)
    pages = tables[seq][:, keys // BS]                           # [T, L]
    slots = pages * BS + keys % BS
    G = H // KVH
    kd = c["k"][slots].permute(0, 2, 1, 3).repeat_interleave(G, dim=1)  # [T, H, L, D]
    vd = c["v"][slots].permute(0, 2, 1, 3).repeat_interleave(G, dim=1)
    mask = (keys[None, :] <= pos[:, None])[:, None, None, :]     # [T,1,1,L]
    mask = mask | (pos[:, None, None, None] < 0) & (keys == 0)[None, None, None, :]
    qd = c["q"][:, :, None, :]                                   # [T, H, 1, D]

    def call():
        return F.scaled_dot_product_attention(qd, kd, vd, attn_mask=mask)

    return call


def phase_kernel() -> dict:
    rng = np.random.default_rng(0)
    bf16 = torch.bfloat16
    decode = [(c - 1, 1) for c in (64, 130, 257, 300, 411, 512, 600, 1)]
    mixed = [(c - 1, 1) for c in (100, 180, 250, 333, 420, 480, 530, 600)] + [
        (0, 64), (128, 64), (32, 100), (0, 0)
    ]
    main = (H, KVH, D, BS)
    cases = [
        ("decode_only", decode, 16, bf16, 0, main),
        ("prefill_prefix_hit", [(0, 128), (64, 100)], 256, bf16, 0, main),
        ("mixed_T256", mixed, 256, bf16, 0, main),
        ("spec_verify_4rows", [(300, 4), (50, 1), (0, 10), (0, 0)], 16, bf16, 0, main),
        ("windowed_mixed", mixed, 256, bf16, 128, main),
        ("mixed_f32", mixed, 256, torch.float32, 0, main),
    ]
    # The kernel's other supported shapes — head dims 16..256 and block
    # size 4, one per template instantiation — on a shorter mixed batch.
    short = [(99, 1), (179, 1), (0, 64), (32, 100), (0, 0)]
    for dims in [(4, 2, 16, 4), (32, 8, 128, 16), (16, 2, 256, 16)]:
        for dt in (bf16, torch.float32):
            cases.append(("shape_H%d_kvH%d_D%d_bs%d" % dims, short, 256, dt, 0, dims))
    worst = {bf16: 0.0, torch.float32: 0.0}
    timed = {}
    for name, spans, T, dtype, window, dims in cases:
        c = make_case(rng, spans, T, dtype, dims=dims)
        got = run_kernel(c, window)
        want = run_plain(c, window)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        owned = sum(ql for _, ql in spans)
        pad_zero = bool((got[owned:] == 0).all().item()) if owned < T else True
        tol = KERNEL_TOL[dtype]
        ok = err <= tol and pad_zero and bool(torch.isfinite(got.float()).all())
        worst[dtype] = max(worst[dtype], err)
        emit({"phase": "kernel", "case": name, "dtype": str(dtype).split(".")[-1],
              "T": T, "spans": len(spans), "window": window,
              "H_kvH_D_bs": list(dims),
              "max_abs_err": err, "tol": tol, "padding_rows_zero": pad_zero,
              "ok": ok})
        if not ok:
            raise SystemExit(f"kernel case {name} disagrees with the plain version")
        if name == "mixed_T256":
            timed = dict(c=c)
        if name == "decode_only":
            emit({"phase": "kernel_timing", "case": name,
                  "kernel_ms": device_ms(lambda: run_kernel(c, window), 20)})

    c = timed["c"]
    kernel_ms = device_ms(lambda: run_kernel(c), iters=20)
    kernel_host_ms = host_ms(lambda: run_kernel(c), iters=50)
    plain_ms = device_ms(lambda: run_plain(c), iters=2)
    sdpa = library_sdpa(c)
    lib_out = sdpa()[:, :, 0, :]
    want = run_plain(c)
    owned = sum(ql for _, ql in c["spans"])
    lib_err = (lib_out[:owned].float() - want[:owned].float()).abs().max().item()
    library_ms = device_ms(sdpa, iters=5)
    nbytes, flops = work_of(c)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOPS_PER_S * 1e3
    bound_ms = max(t_bytes, t_ops)
    bound_by = "bytes" if t_bytes >= t_ops else "operations"
    timing = {
        "phase": "kernel_timing", "case": "mixed_T256", "kernel_ms": kernel_ms,
        "kernel_host_ms": kernel_host_ms, "plain_ms": plain_ms, "library_ms": library_ms,
        "library_max_abs_err": lib_err, "bound_ms": bound_ms,
        "bound_by": bound_by, "bytes": nbytes, "flops": flops,
        "bound_share": bound_ms / kernel_ms,
    }
    emit(timing)
    timing["max_abs_err"] = worst[bf16]
    return timing


# -- phases 3 and 4 ----------------------------------------------------------
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


async def phase_tiny() -> None:
    from dynamo_tpu_torch.engine.config import EngineConfig
    from dynamo_tpu_torch.engine.engine import TorchEngine
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


async def phase_serve() -> dict:
    from dynamo_tpu_torch.engine.config import EngineConfig
    from dynamo_tpu_torch.engine.engine import TorchEngine
    from dynamo_tpu_torch.llm.protocols.common import FinishReason
    from dynamo_tpu_torch.models import llama
    from dynamo_tpu_torch.models.config import ModelConfig
    from dynamo_tpu_torch.ops.kernels.ragged_attention import (
        ragged_paged_attention_cuda,
    )

    cfg = ModelConfig.llama32_1b()
    ecfg = EngineConfig(
        model=cfg, dtype="bfloat16", block_size=16, num_blocks=1024,
        max_num_seqs=8, max_model_len=1024, prefill_batch=4,
        unified_token_budget=256, unified_prefill_quantum=64, seed=0,
    )
    # Random weights from torch.Generator(seed=ecfg.seed) on the card.
    engine = TorchEngine(ecfg, device=DEVICE)
    await engine.start()
    rng = np.random.default_rng(1)
    lens = rng.integers(64, 513, 8)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist() for n in lens]
    max_tokens = 32
    try:
        ragged_paged_attention_cuda.launches = 0
        streams, finishes, ttft, wall = await serve(engine, prompts, max_tokens)
        launches = ragged_paged_attention_cuda.launches
        dispatches = engine.unified_dispatches
        prefill_tokens = engine.unified_prefill_tokens
        decode_tokens = engine.unified_decode_tokens
        more = [rng.integers(0, cfg.vocab_size, n).tolist() for n in lens]
        profile = await profile_serve(engine, more, max_tokens)
    finally:
        await engine.stop()
    full = all(len(s) == max_tokens for s in streams) and all(
        f is FinishReason.LENGTH for f in finishes
    )
    in_vocab = all(0 <= t < cfg.vocab_size for s in streams for t in s)
    # The served model's logits on one request, recomputed without the
    # cache: finite, [T, V], and how often their argmax matches the stream.
    params = engine.runner.params
    seq = prompts[0] + streams[0]
    logits = llama.reference_forward(
        cfg, params, torch.tensor(seq, device=DEVICE)
    )
    finite = bool(torch.isfinite(logits).all().item())
    shape_ok = tuple(logits.shape) == (len(seq), cfg.vocab_size)
    ref_next = torch.argmax(logits[len(prompts[0]) - 1:-1], dim=-1).tolist()
    agree = sum(a == b for a, b in zip(ref_next, streams[0])) / max_tokens
    total = sum(len(s) for s in streams)
    result = {
        "phase": "serve", "model": cfg.name, "dtype": "bfloat16",
        "requests": len(prompts), "prompt_lens": lens.tolist(),
        "max_tokens": max_tokens, "generated_tokens": total,
        "wall_s": wall, "tokens_per_s": total / wall,
        "ttft_p50_ms": float(np.median(ttft)) * 1e3,
        "ttft_max_ms": max(ttft) * 1e3,
        "unified_dispatches": dispatches,
        "prefill_tokens": prefill_tokens, "decode_tokens": decode_tokens,
        "kernel_launches": launches, "num_layers": cfg.num_layers,
        "streams_full_length": full, "tokens_in_vocab": in_vocab,
        "logits_finite": finite, "logits_shape_ok": shape_ok,
        "greedy_agreement_vs_no_cache_reference": agree,
    }
    emit(result)
    emit(profile)
    if launches != cfg.num_layers * dispatches or dispatches == 0:
        raise SystemExit(
            f"kernel launched {launches} times for {dispatches} dispatches "
            f"x {cfg.num_layers} layers"
        )
    if not (full and in_vocab and finite and shape_ok):
        raise SystemExit("served streams failed their checks")
    return result


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


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader", "-i", "0"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    if not out:
        raise SystemExit("nvidia-smi reported no card")
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False   # f32 references stay f32
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    phase_build()
    timing = phase_kernel()
    asyncio.run(phase_tiny())
    served = asyncio.run(phase_serve())
    print(card, flush=True)
    emit({"kernels": [{
        "name": "ragged_paged_attention",
        "route": "cuda",
        "source": "dynamo_tpu_torch/csrc/ragged_attention.cu",
        "replaces": "dynamo_tpu/ops/pallas/ragged_attention.py:67",
        "launches": served["kernel_launches"],
        "max_abs_err": timing["max_abs_err"],
        "ms": timing["kernel_ms"],
        "plain_ms": timing["plain_ms"],
        "bound_ms": timing["bound_ms"],
        "bound_by": timing["bound_by"],
        "library_ms": timing["library_ms"],
    }]})
    emit({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }})
    return 0


if __name__ == "__main__":
    sys.exit(main())
