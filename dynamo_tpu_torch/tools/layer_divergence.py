"""Where a cached serve parts from the no-cache reference, and how far
the reference parts from itself.

    cd <checkout> && python3 <this file> [--preset deepseek-v2-lite]
        [--dtype bfloat16] [--layers N] [--prompts 8] [--tokens 32]
        [--chunk 64] [--dispatch dense] [--device cuda] [--seed 2]
        [--attention kernel,plain] [--float32-products]

Random weights from ``--seed`` (2: ``chip_smoke.py`` phase 13's bf16
weights; 1: its witnesses') and prompts of 256–1024 random tokens from
seed 15 (phase 13's prompts). Prints
one JSON line per measurement:

- ``divergence``, once with the ragged kernel and once with its plain
  version on the same device: the last prompt through the stack in
  chunks of ``--chunk`` rows over a paged cache (the serve's chunked
  prefill) and, in one piece, through the no-cache trunk. Per layer, the
  median and largest relative error |x_cached - x_ref| / |x_ref| of the
  residual after attention and after the MLP, and for a MoE layer the
  share of positions whose top-k expert set differs.
- ``noise_floor``: the no-cache reference over each prompt and its
  greedy stream, once as it is and once with 256 rows appended (causal,
  and drop-free experts per row, so the appended rows change no earlier
  row's value, only every product's shape): its argmax agreement with
  itself at the stream's positions and the largest log-probability gap
  where it disagrees.
- ``greedy``, with the kernel and with the plain version: the prompts
  served greedily through the stack (chunked prefill, then one row per
  prompt a step), each stream held to the no-cache reference as
  ``chip_smoke.py``'s phase 8 gates hold a serve: argmax agreement and
  the largest gap at a disagreement.

``--float32-products`` measures a variant of the model's numerics: every
product with a float32 output (bf16 operands, float32 sums), attention
fed bf16 q, K and V on both sides, and the router fed the float32 normed
residual. The plain version and the variant run here only as witnesses;
the port's entry points launch the kernel on the card and keep the
model's own numerics.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.getcwd())   # the checkout's own package

import numpy as np  # noqa: E402
import torch  # noqa: E402

PAD = 256     # rows appended for the noise floor
VARIANT = {"float32_router": False}


class Paged:
    """One paged cache per layer for ``lens`` sequences: sequence ``i``
    owns a run of blocks after trash block 0."""

    def __init__(self, cfg, lens, bs: int, dtype, device):
        self.bs, self.device = bs, device
        per = [-(-n // bs) for n in lens]
        first = np.concatenate([[1], 1 + np.cumsum(per)[:-1]])
        width = max(per)
        self.tables = [np.arange(f, f + n) for f, n in zip(first, per)]
        shape = ((1 + sum(per)) * bs, cfg.num_cache_heads, cfg.kv_cache_head_dim)
        self.caches = [(torch.zeros(shape, dtype=dtype, device=device),
                        torch.zeros(shape, dtype=dtype, device=device))
                       for _ in range(cfg.num_layers)]
        self.table = torch.zeros((len(lens), width), dtype=torch.int32, device=device)
        for i, t in enumerate(self.tables):
            self.table[i, :len(t)] = torch.tensor(t, dtype=torch.int32)

    def attend(self, cfg, spans, plain: bool):
        """``attend(li, q, k, v)`` for one batch of ``spans``, each
        ``(seq, start, rows)``: writes the layer's cache at the spans'
        slots, then the ragged kernel (or its plain version)."""
        from dynamo_tpu_torch.models import llama
        from dynamo_tpu_torch.ops.attention import ragged_attention, ragged_paged_attention

        bs = self.bs
        seq = np.concatenate([[s] * n for s, _, n in spans])
        pos = np.concatenate([np.arange(a, a + n) for _, a, n in spans])
        slots = np.array([self.tables[s][p // bs] * bs + p % bs for s, p in zip(seq, pos)])

        def t(arr):
            return torch.tensor(np.asarray(arr), dtype=torch.int32, device=self.device)

        table = self.table[[s for s, _, _ in spans]]
        token_seq, token_pos = t(np.repeat(np.arange(len(spans)), [n for *_, n in spans])), t(pos)
        q_start, q_len = t([a for _, a, _ in spans]), t([n for *_, n in spans])
        kv_len = q_start + q_len
        row_start = t(np.concatenate([[0], np.cumsum([n for *_, n in spans])[:-1]]))
        slot_t = t(slots).long()

        def attend(li, q, k, v):
            llama._write_kv(self.caches[li], slot_t, k, v)
            kc, vc = self.caches[li]
            q = q.to(kc.dtype) if kc.dtype == torch.bfloat16 else q
            if plain:
                return ragged_paged_attention(q, kc, vc, table, token_seq, token_pos, bs,
                                              cfg.layer_window(li))
            return ragged_attention(q, kc, vc, table, token_seq, token_pos, q_start, q_len,
                                    kv_len, row_start, bs, window=cfg.layer_window(li))

        return attend, t(pos)


def float32_products() -> None:
    """Patch this process's model module to the ``--float32-products``
    variant (see the module docstring)."""
    from dynamo_tpu_torch.models import llama, moe
    from dynamo_tpu_torch.ops.quant import head_mm

    full, router = llama.full_causal_attention, moe.moe_router
    normed: dict = {}

    def qeinsum(pattern, x, w):
        return torch.einsum(pattern, x.to(w.dtype).float(), w.float())

    def full_bf16(q, k, v, window=0):
        dt = torch.bfloat16
        return full(q.to(dt), k.to(dt), v.to(dt), window)

    def residual_mlp_f32(x, layer, cfg):
        normed["x"] = llama._ln(x, layer["ln_mlp"], cfg)
        try:
            return x + llama._mlp(layer, normed["x"].to(layer["w_up"].dtype), cfg)
        finally:
            normed.clear()

    def router_f32(params, x, cfg):
        hf = normed.get("x")
        return router(params, hf if hf is not None and hf.shape[0] == x.shape[0] else x, cfg)

    llama.qdot, llama.qeinsum, llama.full_causal_attention = head_mm, qeinsum, full_bf16
    llama._residual_mlp, moe.moe_router = residual_mlp_f32, router_f32
    VARIANT["float32_router"] = True


def run_batch(cfg, params, paged, spans, ids, plain: bool, hook=None) -> torch.Tensor:
    """The stack over one batch of spans; the residual after the last
    layer [rows, D]."""
    from dynamo_tpu_torch.models import llama

    attend, pos = paged.attend(cfg, spans, plain)
    ids = torch.tensor(ids, dtype=torch.int32, device=paged.device)
    return llama._layers(cfg, params, ids, pos, attend, hook)


def tracer(cfg, params):
    """(hook, xs_attn, xs_out, tops): the residual after each layer's
    attention and MLP and, per MoE layer, each row's sorted top-k."""
    from dynamo_tpu_torch.models import llama, moe

    xa, xo, tops = [], [], []
    mcfg = llama.moe_config(cfg) if cfg.is_moe else None

    def hook(li, x_attn, x_out):
        xa.append(x_attn.float())
        xo.append(x_out.float())
        layer = params["layers"][li]
        if "w_router" in layer:
            h = llama._ln(x_attn, layer["ln_mlp"], cfg)
            if not VARIANT["float32_router"]:
                h = h.to(layer["w_up"].dtype)
            _, idx = moe._top_k(moe.moe_router(layer, h, mcfg), mcfg.num_experts_per_tok)
            tops.append(idx.sort(-1).values)

    return hook, xa, xo, tops


def divergence(cfg, params, toks, chunk: int, bs: int, device, plain: bool) -> list:
    """Per layer: [layer, after-attention median, max, after-MLP median,
    max(, routing flip share)] of the chunked cached prefill against the
    no-cache trunk."""
    from dynamo_tpu_torch.models import llama

    hook, ra, ro, rt = tracer(cfg, params)
    ids = torch.tensor(toks, device=device)
    llama._layers(cfg, params, ids, torch.arange(len(toks), device=device),
                  lambda li, q, k, v: llama.full_causal_attention(
                      q, k, v, cfg.layer_window(li)),
                  hook)
    paged = Paged(cfg, [len(toks)], bs, params["embed"].dtype, device)
    parts = []
    for a in range(0, len(toks), chunk):
        n = min(chunk, len(toks) - a)
        h = tracer(cfg, params)
        run_batch(cfg, params, paged, [(0, a, n)], toks[a:a + n], plain, h[0])
        parts.append(h[1:])
    ca, co, ct = ([torch.cat([p[j][i] for p in parts]) for i in range(len(parts[0][j]))]
                  for j in range(3))

    def rel(x, ref):
        err = (x - ref).norm(dim=-1) / ref.norm(dim=-1)
        return [float(err.median()), float(err.max())]

    rows, mi = [], 0
    for li in range(cfg.num_layers):
        row = [li, *rel(ca[li], ra[li]), *rel(co[li], ro[li])]
        if cfg.moe_layer(li):
            row.append(float((ct[mi] != rt[mi]).any(-1).float().mean()))
            mi += 1
        rows.append(row)
    return rows


def greedy(cfg, params, prompts, tokens: int, chunk: int, bs: int, device,
           plain: bool) -> list[list[int]]:
    """Greedy streams: each prompt prefilled in chunks, then one row per
    prompt a step."""
    from dynamo_tpu_torch.models import llama

    paged = Paged(cfg, [len(p) + tokens for p in prompts], bs, params["embed"].dtype, device)
    last = []
    for s, p in enumerate(prompts):
        for a in range(0, len(p), chunk):
            n = min(chunk, len(p) - a)
            x = run_batch(cfg, params, paged, [(s, a, n)], p[a:a + n], plain)
        last.append(x[-1])
    streams = [[] for _ in prompts]
    for step in range(tokens):
        nxt = llama._logits(params, cfg, torch.stack(last)).argmax(-1).tolist()
        for s, t in zip(streams, nxt):
            s.append(t)
        if step + 1 == tokens:
            break
        spans = [(i, len(p) + step, 1) for i, p in enumerate(prompts)]
        last = list(run_batch(cfg, params, paged, spans, nxt, plain))
    return streams


def reference_logprobs(cfg, params, prompt, stream, pad: int = 0) -> torch.Tensor:
    """The no-cache reference's log-probabilities at the stream's
    positions, optionally with ``pad`` of the sequence's rows appended."""
    from dynamo_tpu_torch.models import llama

    seq = torch.tensor(prompt + stream, device=params["embed"].device)
    if pad:
        seq = torch.cat([seq, seq[:pad]])
    logits = llama.reference_forward(cfg, params, seq)
    return torch.log_softmax(logits[len(prompt) - 1:len(prompt) + len(stream) - 1].float(), -1)


def agreement(cfg, params, prompts, streams) -> dict:
    """Each stream held to the no-cache reference: argmax agreement and
    the largest gap where the stream's token is not the argmax."""
    hits, n, gaps = 0, 0, []
    for p, s in zip(prompts, streams):
        lp = reference_logprobs(cfg, params, p, s)
        want = torch.tensor(s, device=lp.device)
        best, arg = lp.max(-1)
        hit = arg == want
        hits += int(hit.sum())
        n += len(s)
        gaps += (best - lp.gather(1, want[:, None])[:, 0])[~hit].tolist()
    return {"agreement": hits / max(n, 1), "max_gap": max(gaps, default=0.0)}


def noise_floor(cfg, params, prompts, streams, pad: int = PAD) -> dict:
    """The reference against itself with ``pad`` rows appended."""
    hits, n, gaps = 0, 0, []
    for p, s in zip(prompts, streams):
        a = reference_logprobs(cfg, params, p, s)
        b = reference_logprobs(cfg, params, p, s, pad)
        arg_a = a.argmax(-1)
        hit = arg_a == b.argmax(-1)
        hits += int(hit.sum())
        n += len(s)
        gaps += (b.max(-1).values - b.gather(1, arg_a[:, None])[:, 0])[~hit].tolist()
    return {"self_agreement": hits / max(n, 1), "self_max_gap": max(gaps, default=0.0),
            "pad": pad}


def main() -> int:
    from dynamo_tpu_torch.models import llama
    from dynamo_tpu_torch.models.config import PRESETS

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--preset", default="deepseek-v2-lite")
    ap.add_argument("--dtype", default="bfloat16")
    ap.add_argument("--layers", type=int, default=0, help="0 = the preset's depth")
    ap.add_argument("--prompts", type=int, default=8)
    ap.add_argument("--tokens", type=int, default=32)
    ap.add_argument("--chunk", type=int, default=64)
    ap.add_argument("--block-size", type=int, default=16)
    ap.add_argument("--dispatch", default="dense")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=2)
    ap.add_argument("--float32-products", action="store_true")
    ap.add_argument("--attention", default="kernel,plain",
                    help="comma-separated: kernel, plain")
    args = ap.parse_args()
    if args.float32_products:
        float32_products()
    cfg = PRESETS[args.preset]()
    cfg = cfg.scaled(num_layers=args.layers or cfg.num_layers, moe_dispatch=args.dispatch)
    if args.device == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False   # float32 stays float32
    g = torch.Generator(device=args.device)
    g.manual_seed(args.seed)
    params = llama.init_params(cfg, g, dtype=getattr(torch, args.dtype), device=args.device)
    rng = np.random.default_rng(15)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist()
               for n in rng.integers(256, 1025, 8)][:args.prompts]
    head = {"preset": args.preset, "dtype": args.dtype, "layers": cfg.num_layers,
            "seed": args.seed, "dispatch": args.dispatch,
            "float32_products": args.float32_products,
            "device": torch.cuda.get_device_name(0) if args.device == "cuda" else "cpu"}
    streams = {}
    with torch.no_grad():
        for attention in args.attention.split(","):
            plain = attention == "plain"
            rows = divergence(cfg, params, prompts[-1], args.chunk, args.block_size,
                              args.device, plain)
            print(json.dumps({**head, "measure": "divergence", "attention": attention,
                              "prompt_tokens": len(prompts[-1]), "chunk": args.chunk,
                              "per_layer [layer, after attention median, max, after MLP "
                              "median, max, routing flip share]":
                                  [[r[0]] + [round(x, 6) for x in r[1:]] for r in rows]}),
                  flush=True)
            streams[attention] = greedy(cfg, params, prompts, args.tokens, args.chunk,
                                        args.block_size, args.device, plain)
            print(json.dumps({**head, "measure": "greedy", "attention": attention,
                              "prompts": len(prompts), "tokens": args.tokens,
                              **agreement(cfg, params, prompts, streams[attention])}),
                  flush=True)
        first = next(iter(streams.values()))
        print(json.dumps({**head, "measure": "noise_floor",
                          "streams_equal": len({str(s) for s in streams.values()}) == 1,
                          **noise_floor(cfg, params, prompts, first)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
