"""The split law, the launch plan and the int8 folded-scale law of the
port's ragged kernel (csrc/ragged_attention.cu), held on the CPU with the
plain versions.

The CUDA ragged kernel routes each span on the card by its row count:
spans of at most ``SPLIT_ROWS`` rows (decode lanes, short spec-verify
spans) split their block table into column ranges [s*P, (s+1)*P), each
split the plain attention over those columns with stats, merged by
``merge_stats``; longer spans run unsplit (the tensor-core tile in bf16,
the walk in f32). Here: that routing, emulated with the plain versions
over ``ragged_split_plan``'s splits, equals the unsplit plain call and
the JAX package (the Pallas kernel in interpret mode for caches in q's
dtype; for int8 caches the XLA oracle with scales, since the Pallas int8
branch fails under jax 0.9); the plan covers every column exactly once
for any shapes, fills the card at the serve's shapes and takes host
integers only. The tile's int8 leg (pages converted to bf16 unscaled, the
k scale on the f32 scores, the v scale on P before its two-term bf16
split) is emulated at chip_smoke.py's main mixed case and stays within the
bf16 tolerance of the plain version.

Tolerances: float32 within 1e-5 (the north star's kernel-vs-oracle
bound); bf16 outputs within 1e-2 (chip_smoke.py's)."""

import inspect

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

import jax.numpy as jnp
import torch

from dynamo_tpu.ops import attention as j_attn
from dynamo_tpu.ops.pallas.ragged_attention import ragged_paged_attention_pallas
from dynamo_tpu_torch.ops import attention as t_attn
from dynamo_tpu_torch.ops.kernels import paged_decode_attention as t_dec
from dynamo_tpu_torch.ops.kernels import ragged_attention as t_rag

BS = 16
F32_TOL = 1e-5
BF16_TOL = 1e-2

# (spans [(q_start, q_len)], T, window): decode spans, spec-verify spans of
# 2-4 rows (the split path) and 5+ rows (unsplit), prefill spans, an idle
# span and padding rows.
CASES = {
    "mixed": ([(150, 1), (0, 1), (0, 20), (40, 13), (99, 1), (0, 0)], 48, 0),
    "windowed": ([(150, 1), (0, 30), (60, 10), (120, 3), (0, 0)], 48, 24),
    "spec_verify": ([(140, 4), (0, 3), (33, 1), (90, 2), (0, 10), (70, 5)], 32, 0),
}


def _case(seed, spans, T, H=8, kvH=2, D=128, num_blocks=96, max_blocks=12, int8=False):
    rng = np.random.default_rng(seed)
    shape = (num_blocks * BS, kvH, D)
    if int8:
        k = rng.integers(-127, 128, shape).astype(np.int8)
        v = rng.integers(-127, 128, shape).astype(np.int8)
    else:
        k = rng.standard_normal(shape).astype(np.float32)
        v = rng.standard_normal(shape).astype(np.float32)
    S = len(spans)
    ids = rng.permutation(np.arange(1, num_blocks))[: S * max_blocks]
    tables = ids.reshape(S, max_blocks).astype(np.int32)
    q_start, q_len, row_start = (np.zeros(S, np.int32) for _ in range(3))
    token_seq = np.zeros(T, np.int32)
    token_pos = np.full(T, -1, np.int32)
    cursor = 0
    for s, (qs, ql) in enumerate(spans):
        q_start[s], q_len[s], row_start[s] = qs, ql, cursor
        token_seq[cursor:cursor + ql] = s
        token_pos[cursor:cursor + ql] = np.arange(qs, qs + ql)
        cursor += ql
    assert cursor <= T and max(a + b for a, b in spans) <= max_blocks * BS
    c = dict(q=rng.standard_normal((T, H, D)).astype(np.float32), k=k, v=v,
             tables=tables, q_start=q_start, q_len=q_len, kv_len=q_start + q_len,
             row_start=row_start, token_seq=token_seq, token_pos=token_pos)
    if int8:
        c["ks"] = rng.uniform(0.002, 0.02, (num_blocks, kvH)).astype(np.float32)
        c["vs"] = rng.uniform(0.002, 0.02, (num_blocks, kvH)).astype(np.float32)
    return c


def _torch(c, dtype=torch.float32):
    t = {n: torch.from_numpy(a) for n, a in c.items()}
    t["q"] = t["q"].to(dtype)
    if "ks" not in c:
        t["k"], t["v"] = t["k"].to(dtype), t["v"].to(dtype)
    return t


def _token_call(t, tables, page_offset, window):
    """The plain attention of every row over ``tables`` (per-row columns)
    at ``page_offset``, with stats: float32 (out, m, l)."""
    ctx = torch.clamp(t["token_pos"].long() + 1, min=0)
    return t_attn.paged_decode_attention(
        t["q"], t["k"], t["v"], tables, ctx, BS, window,
        page_offset=page_offset, with_stats=True,
        k_scales=t.get("ks"), v_scales=t.get("vs"),
    )


def _routed(t, window, num_splits, pages):
    """The kernel's routing with the plain versions: rows of spans of at
    most SPLIT_ROWS rows merge the partials of the plan's column splits;
    other rows take the unsplit call; rows no span owns stay zero. Returns
    (routed, merged, unsplit), float32."""
    rows = torch.clamp(t["token_seq"].long(), 0, t["tables"].shape[0] - 1)
    tables = t["tables"][rows]
    unsplit = _token_call(t, tables, 0, window)
    parts = [_token_call(t, tables[:, s * pages:(s + 1) * pages].contiguous(),
                         s * pages, window)
             for s in range(num_splits)]
    merged = t_attn.merge_stats(parts)
    short = (t["q_len"].long()[rows] <= t_rag.SPLIT_ROWS) & (t["token_pos"] >= 0)
    routed = torch.where(short[:, None, None], merged, unsplit[0])
    return routed, merged, unsplit


def _plan(c, window):
    S, max_blocks = c["tables"].shape
    H, kvH = c["q"].shape[1], c["k"].shape[1]
    num_splits, pages = t_rag.ragged_split_plan(
        S, kvH, max_blocks, BS, window, 132, -(-(H // kvH) // t_rag.SPLIT_VECS))
    return num_splits, pages


@pytest.mark.parametrize("name", list(CASES))
@pytest.mark.parametrize("pages", ["plan", 1, 5])
def test_split_law_f32_equals_the_unsplit_call(name, pages):
    spans, T, window = CASES[name]
    c = _case(0, spans, T)
    cols = c["tables"].shape[1]
    num_splits, pages = _plan(c, window) if pages == "plan" else (-(-cols // pages), pages)
    assert num_splits > 1
    routed, merged, (out, m, l) = _routed(_torch(c), window, num_splits, pages)
    np.testing.assert_allclose(merged.numpy(), out.numpy(), rtol=F32_TOL, atol=F32_TOL)
    np.testing.assert_allclose(routed.numpy(), out.numpy(), rtol=F32_TOL, atol=F32_TOL)
    assert not routed[c["token_pos"] < 0].any()                 # unowned rows zero


@pytest.mark.parametrize("name", list(CASES))
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_routed_split_law_matches_the_pallas_kernel(name, dtype):
    """The routed result, cast to q's dtype, against the TPU kernel run in
    interpret mode on the same (bf16-rounded for bf16) inputs."""
    spans, T, window = CASES[name]
    c = _case(1, spans, T)
    tdt, jdt, tol = ((torch.float32, jnp.float32, F32_TOL) if dtype == "f32"
                     else (torch.bfloat16, jnp.bfloat16, BF16_TOL))
    t = _torch(c, tdt)
    routed, _, _ = _routed(t, window, *_plan(c, window))
    want = ragged_paged_attention_pallas(
        *(jnp.asarray(c[n], jdt) for n in ("q", "k", "v")),
        *(jnp.asarray(c[n]) for n in ("tables", "q_start", "q_len", "kv_len",
                                       "row_start")),
        BS, window=window,
    )
    got = routed.to(tdt).float().numpy()
    np.testing.assert_allclose(got, np.asarray(want.astype(jnp.float32)), rtol=tol, atol=tol)


@pytest.mark.parametrize("name", list(CASES))
def test_int8_routed_split_law_matches_the_xla_oracle_with_scales(name):
    spans, T, window = CASES[name]
    c = _case(2, spans, T, int8=True)
    t = _torch(c)
    routed, merged, (out, _, _) = _routed(t, window, *_plan(c, window))
    np.testing.assert_allclose(merged.numpy(), out.numpy(), rtol=F32_TOL, atol=F32_TOL)
    want = np.asarray(j_attn.ragged_paged_attention(
        *(jnp.asarray(c[n]) for n in ("q", "k", "v", "tables", "token_seq", "token_pos")),
        BS, window, k_scales=jnp.asarray(c["ks"]), v_scales=jnp.asarray(c["vs"]),
    ))
    np.testing.assert_allclose(routed.numpy(), want, rtol=F32_TOL, atol=F32_TOL)


# -- the plan ------------------------------------------------------------------
@settings(max_examples=300, deadline=None)
@given(
    spans=st.integers(1, 512), kv_heads=st.sampled_from([1, 2, 4, 8, 16]),
    max_blocks=st.integers(1, 4096), block_size=st.sampled_from([4, 16]),
    window=st.sampled_from([0, 1, 16, 100, 4096]),
    num_sms=st.sampled_from([1, 66, 132]), head_groups=st.integers(1, 4),
)
def test_ragged_plan_covers_every_column_exactly_once(
    spans, kv_heads, max_blocks, block_size, window, num_sms, head_groups,
):
    S, P = t_rag.ragged_split_plan(
        spans, kv_heads, max_blocks, block_size, window, num_sms, head_groups)
    assert 1 <= S <= t_dec.MAX_SPLITS and 1 <= P <= max_blocks
    covered = np.zeros(max_blocks, np.int32)
    for s in range(S):
        covered[s * P:(s + 1) * P] += 1
    assert (covered == 1).all()
    assert (S - 1) * P < max_blocks                           # no split is empty by shape


def test_ragged_plan_fills_the_card_at_the_serve_shapes():
    """12 spans x 8 kv heads with 64-column tables (the full-width serve's
    unified step): 6 splits of 11 pages, 576 split blocks for 132 SMs at
    BLOCKS_PER_SM = 4; many spans need no split."""
    S, P = t_rag.ragged_split_plan(12, 8, 64, 16)
    assert (S, P) == (6, 11)
    assert S * 12 * 8 >= t_rag.BLOCKS_PER_SM * 132 > (S - 1) * 12 * 8
    assert t_rag.ragged_split_plan(200, 8, 64, 16) == (1, 64)


def test_ragged_plan_reads_no_tensor(monkeypatch):
    """The plan's inputs are host integers: nothing that lies on the card
    (q_len never enters it). ``call_split_plan`` plans a call from the
    operands' shapes alone: tensors on the meta device, which hold no
    data, plan as CUDA tensors of the same shapes would."""
    params = inspect.signature(t_rag.ragged_split_plan).parameters
    assert not {"q_len", "q_start", "kv_len", "row_start"} & set(params)
    for p in params.values():
        assert p.annotation in ("int", int), p
    with pytest.raises(TypeError):
        t_rag.ragged_split_plan(torch.tensor(12), 8, 64, 16)
    monkeypatch.setattr(t_rag, "_num_sms", lambda device: 132)
    q = torch.empty(256, 32, 64, device="meta", dtype=torch.bfloat16)
    k = torch.empty(1024 * BS, 8, 64, device="meta", dtype=torch.bfloat16)
    tables = torch.empty(12, 64, device="meta", dtype=torch.int32)
    assert t_rag.call_split_plan(q, k, tables, BS) == (6, 11)


# -- the tile's int8 leg: scales folded into the products ----------------------
def _mixed_t256():
    """chip_smoke.py's main mixed case (ragged_int8_mixed_T256): llama3.2-1b
    attention shapes, 8 decode spans at contexts 1-600, prefill spans of
    64, 64 and 100 rows, an idle span, T = 256."""
    decode = [(n - 1, 1) for n in (64, 130, 257, 300, 411, 512, 600, 1)]
    spans = decode + [(0, 64), (128, 64), (32, 100), (0, 0)]
    c = _case(0, spans, 256, H=32, kvH=8, D=64, num_blocks=640, max_blocks=48,
              int8=True)
    return c, spans


def _folded_tile(t, spans, s):
    """Span s's output as the tile computes it with an int8 cache: bf16 q
    times int8 keys converted to bf16 unscaled (exact), f32 sums; the k
    scale on each key's f32 score; the v scale on P before P's split into
    two bf16 terms (value and rounded remainder), each term times the
    unscaled int8 values; f32 sums. bf16 [q_len, H, D]."""
    qs, ql = spans[s]
    kv = qs + ql
    H, D = t["q"].shape[1:]
    kvH = t["k"].shape[1]
    G = H // kvH
    pos = torch.arange(kv)
    pages = t["tables"][s].long()[pos // BS]
    slots = pages * BS + pos % BS
    kint = t["k"][slots].float()                                  # [L, kvH, D]
    vint = t["v"][slots].float()
    ksc, vsc = t["ks"][pages], t["vs"][pages]                     # [L, kvH]
    r0 = int(t["row_start"][s])
    q = t["q"][r0:r0 + ql].float().reshape(ql, kvH, G, D)
    sc = torch.einsum("tkgd,lkd->tkgl", q, kint) * ksc.T[None, :, None, :]
    rows = qs + torch.arange(ql)
    mask = (pos[None, :] <= rows[:, None])[:, None, None, :]
    sc = torch.where(mask, sc * D**-0.5, torch.tensor(-1e30))
    p = torch.where(mask, torch.exp(sc - sc.amax(-1, keepdim=True)), torch.tensor(0.0))
    l = p.sum(-1, keepdim=True)
    pv = p * vsc.T[None, :, None, :]
    hi = pv.to(torch.bfloat16).float()
    lo = (pv - hi).to(torch.bfloat16).float()
    o = torch.einsum("tkgl,lkd->tkgd", hi, vint) + torch.einsum("tkgl,lkd->tkgd", lo, vint)
    return (o / l).reshape(ql, H, D).to(torch.bfloat16)


def test_int8_folded_scales_stay_within_the_bf16_tolerance():
    c, spans = _mixed_t256()
    t = _torch(c, torch.bfloat16)
    plain = t_attn.ragged_paged_attention(
        t["q"], t["k"], t["v"], t["tables"], t["token_seq"], t["token_pos"], BS,
        k_scales=t["ks"], v_scales=t["vs"],
    )
    worst = 0.0
    for s, (_, ql) in enumerate(spans):
        if ql <= t_rag.SPLIT_ROWS:
            continue                                              # the split path's spans
        r0 = int(t["row_start"][s])
        got = _folded_tile(t, spans, s).float()
        worst = max(worst, (got - plain[r0:r0 + ql].float()).abs().max().item())
    assert worst <= BF16_TOL, worst
