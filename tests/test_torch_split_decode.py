"""The split law of the port's decode kernel (csrc/paged_decode_attention.cu),
held on the CPU with the plain versions.

The CUDA decode kernel splits each lane's block table into column ranges
[s*P, (s+1)*P); split s is the plain ``paged_decode_attention`` over
those columns with ``page_offset + s*P*page_stride`` and stats, and a
merge kernel combines the splits by ``merge_stats``. Here: merging the
plain partials over ``decode_split_plan``'s splits (and over other split
widths) equals the plain unsplit call and the JAX package's Pallas decode
kernel in interpret mode, for tests/test_torch_paged_attention.py's head
shapes, windows and striped shards; the plan covers every column exactly
once for any shapes (hypothesis), and takes plain integers only.

Tolerances: float32 within 1e-5 (the north star's kernel-vs-oracle
bound)."""

import inspect

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

import jax.numpy as jnp
import torch

from dynamo_tpu.ops.pallas import paged_decode_attention_pallas
from dynamo_tpu_torch.ops import attention as t_attn
from dynamo_tpu_torch.ops.kernels import paged_decode_attention as t_dec

BS = 16
F32_TOL = 1e-5
SP = 4


def _case(H, kvH, D, seed=0):
    rng = np.random.default_rng(seed)
    B, max_blocks, num_blocks = 5, 16, 128
    q = rng.standard_normal((B, H, D)).astype(np.float32)
    shape = (num_blocks * BS, kvH, D)
    k = rng.standard_normal(shape).astype(np.float32)
    v = rng.standard_normal(shape).astype(np.float32)
    ids = rng.permutation(np.arange(1, num_blocks))[: B * max_blocks]
    tables = ids.reshape(B, max_blocks).astype(np.int32)
    ctx = np.asarray([256, 190, 77, 1, 0], np.int32)   # full, mid-page, short, 1, idle
    return q, k, v, tables, ctx


def _split_merge(q, k, v, tables, ctx, pages, window=0, off=0, stride=1):
    """The plain partials of splits of ``pages`` columns, merged: (out,
    m, l) as the merge kernel writes them with stats."""
    parts = []
    for c0 in range(0, tables.shape[1], pages):
        parts.append(t_attn.paged_decode_attention(
            q, k, v, tables[:, c0:c0 + pages].contiguous(), ctx, BS, window,
            page_offset=torch.tensor([off + c0 * stride], dtype=torch.int32),
            page_stride=stride, with_stats=True,
        ))
    m = torch.stack([p[1] for p in parts]).amax(dim=0)
    l = sum(torch.exp(p[1] - m) * p[2] for p in parts)
    return t_attn.merge_stats(parts), m, l


def _plan_pages(B, kvH, max_blocks, window=0, stride=1):
    S, P = t_dec.decode_split_plan(B, kvH, max_blocks, BS, window, stride)
    assert S > 1 and S * P >= max_blocks
    return P


@pytest.mark.parametrize("H,kvH,D", [(8, 8, 64), (8, 2, 64), (4, 1, 128)])
@pytest.mark.parametrize("window", [0, 10, 40])
@pytest.mark.parametrize("pages", ["plan", 1, 3])
def test_split_partials_merge_to_the_unsplit_call_and_pallas(H, kvH, D, window, pages):
    q, k, v, tables, ctx = _case(H, kvH, D)
    if pages == "plan":
        pages = _plan_pages(q.shape[0], kvH, tables.shape[1], window)
    tq, tk, tv, tt, tc = (torch.from_numpy(a) for a in (q, k, v, tables, ctx))
    out, m, l = _split_merge(tq, tk, tv, tt, tc, pages, window)
    want = t_attn.paged_decode_attention(tq, tk, tv, tt, tc, BS, window, with_stats=True)
    for got, w in zip((out, m, l), want):
        np.testing.assert_allclose(got.numpy(), w.numpy(), rtol=F32_TOL, atol=F32_TOL)
    jax_out = paged_decode_attention_pallas(
        *(jnp.asarray(a) for a in (q, k, v, tables, ctx)), BS, window=window)
    np.testing.assert_allclose(out.numpy(), np.asarray(jax_out), rtol=F32_TOL, atol=F32_TOL)
    assert not out[-1].any() and not l[-1].any()              # idle lane


def _striped_case():
    rng = np.random.default_rng(5)
    B, H, kvH, D, max_blocks, num_blocks = 6, 8, 2, 64, 24, 256
    q = rng.standard_normal((B, H, D)).astype(np.float32)
    shape = (num_blocks * BS, kvH, D)
    k = rng.standard_normal(shape).astype(np.float32)
    v = rng.standard_normal(shape).astype(np.float32)
    local = num_blocks // SP
    pools = [list(rng.permutation(np.arange(r * local + 1, (r + 1) * local)))
             for r in range(SP)]
    tables = np.zeros((B, max_blocks), np.int32)
    for b in range(B):
        for i in range(max_blocks):
            tables[b, i] = pools[i % SP].pop()
    ctx = np.asarray([384, 190, 77, 40, 1, 0], np.int32)
    return q, k, v, tables, ctx, local


@pytest.mark.parametrize("window", [0, 40])
@pytest.mark.parametrize("pages", [1, 2])
def test_striped_shards_split_merge_to_each_shard_and_the_unstriped_call(window, pages):
    """Each shard's split partials (page_offset = shard + s*P*SP) merge
    to the shard's unsplit call with stats; the shards, merged, equal
    the unstriped call and the Pallas kernel."""
    q, k, v, tables, ctx, local = _striped_case()
    tq, tk, tv, tt, tc = (torch.from_numpy(a) for a in (q, k, v, tables, ctx))
    shards = []
    for r in range(SP):
        lt = t_attn.stripe_tables(tt, r, SP, local)
        sl = slice(r * local * BS, (r + 1) * local * BS)
        got = _split_merge(tq, tk[sl], tv[sl], lt, tc, pages, window, off=r, stride=SP)
        want = t_attn.paged_decode_attention(
            tq, tk[sl], tv[sl], lt, tc, BS, window,
            page_offset=torch.tensor([r], dtype=torch.int32), page_stride=SP,
            with_stats=True)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=F32_TOL, atol=F32_TOL)
        shards.append(got)
    merged = t_attn.merge_stats(shards)
    whole = t_attn.paged_decode_attention(tq, tk, tv, tt, tc, BS, window)
    np.testing.assert_allclose(merged.numpy(), whole.numpy(), rtol=F32_TOL, atol=F32_TOL)
    jax_out = paged_decode_attention_pallas(
        *(jnp.asarray(a) for a in (q, k, v, tables, ctx)), BS, window=window)
    np.testing.assert_allclose(merged.numpy(), np.asarray(jax_out), rtol=F32_TOL, atol=F32_TOL)


@settings(max_examples=300, deadline=None)
@given(
    batch=st.integers(1, 512), kv_heads=st.sampled_from([1, 2, 4, 8, 16]),
    max_blocks=st.integers(1, 4096), block_size=st.sampled_from([4, 16]),
    window=st.sampled_from([0, 1, 16, 100, 4096]), stride=st.integers(1, 8),
    num_sms=st.sampled_from([1, 66, 132]), head_groups=st.integers(1, 4),
)
def test_plan_covers_every_column_exactly_once(
    batch, kv_heads, max_blocks, block_size, window, stride, num_sms, head_groups,
):
    S, P = t_dec.decode_split_plan(
        batch, kv_heads, max_blocks, block_size, window, stride, num_sms, head_groups)
    assert 1 <= S <= t_dec.MAX_SPLITS and 1 <= P <= max_blocks
    covered = np.zeros(max_blocks, np.int32)
    for s in range(S):
        covered[s * P:(s + 1) * P] += 1
    assert (covered == 1).all()
    assert (S - 1) * P < max_blocks                           # no split is empty by shape


def test_plan_fills_the_card_at_the_phase_split_shapes():
    """4 lanes x 8 kv heads with 64-column tables (the full-width phase
    split): 8 splits of 8 pages, 256 blocks for 132 SMs."""
    assert t_dec.decode_split_plan(4, 8, 64, 16) == (8, 8)
    assert t_dec.decode_split_plan(40, 8, 24, 16)[0] == 1      # enough lanes: no split


def test_plan_reads_no_tensor():
    """The plan's inputs are host integers: nothing that lies on the card
    (context_lens never enters it)."""
    params = inspect.signature(t_dec.decode_split_plan).parameters
    assert "context_lens" not in params
    for p in params.values():
        assert p.annotation in ("int", int), p
    with pytest.raises(TypeError):
        t_dec.decode_split_plan(torch.tensor(4), 8, 64, 16)
