"""The port's plain decode and prefill attention (the plain versions of
the CUDA kernels csrc/paged_decode_attention.cu and
csrc/paged_prefill_attention.cu) against the JAX package's Pallas kernels
``paged_decode_attention_pallas`` / ``paged_prefill_attention_pallas``,
run directly in interpret mode on the CPU, on tests/test_pallas.py's
shapes: idle lanes, prefix hits, windows, padded prefill rows, and the
striped kv_sp scan (page_stride 4 at every page_offset, with_stats) whose
four shards, merged, equal the unstriped call and JAX's own kv_sp path
over a 4-device mesh. Also the wrappers on the CPU, which the model
calls directly.

Tolerances: float32 within 1e-5 of JAX (the north star's kernel-vs-oracle
bound); bf16 within 1e-2."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from dynamo_tpu.ops.attention import AttnDispatch
from dynamo_tpu.ops.pallas import (
    paged_decode_attention_pallas,
    paged_prefill_attention_pallas,
)
from dynamo_tpu_torch.ops import attention as t_attn
from dynamo_tpu_torch.ops.kernels import paged_decode_attention as t_dec
from dynamo_tpu_torch.ops.kernels import paged_prefill_attention as t_pre
from dynamo_tpu_torch.ops.kernels._checks import MAX_GRID_YZ

BS = 16
F32_TOL = 1e-5
BF16_TOL = 1e-2
SP = 4


def _caches(rng, num_blocks, kvH, D):
    shape = (num_blocks * BS, kvH, D)
    return (rng.standard_normal(shape).astype(np.float32),
            rng.standard_normal(shape).astype(np.float32))


def _tables(rng, B, max_blocks, num_blocks):
    """Disjoint block tables (block 0 is the trash block, never used)."""
    ids = rng.permutation(np.arange(1, num_blocks))[: B * max_blocks]
    return ids.reshape(B, max_blocks).astype(np.int32)


def _striped_tables(rng, B, max_blocks, num_blocks, sp=SP):
    """Block tables under the striped allocator: logical page i of a lane
    lives on shard i % sp, whose blocks are [r*nb/sp, (r+1)*nb/sp)."""
    local = num_blocks // sp
    pools = [list(rng.permutation(np.arange(r * local + 1, (r + 1) * local)))
             for r in range(sp)]
    tables = np.zeros((B, max_blocks), np.int32)
    for b in range(B):
        for i in range(max_blocks):
            tables[b, i] = pools[i % sp].pop()
    return tables


def _t(*arrays):
    return [torch.from_numpy(np.asarray(a)) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


# -- decode ------------------------------------------------------------------
@pytest.mark.parametrize("H,kvH,D", [(8, 8, 64), (8, 2, 64), (4, 1, 128)])
@pytest.mark.parametrize("window", [0, 10])
def test_decode_matches_pallas_kernel(H, kvH, D, window):
    rng = np.random.default_rng(0)
    B, max_blocks, num_blocks = 5, 4, 64
    q = rng.standard_normal((B, H, D)).astype(np.float32)
    k, v = _caches(rng, num_blocks, kvH, D)
    tables = _tables(rng, B, max_blocks, num_blocks)
    ctx = np.asarray([64, 37, 1, 16, 0], np.int32)   # full, partial, 1, idle
    want = paged_decode_attention_pallas(*_j(q, k, v, tables, ctx), BS, window=window)
    got = t_attn.paged_decode_attention(*_t(q, k, v, tables, ctx), BS, window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=F32_TOL, atol=F32_TOL)
    assert not got[-1].any()                                  # idle lane


def test_decode_bf16_matches_pallas_kernel():
    rng = np.random.default_rng(1)
    B, H, kvH, D = 3, 8, 4, 64
    q = rng.standard_normal((B, H, D)).astype(np.float32)
    k, v = _caches(rng, 32, kvH, D)
    tables = _tables(rng, B, 3, 32)
    ctx = np.asarray([48, 20, 5], np.int32)
    jq, jk, jv = (a.astype(jnp.bfloat16) for a in _j(q, k, v))
    want = paged_decode_attention_pallas(jq, jk, jv, *_j(tables, ctx), BS)
    tq, tk, tv = (a.bfloat16() for a in _t(q, k, v))
    got = t_attn.paged_decode_attention(tq, tk, tv, *_t(tables, ctx), BS)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
                               rtol=BF16_TOL, atol=BF16_TOL)


def _striped_decode_case():
    rng = np.random.default_rng(5)
    B, H, kvH, D, max_blocks, num_blocks = 6, 8, 2, 64, 12, 128
    q = rng.standard_normal((B, H, D)).astype(np.float32)
    k, v = _caches(rng, num_blocks, kvH, D)
    tables = _striped_tables(rng, B, max_blocks, num_blocks)
    # Long, mid-page, one page, shorter than the stripe, one token, idle.
    ctx = np.asarray([190, 77, 16, 40, 1, 0], np.int32)
    return q, k, v, tables, ctx, num_blocks // SP


@pytest.mark.parametrize("shard", range(SP))
@pytest.mark.parametrize("window", [0, 40])
def test_striped_decode_with_stats_matches_pallas_kernel(shard, window):
    """Shard ``shard``'s call over its LOCAL cache and compacted stripe:
    out (float32), m and l all match the Pallas kernel's."""
    q, k, v, tables, ctx, local = _striped_decode_case()
    lt = t_attn.stripe_tables(torch.from_numpy(tables), shard, SP, local).numpy()
    sl = slice(shard * local * BS, (shard + 1) * local * BS)
    off = np.asarray([shard], np.int32)
    want = paged_decode_attention_pallas(
        *_j(q, k[sl], v[sl], lt, ctx), BS, window=window,
        page_offset=jnp.asarray(off), page_stride=SP, with_stats=True,
    )
    got = t_attn.paged_decode_attention(
        *_t(q, k[sl], v[sl], lt, ctx), BS, window,
        page_offset=torch.from_numpy(off), page_stride=SP, with_stats=True,
    )
    assert got[0].dtype == torch.float32
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=F32_TOL, atol=F32_TOL)
    assert (got[1][-1] == t_attn.NEG_INF).all() and not got[2][-1].any()


def _shards_merged(call, tables, k, v, local):
    parts = []
    for r in range(SP):
        lt = t_attn.stripe_tables(tables, r, SP, local)
        sl = slice(r * local * BS, (r + 1) * local * BS)
        parts.append(call(k[sl], v[sl], lt, torch.tensor([r], dtype=torch.int32)))
    return t_attn.merge_stats(parts)


@pytest.mark.parametrize("window", [0, 40])
def test_striped_decode_shards_merge_to_the_unstriped_call(window):
    q, k, v, tables, ctx, local = _striped_decode_case()
    tq, tk, tv, tt, tc = _t(q, k, v, tables, ctx)
    merged = _shards_merged(
        lambda kk, vv, lt, off: t_attn.paged_decode_attention(
            tq, kk, vv, lt, tc, BS, window, page_offset=off, page_stride=SP,
            with_stats=True),
        tt, tk, tv, local,
    )
    whole = t_attn.paged_decode_attention(tq, tk, tv, tt, tc, BS, window)
    np.testing.assert_allclose(merged.numpy(), whole.numpy(), rtol=F32_TOL, atol=F32_TOL)


def _sp_mesh():
    from jax.sharding import Mesh

    return Mesh(np.asarray(jax.devices()[:SP]), ("sp",))


def test_striped_decode_merge_matches_jax_kv_sp_dispatch():
    """The emulated shards, merged, against the reference's own kv_sp
    decode: Pallas kernels per shard of a 4-device mesh, psum merge."""
    q, k, v, tables, ctx, local = _striped_decode_case()
    want = AttnDispatch(use_pallas=True, mesh=_sp_mesh(), kv_sp=True).decode(
        *_j(q, k, v, tables, ctx), BS)
    tq, tk, tv, tt, tc = _t(q, k, v, tables, ctx)
    got = _shards_merged(
        lambda kk, vv, lt, off: t_attn.paged_decode_attention(
            tq, kk, vv, lt, tc, BS, page_offset=off, page_stride=SP,
            with_stats=True),
        tt, tk, tv, local,
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=F32_TOL, atol=F32_TOL)


# -- prefill -----------------------------------------------------------------
def _prefill_case(H, kvH, D, seed=2):
    rng = np.random.default_rng(seed)
    N, T, max_blocks, num_blocks = 4, 24, 4, 64
    q = rng.standard_normal((N, T, H, D)).astype(np.float32)
    k, v = _caches(rng, num_blocks, kvH, D)
    tables = _tables(rng, N, max_blocks, num_blocks)
    q_start = np.asarray([0, 16, 0, 0], np.int32)    # lane 1: prefix hit
    total = np.asarray([24, 40, 10, 0], np.int32)    # lane 2 padded, 3 idle
    return q, k, v, tables, q_start, total


@pytest.mark.parametrize("H,kvH,D", [(8, 8, 64), (8, 2, 64), (4, 1, 128)])
@pytest.mark.parametrize("q_tile", [8, 128])
def test_prefill_matches_pallas_kernel_every_row(H, kvH, D, q_tile):
    """Every row, padded rows included: a padded row attends to all of
    its lane's keys in both, and the idle lane is zeros."""
    q, k, v, tables, q_start, total = _prefill_case(H, kvH, D)
    want = paged_prefill_attention_pallas(
        *_j(q, k, v, tables, q_start, total), BS, q_tile=q_tile)
    got = t_attn.paged_prefill_attention(
        *_t(q, k, v, tables, q_start, total), BS, q_tile=q_tile)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=F32_TOL, atol=F32_TOL)
    assert not got[3].any()
    assert got[2, 10:].abs().max() > 0                        # padded rows not zeroed


def test_prefill_window_matches_pallas_kernel():
    q, k, v, tables, q_start, total = _prefill_case(8, 2, 128, seed=9)
    want = paged_prefill_attention_pallas(
        *_j(q, k, v, tables, q_start, total), BS, q_tile=8, window=10)
    got = t_attn.paged_prefill_attention(
        *_t(q, k, v, tables, q_start, total), BS, q_tile=8, window=10)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=F32_TOL, atol=F32_TOL)


def _striped_prefill_case():
    rng = np.random.default_rng(6)
    N, T, H, kvH, D, max_blocks, num_blocks = 4, 40, 8, 2, 64, 12, 64
    q = rng.standard_normal((N, T, H, D)).astype(np.float32)
    k, v = _caches(rng, num_blocks, kvH, D)
    tables = _striped_tables(rng, N, max_blocks, num_blocks)
    q_start = np.asarray([0, 100, 30, 0], np.int32)
    total = np.asarray([40, 131, 50, 0], np.int32)   # lane 2 padded, 3 idle
    return q, k, v, tables, q_start, total, num_blocks // SP


@pytest.mark.parametrize("shard", range(SP))
@pytest.mark.parametrize("window", [0, 24])
def test_striped_prefill_with_stats_matches_pallas_kernel(shard, window):
    q, k, v, tables, q_start, total, local = _striped_prefill_case()
    lt = t_attn.stripe_tables(torch.from_numpy(tables), shard, SP, local).numpy()
    sl = slice(shard * local * BS, (shard + 1) * local * BS)
    off = np.asarray([shard], np.int32)
    want = paged_prefill_attention_pallas(
        *_j(q, k[sl], v[sl], lt, q_start, total), BS, q_tile=16, window=window,
        page_offset=jnp.asarray(off), page_stride=SP, with_stats=True,
    )
    got = t_attn.paged_prefill_attention(
        *_t(q, k[sl], v[sl], lt, q_start, total), BS, q_tile=16, window=window,
        page_offset=torch.from_numpy(off), page_stride=SP, with_stats=True,
    )
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=F32_TOL, atol=F32_TOL)


@pytest.mark.parametrize("window", [0, 24])
def test_striped_prefill_shards_merge_to_the_unstriped_call(window):
    q, k, v, tables, q_start, total, local = _striped_prefill_case()
    tq, tk, tv, tt, ts, tl = _t(q, k, v, tables, q_start, total)
    merged = _shards_merged(
        lambda kk, vv, lt, off: t_attn.paged_prefill_attention(
            tq, kk, vv, lt, ts, tl, BS, window=window, page_offset=off,
            page_stride=SP, with_stats=True),
        tt, tk, tv, local,
    )
    whole = t_attn.paged_prefill_attention(tq, tk, tv, tt, ts, tl, BS, window=window)
    np.testing.assert_allclose(merged.numpy(), whole.numpy(), rtol=F32_TOL, atol=F32_TOL)


def test_striped_prefill_merge_matches_jax_kv_sp_dispatch():
    q, k, v, tables, q_start, total, local = _striped_prefill_case()
    want = AttnDispatch(use_pallas=True, mesh=_sp_mesh(), kv_sp=True).prefill(
        *_j(q, k, v, tables, q_start, total), BS)
    tq, tk, tv, tt, ts, tl = _t(q, k, v, tables, q_start, total)
    got = _shards_merged(
        lambda kk, vv, lt, off: t_attn.paged_prefill_attention(
            tq, kk, vv, lt, ts, tl, BS, page_offset=off, page_stride=SP,
            with_stats=True),
        tt, tk, tv, local,
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=F32_TOL, atol=F32_TOL)


def test_stripe_tables_localizes_each_logical_page():
    rng = np.random.default_rng(7)
    tables = _striped_tables(rng, 3, 10, 64)
    for r in range(SP):
        lt = t_attn.stripe_tables(torch.from_numpy(tables), r, SP, 16).numpy()
        assert lt.shape == (3, 3)
        for j in range(3):
            if r + j * SP < 10:
                np.testing.assert_array_equal(lt[:, j], tables[:, r + j * SP] - 16 * r)


# -- wrappers on the CPU -------------------------------------------------------
def test_wrappers_and_dispatch_run_the_plain_versions_on_cpu():
    q, k, v, tables, ctx, _ = _striped_decode_case()
    args = _t(q, k, v, tables, ctx)
    before = t_dec.paged_decode_attention_cuda.launches
    want = t_attn.paged_decode_attention(*args, BS, 40)
    np.testing.assert_array_equal(
        t_dec.paged_decode_attention_cuda(*args, BS, window=40).numpy(), want.numpy())
    got = t_dec.paged_decode_attention_cuda(
        *args, BS, window=40, page_offset=torch.tensor([1], dtype=torch.int32),
        page_stride=SP, with_stats=True)
    want = t_attn.paged_decode_attention(
        *args, BS, 40, torch.tensor([1], dtype=torch.int32), SP, True)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w.numpy())
    assert t_dec.paged_decode_attention_cuda.launches == before

    pq, pk, pv, pt, ps, pl_ = _prefill_case(8, 2, 64)
    pargs = _t(pq, pk, pv, pt, ps, pl_)
    before = (t_pre.paged_prefill_attention_cuda.launches,
              t_pre.paged_prefill_attention_cuda.launches_tc)
    for dtype in (torch.float32, torch.bfloat16):
        dargs = [a.to(dtype) if a.is_floating_point() else a for a in pargs]
        want = t_attn.paged_prefill_attention(*dargs, BS, window=10)
        got = t_pre.paged_prefill_attention_cuda(*dargs, BS, window=10)
        assert got.dtype == dtype
        np.testing.assert_array_equal(got.float().numpy(), want.float().numpy())
    got = t_pre.paged_prefill_attention_cuda(*pargs, BS, window=10, with_stats=True)
    want = t_attn.paged_prefill_attention(*pargs, BS, window=10, with_stats=True)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w.numpy())
    assert (t_pre.paged_prefill_attention_cuda.launches,
            t_pre.paged_prefill_attention_cuda.launches_tc) == before


def test_prefill_routing_is_a_dtype_choice():
    """A CUDA call in bf16 launches the tensor-core entry, in float32 the
    CUDA-core walk; anything else is refused before any launch."""
    assert t_pre.kernel_entry(torch.bfloat16) == "paged_prefill_attention_tc"
    assert t_pre.kernel_entry(torch.float32) == "paged_prefill_attention"
    for dtype in (torch.float16, torch.int8):
        with pytest.raises(TypeError):
            t_pre.kernel_entry(dtype)


def test_wrappers_refuse_other_devices():
    q = torch.empty(4, 8, 64, device="meta")
    k = torch.empty(64, 2, 64, device="meta")
    meta = torch.empty(4, dtype=torch.int32, device="meta")
    tables = torch.empty(4, 4, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="device"):
        t_dec.paged_decode_attention_cuda(q, k, k, tables, meta, BS)
    with pytest.raises(ValueError, match="device"):
        t_pre.paged_prefill_attention_cuda(q[None], k, k, tables[:1], meta[:1], meta[:1], BS)


def _misaligned(x):
    """x's values in a contiguous tensor that starts 2 bytes past a
    16-byte boundary."""
    flat = torch.empty(x.numel() + 1, dtype=x.dtype)[1:]
    return flat.view(x.shape).copy_(x)


def _decode_args(**over):
    q, k, v, tables, ctx, _ = _striped_decode_case()
    tq, tk, tv, tt, tc = _t(q, k, v, tables, ctx)
    args = dict(q=tq.bfloat16(), k_cache=tk.bfloat16(), v_cache=tv.bfloat16(),
                block_tables=tt, context_lens=tc, block_size=BS, window=0,
                page_offset=torch.tensor([1], dtype=torch.int32), page_stride=SP)
    args.update(over)
    return args


def test_decode_kernel_args_accept_the_striped_shapes():
    t_dec.check_kernel_args(**_decode_args())
    t_dec.check_kernel_args(**_decode_args(page_offset=None, page_stride=1))


@pytest.mark.parametrize("over", [
    lambda a: {"page_offset": torch.tensor([1], dtype=torch.int64)},
    lambda a: {"page_offset": torch.tensor([1, 2], dtype=torch.int32)},
    lambda a: {"page_stride": 0},
    lambda a: {"context_lens": a["context_lens"][:-1].contiguous()},
    lambda a: {"q": a["q"][:-1].contiguous()},
    lambda a: {"k_cache": a["k_cache"].float(), "v_cache": a["v_cache"].float()},
    lambda a: {"q": a["q"][None]},
    lambda a: {"block_tables": a["block_tables"][:, :0].contiguous()},
    lambda a: {"q": _misaligned(a["q"])},
], ids=["offset_dtype", "offset_shape", "stride", "ctx_len", "lanes", "dtype", "rank",
        "no_columns", "q_misaligned"])
def test_decode_kernel_args_refuse_what_the_kernel_does_not_take(over):
    args = _decode_args()
    args.update(over(args))
    with pytest.raises((TypeError, ValueError)):
        t_dec.check_kernel_args(**args)


def test_prefill_kernel_args():
    q, k, v, tables, q_start, total = _prefill_case(8, 2, 64)
    tq, tk, tv, tt, ts, tl = _t(q, k, v, tables, q_start, total)
    t_pre.check_kernel_args(tq, tk, tv, tt, ts, tl, BS)
    with pytest.raises(ValueError, match="N, T, H, D"):
        t_pre.check_kernel_args(tq[0], tk, tv, tt, ts, tl, BS)
    with pytest.raises(TypeError):
        t_pre.check_kernel_args(tq, tk, tv, tt, ts.long(), tl, BS)
    with pytest.raises(ValueError, match="column"):
        t_pre.check_kernel_args(tq, tk, tv, tt[:, :0].contiguous(), ts, tl, BS)
    with pytest.raises(ValueError, match="aligned"):
        t_pre.check_kernel_args(_misaligned(tq), tk, tv, tt, ts, tl, BS)
    lanes = MAX_GRID_YZ + 1
    with pytest.raises(ValueError, match="lanes"):
        t_pre.check_kernel_args(
            torch.zeros(lanes, 1, 2, 16), torch.zeros(16, 1, 16), torch.zeros(16, 1, 16),
            torch.zeros(lanes, 1, dtype=torch.int32), torch.zeros(lanes, dtype=torch.int32),
            torch.zeros(lanes, dtype=torch.int32), BS)
    with pytest.raises(ValueError, match="q_tile"):
        t_pre.paged_prefill_attention_cuda(tq, tk, tv, tt, ts, tl, BS, q_tile=0)
