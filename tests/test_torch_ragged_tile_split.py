"""The tile's key ranges and the window-relative split plan of the port's
ragged kernel (csrc/ragged_attention.cu), held on the CPU with the plain
versions at the families' head dims (D = 128 and 256), G = 4 and a window.

On the card a span of more than ``SPLIT_ROWS`` rows runs on the
tensor-core tile: 128 query vectors of one kv head a block, whose
visible table columns the wrapper's ``ragged_tile_plan`` may cut into
key ranges, balanced runs of those columns, one block each; the merge
pass combines the ranges' partials (f32 out, m, l) by the logsumexp law
of ``merge_stats``. Shorter spans split the columns their rows can see
the same way (``span_columns``, ``split_columns``). Here:
the plans take host integers only, cover every visible column of every
span exactly once, plan nothing behind a window or past a context at
``chip_smoke.py``'s families shapes and one key range at llama3.2-1b's
serve rungs; the split-and-merge law over the planned ranges equals the
unsplit call in float32 and the JAX package in bf16 (the Pallas kernel in
interpret mode for caches in q's dtype; for int8 caches the XLA oracle
with scales, since the Pallas int8 branch fails under jax 0.9).

Tolerances: float32 within 1e-5 (the north star's kernel-vs-oracle
bound); bf16 outputs within 1e-2 (chip_smoke.py's)."""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from dynamo_tpu.ops import attention as j_attn
from dynamo_tpu.ops.pallas.ragged_attention import ragged_paged_attention_pallas
from dynamo_tpu_torch.engine.compile_cache import budget_ladder
from dynamo_tpu_torch.ops import attention as t_attn
from dynamo_tpu_torch.ops.kernels import ragged_attention as t_rag

BS = 16
F32_TOL = 1e-5
BF16_TOL = 1e-2

# (spans [(q_start, q_len)], T, window, head dim): prefill spans of 40-70
# rows (two or three tiles at G = 4) behind a prefix longer than the
# window, one starting at 0, decode and short spec-verify spans, an idle
# span and padding rows.
CASES = {
    "d128_w96": ([(230, 40), (0, 70), (180, 1), (99, 3), (250, 1), (0, 0)], 128, 96, 128),
    "d256_w64": ([(200, 64), (31, 37), (140, 1), (260, 4), (0, 0)], 112, 64, 256),
    "d128_long_prefix": ([(250, 64), (190, 50), (0, 0)], 128, 80, 128),
}
H, KVH = 16, 4                    # G = 4
RANGES = ["plan", 2, 3, 7]

# chip_smoke.py's families cases (phase 12 and the long-prefix twins):
# (spans, T, window, (H, kvH, D), table columns).
GEMMA_PREFILL = [(0, 64), (480, 64), (900, 100), (0, 0)]
MISTRAL_PREFILL = [(4300, 64), (4100, 96), (0, 0)]
FAMILIES = {
    "gemma_w512": ([(c - 1, 1) for c in (300, 511, 513, 700, 1024, 1200)] + GEMMA_PREFILL,
                   256, 512, (4, 1, 256), 80),
    "gemma_prefill_w512": (GEMMA_PREFILL, 256, 512, (4, 1, 256), 80),
    "mistral_w4096": ([(c - 1, 1) for c in (4200, 4350, 4511, 4700)] + MISTRAL_PREFILL,
                      192, 4096, (32, 8, 128), 320),
    "mistral_prefill_w4096": (MISTRAL_PREFILL, 192, 4096, (32, 8, 128), 320),
}


def _case(seed, spans, T, D, num_blocks=48, max_blocks=24, int8=False):
    rng = np.random.default_rng(seed)
    shape = (num_blocks * BS, KVH, D)
    if int8:
        k = rng.integers(-127, 128, shape).astype(np.int8)
        v = rng.integers(-127, 128, shape).astype(np.int8)
    else:
        k = rng.standard_normal(shape).astype(np.float32)
        v = rng.standard_normal(shape).astype(np.float32)
    S = len(spans)
    tables = np.stack([rng.permutation(np.arange(1, num_blocks))[:max_blocks]
                       for _ in range(S)]).astype(np.int32)
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
        c["ks"] = rng.uniform(0.002, 0.02, (num_blocks, KVH)).astype(np.float32)
        c["vs"] = rng.uniform(0.002, 0.02, (num_blocks, KVH)).astype(np.float32)
    return c


def _torch(c, dtype=torch.float32):
    t = {n: torch.from_numpy(a) for n, a in c.items()}
    t["q"] = t["q"].to(dtype)
    if "ks" not in c:
        t["k"], t["v"] = t["k"].to(dtype), t["v"].to(dtype)
    return t


def _tile_rows(ql, G):
    """Row runs [lo, hi) of a span's tiles: TILE_VECS query vectors each
    (whole rows, since G divides TILE_VECS here)."""
    per = t_rag.TILE_VECS // G
    return [(r, min(r + per, ql)) for r in range(0, ql, per)]


def _tile_range_columns(qs, lo, hi, kv, window, max_blocks, ranges):
    """The table columns [a, b) of each key range of the tile of rows
    [lo, hi): balanced runs (``split_columns``) of the columns from its
    first row's window page to its last row's causal bound."""
    first, end = t_rag.span_columns(qs, lo, hi - 1, kv, window, BS, max_blocks)
    return (first, end), [t_rag.split_columns(first, end, ranges, r) for r in range(ranges)]


def _split_columns(qs, ql, kv, window, max_blocks, num_splits):
    first, end = t_rag.span_columns(qs, 0, ql - 1, kv, window, BS, max_blocks)
    return (first, end), [t_rag.split_columns(first, end, num_splits, s)
                          for s in range(num_splits)]


def _columns_call(t, r0, n, table, lo, hi, window):
    """The plain attention of flat rows [r0, r0 + n) over table columns
    [lo, hi) of their span's ``table``, with stats: float32 (out, m, l);
    an empty run gives out 0, m -1e30, l 0."""
    D = t["q"].shape[2]
    if hi <= lo:
        return (torch.zeros(n, H, D), torch.full((n, H), -1e30), torch.zeros(n, H))
    ctx = t["token_pos"][r0:r0 + n].long() + 1
    return t_attn.paged_decode_attention(
        t["q"][r0:r0 + n], t["k"], t["v"], table[lo:hi].expand(n, -1).contiguous(), ctx,
        BS, window, page_offset=lo, with_stats=True,
        k_scales=t.get("ks"), v_scales=t.get("vs"),
    )


def _plans(c, T, window, D, ranges):
    S, max_blocks = c["tables"].shape
    num_splits, _ = t_rag.ragged_split_plan(
        S, KVH, max_blocks, BS, window, 132, -(-(H // KVH) // t_rag.SPLIT_VECS))
    if ranges == "plan":
        ranges = t_rag.ragged_tile_plan(T, H, KVH, D, max_blocks, BS, window, 132)
    return num_splits, ranges


def _routed(t, window, num_splits, ranges):
    """The kernel's routing and laws with the plain versions: a short
    span's rows merge its splits, a longer span's rows merge, tile by
    tile, the tile's key ranges; rows no span owns stay zero. Returns
    (routed, unsplit), float32."""
    T, _, D = t["q"].shape
    max_blocks = t["tables"].shape[1]
    routed = torch.zeros(T, H, D)
    unsplit = torch.zeros(T, H, D)
    for s, (qs, ql, kv, r0) in enumerate(zip(*(t[n].tolist() for n in (
            "q_start", "q_len", "kv_len", "row_start")))):
        if ql == 0:
            continue
        table = t["tables"][s]
        unsplit[r0:r0 + ql] = _columns_call(t, r0, ql, table, 0, max_blocks, window)[0]
        if ql <= t_rag.SPLIT_ROWS:
            runs = [(0, ql, _split_columns(qs, ql, kv, window, max_blocks, num_splits)[1])]
        else:
            runs = [(lo, hi, _tile_range_columns(qs, lo, hi, kv, window, max_blocks, ranges)[1])
                    for lo, hi in _tile_rows(ql, H // KVH)]
        for lo, hi, cols in runs:
            routed[r0 + lo:r0 + hi] = t_attn.merge_stats([
                _columns_call(t, r0 + lo, hi - lo, table, a, b, window) for a, b in cols])
    return routed, unsplit


# -- the plans -------------------------------------------------------------------
@pytest.mark.parametrize("name", list(FAMILIES))
def test_families_plans_cover_the_visible_columns_and_nothing_behind_a_window(name):
    """At chip_smoke.py's families shapes: every split of a short span and
    every non-empty key range of a tile lies inside the columns its rows
    can see (none wholly behind the window or past the context), the
    short spans' splits are never empty, and the runs partition those
    columns exactly once. A tile that sees fewer columns than it has
    ranges leaves some ranges empty (those blocks read nothing and write
    l = 0)."""
    spans, T, window, (h, kvh, d), max_blocks = FAMILIES[name]
    G = h // kvh
    num_splits, pages = t_rag.ragged_split_plan(
        len(spans), kvh, max_blocks, BS, window, 132, -(-G // t_rag.SPLIT_VECS),
        t_rag.split_blocks_per_sm(torch.bfloat16, d))
    ranges = t_rag.ragged_tile_plan(T, h, kvh, d, max_blocks, BS, window, 132)
    assert ranges > 1                                 # the long windows cut the tile's keys
    for qs, ql in spans:
        if ql == 0:
            continue
        kv = qs + ql
        if ql <= t_rag.SPLIT_ROWS:
            runs = [(0, ql, *_split_columns(qs, ql, kv, window, max_blocks, num_splits))]
        else:
            runs = [(lo, hi, *_tile_range_columns(qs, lo, hi, kv, window, max_blocks, ranges))
                    for lo, hi in _tile_rows(ql, G)]
        for lo, hi, (first, end), cols in runs:
            assert first == max(qs + lo - window + 1, 0) // BS       # the window's page
            assert end == -(-min(qs + hi, kv) // BS)                 # the causal bound's
            covered = np.zeros(max_blocks, np.int32)
            for a, b in cols:
                if ql <= t_rag.SPLIT_ROWS:
                    assert first <= a < b <= end and b - a <= pages
                elif b > a:
                    assert first <= a < b <= end
                covered[a:b] += 1
            assert (covered[first:end] == 1).all() and covered.sum() == end - first


@pytest.mark.parametrize("name", list(FAMILIES))
def test_families_split_count_follows_the_visible_columns(name):
    """The split count is ceil(visible / P) of the columns a short span
    can see inside its window, not ceil(max_blocks / P)."""
    spans, T, window, (h, kvh, d), max_blocks = FAMILIES[name]
    num_splits, pages = t_rag.ragged_split_plan(
        len(spans), kvh, max_blocks, BS, window, 132, -(-(h // kvh) // t_rag.SPLIT_VECS),
        t_rag.split_blocks_per_sm(torch.bfloat16, d))
    visible = t_rag.visible_columns(max_blocks, BS, window + t_rag.SPLIT_ROWS - 1)
    assert visible < max_blocks
    assert num_splits == -(-visible // pages) < -(-max_blocks // pages)


def test_tile_plan_gives_one_range_at_the_llama_serve_rungs():
    """llama3.2-1b's full-width serve (chip_smoke.py full_width_config: D =
    64, G = 4, 64-column tables, no window, budget 256): every captured
    rung, decode-only or mixed, walks its keys in one range, so the tile
    runs as it did before key ranges existed."""
    from dynamo_tpu_torch.engine.config import EngineConfig
    from dynamo_tpu_torch.models.config import ModelConfig

    cfg = EngineConfig(model=ModelConfig.llama32_1b(), dtype="bfloat16", block_size=16,
                       num_blocks=1024, max_num_seqs=8, max_model_len=1024,
                       unified_token_budget=256, unified_prefill_quantum=64)
    m = cfg.model
    for T in budget_ladder(cfg.unified_token_budget):
        assert t_rag.ragged_tile_plan(T, m.num_heads, m.num_kv_heads, m.head_dim,
                                      cfg.max_blocks_per_seq, cfg.block_size) == 1, T


@pytest.mark.parametrize("T", [16, 64, 192, 256, 512, 1024])
def test_tile_plan_fills_a_wave_and_never_cuts_below_its_minimum(T):
    """The families' rungs: the ranges are the fewest whose blocks (the
    tiles a T-row batch can hold, times the ranges) fill a wave of 132
    SMs, unless a range would then walk fewer than MIN_RANGE_WORK keys x
    head dim of the keys a tile sees; one range once the tiles fill the
    card, and one at a rung that cannot hold a full tile of rows."""
    for h, kvh, d, max_blocks, window in ((4, 1, 256, 80, 512), (32, 8, 128, 320, 4096)):
        ranges = t_rag.ragged_tile_plan(T, h, kvh, d, max_blocks, BS, window, 132)
        G = h // kvh
        if T * G < t_rag.TILE_VECS:
            assert ranges == 1
            continue
        tiles = -(-T * G // t_rag.TILE_VECS) * kvh
        reach = min(max_blocks * BS, window + -(-t_rag.TILE_VECS // G) - 1 + BS - 1)
        most = max(1, reach * d // t_rag.MIN_RANGE_WORK)          # ranges the reach allows
        assert 1 <= ranges <= most
        assert tiles * ranges >= 132 or ranges == most
        assert (ranges - 1) * tiles < 132
        if tiles >= 132:
            assert ranges == 1


# -- the law -------------------------------------------------------------------
@pytest.mark.parametrize("name", list(CASES))
@pytest.mark.parametrize("ranges", RANGES)
def test_tile_range_law_f32_equals_the_unsplit_call(name, ranges):
    spans, T, window, D = CASES[name]
    c = _case(0, spans, T, D)
    num_splits, ranges = _plans(c, T, window, D, ranges)
    routed, unsplit = _routed(_torch(c), window, num_splits, ranges)
    np.testing.assert_allclose(routed.numpy(), unsplit.numpy(), rtol=F32_TOL, atol=F32_TOL)
    assert not routed[c["token_pos"] < 0].any()                 # unowned rows zero


@pytest.mark.parametrize("name", list(CASES))
@pytest.mark.parametrize("ranges", ["plan", 3])
def test_tile_range_law_bf16_matches_the_pallas_kernel(name, ranges):
    """The routed result in bf16 against the TPU kernel run in interpret
    mode on the same bf16-rounded inputs."""
    spans, T, window, D = CASES[name]
    c = _case(1, spans, T, D)
    t = _torch(c, torch.bfloat16)
    routed, _ = _routed(t, window, *_plans(c, T, window, D, ranges))
    want = ragged_paged_attention_pallas(
        *(jnp.asarray(c[n], jnp.bfloat16) for n in ("q", "k", "v")),
        *(jnp.asarray(c[n]) for n in ("tables", "q_start", "q_len", "kv_len",
                                       "row_start")),
        BS, window=window,
    )
    got = routed.to(torch.bfloat16).float().numpy()
    np.testing.assert_allclose(got, np.asarray(want.astype(jnp.float32)),
                               rtol=BF16_TOL, atol=BF16_TOL)


@pytest.mark.parametrize("name", list(CASES))
@pytest.mark.parametrize("ranges", ["plan", 3])
def test_int8_tile_range_law_matches_the_xla_oracle_with_scales(name, ranges):
    """The int8 leg: bf16 q over int8 caches with per-(block, kv head)
    scales, routed and merged, within the bf16 tolerance of the XLA
    oracle (float32 arithmetic on the same inputs)."""
    spans, T, window, D = CASES[name]
    c = _case(2, spans, T, D, int8=True)
    t = _torch(c, torch.bfloat16)
    routed, _ = _routed(t, window, *_plans(c, T, window, D, ranges))
    q = np.asarray(t["q"].float())
    want = np.asarray(j_attn.ragged_paged_attention(
        jnp.asarray(q), *(jnp.asarray(c[n]) for n in (
            "k", "v", "tables", "token_seq", "token_pos")),
        BS, window, k_scales=jnp.asarray(c["ks"]), v_scales=jnp.asarray(c["vs"]),
    ))
    got = routed.to(torch.bfloat16).float().numpy()
    np.testing.assert_allclose(got, want, rtol=BF16_TOL, atol=BF16_TOL)
