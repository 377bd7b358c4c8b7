"""The port's plain ragged paged attention (dynamo_tpu_torch/ops/
attention.py) against the JAX package's ``ragged_paged_attention`` and
its Pallas kernel in interpret mode, on the case set of
tests/test_ragged_attention.py: decode-only, prefill-only with a prefix
hit, mixed batches, GQA 8/2/1, bf16, sliding windows, idle metadata rows,
padding rows and spec-verify spans. Same numpy inputs to both packages;
f32 within 1e-5, bf16 within 1e-2. Also the CUDA wrapper's CPU routing,
argument checks and build command. The kernel itself is held against
the plain version on the card by chip_smoke.py."""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from dynamo_tpu.ops import attention as j_attn
from dynamo_tpu.ops.pallas.ragged_attention import ragged_paged_attention_pallas
from dynamo_tpu_torch.ops import attention as t_attn
from dynamo_tpu_torch.ops.kernels import _build
from dynamo_tpu_torch.ops.kernels import ragged_attention as t_kernel

BS = 16
F32_TOL = 1e-5
BF16_TOL = 1e-2


def _case(seed, spans, T, H, kvH, D, num_blocks=64, max_blocks=4,
          dtype=np.float32):
    """Numpy inputs for spans [(q_start, q_len), ...] packed from row 0,
    with disjoint block tables (block 0, the trash block, never used)."""
    rng = np.random.default_rng(seed)
    S = len(spans)
    k = rng.standard_normal((num_blocks * BS, kvH, D)).astype(np.float32)
    v = rng.standard_normal((num_blocks * BS, kvH, D)).astype(np.float32)
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
    q = rng.standard_normal((T, H, D)).astype(np.float32)
    return dict(q=q, k=k, v=v, tables=tables, q_start=q_start, q_len=q_len,
                kv_len=q_start + q_len, row_start=row_start,
                token_seq=token_seq, token_pos=token_pos, dtype=dtype)


def _jax(c, window=0):
    dt = jnp.bfloat16 if c["dtype"] == "bf16" else jnp.float32
    out = j_attn.ragged_paged_attention(
        jnp.asarray(c["q"], dt), jnp.asarray(c["k"], dt),
        jnp.asarray(c["v"], dt), jnp.asarray(c["tables"]),
        jnp.asarray(c["token_seq"]), jnp.asarray(c["token_pos"]), BS, window,
    )
    return np.asarray(out.astype(jnp.float32))


def _torch_args(c):
    dt = torch.bfloat16 if c["dtype"] == "bf16" else torch.float32

    def t(a):
        return torch.from_numpy(np.array(a))

    return dict(
        q=t(c["q"]).to(dt), k=t(c["k"]).to(dt), v=t(c["v"]).to(dt),
        tables=t(c["tables"]), q_start=t(c["q_start"]), q_len=t(c["q_len"]),
        kv_len=t(c["kv_len"]), row_start=t(c["row_start"]),
        token_seq=t(c["token_seq"]), token_pos=t(c["token_pos"]),
    )


def _port(c, window=0):
    a = _torch_args(c)
    out = t_attn.ragged_paged_attention(
        a["q"], a["k"], a["v"], a["tables"], a["token_seq"], a["token_pos"],
        BS, window,
    )
    return out.float().numpy()


def _check(c, window=0, tol=F32_TOL):
    want = _jax(c, window)
    got = _port(c, window)
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)
    owned = int(c["q_len"].sum())
    assert not got[owned:].any()  # padding rows stay zero
    return got


@pytest.mark.parametrize("H,kvH,D", [(8, 8, 64), (8, 2, 64), (4, 1, 32)])
def test_mixed_batch_matches_jax(H, kvH, D):
    """Decode spans + prefill quanta + a prefix-hit chunk + an idle row in
    ONE flat batch (GQA 8/2/1 query heads per kv head)."""
    spans = [(36, 1), (0, 1), (0, 20), (16, 13), (0, 0)]
    _check(_case(0, spans, 40, H, kvH, D))


def test_decode_only_matches_jax_and_decode_oracle():
    ctx = np.array([64, 37, 1, 16], np.int32)
    c = _case(1, [(n - 1, 1) for n in ctx], 16, 8, 2, 64)
    got = _check(c)
    want = np.asarray(j_attn.paged_decode_attention(
        jnp.asarray(c["q"][:4]), jnp.asarray(c["k"]), jnp.asarray(c["v"]),
        jnp.asarray(c["tables"]), jnp.asarray(ctx), BS,
    ))
    np.testing.assert_allclose(got[:4], want, rtol=F32_TOL, atol=F32_TOL)
    a = _torch_args(c)
    port_decode = t_attn.paged_decode_attention(
        a["q"][:4], a["k"], a["v"], a["tables"], torch.from_numpy(ctx), BS,
    ).numpy()
    np.testing.assert_allclose(port_decode, want, rtol=F32_TOL, atol=F32_TOL)


def test_prefill_only_with_prefix_hit_matches_jax():
    """Span 1 extends a 16-token cached prefix; both spans also against
    the reference's per-lane prefill oracle."""
    c = _case(2, [(0, 24), (16, 13)], 40, 8, 2, 64)
    got = _check(c)
    o1 = np.asarray(j_attn.paged_prefill_attention(
        jnp.asarray(c["q"][24:37]), jnp.asarray(c["k"]), jnp.asarray(c["v"]),
        jnp.asarray(c["tables"][1]), jnp.int32(16), jnp.int32(29), BS,
    ))
    np.testing.assert_allclose(got[24:37], o1, rtol=F32_TOL, atol=F32_TOL)


def test_bf16_mixed_batch_matches_jax():
    c = _case(3, [(19, 1), (0, 12), (8, 5)], 24, 8, 4, 64, num_blocks=32,
              max_blocks=3, dtype="bf16")
    _check(c, tol=BF16_TOL)


@pytest.mark.parametrize("window", [8, 24])
def test_sliding_window_mixed_batch_matches_jax(window):
    c = _case(4, [(63, 1), (0, 20), (30, 9)], 32, 4, 2, 64)
    got = _check(c, window=window)
    want = np.asarray(j_attn.paged_decode_attention(
        jnp.asarray(c["q"][:1]), jnp.asarray(c["k"]), jnp.asarray(c["v"]),
        jnp.asarray(c["tables"][:1]), jnp.asarray([64], jnp.int32), BS,
        window=window,
    ))
    np.testing.assert_allclose(got[:1], want, rtol=F32_TOL, atol=F32_TOL)


@pytest.mark.parametrize("H,kvH", [(8, 8), (8, 2)])
def test_spec_verify_spans_match_jax(H, kvH):
    """Draft-verify spans (q_len = k+1 rows at q_start = ctx-1) beside a
    plain decode span and a prefill quantum."""
    c = _case(7, [(35, 4), (0, 3), (21, 1), (0, 10)], 32, H, kvH, 64)
    _check(c)


@pytest.mark.parametrize("window", [8, 16])
def test_spec_verify_spans_windowed_match_jax(window):
    c = _case(8, [(50, 5), (0, 8)], 16, 4, 2, 64)
    _check(c, window=window)


def test_idle_rows_and_padding_rows_are_zero():
    c = _case(9, [(0, 0), (5, 3), (0, 0), (0, 2)], 16, 4, 2, 32)
    got = _check(c)
    assert got[:5].any() and not got[5:].any()


def test_matches_pallas_kernel_in_interpret_mode():
    """The port's plain version against the TPU kernel itself, run in
    interpret mode on the CPU (D=128, the kernel's lane width)."""
    c = _case(10, [(36, 1), (0, 1), (0, 20), (16, 13), (0, 0)], 40, 8, 2, 128)
    want = np.asarray(ragged_paged_attention_pallas(
        jnp.asarray(c["q"]), jnp.asarray(c["k"]), jnp.asarray(c["v"]),
        jnp.asarray(c["tables"]), jnp.asarray(c["q_start"]),
        jnp.asarray(c["q_len"]), jnp.asarray(c["kv_len"]),
        jnp.asarray(c["row_start"]), BS,
    ))
    np.testing.assert_allclose(_port(c), want, rtol=F32_TOL, atol=F32_TOL)


def test_full_causal_attention_matches_jax():
    rng = np.random.default_rng(11)
    q = rng.standard_normal((12, 8, 32)).astype(np.float32)
    k = rng.standard_normal((12, 2, 32)).astype(np.float32)
    v = rng.standard_normal((12, 2, 32)).astype(np.float32)
    for window in (0, 5):
        want = np.asarray(j_attn.full_causal_attention(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), window))
        got = t_attn.full_causal_attention(
            torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
            window).numpy()
        np.testing.assert_allclose(got, want, rtol=F32_TOL, atol=F32_TOL)


def test_span_tokens_rebuilds_the_token_view():
    c = _case(12, [(36, 1), (0, 0), (0, 20), (16, 13)], 40, 4, 2, 32)
    a = _torch_args(c)
    seq, pos = t_attn.span_tokens(a["q_start"], a["q_len"], a["row_start"], 40)
    np.testing.assert_array_equal(pos.numpy(), c["token_pos"])
    owned = c["token_pos"] >= 0
    np.testing.assert_array_equal(seq.numpy()[owned], c["token_seq"][owned])


@pytest.mark.parametrize("window", [0, 8])
def test_cuda_wrapper_runs_the_plain_version_on_cpu(window):
    c = _case(13, [(36, 1), (0, 20), (16, 13), (0, 0)], 40, 8, 2, 64)
    a = _torch_args(c)
    before = t_kernel.ragged_paged_attention_cuda.launches
    got = t_kernel.ragged_paged_attention_cuda(
        a["q"], a["k"], a["v"], a["tables"], a["q_start"], a["q_len"],
        a["kv_len"], a["row_start"], BS, window=window,
    )
    np.testing.assert_array_equal(got.numpy(), _port(c, window))
    # The plain version is no launch of the kernel.
    assert t_kernel.ragged_paged_attention_cuda.launches == before


def test_cuda_wrapper_refuses_other_devices():
    q = torch.empty(4, 8, 64, device="meta")
    k = torch.empty(64, 2, 64, device="meta")
    meta = torch.empty(1, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="device"):
        t_kernel.ragged_paged_attention_cuda(
            q, k, k, torch.empty(1, 4, dtype=torch.int32, device="meta"),
            meta, meta, meta, meta, BS,
        )


def _kernel_args(**over):
    a = _torch_args(_case(14, [(3, 1), (0, 4)], 16, 8, 2, 64, dtype="bf16"))
    args = dict(q=a["q"], k_cache=a["k"], v_cache=a["v"],
                block_tables=a["tables"], q_start=a["q_start"],
                q_len=a["q_len"], kv_len=a["kv_len"],
                row_start=a["row_start"], block_size=BS, window=0)
    args.update(over)
    return args


def test_kernel_args_accept_the_main_path_shapes():
    t_kernel.check_kernel_args(**_kernel_args())


@pytest.mark.parametrize("over,err", [
    (lambda a: {"q": a["q"][..., :40].contiguous(),
                "k_cache": a["k_cache"][..., :40].contiguous(),
                "v_cache": a["v_cache"][..., :40].contiguous()}, ValueError),
    (lambda a: {"block_size": 8}, ValueError),
    (lambda a: {"q": a["q"].float()}, TypeError),
    (lambda a: {"q_len": a["q_len"].long()}, TypeError),
    (lambda a: {"q": a["q"].transpose(0, 1).contiguous().transpose(0, 1)},
     ValueError),
    (lambda a: {"q": a["q"][:, :5].contiguous()}, ValueError),
    (lambda a: {"window": -1}, ValueError),
    (lambda a: {name: a[name].flatten()[1:1 + 1008 * 128].view(1008, 2, 64)
                for name in ("k_cache", "v_cache")}, ValueError),
    # Spans map onto grid.y (at most 65535), and q's fragments are read
    # in whole 16-byte-aligned words.
    (lambda a: {"block_tables": torch.zeros(65536, 4, dtype=torch.int32),
                **{name: torch.zeros(65536, dtype=torch.int32)
                   for name in ("q_start", "q_len", "kv_len", "row_start")}},
     ValueError),
    (lambda a: {"q": torch.cat([a["q"].new_zeros(1), a["q"].flatten()])[1:]
                .view(a["q"].shape)}, ValueError),
], ids=["head_dim", "block_size", "dtype", "int64_meta", "strided",
        "heads", "window", "misaligned", "spans_past_grid", "q_misaligned"])
def test_kernel_args_refuse_what_the_kernel_does_not_take(over, err):
    args = _kernel_args()
    args.update(over(args))
    with pytest.raises(err):
        t_kernel.check_kernel_args(**args)


def test_build_command_targets_hopper(monkeypatch):
    cmd = _build.nvcc_command("nvcc", "ragged_attention", _build.BUILD_DIR / "x.so")
    assert "arch=compute_90a,code=sm_90a" in cmd and "-shared" in cmd
    assert cmd[-1].endswith("csrc/ragged_attention.cu")
    assert _build.source_path("ragged_attention").exists()
    monkeypatch.setattr(_build.shutil, "which", lambda _: None)
    monkeypatch.setattr(_build.os.path, "exists", lambda _: False)
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.nvcc_path()
