"""Weight quantization, the weight access sites and the int8 KV write law
(port of dynamo_tpu/ops/quant.py: ``quantize_weight``, the quantized and
plain arms of ``qdot``/``qeinsum``/``embed_lookup``/``tied_head_mm``,
``quantize_params``, the per-matmul policy functions, ``quant_tree_stats``
and ``quantize_kv_write``; and the stacked experts' products of
dynamo_tpu/models/moe.py ``_expert_einsum``).

A quantized weight is a dict ``{"q": int8 | float8_e4m3fn [..., in, out],
"s": scales}``, ``s`` the weight's shape without its contraction axis
(per output channel; ``w_uv`` contracts its last axis, the tied table is
scaled per row) and in the weight's dtype, as the reference keeps it.
Every matmul on the unified path goes through the functions below, so a
plain tensor and a quantized dict are interchangeable in models/.

Each quantized product has two arms:
- on the CPU, the reference's expression in torch ops: ``q`` converts to
  the activation's dtype on the operand and the per-column scale
  multiplies the result (``(x @ q.to(x.dtype)) * s``);
- on the card, the hand-written kernel ``ops/kernels/wq_gemm.py``, which
  streams the int8/e4m3 bytes and converts them in registers. Eager
  PyTorch has no fusion of the convert into the product (XLA gives it to
  the reference for free): ``x @ q.to(bf16)`` would write a bf16 copy of
  every weight and read it back, 5 bytes a weight instead of 1. The
  kernel sums in float32 and rounds once, after the scale (the
  reference rounds ``x @ q`` to bf16, then multiplies by a bf16 scale).
"""

from __future__ import annotations

from types import SimpleNamespace

import torch

from dynamo_tpu_torch.ops.kernels.wq_gemm import operand_ok, wq_gemm_cuda

# The large matmul operands: norm gains, biases, the router (tiny,
# routing-accuracy-critical) and the embedding table (a gather; tied, it
# quantizes per row as the head's operand) stay in the model's dtype.
QUANT_KEYS = (
    "wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down", "lm_head",
    "w_dq", "w_uq", "w_dkv", "w_uk", "w_uv",
    "w_shared_gate", "w_shared_up", "w_shared_down",
)
# The policy's sites (models/llama.py WeightQuantPolicy): attn is every
# attention projection (GQA's q/k/v/o and MLA's ladder), mlp the gated
# MLP's and the experts' matrices (not the router).
ATTN_KEYS = (
    "wq", "wk", "wv", "wo", "w_dq", "w_uq", "w_dkv", "w_uk", "w_uv",
)
MLP_KEYS = (
    "w_gate", "w_up", "w_down",
    "w_shared_gate", "w_shared_up", "w_shared_down",
)
FP8_DTYPE = torch.float8_e4m3fn
FP8_MAX = 448.0
WEIGHT_FORMATS = ("int8", "fp8")
CONTRACT_AXIS = -2  # the weight layout is [..., in, out]
# Per-key contraction axes: w_uv [H, v, dc] contracts its last axis (the
# latent) in _mla_out's einsum, so its scales are per (head, v).
QUANT_AXES = {"w_uv": -1}

# Quantized products that took the plain arm (any device): the card's
# serves must leave it at 0 (every one goes through the kernel there).
PLAIN_CALLS = {"count": 0}


def is_quantized(w) -> bool:
    return isinstance(w, dict) and "q" in w and "s" in w


def weight_dtype(w) -> torch.dtype:
    """The compute dtype of a plain or quantized weight (its scales keep
    the dtype the weight had)."""
    return w["s"].dtype if is_quantized(w) else w.dtype


# Elements a float32 temporary of quantize_weight holds at most: the
# weight is quantized in slices along its first axis, so quantizing the
# 128256 x 4096 head of an 8B model needs ~200 MB of scratch, not ~6 GB.
QUANT_CHUNK = 1 << 24


def quantize_weight(
    w: torch.Tensor, axis: int = CONTRACT_AXIS, fmt: str = "int8"
) -> dict:
    """Symmetric per-output-channel quantization over the contraction
    axis, in float32: int8 ``q = clip(round(w / s), -127, 127)`` with
    ``s = max(amax|w|, 1e-8) / 127``; fp8 e4m3 ``q = (w / s)`` cast with
    ``s = max(amax|w|, 1e-8) / 448``. ``s`` keeps ``w``'s dtype. The
    elementwise law runs in slices along the first axis (QUANT_CHUNK);
    the amax is exact in ``w``'s own dtype."""
    if fmt not in WEIGHT_FORMATS:
        raise ValueError(f"unknown weight format {fmt!r} (use {WEIGHT_FORMATS})")
    amax = w.abs().amax(dim=axis).float()
    s = torch.clamp(amax, min=1e-8) / (FP8_MAX if fmt == "fp8" else 127.0)
    sx = s.unsqueeze(axis)
    q = torch.empty(w.shape, dtype=FP8_DTYPE if fmt == "fp8" else torch.int8,
                    device=w.device)
    step = max(1, QUANT_CHUNK // max(1, w[0].numel()))
    for r in range(0, w.shape[0], step):
        scaled = w[r:r + step].float() / (sx if sx.shape[0] == 1 else sx[r:r + step])
        if fmt == "fp8":
            q[r:r + step] = scaled.to(FP8_DTYPE)
        else:
            q[r:r + step] = torch.clamp(torch.round(scaled), -127, 127).to(torch.int8)
    return {"q": q, "s": s.to(w.dtype)}


def dequantize_weight(
    w: dict, dtype: torch.dtype = torch.float32, axis: int = CONTRACT_AXIS
) -> torch.Tensor:
    """Invert quantize_weight with the axis it was quantized over."""
    return (w["q"].float() * w["s"].float().unsqueeze(axis)).to(dtype)


def _plain_arm() -> None:
    PLAIN_CALLS["count"] += 1


def qdot(x: torch.Tensor, w) -> torch.Tensor:
    """``x @ w`` with ``w`` in the reference's ``[in, out]`` layout, plain
    or quantized (the result in x's dtype)."""
    if not is_quantized(w):
        return x @ w
    q, s = w["q"], w["s"]
    if x.is_cuda:
        K = q.shape[0]
        a = x.reshape(-1, K).contiguous()
        out = wq_gemm_cuda(a[None], q[None], s[None], out_dtype=x.dtype)
        return out[0].reshape(*x.shape[:-1], q.shape[1])
    _plain_arm()
    return (x @ q.to(x.dtype)) * s.to(x.dtype)


# The per-head einsums of MLA's absorbed attention on the card: the head
# is the kernel's batch, and whether q is stored [h, n, k] (transposed).
_QEINSUM_TRANSPOSED = {"thn,hnc->thc": False, "thc,hvc->thv": True}


def qeinsum(pattern: str, x: torch.Tensor, w) -> torch.Tensor:
    """Einsum against a per-head weight (MLA's absorbed ``w_uk`` and
    ``w_uv``), in x's dtype; a quantized weight's scales broadcast onto
    the result's trailing axes."""
    if not is_quantized(w):
        return torch.einsum(pattern, x, w)
    q, s = w["q"], w["s"]
    if x.is_cuda:
        if pattern not in _QEINSUM_TRANSPOSED:
            raise ValueError(f"no quantized kernel for einsum {pattern!r}")
        transposed = _QEINSUM_TRANSPOSED[pattern]
        T, Hh = x.shape[0], q.shape[0]
        N = q.shape[1] if transposed else q.shape[2]
        out = torch.empty((T, Hh, N), dtype=x.dtype, device=x.device)
        a = x.permute(1, 0, 2)
        if not operand_ok(a):
            a = x.contiguous().permute(1, 0, 2)
        wq_gemm_cuda(a, q, s, out=out.permute(1, 0, 2), transposed=transposed)
        return out
    _plain_arm()
    return torch.einsum(pattern, x, q.to(x.dtype)) * s.to(x.dtype)


def _qbmm_f32(x: torch.Tensor, w: dict) -> torch.Tensor:
    """Stacked quantized products ``[E, N, in] @ [E, in, out]`` scaled per
    (expert, out), float32 sums and output."""
    q, s = w["q"], w["s"]
    if x.is_cuda:
        # The dense formulation's rows are one [N, in] block expanded over
        # the experts (batch stride 0): the kernel reads it as it lies.
        a = x if operand_ok(x) else x.contiguous()
        return wq_gemm_cuda(a, q, s, out_dtype=torch.float32)
    _plain_arm()
    return torch.bmm(x.float(), q.float()) * s.float()[:, None, :]


def _bmm_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` with operands of one dtype, float32 sums and output: on
    the card one cuBLAS batched product, so the stacked weights are never
    copied to float32; on the CPU the operands are widened first (the
    same products and sums)."""
    if w.dtype == torch.float32:
        return torch.bmm(x, w)
    if x.is_cuda:
        return torch.bmm(x, w, out_dtype=torch.float32)
    return torch.bmm(x.float(), w.float())


def expert_mm(x: torch.Tensor, w) -> torch.Tensor:
    """Stacked experts' products ``[E, N, in] @ [E, in, out]`` with a
    float32 output and the operands in ``w``'s dtype (a quantized ``w``:
    its scales' dtype, the int8/e4m3 values exact in it)."""
    if is_quantized(w):
        return _qbmm_f32(x.to(w["s"].dtype), w)
    return _bmm_f32(x.to(w.dtype), w)


def expert_mm_f32(h: torch.Tensor, w) -> torch.Tensor:
    """Stacked experts' products with a float32 input kept in float32, as
    the reference's ``_expert_einsum`` widens the weights: on the CPU the
    weights are widened; on the card ``split_bmm`` (a float32 model's
    quantized weights go to the kernel's float32 entry as they are)."""
    h = h.float()
    if weight_dtype(w) == torch.float32 or not h.is_cuda:
        if is_quantized(w):
            return _qbmm_f32(h, w)
        return torch.bmm(h, w.float())
    return split_bmm(h, w)


def split_bmm(h: torch.Tensor, w) -> torch.Tensor:
    """float32 ``h [E, N, in]`` against a low-precision ``w`` without
    widening ``w``: ``h`` splits into two terms of ``w``'s dtype, ``hi =
    h`` rounded and ``lo = h - hi`` rounded, stacked along the rows as
    ``[E, 2N, in]``, and one product with float32 sums gives both halves,
    which are added. The stacked weights are read once (a widened copy
    would cost 1.1 GB a deepseek-v2-lite layer); the rows' arithmetic
    doubles. ``hi + lo`` carries ``h`` to about 16 bits of mantissa. A
    quantized ``w`` goes through the kernel with its scales on each
    half."""
    dt = weight_dtype(w)
    hi = h.to(dt)
    lo = (h - hi.float()).to(dt)
    n = h.shape[1]
    rows = torch.cat([hi, lo], dim=1)
    out = _qbmm_f32(rows, w) if is_quantized(w) else _bmm_f32(rows, w)
    return out[:, :n] + out[:, n:]


def embed_lookup(embed, token_ids: torch.Tensor) -> torch.Tensor:
    """Embedding-table row gather, plain or per-row quantized (a gather,
    not a product: the rows dequantize where they land)."""
    if not is_quantized(embed):
        return embed[token_ids]
    q, s = embed["q"], embed["s"]
    rows = q.view(torch.uint8)[token_ids].view(q.dtype)
    return rows.to(s.dtype) * s[token_ids][..., None]


def tied_head_mm(h: torch.Tensor, embed) -> torch.Tensor:
    """``h @ embed.T`` (tied lm_head), float32 out (``head_mm``). A
    per-row quantized table ``[V, D]`` is the product's operand as it is
    stored (the kernel's transposed entry), its row scales per logit."""
    if not is_quantized(embed):
        return head_mm(h, embed.T)
    return _head_quantized(h, embed, transposed=True)


def head_mm(h: torch.Tensor, w) -> torch.Tensor:
    """The LM head ``h @ w`` with its sums and its output in float32 and
    the operands in ``w``'s dtype. A bf16 output would round the logits
    to steps of 1/32 at magnitudes of 4–8, coarser than the differences
    greedy sampling and the no-cache reference check look at. On the card
    one cuBLAS product with a float32 output (a quantized head: the
    kernel, float32 out); on the CPU the operands are widened first (the
    same products and sums)."""
    if is_quantized(w):
        return _head_quantized(h, w, transposed=False)
    lead = h.shape[:-1]
    h = h.reshape(-1, h.shape[-1]).to(w.dtype)
    if w.dtype == torch.float32:
        out = h @ w
    elif h.is_cuda:
        out = torch.mm(h, w, out_dtype=torch.float32)
    else:
        out = h.float() @ w.float()
    return out.reshape(*lead, -1)


def _head_quantized(h: torch.Tensor, w: dict, transposed: bool) -> torch.Tensor:
    """The quantized head in float32: ``(h @ deq(q)) * s`` with ``h`` in
    the scales' dtype; ``transposed``: ``q`` is the ``[V, D]`` table."""
    q, s = w["q"], w["s"]
    lead = h.shape[:-1]
    a = h.reshape(-1, h.shape[-1]).to(s.dtype)
    if a.is_cuda:
        out = wq_gemm_cuda(a.contiguous()[None], q[None], s[None],
                           out_dtype=torch.float32, transposed=transposed)[0]
    else:
        _plain_arm()
        qf = q.float().T if transposed else q.float()
        out = (a.float() @ qf) * s.float()
    return out.reshape(*lead, -1)


# ---------------------------------------------------------------------------
# Whole-tree quantization and the per-matmul policy (docs/architecture/
# weight_quant.md). The policy is duck-typed (models/llama.py
# WeightQuantPolicy): ``embedding``, ``attn``, ``mlp``, ``unembed``, each
# None (full precision) or a WEIGHT_FORMATS entry. These functions are
# the one mapping from policy sites to params keys, shared by random init,
# quantize-on-load and the runner.
# ---------------------------------------------------------------------------


def quantize_params(params: dict, include_lm_head: bool = True,
                    tie_embed: bool = False) -> dict:
    """The legacy whole-model int8 (``--quant int8``): every QUANT_KEYS
    weight; with ``tie_embed`` the table too, per row (it is the head's
    operand). The all-matmul policy, as the reference's init_params_int8
    spells it."""
    policy = SimpleNamespace(embedding="int8" if tie_embed else None, attn="int8",
                             mlp="int8", unembed="int8" if include_lm_head else None)
    return quantize_params_policy(params, policy)


def policy_layer_fmts(policy) -> dict[str, str]:
    """Per-layer params key → storage format under ``policy`` (the attn
    and mlp sites; the table and the head are top-level)."""
    fmts: dict[str, str] = {}
    if getattr(policy, "attn", None):
        fmts.update({k: policy.attn for k in ATTN_KEYS})
    if getattr(policy, "mlp", None):
        fmts.update({k: policy.mlp for k in MLP_KEYS})
    return fmts


def policy_top_fmts(policy, tie_embed: bool) -> tuple[str | None, str | None]:
    """(the table's format, the untied head's format) under ``policy``: a
    tied table takes ``embedding``'s format, else ``unembed``'s (it is
    the head's operand, so ``unembed`` alone must not be a no-op)."""
    unembed = getattr(policy, "unembed", None)
    embed = getattr(policy, "embedding", None) or (unembed if tie_embed else None)
    return embed, unembed


def quantize_layer(layer: dict, fmts: dict[str, str]) -> dict:
    """One layer's selected weights quantized (already quantized ones
    kept as they are)."""
    out = dict(layer)
    for k, fmt in fmts.items():
        if k in out and not is_quantized(out[k]):
            out[k] = quantize_weight(out[k], axis=QUANT_AXES.get(k, CONTRACT_AXIS), fmt=fmt)
    return out


def quantize_params_policy(params: dict, policy, tie_embed: bool = False) -> dict:
    """quantize_params with per-site selection: the table per row, the
    head per column. A weight already quantized (a tree quantized as it
    loaded) is kept."""
    fmts = policy_layer_fmts(policy)
    out = dict(params)
    out["layers"] = [quantize_layer(layer, fmts) for layer in params["layers"]]
    embed_fmt, unembed = policy_top_fmts(policy, tie_embed)
    if unembed and "lm_head" in params and not is_quantized(params["lm_head"]):
        out["lm_head"] = quantize_weight(params["lm_head"], fmt=unembed)
    if embed_fmt and not is_quantized(params["embed"]):
        out["embed"] = quantize_weight(params["embed"], axis=-1, fmt=embed_fmt)
    return out


def tree_leaves(params) -> list:
    """The params tree's leaves, a quantized dict as one leaf."""
    if is_quantized(params) or isinstance(params, torch.Tensor):
        return [params]
    items = params.values() if isinstance(params, dict) else params
    return [leaf for v in items for leaf in tree_leaves(v)]


def quant_tree_stats(params, dtype_bytes: int = 2) -> tuple[float, float]:
    """(bytes_saved, density) of a possibly-quantized params tree: the
    resident bytes saved against every parameter at ``dtype_bytes``, and
    the fraction of parameters stored quantized. Shapes and dtypes only:
    the leaves may be tensors on any device, or the meta device."""
    total = qcount = 0
    saved = 0.0
    for leaf in tree_leaves(params):
        if is_quantized(leaf):
            n = leaf["q"].numel()
            stored = (n * leaf["q"].element_size()
                      + leaf["s"].numel() * leaf["s"].element_size())
            saved += n * dtype_bytes - stored
            qcount += n
            total += n
        else:
            total += leaf.numel()
    return saved, (qcount / total if total else 0.0)


# ---------------------------------------------------------------------------
# KV-cache block quantization (port of dynamo_tpu/ops/quant.py
# ``quantize_kv_write``). The cache keeps its [num_slots, kvH, D] layout
# but stores int8; a per-(block, kv head) float32 scale rides beside it
# (``kv_scales: [num_layers, 2, num_blocks, kvH]``). Reads dequantize
# ``int8 * scale`` — in the CUDA kernel's registers and in the plain
# version's gathered page, with the same arithmetic.
#
# Write law:
#   - a step's new K/V values scatter-max a per-(block, head) amax;
#   - a block whose FIRST slot is written this step is fresh: its stale
#     scale (from a previous tenant of the physical block) resets;
#   - within an occupancy the scale only grows,
#     new_scale = max(old_scale, amax / 127); where it grows, the block's
#     existing int8 entries requantize by round(q * old / new), touched
#     blocks only;
#   - new values quantize at the new scale: clip(round(v / s), -127, 127).
# ---------------------------------------------------------------------------


def quantize_kv_write(
    cache: torch.Tensor,    # [num_slots, kvH, D] int8, written IN PLACE
    scales: torch.Tensor,   # [num_blocks, kvH] float32
    slots: torch.Tensor,    # [T] target slot per new token
    vals: torch.Tensor,     # [T, kvH, D] new K or V values
    block_size: int,
) -> torch.Tensor:
    """Scatter new K/V values into an int8 cache under per-block scales;
    returns the new scales. Padding rows aimed at trash block 0 churn
    only block 0, which no attention reads. Duplicate touched blocks
    write identical requantized rows, so their order cannot matter; the
    padding rows' values at block 0 may land in any order on the card."""
    num_blocks, kvH = scales.shape
    bs = block_size
    dev = cache.device
    vf = vals.float()
    slots = slots.long()
    blk = slots // bs                                        # [T]

    amax = torch.zeros((num_blocks, kvH), dtype=torch.float32, device=dev)
    amax.scatter_reduce_(
        0, blk[:, None].expand(-1, kvH), vf.abs().amax(dim=-1), "amax",
        include_self=True,
    )
    fresh = torch.zeros(num_blocks, dtype=torch.int32, device=dev)
    fresh.scatter_reduce_(
        0, blk, (slots % bs == 0).to(torch.int32), "amax", include_self=True
    )
    old = torch.where(fresh[:, None] > 0, 0.0, scales)
    new_scales = torch.maximum(old, amax / 127.0)

    ratio = torch.where(
        new_scales > 0, old / torch.clamp(new_scales, min=1e-30), 1.0
    )
    tslots = (blk[:, None] * bs + torch.arange(bs, device=dev)).reshape(-1)
    rows = cache[tslots].float()                             # [T*bs, kvH, D]
    cache[tslots] = torch.clamp(
        torch.round(rows * ratio[blk].repeat_interleave(bs, dim=0)[:, :, None]),
        -127, 127,
    ).to(torch.int8)

    s_at = new_scales[blk]                                   # [T, kvH]
    q = torch.clamp(
        torch.round(vf / torch.clamp(s_at, min=1e-30)[:, :, None]), -127, 127
    ).to(torch.int8)
    cache[slots] = torch.where((s_at > 0)[:, :, None], q, 0).to(torch.int8)
    return new_scales
