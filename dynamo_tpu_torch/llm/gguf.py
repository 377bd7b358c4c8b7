"""GGUF files: metadata, tensor index, embedded tokenizer and unquantized
weights (port of dynamo_tpu/llm/gguf.py, standard library + numpy +
torch).

A ``.gguf`` reference yields a ModelConfig, a deployment card, the
embedded tokenizer and, for F32/F16/BF16 files, the weights. Format
(little-endian): magic ``GGUF``, version (2/3), tensor count, metadata
count; then the typed metadata (nested arrays included), the tensor
infos (name, dims innermost first, ggml type, data offset), padding to
the alignment, and the tensor data. Quantized ggml types are indexed
but refused at load, by type. The writer builds fixtures: F16 and BF16
tensors keep their type, anything else is written as F32.
"""

from __future__ import annotations

import mmap
import os
import struct
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, BinaryIO, Sequence

import numpy as np
import torch

MAGIC = b"GGUF"
ALIGNMENT = 32

# metadata value types
U8, I8, U16, I16, U32, I32, F32, BOOL, STRING, ARRAY, U64, I64, F64 = range(13)

_SCALAR = {
    U8: "<B", I8: "<b", U16: "<H", I16: "<h", U32: "<I", I32: "<i",
    F32: "<f", U64: "<Q", I64: "<q", F64: "<d",
}

# ggml tensor types loaded without dequantization
GGML_F32, GGML_F16 = 0, 1
GGML_BF16 = 30
_TENSOR_DTYPE = {GGML_F32: torch.float32, GGML_F16: torch.float16, GGML_BF16: torch.bfloat16}
_GGML_OF = {dt: t for t, dt in _TENSOR_DTYPE.items()}


@dataclass
class TensorInfo:
    name: str
    shape: tuple[int, ...]   # logical shape, row-major (GGUF's dims reversed)
    ggml_type: int
    offset: int              # relative to the data section's start


@dataclass
class GgufFile:
    path: str
    metadata: dict[str, Any]
    tensors: dict[str, TensorInfo] = field(default_factory=dict)
    data_start: int = 0

    def load_tensor(self, name: str, device=None) -> torch.Tensor:
        """One tensor in its file type, copied from the mapped file
        straight to ``device`` (the host when None)."""
        info = self.tensors[name]
        if info.ggml_type not in _TENSOR_DTYPE:
            raise NotImplementedError(
                f"tensor {name!r} uses quantized ggml type {info.ggml_type}; "
                "dequantization is not supported — export an unquantized "
                "(F32/F16/BF16) GGUF or a safetensors checkout"
            )
        dt = _TENSOR_DTYPE[info.ggml_type]
        count = int(np.prod(info.shape)) if info.shape else 1
        start = self.data_start + info.offset
        if start + count * dt.itemsize > os.path.getsize(self.path):
            raise ValueError(f"tensor {name!r} runs past the end of {self.path}")
        if count == 0:
            return torch.empty(info.shape, dtype=dt, device=device)
        # A private copy-on-write map, as utils/safetensors.py reads.
        with open(self.path, "rb") as f, mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY) as mm:
            view = torch.frombuffer(mm, dtype=dt, count=count, offset=start)
            out = view.reshape(info.shape).to(device=device, copy=True)
            del view
        return out


# ---------------------------------------------------------------------------
# reader
# ---------------------------------------------------------------------------


def _read_str(f: BinaryIO) -> str:
    (n,) = struct.unpack("<Q", f.read(8))
    return f.read(n).decode("utf-8", errors="replace")


def _read_value(f: BinaryIO, vtype: int) -> Any:
    if vtype in _SCALAR:
        fmt = _SCALAR[vtype]
        (v,) = struct.unpack(fmt, f.read(struct.calcsize(fmt)))
        return v
    if vtype == BOOL:
        return bool(f.read(1)[0])
    if vtype == STRING:
        return _read_str(f)
    if vtype == ARRAY:
        (etype,) = struct.unpack("<I", f.read(4))
        (n,) = struct.unpack("<Q", f.read(8))
        return [_read_value(f, etype) for _ in range(n)]
    raise ValueError(f"bad GGUF metadata type {vtype}")


def read_gguf(path: str | Path, load_tensors_index: bool = True) -> GgufFile:
    path = str(path)
    with open(path, "rb") as f:
        if f.read(4) != MAGIC:
            raise ValueError(f"{path} is not a GGUF file")
        (version,) = struct.unpack("<I", f.read(4))
        if version < 2:
            raise ValueError(f"GGUF v{version} unsupported (need >= 2)")
        n_tensors, n_kv = struct.unpack("<QQ", f.read(16))
        meta: dict[str, Any] = {}
        for _ in range(n_kv):
            key = _read_str(f)
            (vtype,) = struct.unpack("<I", f.read(4))
            meta[key] = _read_value(f, vtype)
        gf = GgufFile(path=path, metadata=meta)
        if not load_tensors_index:
            return gf
        for _ in range(n_tensors):
            name = _read_str(f)
            (ndim,) = struct.unpack("<I", f.read(4))
            dims = struct.unpack(f"<{ndim}Q", f.read(8 * ndim))
            gtype, offset = struct.unpack("<IQ", f.read(12))
            gf.tensors[name] = TensorInfo(
                name=name, shape=tuple(reversed(dims)), ggml_type=gtype, offset=offset,
            )
        pos = f.tell()
        gf.data_start = (pos + ALIGNMENT - 1) // ALIGNMENT * ALIGNMENT
        return gf


# ---------------------------------------------------------------------------
# writer (fixtures)
# ---------------------------------------------------------------------------


def _vtype_of(v: Any) -> int:
    if isinstance(v, bool):
        return BOOL
    if isinstance(v, int):
        return I64 if v < 0 else U64
    if isinstance(v, float):
        return F64
    if isinstance(v, str):
        return STRING
    raise ValueError(f"can't encode {type(v)} in GGUF metadata")


def _write_str(f: BinaryIO, s: str) -> None:
    b = s.encode("utf-8")
    f.write(struct.pack("<Q", len(b)))
    f.write(b)


def _write_value(f: BinaryIO, v: Any, vtype: int | None = None) -> int:
    vtype = vtype if vtype is not None else _vtype_of(v)
    if vtype in _SCALAR:
        f.write(struct.pack(_SCALAR[vtype], v))
    elif vtype == BOOL:
        f.write(bytes([1 if v else 0]))
    elif vtype == STRING:
        _write_str(f, v)
    else:
        raise ValueError(f"bad scalar type {vtype}")
    return vtype


def _file_dtype(arr) -> torch.dtype:
    """The torch dtype a tensor is written in: F16/BF16 kept, the rest F32."""
    if arr.dtype in (torch.float16, torch.bfloat16):
        return arr.dtype
    return torch.float16 if arr.dtype == np.float16 else torch.float32


def _as_tensor(arr) -> torch.Tensor:
    t = arr if isinstance(arr, torch.Tensor) else torch.from_numpy(np.asarray(arr))
    return t.detach().to("cpu").to(_file_dtype(arr)).contiguous()


def write_gguf(
    path: str | Path,
    metadata: dict[str, Any],
    tensors: dict[str, Any] | None = None,
) -> None:
    tensors = tensors or {}
    # A fixture writer, streamed a tensor at a time (a device tensor is
    # copied to the host alone); the caller discards a partial file.
    with open(path, "wb") as f:
        f.write(MAGIC)
        f.write(struct.pack("<I", 3))
        f.write(struct.pack("<QQ", len(tensors), len(metadata)))
        for key, v in metadata.items():
            _write_str(f, key)
            if isinstance(v, (list, tuple)):
                f.write(struct.pack("<I", ARRAY))
                etype = _vtype_of(v[0]) if v else U64
                f.write(struct.pack("<IQ", etype, len(v)))
                for item in v:
                    _write_value(f, item, etype)
            else:
                vtype = _vtype_of(v)
                f.write(struct.pack("<I", vtype))
                _write_value(f, v, vtype)
        offset = 0
        infos = []
        for name, arr in tensors.items():
            shape, dt = tuple(arr.shape), _file_dtype(arr)
            nbytes = int(np.prod(shape)) * dt.itemsize
            _write_str(f, name)
            f.write(struct.pack("<I", len(shape)))
            f.write(struct.pack(f"<{len(shape)}Q", *reversed(shape)))
            f.write(struct.pack("<IQ", _GGML_OF[dt], offset))
            infos.append((offset, arr))
            offset += nbytes
            offset = (offset + ALIGNMENT - 1) // ALIGNMENT * ALIGNMENT
        pad = (-f.tell()) % ALIGNMENT
        f.write(b"\0" * pad)
        data_start = f.tell()
        for off, arr in infos:
            f.seek(data_start + off)
            t = _as_tensor(arr)
            if t.numel():
                f.write(t.reshape(-1).view(torch.uint8).numpy().tobytes())


# ---------------------------------------------------------------------------
# model config + tokenizer from metadata
# ---------------------------------------------------------------------------


def model_config_from_gguf(gf: GgufFile):
    """A ModelConfig from GGUF metadata (llama/qwen2/qwen3 families)."""
    from dynamo_tpu_torch.models.config import ModelConfig

    m = gf.metadata
    arch = m.get("general.architecture", "llama")

    def k(name: str, default=None):
        return m.get(f"{arch}.{name}", default)

    n_heads = int(k("attention.head_count", 32))
    hidden = int(k("embedding_length", 4096))
    vocab = m.get("tokenizer.ggml.tokens")
    vocab_size = int(k("vocab_size", len(vocab) if vocab else 32000))
    # GGUF convention: no separate output head tensor ⇒ tied embeddings.
    tied = bool(gf.tensors) and "output.weight" not in gf.tensors
    # Llama-3.1+ long-context rope scaling (llama.rope.scaling.* keys).
    scaling = None
    if k("rope.scaling.type") == "llama3" or (
        k("rope.scaling.type") is None and k("rope.scaling.factor") is not None
    ):
        from dynamo_tpu_torch.ops.rope import RopeScaling

        scaling = RopeScaling(
            factor=float(k("rope.scaling.factor", 8.0)),
            low_freq_factor=float(k("rope.scaling.low_freq_factor", 1.0)),
            high_freq_factor=float(k("rope.scaling.high_freq_factor", 4.0)),
            original_max_position=int(k("rope.scaling.original_context_length", 8192)),
        )
    return ModelConfig(
        rope_scaling=scaling,
        tie_word_embeddings=tied,
        name=m.get("general.name", arch),
        vocab_size=vocab_size,
        hidden_size=hidden,
        intermediate_size=int(k("feed_forward_length", 4 * hidden)),
        num_layers=int(k("block_count", 32)),
        num_heads=n_heads,
        num_kv_heads=int(k("attention.head_count_kv", n_heads)),
        head_dim=int(k("attention.key_length", hidden // n_heads)),
        rope_theta=float(k("rope.freq_base", 10000.0)),
        rms_eps=float(k("attention.layer_norm_rms_epsilon", 1e-5)),
        max_position=int(k("context_length", 8192)),
        qkv_bias=arch == "qwen2",
        qk_norm=arch == "qwen3",
        sliding_window=int(k("attention.sliding_window", 0) or 0),
    )


def bytes_to_unicode() -> dict[int, str]:
    """GPT-2's reversible byte→unicode table (byte-level BPE vocabularies
    store token strings in this mapped space: 'Ġ' is the space)."""
    bs = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("¡"), ord("¬") + 1))
        + list(range(ord("®"), ord("ÿ") + 1))
    )
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, map(chr, cs)))


class GgufTokenizer:
    """The tokenizer of a GGUF's embedded vocabulary, in either flavour
    ``tokenizer.ggml.model`` names:

    - ``llama`` (SentencePiece): '▁' word boundaries, <0xNN> byte tokens;
    - ``gpt2`` (byte-level BPE, llama3/qwen2 files): token strings in the
      GPT-2 byte→unicode mapped space ('Ġ' = space).

    Encoding is greedy longest match over the vocabulary, as the
    reference encodes: it round-trips text; merge-exact ids are the HF
    tokenizer's, where a checkout has one.
    """

    SPACE = "▁"

    def __init__(self, gf: GgufFile) -> None:
        from dynamo_tpu_torch.llm.tokenizer import chat_template

        m = gf.metadata
        self.tokens: list[str] = list(m.get("tokenizer.ggml.tokens") or [])
        if not self.tokens:
            raise ValueError("GGUF file has no embedded tokenizer")
        self.vocab_size = len(self.tokens)
        self._index = {t: i for i, t in enumerate(self.tokens)}
        model = m.get("tokenizer.ggml.model")
        if model is None:  # files that omit the key
            model = "gpt2" if any(t.startswith("Ġ") for t in self.tokens) else "llama"
        self.is_bpe = model == "gpt2"
        self._b2u = bytes_to_unicode()
        self._u2b = {u: b for b, u in self._b2u.items()}
        self._byte_ids = {}
        for i, t in enumerate(self.tokens):
            if len(t) == 6 and t.startswith("<0x") and t.endswith(">"):
                self._byte_ids[int(t[3:5], 16)] = i
        self._max_len = max(len(t) for t in self.tokens)
        self.bos_token_id = m.get("tokenizer.ggml.bos_token_id")
        eos = m.get("tokenizer.ggml.eos_token_id")
        self.eos_token_ids = [int(eos)] if eos is not None else []
        self._template = chat_template(m.get("tokenizer.chat_template"))

    def _greedy(self, s: str, byte_fallback) -> list[int]:
        out: list[int] = []
        i = 0
        while i < len(s):
            for ln in range(min(self._max_len, len(s) - i), 0, -1):
                tid = self._index.get(s[i : i + ln])
                if tid is not None:
                    out.append(tid)
                    i += ln
                    break
            else:
                out.extend(byte_fallback(s[i]))
                i += 1
        return out

    def encode(self, text: str) -> list[int]:
        if self.is_bpe:
            s = "".join(self._b2u[b] for b in text.encode("utf-8"))
            # Every mapped byte is normally in a BPE vocabulary; a miss
            # (a truncated fixture vocabulary) is skipped.
            return self._greedy(s, lambda ch: [])
        s = self.SPACE + text.replace(" ", self.SPACE)
        return self._greedy(
            s,
            lambda ch: [self._byte_ids[b] for b in ch.encode("utf-8") if b in self._byte_ids],
        )

    def _piece(self, tid: int) -> bytes:
        if not 0 <= tid < self.vocab_size:
            return b""
        t = self.tokens[tid]
        if self.is_bpe:
            return bytes(self._u2b[ch] for ch in t if ch in self._u2b)
        if len(t) == 6 and t.startswith("<0x") and t.endswith(">"):
            return bytes([int(t[3:5], 16)])
        return t.replace(self.SPACE, " ").encode("utf-8")

    def decode(self, ids: Sequence[int]) -> str:
        text = b"".join(self._piece(t) for t in ids).decode("utf-8", errors="replace")
        # SPM's '▁' prefix gives a leading space; BPE text round-trips
        # exactly and is not trimmed.
        if not self.is_bpe and text.startswith(" "):
            return text[1:]
        return text

    def decode_stream(self):
        outer = self

        class _Stream:
            def __init__(self) -> None:
                self._buf = b""
                self._first = True

            def step(self, token_id: int) -> str | None:
                self._buf += outer._piece(token_id)
                try:
                    text = self._buf.decode("utf-8")
                except UnicodeDecodeError:
                    return None  # partial multibyte sequence: hold
                self._buf = b""
                if self._first:
                    self._first = False
                    if not outer.is_bpe and text.startswith(" "):
                        text = text[1:]
                return text or None

        return _Stream()

    def apply_chat_template(
        self,
        messages: list[dict],
        add_generation_prompt: bool = True,
        tools: list[dict] | None = None,
    ) -> str:
        return self._template.render(messages, add_generation_prompt, tools=tools)


# ---------------------------------------------------------------------------
# weights (unquantized files)
# ---------------------------------------------------------------------------

LAYER_MAP = {
    "wq": "attn_q", "wk": "attn_k", "wv": "attn_v", "wo": "attn_output",
    "w_gate": "ffn_gate", "w_up": "ffn_up", "w_down": "ffn_down",
}


def load_gguf_weights(cfg, gf: GgufFile, dtype: torch.dtype | str = torch.bfloat16,
                      device=None):
    """The params of an unquantized GGUF (F32/F16/BF16 tensors). GGML 2-D
    tensors are [out, in] after the dim reversal: each moves to
    ``device`` (default: the card) as it is read and is transposed to the
    [in, out] layout there, as the safetensors path does."""
    from dynamo_tpu_torch import resolve_device

    device = resolve_device(device)
    if isinstance(dtype, str):
        dtype = getattr(torch, dtype)

    def w(name: str, transpose: bool = True) -> torch.Tensor:
        t = gf.load_tensor(name, device)
        if transpose and t.ndim == 2:
            t = t.t()
        return t.to(dtype).contiguous()

    layers = []
    for i in range(cfg.num_layers):
        layer = {our: w(f"blk.{i}.{theirs}.weight") for our, theirs in LAYER_MAP.items()}
        layer["ln_attn"] = w(f"blk.{i}.attn_norm.weight", transpose=False)
        layer["ln_mlp"] = w(f"blk.{i}.ffn_norm.weight", transpose=False)
        if cfg.qkv_bias:
            for our, theirs in (("bq", "attn_q"), ("bk", "attn_k"), ("bv", "attn_v")):
                layer[our] = w(f"blk.{i}.{theirs}.bias", transpose=False)
        if cfg.qk_norm:
            # Qwen3's per-head q/k RMSNorm gains (blk.N.attn_q_norm).
            layer["ln_q_head"] = w(f"blk.{i}.attn_q_norm.weight", transpose=False)
            layer["ln_k_head"] = w(f"blk.{i}.attn_k_norm.weight", transpose=False)
        layers.append(layer)
    params = {
        "embed": w("token_embd.weight", transpose=False),
        "layers": layers,
        "ln_f": w("output_norm.weight", transpose=False),
    }
    if "output.weight" in gf.tensors:
        params["lm_head"] = w("output.weight")
    return params


def gguf_tensors(cfg, params) -> dict[str, torch.Tensor]:
    """The inverse of ``load_gguf_weights``: the port's params as GGUF
    tensors ([out, in] views), for fixtures and the chip check."""
    out = {"token_embd.weight": params["embed"], "output_norm.weight": params["ln_f"]}
    if "lm_head" in params:
        out["output.weight"] = params["lm_head"].t()
    for i, layer in enumerate(params["layers"]):
        for our, theirs in LAYER_MAP.items():
            out[f"blk.{i}.{theirs}.weight"] = layer[our].t()
        out[f"blk.{i}.attn_norm.weight"] = layer["ln_attn"]
        out[f"blk.{i}.ffn_norm.weight"] = layer["ln_mlp"]
        for our, theirs in (("bq", "attn_q"), ("bk", "attn_k"), ("bv", "attn_v")):
            if our in layer:
                out[f"blk.{i}.{theirs}.bias"] = layer[our]
        if "ln_q_head" in layer:
            out[f"blk.{i}.attn_q_norm.weight"] = layer["ln_q_head"]
            out[f"blk.{i}.attn_k_norm.weight"] = layer["ln_k_head"]
    return out
