"""Write model checkouts from a params tree: the HF layout (config.json,
safetensors shards with their index, tokenizer.json, tokenizer_config.json,
generation_config.json) and GGUF files with an embedded vocabulary. The
tests and ``chip_smoke.py`` serve from what this writes; nothing here is
downloaded.

The tokenizer is a Llama-3-style byte-level BPE written with the
standard library: merges learned from a fixed text by counting pairs
(the most frequent pair first, ties to the smallest), the Llama-3 Split
pattern, Llama-3's special tokens and chat template. ``filler`` ids up to
a vocabulary size are ASCII strings, so every id of a full-width
vocabulary decodes to text.

    python -m dynamo_tpu_torch.tools.write_checkout DIR [--preset NAME]
        [--layers N] [--dtype bfloat16] [--shards 2] [--gguf FILE]

writes a checkout of a preset's seeded random weights (on the CPU).
"""

from __future__ import annotations

import argparse
import itertools
import json
import os
import re
import string
from collections import Counter
from pathlib import Path

import torch

from dynamo_tpu_torch.llm.gguf import bytes_to_unicode, gguf_tensors, write_gguf
from dynamo_tpu_torch.llm.hf_tokenizer import translate_regex
from dynamo_tpu_torch.models.config import ModelConfig, to_hf_config
from dynamo_tpu_torch.models.llama import hf_tensors
from dynamo_tpu_torch.utils import safetensors as st

LLAMA3_PATTERN = (
    r"(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\p{L}\p{N}]?\p{L}+|\p{N}{1,3}"
    r"| ?[^\s\p{L}\p{N}]+[\r\n]*|\s*[\r\n]+|\s+(?!\S)|\s+"
)
SPECIALS = ("<|begin_of_text|>", "<|end_of_text|>", "<|start_header_id|>",
            "<|end_header_id|>", "<|eot_id|>", "<|eom_id|>", "<|python_tag|>")
# Llama-3's template shape (the header tokens, a trimmed content, the
# end-of-turn token), rendered as jinja2 renders the file's own.
LLAMA3_CHAT_TEMPLATE = (
    "{{ '<|begin_of_text|>' }}{% for message in messages %}"
    "{{ '<|start_header_id|>' + message['role'] + '<|end_header_id|>\n\n'"
    " + message['content'] | trim + '<|eot_id|>' }}{% endfor %}"
    "{% if add_generation_prompt %}"
    "{{ '<|start_header_id|>assistant<|end_header_id|>\n\n' }}{% endif %}"
)
TRAIN_TEXT = (
    "The quick brown fox jumps over the lazy dog. Serving a model from its "
    "files reads the weights, the vocabulary and the config with nothing but "
    "the standard library, numpy and torch. It's 2048 wide, isn't it? We'll "
    "see: 16 layers, 32 heads, 8 key-value heads and 128256 tokens.\n"
    "def main():\n    return sum(x * x for x in range(10))\n"
    "Über naïve café, 東京, emoji 🙂 and tabs\tand  spaces.\n"
) * 4


def train_bpe(text: str, merges: int, pattern: str = LLAMA3_PATTERN) -> tuple[list[str], list[str]]:
    """(the 256 byte symbols then one symbol per merge, the merges as
    "a b") learned from ``text`` split by ``pattern``."""
    b2u = bytes_to_unicode()
    symbols = [b2u[b] for b in range(256)]
    words = Counter(
        tuple(b2u[b] for b in w.encode("utf-8"))
        for w in re.findall(translate_regex(pattern), text)
    )
    out: list[str] = []
    for _ in range(merges):
        pairs: Counter = Counter()
        for w, n in words.items():
            for pair in zip(w, w[1:]):
                pairs[pair] += n
        if not pairs:
            break
        best = min(pairs, key=lambda p: (-pairs[p], p))
        merged = best[0] + best[1]
        out.append(f"{best[0]} {best[1]}")
        symbols.append(merged)
        new_words: Counter = Counter()
        for w, n in words.items():
            i, nw = 0, []
            while i < len(w):
                if i + 1 < len(w) and (w[i], w[i + 1]) == best:
                    nw.append(merged)
                    i += 2
                else:
                    nw.append(w[i])
                    i += 1
            new_words[tuple(nw)] += n
        words = new_words
    return symbols, out


def _filler():
    """ASCII token strings (in the byte-mapped space, 'Ġ' for a space)."""
    b2u = bytes_to_unicode()
    chars = string.ascii_letters + string.digits + " "
    for n in itertools.count(2):
        for combo in itertools.product(chars, repeat=n):
            yield "".join(b2u[ord(c)] for c in combo)


def llama3_tokenizer(vocab_size: int, merges: int = 200, text: str = TRAIN_TEXT) -> dict:
    """A tokenizer.json of ``vocab_size`` ids: the learned BPE (at most
    ``merges`` merges, fewer where the vocabulary is small), ASCII
    filler, and Llama-3's special tokens (then reserved ones) at the top
    ids, as Llama-3 places them."""
    specials = list(SPECIALS)
    n_special = max(len(specials), min(256, vocab_size // 64))
    specials += [f"<|reserved_special_token_{i}|>" for i in range(n_special - len(specials))]
    n_model = vocab_size - len(specials)
    if n_model < 256:
        raise ValueError(f"vocab_size {vocab_size} < {256 + len(specials)}")
    symbols, merge_list = train_bpe(text, min(merges, n_model - 256))
    vocab = {s: i for i, s in enumerate(symbols)}
    fill = _filler()
    while len(vocab) < n_model:
        t = next(fill)
        if t not in vocab:
            vocab[t] = len(vocab)
    added = [{"id": n_model + i, "content": s, "single_word": False, "lstrip": False,
              "rstrip": False, "normalized": False, "special": True}
             for i, s in enumerate(specials)]
    return {
        "version": "1.0", "truncation": None, "padding": None,
        "added_tokens": added,
        "normalizer": None,
        "pre_tokenizer": {"type": "Sequence", "pretokenizers": [
            {"type": "Split", "pattern": {"Regex": LLAMA3_PATTERN},
             "behavior": "Isolated", "invert": False},
            {"type": "ByteLevel", "add_prefix_space": False, "trim_offsets": True,
             "use_regex": False}]},
        "post_processor": None,
        "decoder": {"type": "ByteLevel", "add_prefix_space": True, "trim_offsets": True,
                    "use_regex": True},
        "model": {"type": "BPE", "dropout": None, "unk_token": None,
                  "continuing_subword_prefix": None, "end_of_word_suffix": None,
                  "fuse_unk": False, "byte_fallback": False, "ignore_merges": True,
                  "vocab": vocab, "merges": merge_list},
    }


def _shard(tensors: dict, shards: int) -> list[list[str]]:
    """Names split into ``shards`` runs of about equal bytes, in order."""
    total = sum(t.numel() * t.element_size() for t in tensors.values())
    out, cur, acc = [], [], 0
    for name, t in tensors.items():
        cur.append(name)
        acc += t.numel() * t.element_size()
        if acc >= total * (len(out) + 1) / shards and len(out) < shards - 1:
            out.append(cur)
            cur = []
    out.append(cur)
    return [s for s in out if s]


def write_weights(model_dir, cfg: ModelConfig, params, dtype: torch.dtype | None = None,
                  shards: int = 1) -> int:
    """config.json and the safetensors shards (with
    ``model.safetensors.index.json`` when there is more than one), each
    tensor cast to ``dtype`` as it is written; returns the bytes."""
    model_dir = Path(model_dir)
    model_dir.mkdir(parents=True, exist_ok=True)
    (model_dir / "config.json").write_text(json.dumps(to_hf_config(cfg), indent=2))
    tensors = hf_tensors(cfg, params)
    if dtype is not None:
        tensors = {k: _Cast(v, dtype) for k, v in tensors.items()}
    groups = _shard(tensors, shards)
    weight_map, nbytes = {}, 0
    for k, names in enumerate(groups):
        fname = (f"model-{k + 1:05d}-of-{len(groups):05d}.safetensors" if len(groups) > 1
                 else "model.safetensors")
        nbytes += st.save_file({n: tensors[n] for n in names}, model_dir / fname,
                               metadata={"format": "pt"})
        weight_map.update({n: fname for n in names})
    if len(groups) > 1:
        (model_dir / st.INDEX_FILE).write_text(json.dumps(
            {"metadata": {"total_size": nbytes}, "weight_map": weight_map}, indent=2))
    return nbytes


class _Cast:
    """A tensor cast to a dtype when it is written (one at a time)."""

    def __init__(self, t: torch.Tensor, dtype: torch.dtype) -> None:
        self.t, self.dtype, self.shape = t, dtype, t.shape

    def numel(self) -> int:
        return self.t.numel()

    def element_size(self) -> int:
        return self.dtype.itemsize

    def detach(self):
        return self.t.detach().to(self.dtype)


def write_tokenizer(model_dir, tok_json: dict, eos_ids: list[int],
                    template: str = LLAMA3_CHAT_TEMPLATE) -> None:
    """tokenizer.json, tokenizer_config.json (chat template, bos/eos) and
    generation_config.json (``eos_ids``)."""
    model_dir = Path(model_dir)
    model_dir.mkdir(parents=True, exist_ok=True)
    (model_dir / "tokenizer.json").write_text(json.dumps(tok_json, ensure_ascii=False))
    by_content = {t["content"]: t["id"] for t in tok_json["added_tokens"]}
    eos = next((t for t, i in by_content.items() if i == eos_ids[0]), "<|eot_id|>")
    (model_dir / "tokenizer_config.json").write_text(json.dumps({
        "bos_token": "<|begin_of_text|>", "eos_token": eos, "chat_template": template,
        "tokenizer_class": "PreTrainedTokenizerFast"}, indent=2))
    (model_dir / "generation_config.json").write_text(json.dumps({
        "bos_token_id": by_content.get("<|begin_of_text|>"), "eos_token_id": eos_ids},
        indent=2))


def gguf_vocab(tok_json: dict) -> list[str]:
    """Token strings by id, every id of the vocabulary."""
    by_id = {i: t for t, i in tok_json["model"]["vocab"].items()}
    by_id.update({t["id"]: t["content"] for t in tok_json["added_tokens"]})
    return [by_id.get(i, f"<|unused_{i}|>") for i in range(max(by_id) + 1)]


def write_gguf_checkout(path, cfg: ModelConfig, params, tok_json: dict, eos_id: int,
                        dtype: torch.dtype = torch.float16) -> int:
    """A llama-architecture GGUF: metadata, the byte-level vocabulary
    (``tokenizer.ggml.model`` gpt2) and the tensors in ``dtype``; returns
    the file's bytes."""
    meta = {
        "general.architecture": "llama",
        "general.name": cfg.name,
        "llama.embedding_length": cfg.hidden_size,
        "llama.feed_forward_length": cfg.intermediate_size,
        "llama.block_count": cfg.num_layers,
        "llama.attention.head_count": cfg.num_heads,
        "llama.attention.head_count_kv": cfg.num_kv_heads,
        "llama.attention.key_length": cfg.head_dim,
        "llama.attention.layer_norm_rms_epsilon": cfg.rms_eps,
        "llama.rope.freq_base": cfg.rope_theta,
        "llama.context_length": cfg.max_position,
        "llama.vocab_size": cfg.vocab_size,
        "tokenizer.ggml.model": "gpt2",
        "tokenizer.ggml.tokens": gguf_vocab(tok_json),
        "tokenizer.ggml.eos_token_id": eos_id,
        "tokenizer.chat_template": LLAMA3_CHAT_TEMPLATE,
    }
    sc = cfg.rope_scaling
    if sc is not None and sc.kind == "llama3":
        meta.update({
            "llama.rope.scaling.type": "llama3", "llama.rope.scaling.factor": sc.factor,
            "llama.rope.scaling.low_freq_factor": sc.low_freq_factor,
            "llama.rope.scaling.high_freq_factor": sc.high_freq_factor,
            "llama.rope.scaling.original_context_length": sc.original_max_position,
        })
    tensors = {k: v.to(dtype) if v.dtype != dtype else v
               for k, v in gguf_tensors(cfg, params).items()}
    write_gguf(path, meta, tensors)
    return os.path.getsize(path)


def main(argv=None) -> None:
    from dynamo_tpu_torch.models import llama
    from dynamo_tpu_torch.models.config import PRESETS

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("dir")
    ap.add_argument("--preset", default="tiny-test")
    ap.add_argument("--layers", type=int, default=None)
    ap.add_argument("--dtype", default="bfloat16")
    ap.add_argument("--shards", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--gguf", default=None, metavar="FILE")
    args = ap.parse_args(argv)
    cfg = PRESETS[args.preset]()
    if args.layers:
        cfg = cfg.scaled(num_layers=args.layers)
    g = torch.Generator().manual_seed(args.seed)
    dtype = getattr(torch, args.dtype)
    params = llama.init_params(cfg, g, dtype=dtype, device="cpu")
    n = write_weights(args.dir, cfg, params, shards=args.shards)
    tok = llama3_tokenizer(cfg.vocab_size)
    eos = [t["id"] for t in tok["added_tokens"] if t["content"] in ("<|end_of_text|>", "<|eot_id|>")]
    write_tokenizer(args.dir, tok, eos)
    print(f"wrote {n} bytes of weights to {args.dir}")
    if args.gguf:
        print(f"wrote {write_gguf_checkout(args.gguf, cfg, params, tok, eos[0])} bytes to "
              f"{args.gguf}")


if __name__ == "__main__":
    main()
