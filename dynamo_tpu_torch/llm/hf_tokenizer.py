"""A reader of HF ``tokenizer.json`` files, written on the standard
library (the role ``tokenizers.Tokenizer.from_file`` plays for
dynamo_tpu/llm/tokenizer.py).

The subset is what current Llama-3, Qwen2/3, Mistral, Gemma-3 and
DeepSeek files use, with the Rust crate's semantics:

- model ``BPE``: merges as ``"a b"`` strings or ``[a, b]`` pairs, the
  lowest-rank pair merged first (ties to the leftmost), ``ignore_merges``,
  ``byte_fallback`` (``<0xNN>`` tokens), ``unk_token`` and ``fuse_unk``,
  ``continuing_subword_prefix``/``end_of_word_suffix``;
- added tokens split out first (leftmost-longest), honouring
  ``special``, ``lstrip``, ``rstrip``, ``single_word`` and ``normalized``
  (a normalized token is matched on the normalized text);
- normalizers ``NFC``, ``NFKC``, ``Prepend``, ``Replace``, ``Sequence``;
- pre-tokenizers ``ByteLevel`` (``add_prefix_space``, ``use_regex``),
  ``Split`` (regex or string, every ``behavior``, ``invert``),
  ``Metaspace`` (``prepend_scheme`` or the older ``add_prefix_space``,
  ``split``), ``Digits``, ``Sequence``;
- decoders ``ByteLevel``, ``ByteFallback``, ``Fuse``, ``Replace``,
  ``Strip``, ``Metaspace``, ``Sequence``;
- ``DecodeStream``'s step, chunk for chunk.

Anything else raises, naming the component. The files' regexes are
Oniguruma's: ``\\p{L}``-style classes become character classes built
once from ``unicodedata`` categories, and ``\\s``/``\\S`` the Unicode
White_Space set (Python's own ``\\s`` adds U+001C..U+001F).
"""

from __future__ import annotations

import heapq
import json
import os
import re
import sys
import unicodedata
from functools import lru_cache
from pathlib import Path
from typing import Sequence

from dynamo_tpu_torch.llm.gguf import bytes_to_unicode

# Unicode's White_Space property (Rust's char::is_whitespace, Oniguruma's \s).
WHITE_SPACE = "".join(map(chr, (
    *range(0x09, 0x0E), 0x20, 0x85, 0xA0, 0x1680, *range(0x2000, 0x200B),
    0x2028, 0x2029, 0x202F, 0x205F, 0x3000,
)))
_WS_SET = frozenset(WHITE_SPACE)
_B2U = bytes_to_unicode()
_U2B = {u: b for b, u in _B2U.items()}
# The Rust crate caches words up to this many characters.
_CACHE_WORD_CHARS = 256
_CACHE_ENTRIES = 100_000


class UnsupportedTokenizer(ValueError):
    """A tokenizer.json component outside the served subset."""


def _unsupported(kind: str, what) -> UnsupportedTokenizer:
    return UnsupportedTokenizer(f"tokenizer.json {kind} {what!r} is not supported")


# -- regex translation ------------------------------------------------------


def _class_body(chars: list[int]) -> str:
    """A character-class body (no brackets) of sorted code points."""
    out, i = [], 0
    while i < len(chars):
        j = i
        while j + 1 < len(chars) and chars[j + 1] == chars[j] + 1:
            j += 1
        lo, hi = chars[i], chars[j]
        out.append(re.escape(chr(lo)) if lo == hi else f"{re.escape(chr(lo))}-{re.escape(chr(hi))}")
        i = j + 1
    return "".join(out)


@lru_cache(maxsize=None)
def _categories() -> dict[str, list[int]]:
    cats: dict[str, list[int]] = {}
    for cp in range(sys.maxunicode + 1):
        cats.setdefault(unicodedata.category(chr(cp)), []).append(cp)
    return cats


@lru_cache(maxsize=None)
def _property_body(name: str) -> str:
    """The class body of ``\\p{name}``: a one-letter general category
    (L, N, P, S, M, Z, C) or a two-letter one (Lu, Nd, ...)."""
    cats = _categories()
    if len(name) == 1:
        cps = sorted(cp for cat, cps in cats.items() if cat[0] == name for cp in cps)
    elif name in cats:
        cps = cats[name]
    else:
        cps = []
    if not cps or name == "Cs":
        raise _unsupported("regex property", "\\p{" + name + "}")
    return _class_body(cps)


_WS_BODY = _class_body(sorted(ord(c) for c in WHITE_SPACE))


def translate_regex(pattern: str) -> str:
    """An Oniguruma pattern of the files in Python ``re`` syntax:
    ``\\p{X}``/``\\P{X}``, ``\\s``/``\\S`` rewritten, the rest kept."""
    out, i, in_class = [], 0, False
    while i < len(pattern):
        c = pattern[i]
        if c == "\\" and i + 1 < len(pattern):
            n = pattern[i + 1]
            if n in "pP":
                m = re.match(r"\{([A-Za-z]+)\}", pattern[i + 2:])
                if not m:
                    raise _unsupported("regex escape", pattern[i:i + 6])
                name = m.group(1)
                negated = n == "P"
                body = _property_body(name)
                if in_class:
                    if negated:
                        raise _unsupported("regex construct", f"negated \\p{{{name}}} in a class")
                    out.append(body)
                else:
                    out.append(f"[{'^' if negated else ''}{body}]")
                i += 2 + m.end()
                continue
            if n in "sS":
                if in_class:
                    if n == "S":
                        raise _unsupported("regex construct", "\\S inside a class")
                    out.append(_WS_BODY)
                else:
                    out.append(f"[{'^' if n == 'S' else ''}{_WS_BODY}]")
                i += 2
                continue
            out.append(pattern[i:i + 2])
            i += 2
            continue
        if c == "[" and not in_class:
            in_class = True
            out.append(c)
            i += 1
            # A ']' or '^]' right after the opening bracket is literal.
            if pattern[i:i + 1] == "^":
                out.append("^")
                i += 1
            if pattern[i:i + 1] == "]":
                out.append("\\]")
                i += 1
            continue
        if c == "[" and in_class:
            raise _unsupported("regex construct", "nested character class")
        if c == "]" and in_class:
            in_class = False
        out.append(c)
        i += 1
    return "".join(out)


def _compile_pattern(spec: dict, kind: str) -> re.Pattern:
    if "Regex" in spec:
        return re.compile(translate_regex(spec["Regex"]))
    if "String" in spec:
        return re.compile(re.escape(spec["String"]))
    raise _unsupported(f"{kind} pattern", spec)


# -- pieces -----------------------------------------------------------------
# A piece is (text, at_start): at_start says whether it begins at the
# original text's offset 0 (Metaspace's prepend_scheme "first").


def _find_matches(pattern: re.Pattern, text: str) -> list[tuple[int, int, bool]]:
    if not text:
        return [(0, 0, False)]
    out, prev = [], 0
    for m in pattern.finditer(text):
        start, end = m.span()
        if prev != start:
            out.append((prev, start, False))
        out.append((start, end, True))
        prev = end
    if prev != len(text):
        out.append((prev, len(text), False))
    return out


def _split(text: str, matches: list[tuple[int, int, bool]], behavior: str) -> list[tuple[int, int]]:
    """The crate's NormalizedString::split: (start, end) of each kept
    piece, empty ones included (the caller drops them)."""
    if behavior == "Isolated":
        return [(s, e) for s, e, _ in matches]
    if behavior == "Removed":
        return [(s, e) for s, e, is_match in matches if not is_match]
    acc: list[list[int]] = []
    prev_match = False
    if behavior == "Contiguous":
        for s, e, is_match in matches:
            if is_match == prev_match and acc:
                acc[-1][1] = e
            else:
                acc.append([s, e])
            prev_match = is_match
        return [tuple(a) for a in acc]
    if behavior == "MergedWithPrevious":
        for s, e, is_match in matches:
            if is_match and not prev_match and acc:
                acc[-1][1] = e
            else:
                acc.append([s, e])
            prev_match = is_match
        return [tuple(a) for a in acc]
    if behavior == "MergedWithNext":
        for s, e, is_match in reversed(matches):
            if is_match and not prev_match and acc:
                acc[-1][0] = s
            else:
                acc.append([s, e])
            prev_match = is_match
        return [tuple(a) for a in reversed(acc)]
    raise _unsupported("split behavior", behavior)


def _split_pieces(pieces, fn):
    """Apply ``fn(text, at_start) -> [(text, at_start)]`` to each piece;
    empty results are dropped, as PreTokenizedString::split drops them."""
    out = []
    for text, at_start in pieces:
        out.extend(p for p in fn(text, at_start) if p[0])
    return out


def _cut(text: str, at_start: bool, spans) -> list[tuple[str, bool]]:
    return [(text[s:e], at_start and s == 0) for s, e in spans]


# -- normalizers ------------------------------------------------------------


def _normalizer(spec: dict | None):
    if spec is None:
        return None
    kind = spec.get("type")
    if kind == "Sequence":
        parts = [_normalizer(n) for n in spec["normalizers"]]

        def seq(text):
            for p in parts:
                text = p(text)
            return text
        return seq
    if kind in ("NFC", "NFKC"):
        return lambda text: unicodedata.normalize(kind, text)
    if kind == "Prepend":
        prefix = spec["prepend"]
        return lambda text: prefix + text if text else text
    if kind == "Replace":
        pat, content = _compile_pattern(spec["pattern"], "Replace"), spec["content"]
        return lambda text: pat.sub(lambda m: content, text)
    raise _unsupported("normalizer", kind)


# -- pre-tokenizers ---------------------------------------------------------

# GPT-2's pattern, ByteLevel's use_regex split.
GPT2_PATTERN = (
    r"'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+| ?[^\s\p{L}\p{N}]+|\s+(?!\S)|\s+"
)


def _byte_map(text: str) -> str:
    return "".join(_B2U[b] for b in text.encode("utf-8"))


def _pre_tokenizer(spec: dict | None):
    """``fn(pieces) -> pieces`` over (text, at_start) pieces."""
    if spec is None:
        return None
    kind = spec.get("type")
    if kind == "Sequence":
        parts = [_pre_tokenizer(p) for p in spec["pretokenizers"]]

        def seq(pieces):
            for p in parts:
                pieces = p(pieces)
            return pieces
        return seq
    if kind == "ByteLevel":
        prefix = spec.get("add_prefix_space", True)
        pattern = re.compile(translate_regex(GPT2_PATTERN)) if spec.get("use_regex", True) else None

        def byte_level(pieces):
            def one(text, at_start):
                if prefix and not text.startswith(" "):
                    text = " " + text
                if pattern is None:
                    return [(text, at_start)]
                return _cut(text, at_start, _split(text, _find_matches(pattern, text), "Isolated"))
            return [(_byte_map(t), s) for t, s in _split_pieces(pieces, one)]
        return byte_level
    if kind == "Split":
        pattern = _compile_pattern(spec["pattern"], "Split")
        behavior, invert = spec.get("behavior", "Isolated"), spec.get("invert", False)

        def split(pieces):
            def one(text, at_start):
                matches = _find_matches(pattern, text)
                if invert:
                    matches = [(s, e, not m) for s, e, m in matches]
                return _cut(text, at_start, _split(text, matches, behavior))
            return _split_pieces(pieces, one)
        return split
    if kind == "Metaspace":
        rep = spec.get("replacement", "▁")
        scheme = spec.get("prepend_scheme")
        if scheme is None:
            scheme = "always" if spec.get("add_prefix_space", True) else "never"
        if scheme not in ("always", "first", "never"):
            raise _unsupported("Metaspace prepend_scheme", scheme)
        do_split = spec.get("split", True)
        pattern = re.compile(re.escape(rep))

        def metaspace(pieces):
            def one(text, at_start):
                text = text.replace(" ", rep)
                if not text.startswith(rep) and (
                        scheme == "always" or (scheme == "first" and at_start)):
                    text = rep + text
                if not do_split:
                    return [(text, at_start)]
                return _cut(text, at_start,
                            _split(text, _find_matches(pattern, text), "MergedWithNext"))
            return _split_pieces(pieces, one)
        return metaspace
    if kind == "Digits":
        behavior = "Isolated" if spec.get("individual_digits", False) else "Contiguous"

        def digits(pieces):
            def one(text, at_start):
                return _cut(text, at_start, _split(text, _numeric_matches(text), behavior))
            return _split_pieces(pieces, one)
        return digits
    raise _unsupported("pre_tokenizer", kind)


def _numeric_matches(text: str) -> list[tuple[int, int, bool]]:
    """Each numeric character (Rust's char::is_numeric: Nd, Nl, No) a
    match of its own, the runs between them not."""
    if not text:
        return [(0, 0, False)]
    out, prev = [], 0
    for i, ch in enumerate(text):
        if unicodedata.category(ch)[0] == "N":
            if prev != i:
                out.append((prev, i, False))
            out.append((i, i + 1, True))
            prev = i + 1
    if prev != len(text):
        out.append((prev, len(text), False))
    return out


# -- decoders ---------------------------------------------------------------


def _decoder(spec: dict | None):
    """``fn(tokens) -> tokens`` (the crate's decode_chain)."""
    if spec is None:
        return None
    kind = spec.get("type")
    if kind == "Sequence":
        parts = [_decoder(d) for d in spec["decoders"]]

        def seq(tokens):
            for p in parts:
                tokens = p(tokens)
            return tokens
        return seq
    if kind == "ByteLevel":
        def byte_level(tokens):
            raw = bytearray()
            for t in tokens:
                mapped = [_U2B.get(c) for c in t]
                raw += t.encode("utf-8") if None in mapped else bytes(mapped)
            return [bytes(raw).decode("utf-8", errors="replace")]
        return byte_level
    if kind == "ByteFallback":
        def byte_fallback(tokens):
            out, pending = [], bytearray()

            def flush():
                if pending:
                    try:
                        out.append(bytes(pending).decode("utf-8"))
                    except UnicodeDecodeError:
                        out.extend("�" for _ in pending)
                    pending.clear()
            for t in tokens:
                byte = _byte_token(t)
                if byte is not None:
                    pending.append(byte)
                else:
                    flush()
                    out.append(t)
            flush()
            return out
        return byte_fallback
    if kind == "Fuse":
        return lambda tokens: ["".join(tokens)]
    if kind == "Replace":
        pat, content = _compile_pattern(spec["pattern"], "Replace"), spec["content"]
        return lambda tokens: [pat.sub(lambda m: content, t) for t in tokens]
    if kind == "Strip":
        ch, start, stop = spec["content"], spec.get("start", 0), spec.get("stop", 0)

        def strip(tokens):
            out = []
            for t in tokens:
                lo = 0
                while lo < min(start, len(t)) and t[lo] == ch:
                    lo += 1
                hi = len(t)
                for _ in range(stop):
                    if hi > lo and t[hi - 1] == ch:
                        hi -= 1
                    else:
                        break
                out.append(t[lo:hi])
            return out
        return strip
    if kind == "Metaspace":
        rep = spec.get("replacement", "▁")
        scheme = spec.get("prepend_scheme")
        if scheme is None:
            scheme = "always" if spec.get("add_prefix_space", True) else "never"
        drop_first = scheme != "never"

        def metaspace(tokens):
            return [
                "".join("" if c == rep and i == 0 and drop_first else (" " if c == rep else c)
                        for c in t)
                for i, t in enumerate(tokens)
            ]
        return metaspace
    raise _unsupported("decoder", kind)


def _byte_token(t: str) -> int | None:
    if len(t) == 6 and t.startswith("<0x") and t.endswith(">"):
        try:
            return int(t[3:5], 16)
        except ValueError:
            return None
    return None


# -- the BPE model ----------------------------------------------------------


class _Bpe:
    def __init__(self, spec: dict) -> None:
        if spec.get("dropout") not in (None, 0, 0.0):
            raise _unsupported("BPE option", "dropout")
        self.vocab: dict[str, int] = spec["vocab"]
        self.vocab_r = {i: t for t, i in self.vocab.items()}
        self.unk = spec.get("unk_token")
        self.fuse_unk = spec.get("fuse_unk", False)
        self.byte_fallback = spec.get("byte_fallback", False)
        self.ignore_merges = spec.get("ignore_merges", False)
        self.prefix = spec.get("continuing_subword_prefix") or ""
        self.suffix = spec.get("end_of_word_suffix") or ""
        merges: dict[tuple[int, int], tuple[int, int]] = {}
        plen = len(self.prefix)
        for rank, m in enumerate(spec.get("merges") or []):
            a, b = m.split(" ") if isinstance(m, str) else m
            try:
                new_id = self.vocab[a + b[plen:]]
                merges[(self.vocab[a], self.vocab[b])] = (rank, new_id)
            except KeyError as exc:
                raise ValueError(f"tokenizer.json merge {m!r}: {exc} not in the vocabulary") from None
        self.merges = merges
        self._cache: dict[str, list[int]] = {}

    def tokenize(self, word: str) -> list[int]:
        if not word:
            return []
        if self.ignore_merges and word in self.vocab:
            return [self.vocab[word]]
        hit = self._cache.get(word)
        if hit is not None:
            return hit
        ids = self._merge_word(word)
        if len(word) < _CACHE_WORD_CHARS:
            if len(self._cache) >= _CACHE_ENTRIES:
                self._cache.clear()
            self._cache[word] = ids
        return ids

    def _merge_word(self, w: str) -> list[int]:
        symbols: list[int] = []
        unk: int | None = None
        n = len(w)
        for i, ch in enumerate(w):
            s = ch
            if i and self.prefix:
                s = self.prefix + s
            if i == n - 1 and self.suffix:
                s = s + self.suffix
            tid = self.vocab.get(s)
            if tid is not None:
                if unk is not None:
                    symbols.append(unk)
                    unk = None
                symbols.append(tid)
                continue
            if self.byte_fallback:
                byte_ids = [self.vocab.get(f"<0x{b:02X}>") for b in s.encode("utf-8")]
                if None not in byte_ids:
                    symbols.extend(byte_ids)
                    continue
            if self.unk is not None:
                unk_id = self.vocab.get(self.unk)
                if unk_id is None:
                    raise ValueError(f"tokenizer.json unk_token {self.unk!r} not in the vocabulary")
                if unk is not None and not self.fuse_unk:
                    symbols.append(unk)
                unk = unk_id
        if unk is not None:
            symbols.append(unk)
        return self._merge_all(symbols)

    def _merge_all(self, sym: list[int]) -> list[int]:
        n = len(sym)
        if n < 2:
            return sym
        merges = self.merges
        prev = list(range(-1, n - 1))
        nxt = list(range(1, n + 1))
        nxt[-1] = -1
        alive = [True] * n
        heap = []
        for i in range(n - 1):
            m = merges.get((sym[i], sym[i + 1]))
            if m is not None:
                heap.append((m[0], i, m[1]))
        heapq.heapify(heap)
        while heap:
            _rank, pos, new_id = heapq.heappop(heap)
            if not alive[pos] or nxt[pos] == -1:
                continue
            right = nxt[pos]
            m = merges.get((sym[pos], sym[right]))
            if m is None or m[1] != new_id:
                continue  # a stale entry
            sym[pos] = new_id
            alive[right] = False
            nxt[pos] = nxt[right]
            if nxt[right] != -1:
                prev[nxt[right]] = pos
            p = prev[pos]
            if p >= 0:
                m = merges.get((sym[p], sym[pos]))
                if m is not None:
                    heapq.heappush(heap, (m[0], p, m[1]))
            q = nxt[pos]
            if q != -1:
                m = merges.get((sym[pos], sym[q]))
                if m is not None:
                    heapq.heappush(heap, (m[0], pos, m[1]))
        return [s for s, a in zip(sym, alive) if a]


# -- added tokens -----------------------------------------------------------


# Other_Alphabetic symbols (circled and squared Latin letters, So) that
# Unicode's \\w counts as word characters.
_ALPHABETIC_SO = ((0x24B6, 0x24E9), (0x1F130, 0x1F149), (0x1F150, 0x1F169), (0x1F170, 0x1F189))


def _is_word_char(ch: str) -> bool:
    """Unicode's \\w (the crate's single_word test): alphabetic, marks,
    decimal digits, connector punctuation and the joiners."""
    cat = unicodedata.category(ch)
    if cat[0] in "LM" or cat in ("Nd", "Nl", "Pc") or ch in "\u200c\u200d":
        return True
    cp = ord(ch)
    return any(lo <= cp <= hi for lo, hi in _ALPHABETIC_SO)


class _AddedTokens:
    def __init__(self, entries: list[dict], normalize) -> None:
        self.by_id: dict[int, dict] = {}
        self.by_content: dict[str, int] = {}
        self.special: set[str] = set()
        raw, norm = {}, {}
        for e in entries:
            self.by_id[e["id"]] = e
            self.by_content[e["content"]] = e["id"]
            if e.get("special"):
                self.special.add(e["content"])
            if e.get("normalized", not e.get("special", False)):
                content = normalize(e["content"]) if normalize is not None else e["content"]
                norm[content] = e["id"]
            else:
                raw[e["content"]] = e["id"]
        self.raw = self._matcher(raw)
        self.norm = self._matcher(norm)

    @staticmethod
    def _matcher(patterns: dict[str, int]):
        pats = [p for p in patterns if p]
        if not pats:
            return None
        # Alternatives longest first: at the leftmost position a match
        # starts, Python's alternation takes the longest.
        alt = "|".join(re.escape(p) for p in sorted(pats, key=len, reverse=True))
        return re.compile(alt), patterns

    def split(self, text: str, matcher) -> list[tuple[int | None, int, int]]:
        """(added id or None, start, end) pieces of ``text`` (the
        crate's AddedVocabulary::find_matches)."""
        if matcher is None or not text:
            return [(None, 0, len(text))]
        pattern, ids = matcher
        out, prev = [], 0
        for m in pattern.finditer(text):
            start, stop = m.span()
            tid = ids[m.group(0)]
            tok = self.by_id[tid]
            if tok.get("single_word"):
                before = start == 0 or not _is_word_char(text[start - 1])
                after = stop == len(text) or not _is_word_char(text[stop])
                if not (before and after):
                    continue
            if tok.get("lstrip"):
                s = start
                while s > 0 and text[s - 1] in _WS_SET:
                    s -= 1
                start = max(s, prev)
            if tok.get("rstrip"):
                while stop < len(text) and text[stop] in _WS_SET:
                    stop += 1
            if prev < start:
                out.append((None, prev, start))
            out.append((tid, start, stop))
            prev = stop
        if prev != len(text):
            out.append((None, prev, len(text)))
        return out


# -- the tokenizer ----------------------------------------------------------


class HfTokenizerJson:
    """``tokenizer.json`` read into encode/decode/decode_stream with the
    Rust crate's semantics on the supported subset."""

    def __init__(self, spec: dict) -> None:
        model = spec.get("model") or {}
        if model.get("type", "BPE" if "merges" in model else None) != "BPE":
            raise _unsupported("model", model.get("type"))
        self.model = _Bpe(model)
        self.normalize = _normalizer(spec.get("normalizer"))
        self.pre_tokenize = _pre_tokenizer(spec.get("pre_tokenizer"))
        self.decoder = _decoder(spec.get("decoder"))
        self.added = _AddedTokens(spec.get("added_tokens") or [], self.normalize)

    @staticmethod
    def from_file(path: str | os.PathLike) -> "HfTokenizerJson":
        return HfTokenizerJson(json.loads(Path(path).read_text(encoding="utf-8")))

    def get_vocab_size(self) -> int:
        return len(set(self.model.vocab) | set(self.added.by_content))

    def token_to_id(self, token: str) -> int | None:
        if token in self.added.by_content:
            return self.added.by_content[token]
        return self.model.vocab.get(token)

    def id_to_token(self, tid: int) -> str | None:
        if tid in self.added.by_id:
            return self.added.by_id[tid]["content"]
        return self.model.vocab_r.get(tid)

    def encode(self, text: str) -> list[int]:
        """Ids of ``text`` without special-token templates
        (``add_special_tokens=False``)."""
        ids: list[int] = []
        for tid, s, e in self.added.split(text, self.added.raw):
            if tid is not None:
                ids.append(tid)
                continue
            piece = text[s:e]
            at_start = s == 0
            if self.normalize is not None:
                piece = self.normalize(piece)
            for tid2, s2, e2 in self.added.split(piece, self.added.norm):
                if tid2 is not None:
                    ids.append(tid2)
                    continue
                sub = piece[s2:e2]
                if not sub:
                    continue
                pieces = [(sub, at_start and s2 == 0)]
                if self.pre_tokenize is not None:
                    pieces = self.pre_tokenize(pieces)
                for word, _ in pieces:
                    ids.extend(self.model.tokenize(word))
        return ids

    def decode(self, ids: Sequence[int], skip_special_tokens: bool = True) -> str:
        tokens = []
        for tid in ids:
            t = self.id_to_token(int(tid))
            if t is None or (skip_special_tokens and t in self.added.special):
                continue
            tokens.append(t)
        if self.decoder is None:
            return " ".join(tokens)
        return "".join(self.decoder(tokens))

    def decode_stream(self, skip_special_tokens: bool = True) -> "DecodeStream":
        return DecodeStream(self, skip_special_tokens)


class DecodeStream:
    """The crate's DecodeStream: each step decodes a window of ids and
    returns the text past its prefix once that text is longer and does
    not end in U+FFFD (an incomplete UTF-8 sequence held back)."""

    def __init__(self, tok: HfTokenizerJson, skip_special_tokens: bool = True) -> None:
        self._tok = tok
        self._skip = skip_special_tokens
        self._ids: list[int] = []
        self._prefix = ""
        self._prefix_index = 0

    def step(self, token_id: int) -> str | None:
        tok, skip = self._tok, self._skip
        if not self._prefix and self._ids:
            new_prefix = tok.decode(self._ids, skip)
            if not new_prefix.endswith("�"):
                self._prefix = new_prefix
                self._prefix_index = len(self._ids)
        self._ids.append(int(token_id))
        text = tok.decode(self._ids, skip)
        if len(text.encode("utf-8")) > len(self._prefix.encode("utf-8")) and not text.endswith(
                "�"):
            if not text.startswith(self._prefix):
                raise ValueError("decode stream: the text no longer starts with its prefix")
            new = text[len(self._prefix):]
            new_index = len(self._ids) - self._prefix_index
            self._ids = self._ids[self._prefix_index:]
            self._prefix = tok.decode(self._ids, skip)
            self._prefix_index = new_index
            return new
        return None
