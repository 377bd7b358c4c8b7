"""Layered per-component configuration (port of dynamo_tpu/utils/config.py).

Layers, lowest to highest precedence:
  1. caller defaults
  2. YAML file: per-component sections; each section may list
     ``common-configs: [key, ...]`` to inherit those keys from the
     ``Common`` section
  3. environment: ``DYNTPU_<COMPONENT>_<KEY>`` (dashes as underscores)
  4. overrides: ``Component.key=value`` strings (CLI ``--set``)

Values from the environment and overrides are YAML-parsed, so
``true``/``8``/``[a,b]`` arrive typed. Key lookup is dash/underscore-
insensitive (YAML says ``max-model-len``, Python asks for
``max_model_len``).

The YAML is read by ``yaml_load``, a subset written here that gives what
``yaml.safe_load`` gives on it: block mappings and sequences (a
sequence may sit at its key's indentation), flow ``[...]``/``{...}``,
comments, a leading ``---``; plain, single- and double-quoted scalars,
plain ones resolved as YAML 1.1 does (ints in every base, floats,
``true/false/yes/no/on/off``, ``null``/``~``). Anchors, aliases, tags,
block scalars, complex and merge keys, timestamps, multi-line plain
scalars and multiple documents raise ``YamlSubsetError``, naming the
construct.
"""

from __future__ import annotations

import math
import os
import re
from pathlib import Path
from typing import Any, Mapping

COMMON_SECTION = "Common"
COMMON_KEY = "common-configs"
ENV_PREFIX = "DYNTPU"


# -- the YAML subset --------------------------------------------------------


class YamlSubsetError(ValueError):
    """YAML outside the subset, or malformed."""


_BOOL = re.compile(r"^(?:yes|Yes|YES|no|No|NO|true|True|TRUE|false|False|FALSE|on|On|ON|off|Off|OFF)$")
_FLOAT = re.compile(
    r"^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?|\.[0-9_]+(?:[eE][-+][0-9]+)?"
    r"|[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*|[-+]?\.(?:inf|Inf|INF)|\.(?:nan|NaN|NAN))$"
)
_INT = re.compile(
    r"^(?:[-+]?0b[0-1_]+|[-+]?0[0-7_]+|[-+]?(?:0|[1-9][0-9_]*)|[-+]?0x[0-9a-fA-F_]+"
    r"|[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$"
)
_NULL = re.compile(r"^(?:~|null|Null|NULL|)$")
_TIMESTAMP = re.compile(
    r"^(?:[0-9][0-9][0-9][0-9]-[0-9][0-9]-[0-9][0-9]|[0-9][0-9][0-9][0-9]-[0-9][0-9]?-[0-9][0-9]?"
    r"(?:[Tt]|[ \t]+)[0-9][0-9]?:[0-9][0-9]:[0-9][0-9](?:\.[0-9]*)?"
    r"(?:[ \t]*(?:Z|[-+][0-9][0-9]?(?::[0-9][0-9])?))?)$"
)
_FIRST_CHARS = {"float": "-+0123456789.", "int": "-+0123456789", "bool": "yYnNtTfFoO"}


def _sexagesimal(digits: str, cast) -> Any:
    total = cast(0)
    for part in digits.split(":"):
        total = total * 60 + cast(part)
    return total


def _resolve(s: str) -> Any:
    """A plain scalar resolved as PyYAML's safe_load resolves it."""
    first = s[:1]
    if first in _FIRST_CHARS["bool"] and _BOOL.match(s):
        return s.lower() in ("yes", "true", "on")
    if first in _FIRST_CHARS["float"] and _FLOAT.match(s):
        v = s.replace("_", "").lower()
        sign = -1 if v.startswith("-") else 1
        v = v.lstrip("+-")
        if v == ".inf":
            return sign * math.inf
        if v == ".nan":
            return math.nan
        return sign * (_sexagesimal(v, float) if ":" in v else float(v))
    if first in _FIRST_CHARS["int"] and _INT.match(s):
        v = s.replace("_", "")
        sign = -1 if v.startswith("-") else 1
        v = v.lstrip("+-")
        if v == "0":
            return 0
        if v.startswith("0b"):
            return sign * int(v[2:], 2)
        if v.startswith("0x"):
            return sign * int(v[2:], 16)
        if v.startswith("0"):
            return sign * int(v, 8)
        return sign * (_sexagesimal(v, int) if ":" in v else int(v))
    if s == "<<":
        raise YamlSubsetError("YAML merge keys (<<) are outside the subset")
    if _NULL.match(s):
        return None
    if first.isdigit() and _TIMESTAMP.match(s):
        raise YamlSubsetError(f"YAML timestamp {s!r} is outside the subset (quote it)")
    if s == "=":
        raise YamlSubsetError("the YAML value key (=) is outside the subset")
    return s


_ESCAPES = {
    "0": "\0", "a": "\a", "b": "\b", "t": "\t", "\t": "\t", "n": "\n", "v": "\v",
    "f": "\f", "r": "\r", "e": "\x1b", " ": " ", '"': '"', "/": "/", "\\": "\\",
    "N": "\x85", "_": "\xa0", "L": "\u2028", "P": "\u2029",
}
_HEX_LEN = {"x": 2, "u": 4, "U": 8}


def _check_plain_start(s: str, where: str) -> None:
    c = s[:1]
    if c == "&":
        raise YamlSubsetError(f"YAML anchors are outside the subset ({where})")
    if c == "*":
        raise YamlSubsetError(f"YAML aliases are outside the subset ({where})")
    if c == "!":
        raise YamlSubsetError(f"YAML tags are outside the subset ({where})")
    if c in "|>":
        raise YamlSubsetError(f"YAML block scalars are outside the subset ({where})")
    if c == "?" and (len(s) == 1 or s[1] in " \t"):
        raise YamlSubsetError(f"YAML complex keys are outside the subset ({where})")
    if c in "@`%":
        raise YamlSubsetError(f"a plain YAML scalar cannot start with {c!r} ({where})")


class _Scanner:
    """A cursor over one string: quoted scalars and flow collections."""

    def __init__(self, text: str, where: str) -> None:
        self.s, self.i, self.where = text, 0, where

    def error(self, msg: str) -> YamlSubsetError:
        return YamlSubsetError(f"{msg} ({self.where})")

    def skip_ws(self) -> None:
        while self.i < len(self.s) and self.s[self.i] in " \t":
            self.i += 1

    def peek(self) -> str:
        return self.s[self.i:self.i + 1]

    def single(self) -> str:
        out, self.i = [], self.i + 1
        while True:
            j = self.s.find("'", self.i)
            if j < 0:
                raise self.error("unterminated single-quoted scalar")
            out.append(self.s[self.i:j])
            if self.s[j + 1:j + 2] == "'":
                out.append("'")
                self.i = j + 2
                continue
            self.i = j + 1
            return "".join(out)

    def double(self) -> str:
        out, self.i = [], self.i + 1
        while self.i < len(self.s):
            c = self.s[self.i]
            if c == '"':
                self.i += 1
                return "".join(out)
            if c == "\\":
                e = self.s[self.i + 1:self.i + 2]
                if e in _ESCAPES:
                    out.append(_ESCAPES[e])
                    self.i += 2
                elif e in _HEX_LEN:
                    n = _HEX_LEN[e]
                    digits = self.s[self.i + 2:self.i + 2 + n]
                    if len(digits) != n or not all(d in "0123456789abcdefABCDEF" for d in digits):
                        raise self.error(f"bad escape \\{e}{digits}")
                    out.append(chr(int(digits, 16)))
                    self.i += 2 + n
                else:
                    raise self.error(f"unknown escape \\{e}")
                continue
            out.append(c)
            self.i += 1
        raise self.error("unterminated double-quoted scalar")

    def flow_node(self) -> Any:
        self.skip_ws()
        c = self.peek()
        if c == "[":
            return self.flow_seq()
        if c == "{":
            return self.flow_map()
        if c == "'":
            return self.single()
        if c == '"':
            return self.double()
        return self.flow_plain()

    def flow_plain(self) -> Any:
        start = self.i
        while self.i < len(self.s):
            c = self.s[self.i]
            if c in ",[]{}":
                break
            if c == ":" and self.s[self.i + 1:self.i + 2] in ("", " ", ",", "]", "}"):
                break
            if c == "#" and self.i > start and self.s[self.i - 1] in " \t":
                raise self.error("a comment inside a flow collection")
            self.i += 1
        text = self.s[start:self.i].strip()
        _check_plain_start(text, self.where)
        return _resolve(text)

    def flow_seq(self) -> list:
        self.i += 1
        out = []
        while True:
            self.skip_ws()
            if self.peek() == "]":
                self.i += 1
                return out
            item = self.flow_node()
            self.skip_ws()
            if self.peek() == ":":
                raise self.error("a single-pair mapping inside a flow sequence")
            out.append(item)
            self.skip_ws()
            c = self.peek()
            if c == ",":
                self.i += 1
            elif c != "]":
                raise self.error("expected ',' or ']' in a flow sequence")

    def flow_map(self) -> dict:
        self.i += 1
        out: dict = {}
        while True:
            self.skip_ws()
            if self.peek() == "}":
                self.i += 1
                return out
            key = self.flow_node()
            self.skip_ws()
            value = None
            if self.peek() == ":":
                self.i += 1
                self.skip_ws()
                value = None if self.peek() in (",", "}") else self.flow_node()
            out[key] = value
            self.skip_ws()
            c = self.peek()
            if c == ",":
                self.i += 1
            elif c != "}":
                raise self.error("expected ',' or '}' in a flow mapping")


def _strip_comment(line: str) -> str:
    """The line without its comment (a '#' at the start or after
    whitespace, outside quotes) and trailing whitespace."""
    quote = None
    for i, c in enumerate(line):
        if quote:
            if c == quote:
                quote = None
            elif c == "\\" and quote == '"':
                continue
        elif c in "'\"" and (i == 0 or line[i - 1] in " \t[{,:-"):
            quote = c
        elif c == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i].rstrip()
    return line.rstrip()


def _split_key(text: str, where: str):
    """(key, rest) when ``text`` is a mapping entry ``key: rest``, else
    None."""
    if text[:1] in ("'", '"'):
        sc = _Scanner(text, where)
        key = sc.single() if text[0] == "'" else sc.double()
        sc.skip_ws()
        if sc.peek() == ":" and text[sc.i + 1:sc.i + 2] in ("", " ", "\t"):
            return key, text[sc.i + 1:].strip()
        return None
    if text[:1] in "[{":
        return None
    m = re.search(r":(?:[ \t]|$)", text)
    if not m:
        return None
    key = text[:m.start()].rstrip()
    _check_plain_start(key, where)
    return _resolve(key), text[m.end():].strip()


class _Block:
    def __init__(self, lines: list[tuple[int, str, int]], path: str) -> None:
        self.lines, self.pos, self.path = lines, 0, path

    def where(self, k: int | None = None) -> str:
        k = self.pos if k is None else k
        return f"{self.path}:{self.lines[min(k, len(self.lines) - 1)][2]}"

    def value(self, rest: str, parent_indent: int, where: str, key: bool) -> Any:
        """The value after ``key:`` or ``-``: inline, or a nested block (a
        key's sequence may sit at the key's own indentation)."""
        if rest:
            return self.inline(rest, where)
        if self.pos < len(self.lines):
            indent, text, _ = self.lines[self.pos]
            if indent > parent_indent or (key and indent == parent_indent and _is_item(text)):
                return self.node(indent)
        return None

    def inline(self, rest: str, where: str) -> Any:
        c = rest[:1]
        if c in "[{":
            # A flow collection may continue on the following lines.
            while _unbalanced(rest) and self.pos < len(self.lines):
                rest += " " + self.lines[self.pos][1]
                self.pos += 1
            sc = _Scanner(rest, where)
            node = sc.flow_node()
            sc.skip_ws()
            if sc.i != len(rest):
                raise YamlSubsetError(f"text after a flow collection ({where})")
            return node
        if c in ("'", '"'):
            sc = _Scanner(rest, where)
            node = sc.single() if c == "'" else sc.double()
            sc.skip_ws()
            if sc.i != len(rest):
                raise YamlSubsetError(f"text after a quoted scalar ({where})")
            return node
        _check_plain_start(rest, where)
        if re.search(r":(?:[ \t]|$)", rest):
            raise YamlSubsetError(f"a mapping inside a plain scalar ({where})")
        return _resolve(rest)

    def node(self, indent: int) -> Any:
        text = self.lines[self.pos][1]
        return self.sequence(indent) if _is_item(text) else self.mapping(indent)

    def sequence(self, indent: int) -> list:
        out = []
        while self.pos < len(self.lines):
            ind, text, _ = self.lines[self.pos]
            if ind < indent or not _is_item(text):
                if ind > indent:
                    raise YamlSubsetError(f"bad indentation ({self.where()})")
                break
            if ind > indent:
                raise YamlSubsetError(f"bad indentation ({self.where()})")
            where = self.where()
            rest = text[1:].lstrip()
            self.pos += 1
            if rest and (_is_item(rest) or (
                    rest[:1] not in "[{" and _split_key(rest, where) is not None)):
                # "- key: value" or "- - x": a block whose first line
                # starts past the dash.
                inner = indent + (len(text) - len(rest))
                self.lines.insert(self.pos, (inner, rest, self.lines[self.pos - 1][2]))
                out.append(self.node(inner))
            else:
                out.append(self.value(rest, indent, where, key=False))
        return out

    def mapping(self, indent: int) -> dict:
        out: dict = {}
        while self.pos < len(self.lines):
            ind, text, _ = self.lines[self.pos]
            if ind < indent:
                break
            where = self.where()
            if ind > indent:
                raise YamlSubsetError(
                    f"a multi-line plain scalar or bad indentation ({where})")
            if _is_item(text):
                break
            kv = _split_key(text, where)
            if kv is None:
                raise YamlSubsetError(f"expected 'key: value' ({where})")
            key, rest = kv
            self.pos += 1
            out[key] = self.value(rest, indent, where, key=True)
        return out


def _is_item(text: str) -> bool:
    return text == "-" or text.startswith("- ") or text.startswith("-\t")


def _unbalanced(text: str) -> bool:
    depth, quote = 0, None
    for c in text:
        if quote:
            if c == quote:
                quote = None
        elif c in "'\"":
            quote = c
        elif c in "[{":
            depth += 1
        elif c in "]}":
            depth -= 1
    return depth > 0


def yaml_load(text: str, path: str = "<yaml>") -> Any:
    """The YAML subset's ``safe_load``."""
    lines: list[tuple[int, str, int]] = []
    seen_start = False
    for n, raw in enumerate(text.splitlines(), 1):
        if "\t" in raw[:len(raw) - len(raw.lstrip(" \t"))]:
            raise YamlSubsetError(f"tab indentation ({path}:{n})")
        line = _strip_comment(raw)
        if not line.strip():
            continue
        if line.startswith("%"):
            raise YamlSubsetError(f"YAML directives are outside the subset ({path}:{n})")
        if line.rstrip() == "---" or line.startswith("--- "):
            if seen_start or lines:
                raise YamlSubsetError(f"multiple YAML documents are outside the subset ({path}:{n})")
            seen_start = True
            rest = line[3:].strip()
            if rest:
                lines.append((0, rest, n))
            continue
        if line.rstrip() == "...":
            raise YamlSubsetError(f"YAML document end markers are outside the subset ({path}:{n})")
        stripped = line.lstrip(" ")
        lines.append((len(line) - len(stripped), stripped, n))
    if not lines:
        return None
    block = _Block(lines, path)
    indent, text0, _ = lines[0]
    if _is_item(text0) or _split_key(text0, block.where(0)) is not None:
        node = block.node(indent)
    else:
        block.pos = 1
        node = block.inline(text0, block.where(0))
    if block.pos < len(block.lines):
        raise YamlSubsetError(f"unexpected content ({block.where()})")
    return node


# -- layered configuration --------------------------------------------------


def _norm(key: str) -> str:
    return key.replace("-", "_").lower()


class ComponentConfig:
    """One component's resolved key/value view."""

    def __init__(self, name: str, values: dict[str, Any]) -> None:
        self.name = name
        self._values = {_norm(k): v for k, v in values.items()}

    def get(self, key: str, default: Any = None) -> Any:
        return self._values.get(_norm(key), default)

    def require(self, key: str) -> Any:
        k = _norm(key)
        if k not in self._values:
            raise KeyError(f"config {self.name}.{key} is required")
        return self._values[k]

    def __contains__(self, key: str) -> bool:
        return _norm(key) in self._values

    def as_dict(self) -> dict[str, Any]:
        return dict(self._values)

    def apply_to(self, obj: Any) -> Any:
        """Set matching attributes on a dataclass-ish object (unknown keys
        ignored) — the ``--Component.key=value`` → EngineConfig bridge."""
        for k, v in self._values.items():
            if hasattr(obj, k):
                setattr(obj, k, v)
        return obj


class Config:
    """The resolved layered configuration of a deployment."""

    def __init__(self, sections: dict[str, dict[str, Any]]) -> None:
        self._sections = sections

    def component(self, name: str) -> ComponentConfig:
        return ComponentConfig(name, self._sections.get(name, {}))

    def sections(self) -> list[str]:
        return sorted(self._sections)

    def __getitem__(self, name: str) -> ComponentConfig:
        return self.component(name)


def load_config(
    path: str | Path | None = None,
    overrides: list[str] | None = None,
    defaults: Mapping[str, Mapping[str, Any]] | None = None,
    env: Mapping[str, str] | None = None,
) -> Config:
    # Keys are normalized at insertion so later layers spelled
    # differently still override earlier ones.
    sections: dict[str, dict[str, Any]] = {
        name: {_norm(k): v for k, v in vals.items()}
        for name, vals in (defaults or {}).items()
    }

    # Layer 2: YAML with Common inheritance.
    if path is not None:
        raw = yaml_load(Path(path).read_text(), str(path)) or {}
        if not isinstance(raw, dict):
            raise ValueError(f"config {path} must be a mapping of sections")
        common = raw.get(COMMON_SECTION) or {}
        for name, section in raw.items():
            if name == COMMON_SECTION:
                continue
            if section is None:
                section = {}
            if not isinstance(section, dict):
                raise ValueError(f"config section {name!r} must be a mapping")
            merged: dict[str, Any] = {}
            wanted = section.get(COMMON_KEY)
            if wanted is not None:
                for key in wanted:
                    if key not in common:
                        raise KeyError(
                            f"{name}.{COMMON_KEY} references {key!r} "
                            f"missing from {COMMON_SECTION}"
                        )
                    merged[_norm(key)] = common[key]
            merged.update({_norm(k): v for k, v in section.items() if k != COMMON_KEY})
            sections.setdefault(name, {}).update(merged)

    # Layer 3: environment DYNTPU_<COMPONENT>_<KEY>, for KNOWN sections
    # only (declared by the defaults or the file): other DYNTPU_* vars
    # (the DYNTPU_LOG filters, say) belong to other subsystems.
    env = os.environ if env is None else env
    known = {name.upper().replace("-", "_"): name for name in sections}
    for var, val in env.items():
        if not var.startswith(ENV_PREFIX + "_"):
            continue
        rest = var[len(ENV_PREFIX) + 1:]
        for cand in sorted(known, key=len, reverse=True):  # longest wins
            if rest.upper().startswith(cand + "_"):
                key = rest[len(cand) + 1:]
                if key:
                    sections[known[cand]][_norm(key)] = yaml_load(val, var)
                break

    # Layer 4: Component.key=value overrides.
    for item in overrides or []:
        lhs, sep, val = item.partition("=")
        if not sep or "." not in lhs:
            raise ValueError(f"override {item!r} must look like Component.key=value")
        comp, _, key = lhs.partition(".")
        sections.setdefault(comp, {})[_norm(key)] = yaml_load(val, f"--set {lhs}")

    return Config(sections)
