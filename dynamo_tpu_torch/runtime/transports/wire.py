"""A standard-library MessagePack codec for the runtime plane's wire.

The JAX package frames every control map and response item with
``msgpack.packb`` / ``msgpack.unpackb``; the machine with the card has no
``msgpack``, so the port speaks the same bytes itself. This codec covers
the subset those messages use, with msgpack 1.x's defaults:

- nil, bool, int (fixint, uint 8–64, int 8–64 — msgpack's smallest
  encoding for each value), float64;
- str (fixstr, str 8/16/32: ``use_bin_type=True``) and bin 8/16/32
  (bytes, bytearray, memoryview);
- array (list and tuple; decoded as list) and map (dict, in insertion
  order);
- ``default``: one fallback call for any other object, whose result is
  packed in its place (the ingress packs dataclass payloads through it).

Decoding is ``raw=False`` (str as str, bin as bytes), ``strict_map_key=
True`` (a map key that is not str or bytes raises ``ValueError``) and
rejects trailing bytes. A value outside the subset raises: a type with no
``default`` (``TypeError``), an int outside [-2**63, 2**64) (``Overflow
Error``), ext types, float32 or the reserved byte 0xc1 on decode
(``ValueError``). Nesting deeper than ``NEST_LIMIT`` raises ``ValueError``
both ways, as msgpack's does.
"""

from __future__ import annotations

import struct
from typing import Any, Callable

NEST_LIMIT = 511

_B = struct.Struct(">B")
_H = struct.Struct(">H")
_I = struct.Struct(">I")
_Q = struct.Struct(">Q")
_b = struct.Struct(">b")
_h = struct.Struct(">h")
_i = struct.Struct(">i")
_q = struct.Struct(">q")
_d = struct.Struct(">d")
_FIXED = {0xCC: _B, 0xCD: _H, 0xCE: _I, 0xCF: _Q,
          0xD0: _b, 0xD1: _h, 0xD2: _i, 0xD3: _q}


def _pack_len(out: bytearray, n: int, fix: int | None, fix_max: int,
              codes: tuple[int, int, int], kind: str) -> None:
    """Header of a str/bin/array/map of length ``n``: the fix form when
    ``fix`` is set and ``n < fix_max``, else the 8/16/32-bit form
    (``codes[0]`` is -1 for the kinds that have no 8-bit form)."""
    if fix is not None and n < fix_max:
        out.append(fix | n)
    elif codes[0] >= 0 and n <= 0xFF:
        out.append(codes[0])
        out.append(n)
    elif n <= 0xFFFF:
        out.append(codes[1])
        out += _H.pack(n)
    elif n <= 0xFFFFFFFF:
        out.append(codes[2])
        out += _I.pack(n)
    else:
        raise ValueError(f"{kind} is too large")


def _pack_int(out: bytearray, n: int) -> None:
    if n >= 0:
        if n < 0x80:
            out.append(n)
        elif n <= 0xFF:
            out.append(0xCC)
            out.append(n)
        elif n <= 0xFFFF:
            out.append(0xCD)
            out += _H.pack(n)
        elif n <= 0xFFFFFFFF:
            out.append(0xCE)
            out += _I.pack(n)
        elif n <= 0xFFFFFFFFFFFFFFFF:
            out.append(0xCF)
            out += _Q.pack(n)
        else:
            raise OverflowError("Integer value out of range")
    elif n >= -32:
        out.append(n & 0xFF)
    elif n >= -0x80:
        out.append(0xD0)
        out += _b.pack(n)
    elif n >= -0x8000:
        out.append(0xD1)
        out += _h.pack(n)
    elif n >= -0x80000000:
        out.append(0xD2)
        out += _i.pack(n)
    elif n >= -0x8000000000000000:
        out.append(0xD3)
        out += _q.pack(n)
    else:
        raise OverflowError("Integer value out of range")


def _pack(out: bytearray, obj: Any, default, depth: int) -> None:
    if depth > NEST_LIMIT:
        raise ValueError("recursion limit exceeded")
    default_used = False
    while True:
        if obj is None:
            out.append(0xC0)
        elif obj is True:
            out.append(0xC3)
        elif obj is False:
            out.append(0xC2)
        elif isinstance(obj, int):
            _pack_int(out, int(obj))
        elif isinstance(obj, float):
            out.append(0xCB)
            out += _d.pack(obj)
        elif isinstance(obj, str):
            raw = str.encode(obj, "utf-8")
            _pack_len(out, len(raw), 0xA0, 32, (0xD9, 0xDA, 0xDB), "str")
            out += raw
        elif isinstance(obj, (bytes, bytearray, memoryview)):
            raw = bytes(obj)
            _pack_len(out, len(raw), None, 0, (0xC4, 0xC5, 0xC6), "bin")
            out += raw
        elif isinstance(obj, (list, tuple)):
            _pack_len(out, len(obj), 0x90, 16, (-1, 0xDC, 0xDD), "array")
            for item in obj:
                _pack(out, item, default, depth + 1)
        elif isinstance(obj, dict):
            _pack_len(out, len(obj), 0x80, 16, (-1, 0xDE, 0xDF), "map")
            for key, value in obj.items():
                _pack(out, key, default, depth + 1)
                _pack(out, value, default, depth + 1)
        elif default is not None and not default_used:
            obj = default(obj)
            default_used = True
            continue
        else:
            raise TypeError(f"can not serialize {type(obj).__name__!r} object")
        return


def packb(obj: Any, default: Callable[[Any], Any] | None = None) -> bytes:
    """``msgpack.packb(obj, default=default)`` for the subset above."""
    out = bytearray()
    _pack(out, obj, default, 0)
    return bytes(out)


class _Reader:
    __slots__ = ("data", "pos")

    def __init__(self, data: bytes) -> None:
        self.data = data
        self.pos = 0

    def take(self, n: int) -> bytes:
        end = self.pos + n
        if end > len(self.data):
            raise ValueError("Unpack failed: incomplete input")
        chunk = self.data[self.pos:end]
        self.pos = end
        return chunk

    def unpack(self, st: struct.Struct):
        return st.unpack(self.take(st.size))[0]


def _str(r: _Reader, n: int) -> str:
    return r.take(n).decode("utf-8")


def _array(r: _Reader, n: int, depth: int) -> list:
    return [_unpack(r, depth + 1) for _ in range(n)]


def _map(r: _Reader, n: int, depth: int) -> dict:
    out = {}
    for _ in range(n):
        key = _unpack(r, depth + 1)
        if type(key) not in (str, bytes):
            raise ValueError(
                f"{type(key).__name__} is not allowed for map key when "
                "strict_map_key=True"
            )
        out[key] = _unpack(r, depth + 1)
    return out


def _unpack(r: _Reader, depth: int) -> Any:
    if depth > NEST_LIMIT:
        raise ValueError("recursion limit exceeded")
    (code,) = r.take(1)
    if code < 0x80:
        return code
    if code >= 0xE0:
        return code - 0x100
    if code < 0x90:
        return _map(r, code & 0x0F, depth)
    if code < 0xA0:
        return _array(r, code & 0x0F, depth)
    if code < 0xC0:
        return _str(r, code & 0x1F)
    if code == 0xC0:
        return None
    if code == 0xC2:
        return False
    if code == 0xC3:
        return True
    if code == 0xC4:
        return r.take(r.unpack(_B))
    if code == 0xC5:
        return r.take(r.unpack(_H))
    if code == 0xC6:
        return r.take(r.unpack(_I))
    if code == 0xCB:
        return r.unpack(_d)
    fixed = _FIXED.get(code)
    if fixed is not None:
        return r.unpack(fixed)
    if code == 0xD9:
        return _str(r, r.unpack(_B))
    if code == 0xDA:
        return _str(r, r.unpack(_H))
    if code == 0xDB:
        return _str(r, r.unpack(_I))
    if code == 0xDC:
        return _array(r, r.unpack(_H), depth)
    if code == 0xDD:
        return _array(r, r.unpack(_I), depth)
    if code == 0xDE:
        return _map(r, r.unpack(_H), depth)
    if code == 0xDF:
        return _map(r, r.unpack(_I), depth)
    raise ValueError(f"msgpack type byte 0x{code:02x} is outside the wire subset")


def unpackb(data: bytes) -> Any:
    """``msgpack.unpackb(data)`` (raw=False, strict_map_key=True) for the
    subset above; trailing bytes raise ``ValueError``."""
    r = _Reader(bytes(data))
    obj = _unpack(r, 0)
    if r.pos != len(r.data):
        raise ValueError("unpack(b) received extra data.")
    return obj
