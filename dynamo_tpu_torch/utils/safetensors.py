"""The safetensors format, read and written with the standard library and
torch (the role the ``safetensors`` package plays for
dynamo_tpu/models/llama.py ``load_hf_weights``).

A file is an 8-byte little-endian header length N, N bytes of JSON and
the tensors' bytes. The header maps each tensor's name to its ``dtype``,
``shape`` and ``data_offsets`` (begin, end) relative to the end of the
header, plus an optional ``__metadata__`` map of strings. The reader
maps the file and builds each tensor with ``torch.frombuffer`` on its
byte range: a tensor shares memory with the map until it is copied to
its device (``get_tensor`` always copies), so the host holds at most
one tensor beyond the page cache. The writer lays tensors out as the
``safetensors`` package does (descending dtype rank, then name; the
header padded with spaces to 8 bytes), so the two write the same bytes.
"""

from __future__ import annotations

import glob
import json
import mmap
import os
import struct
from pathlib import Path

import torch

# The dtypes served, in the package's rank order (the writer sorts by
# descending rank, so wider elements come first and stay aligned).
DTYPES = {
    "BOOL": torch.bool,
    "U8": torch.uint8,
    "I8": torch.int8,
    "F8_E4M3": torch.float8_e4m3fn,
    "I16": torch.int16,
    "F16": torch.float16,
    "BF16": torch.bfloat16,
    "I32": torch.int32,
    "F32": torch.float32,
    "I64": torch.int64,
}
_RANK = {name: i for i, name in enumerate(DTYPES)}
_NAME_OF = {dt: name for name, dt in DTYPES.items()}
METADATA_KEY = "__metadata__"
INDEX_FILE = "model.safetensors.index.json"
# A header beyond this is not a tensor index (the package's own limit).
MAX_HEADER = 100_000_000


class SafetensorsError(ValueError):
    """A file that is not well-formed safetensors, or uses a dtype that
    is not served."""


def _numel(shape) -> int:
    n = 1
    for d in shape:
        n *= d
    return n


def read_header(path: str | os.PathLike) -> tuple[dict, dict, int]:
    """(tensor infos by name, ``__metadata__``, data start) of one file,
    every entry checked: a served dtype, a size that matches its shape,
    and byte ranges inside the file that neither overlap nor leave
    gaps."""
    path = str(path)
    size = os.path.getsize(path)
    with open(path, "rb") as f:
        raw = f.read(8)
        if len(raw) != 8:
            raise SafetensorsError(f"{path}: shorter than its 8-byte header length")
        (n,) = struct.unpack("<Q", raw)
        if n > MAX_HEADER or 8 + n > size:
            raise SafetensorsError(f"{path}: header length {n} out of range")
        try:
            header = json.loads(f.read(n))
        except (UnicodeDecodeError, json.JSONDecodeError) as exc:
            raise SafetensorsError(f"{path}: header is not JSON ({exc})") from None
    if not isinstance(header, dict):
        raise SafetensorsError(f"{path}: header is not a JSON object")
    meta = header.pop(METADATA_KEY, None) or {}
    data_len = size - 8 - n
    infos = {}
    for name, info in header.items():
        try:
            dtype, shape, (begin, end) = info["dtype"], info["shape"], info["data_offsets"]
        except (KeyError, TypeError, ValueError):
            raise SafetensorsError(f"{path}: tensor {name!r} has a malformed entry") from None
        if dtype not in DTYPES:
            raise SafetensorsError(
                f"{path}: tensor {name!r} has dtype {dtype!r}, which is not served "
                f"(served: {', '.join(DTYPES)})"
            )
        nbytes = _numel(shape) * DTYPES[dtype].itemsize
        if not 0 <= begin <= end <= data_len:
            raise SafetensorsError(
                f"{path}: tensor {name!r} data_offsets [{begin}, {end}] out of range "
                f"(data is {data_len} bytes)"
            )
        if end - begin != nbytes:
            raise SafetensorsError(
                f"{path}: tensor {name!r} spans {end - begin} bytes, its shape "
                f"{shape} of {dtype} needs {nbytes}"
            )
        infos[name] = {"dtype": dtype, "shape": list(shape), "data_offsets": (begin, end)}
    pos = 0
    for name, info in sorted(infos.items(), key=lambda kv: kv[1]["data_offsets"]):
        begin, end = info["data_offsets"]
        if begin != pos:
            kind = "overlaps the tensor before it" if begin < pos else "leaves a gap before it"
            raise SafetensorsError(f"{path}: tensor {name!r} at offset {begin} {kind}")
        pos = end
    return infos, meta, 8 + n


class SafeOpen:
    """One file mapped for reading: ``keys()``, ``metadata()`` and
    ``get_tensor(name, device, dtype)``, which returns a copy (on the
    device, in ``dtype`` when given); use as a context manager."""

    def __init__(self, path: str | os.PathLike) -> None:
        self.path = str(path)
        self._infos, self._meta, self._start = read_header(self.path)
        self._file = open(self.path, "rb")
        size = os.path.getsize(self.path)
        # A private copy-on-write map: writable for torch.frombuffer, and
        # nothing is ever written back to the file.
        self._map = (
            mmap.mmap(self._file.fileno(), 0, access=mmap.ACCESS_COPY) if size else None
        )

    def keys(self) -> list[str]:
        return list(self._infos)

    def metadata(self) -> dict:
        return dict(self._meta)

    def get_tensor(self, name: str, device=None, dtype: torch.dtype | None = None) -> torch.Tensor:
        info = self._infos[name]
        src = DTYPES[info["dtype"]]
        count = _numel(info["shape"])
        if count == 0:
            return torch.empty(info["shape"], dtype=dtype or src, device=device)
        view = torch.frombuffer(
            self._map, dtype=src, count=count, offset=self._start + info["data_offsets"][0]
        ).reshape(info["shape"])
        out = view.to(device=device, dtype=dtype or src, copy=True)
        del view
        return out

    def close(self) -> None:
        if self._map is not None:
            self._map.close()
            self._map = None
        self._file.close()

    def __enter__(self) -> "SafeOpen":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def load_file(path: str | os.PathLike, device=None) -> dict[str, torch.Tensor]:
    """Every tensor of one file, copied (to ``device`` when given)."""
    with SafeOpen(path) as f:
        return {name: f.get_tensor(name, device) for name in f.keys()}


def checkpoint_files(model_dir: str | os.PathLike) -> list[str]:
    """The files of a checkout: those ``model.safetensors.index.json``
    names when there is one, else every ``*.safetensors`` sorted."""
    model_dir = str(model_dir)
    index = Path(model_dir) / INDEX_FILE
    if index.is_file():
        weight_map = json.loads(index.read_text())["weight_map"]
        return [os.path.join(model_dir, f) for f in sorted(set(weight_map.values()))]
    files = sorted(glob.glob(os.path.join(model_dir, "*.safetensors")))
    if not files:
        raise FileNotFoundError(f"no safetensors in {model_dir}")
    return files


class Checkpoint:
    """The tensors of a checkout across its shards, by name: each shard
    is mapped once; a name in two shards is read from the later one (the
    reference's dict of every tensor keeps the last). Use as a context
    manager."""

    def __init__(self, model_dir: str | os.PathLike) -> None:
        self._files: list[SafeOpen] = []
        try:
            for p in checkpoint_files(model_dir):
                self._files.append(SafeOpen(p))
        except BaseException:
            self.close()
            raise
        self._where = {name: f for f in self._files for name in f.keys()}

    def __contains__(self, name: str) -> bool:
        return name in self._where

    def keys(self) -> list[str]:
        return list(self._where)

    def get(self, name: str, device=None, dtype: torch.dtype | None = None) -> torch.Tensor:
        if name not in self._where:
            raise KeyError(f"tensor {name!r} not in the checkpoint")
        return self._where[name].get_tensor(name, device, dtype)

    def close(self) -> None:
        for f in self._files:
            f.close()

    def __enter__(self) -> "Checkpoint":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def serialize(tensors: dict[str, torch.Tensor], metadata: dict | None = None) -> tuple[bytes, list]:
    """(header bytes with their length prefix, tensors in file order)."""
    for name, t in tensors.items():
        if t.dtype not in _NAME_OF:
            raise SafetensorsError(f"tensor {name!r} has dtype {t.dtype}, which is not served")
    order = sorted(tensors.items(), key=lambda kv: (-_RANK[_NAME_OF[kv[1].dtype]], kv[0]))
    header: dict = {}
    if metadata:
        header[METADATA_KEY] = {str(k): str(v) for k, v in metadata.items()}
    pos = 0
    for name, t in order:
        n = t.numel() * t.element_size()
        header[name] = {"dtype": _NAME_OF[t.dtype], "shape": list(t.shape),
                        "data_offsets": [pos, pos + n]}
        pos += n
    raw = json.dumps(header, separators=(",", ":"), ensure_ascii=False).encode()
    raw += b" " * ((8 - len(raw) % 8) % 8)
    return struct.pack("<Q", len(raw)) + raw, order


def _tensor_bytes(t: torch.Tensor) -> memoryview:
    flat = t.detach().to("cpu").contiguous().reshape(-1)
    return memoryview(flat.view(torch.uint8).numpy()) if flat.numel() else memoryview(b"")


def save(tensors: dict[str, torch.Tensor], metadata: dict | None = None) -> bytes:
    head, order = serialize(tensors, metadata)
    return head + b"".join(bytes(_tensor_bytes(t)) for _, t in order)


def save_file(tensors: dict[str, torch.Tensor], path: str | os.PathLike,
              metadata: dict | None = None) -> int:
    """Write one file, a tensor at a time (a device tensor is copied to
    the host alone); returns the bytes written."""
    head, order = serialize(tensors, metadata)
    n = len(head)
    # A fixture and export writer: the file is complete or the caller
    # discards its directory.
    with open(path, "wb") as f:
        f.write(head)
        for _, t in order:
            buf = _tensor_bytes(t)
            f.write(buf)
            n += buf.nbytes
    return n
