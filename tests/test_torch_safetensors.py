"""The port's safetensors reader and writer (dynamo_tpu_torch/utils/
safetensors.py) against the ``safetensors`` package the JAX package
loads checkpoints with: for every served dtype, bf16 included, the two
writers write the same bytes and each reader reads the other's file
bit for bit. A sharded checkout reads through its index file or, without
one, every ``*.safetensors`` in sorted order; malformed headers and
unserved dtypes are refused by name."""

import json
import struct

import numpy as np
import pytest
import torch

from dynamo_tpu_torch.utils import safetensors as st

sft = pytest.importorskip("safetensors.torch")

DTYPES = sorted(st.DTYPES)


def _tensor(name: str, shape, seed: int) -> torch.Tensor:
    dt = st.DTYPES[name]
    rng = np.random.default_rng(seed)
    if dt == torch.bool:
        return torch.from_numpy(rng.integers(0, 2, shape).astype(bool))
    if dt.is_floating_point:
        return torch.from_numpy(rng.normal(0, 3, shape).astype(np.float32)).to(dt)
    info = torch.iinfo(dt)
    return torch.from_numpy(rng.integers(info.min, info.max, shape, dtype=np.int64)).to(dt)


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().view(torch.uint8) if t.element_size() == 1 else t.contiguous().view(
        {2: torch.int16, 4: torch.int32, 8: torch.int64}[t.element_size()])


@pytest.mark.parametrize("dtype", DTYPES)
def test_round_trip_byte_exact_against_the_package(dtype, tmp_path):
    tensors = {"b": _tensor(dtype, (3, 5), 0), "a.weight": _tensor(dtype, (7,), 1),
               "empty": _tensor(dtype, (0, 4), 2)}
    meta = {"format": "pt"}
    ours = st.save(tensors, metadata=meta)
    assert ours == sft.save(tensors, metadata=meta)
    # The package's file through the port's reader, the port's file
    # through the package's.
    (tmp_path / "theirs.safetensors").write_bytes(sft.save(tensors, metadata=meta))
    st.save_file(tensors, tmp_path / "ours.safetensors", metadata=meta)
    got = st.load_file(tmp_path / "theirs.safetensors")
    back = sft.load_file(str(tmp_path / "ours.safetensors"))
    for name, t in tensors.items():
        for other in (got[name], back[name]):
            assert other.dtype == t.dtype and other.shape == t.shape
            assert torch.equal(_bits(other), _bits(t))
    with st.SafeOpen(tmp_path / "theirs.safetensors") as f:
        assert f.metadata() == meta and sorted(f.keys()) == sorted(tensors)


def test_mixed_dtypes_one_file_and_get_tensor_casts(tmp_path):
    tensors = {name: _tensor(name, (2, 3), i) for i, name in enumerate(DTYPES)}
    assert st.save(tensors) == sft.save(tensors)
    path = tmp_path / "m.safetensors"
    path.write_bytes(sft.save(tensors))
    with st.SafeOpen(path) as f:
        got = f.get_tensor("BF16", dtype=torch.float32)
    assert got.dtype == torch.float32 and torch.equal(got, tensors["BF16"].float())


def _checkout(tmp_path, tensors, shards, index: bool):
    names = sorted(tensors)
    weight_map = {}
    for k in range(shards):
        fname = f"model-{k + 1:05d}-of-{shards:05d}.safetensors"
        part = {n: tensors[n] for n in names[k::shards]}
        (tmp_path / fname).write_bytes(sft.save(part, metadata={"format": "pt"}))
        weight_map.update({n: fname for n in part})
    if index:
        (tmp_path / st.INDEX_FILE).write_text(json.dumps(
            {"metadata": {"total_size": 0}, "weight_map": weight_map}))


@pytest.mark.parametrize("index", [True, False], ids=["index", "glob"])
def test_sharded_checkout_reads_every_tensor(tmp_path, index):
    tensors = {f"t{i}": _tensor("F32", (i + 1, 2), i) for i in range(7)}
    _checkout(tmp_path, tensors, shards=3, index=index)
    if index:
        # A stray file the index does not name is not read.
        (tmp_path / "stray.safetensors").write_bytes(sft.save({"t0": torch.zeros(1)}))
    with st.Checkpoint(tmp_path) as ckpt:
        assert sorted(ckpt.keys()) == sorted(tensors)
        for name, t in tensors.items():
            assert torch.equal(ckpt.get(name), t)


def test_glob_order_later_file_wins_as_the_reference_dict_does(tmp_path):
    (tmp_path / "a.safetensors").write_bytes(sft.save({"w": torch.zeros(2)}))
    (tmp_path / "b.safetensors").write_bytes(sft.save({"w": torch.ones(2)}))
    with st.Checkpoint(tmp_path) as ckpt:
        assert torch.equal(ckpt.get("w"), torch.ones(2))


def test_empty_checkout_is_refused(tmp_path):
    with pytest.raises(FileNotFoundError, match="no safetensors"):
        st.Checkpoint(tmp_path)


def _raw_file(path, header: dict, data: bytes) -> None:
    raw = json.dumps(header).encode()
    path.write_bytes(struct.pack("<Q", len(raw)) + raw + data)


BAD = {
    "overlap": ({"a": {"dtype": "F32", "shape": [2], "data_offsets": [0, 8]},
                 "b": {"dtype": "F32", "shape": [2], "data_offsets": [4, 12]}}, 12,
                "overlaps"),
    "gap": ({"a": {"dtype": "F32", "shape": [1], "data_offsets": [4, 8]}}, 8, "gap"),
    "out_of_range": ({"a": {"dtype": "F32", "shape": [4], "data_offsets": [0, 16]}}, 8,
                     "out of range"),
    "size": ({"a": {"dtype": "F32", "shape": [3], "data_offsets": [0, 8]}}, 8, "needs 12"),
    "dtype": ({"a": {"dtype": "F64", "shape": [1], "data_offsets": [0, 8]}}, 8, "'F64'"),
}


@pytest.mark.parametrize("case", sorted(BAD))
def test_malformed_files_are_refused_by_name(tmp_path, case):
    header, nbytes, words = BAD[case]
    path = tmp_path / "bad.safetensors"
    _raw_file(path, header, bytes(nbytes))
    with pytest.raises(st.SafetensorsError, match=words):
        st.SafeOpen(path)


def test_writer_refuses_an_unserved_dtype():
    with pytest.raises(st.SafetensorsError, match="float64"):
        st.save({"x": torch.zeros(2, dtype=torch.float64)})
