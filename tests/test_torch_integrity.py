"""The port's KV-block integrity envelope
(dynamo_tpu_torch/block_manager/integrity.py): the cases of
tests/test_integrity.py on port objects — checksum primitives, the
host-onboard verify with quarantine and re-admission, quantized packed
rows, the G3 promotion verify, the background scrubber, crash-consistent
sidecar recovery with the torn-write faults, a kill -9 mid-offload
restart drill, the disagg layout handshake and the metric surfaces —
with the JAX package's envelope as the reference for the checksum and
the rows. (The G4 blockset refusal waits for the port's G4 tier.)
Block bytes and checksums are compared exactly."""

import asyncio
import dataclasses
import logging
import pathlib
import sys
import time
from types import SimpleNamespace

import numpy as np
import pytest

from dynamo_tpu.block_manager import integrity as j_integrity
from dynamo_tpu.block_manager import quant as j_bq
from dynamo_tpu.block_manager.config import KvLayoutConfig as JKvLayoutConfig
from dynamo_tpu.disagg.worker import DecodeOperator as JDecodeOperator
from dynamo_tpu_torch.block_manager import (
    BlockPool,
    DiskStorage,
    HostStorage,
    KvbmConfig,
    KvBlockManager,
    KvLayoutConfig,
)
from dynamo_tpu_torch.block_manager.integrity import (
    CHECKSUM_ALGO,
    INTEGRITY,
    block_checksum,
    verify_block,
)
from dynamo_tpu_torch.block_manager.offload import OffloadManager
from dynamo_tpu_torch.disagg.worker import DecodeOperator, PrefillWorker
from dynamo_tpu_torch.utils.faults import FAULTS

pytestmark = pytest.mark.anyio

REPO = pathlib.Path(__file__).resolve().parents[1]
LAYOUT = KvLayoutConfig(
    num_layers=2, page_size=16, num_kv_heads=2, head_dim=16, dtype="float32"
)
QLAYOUT = KvLayoutConfig(
    num_layers=2, page_size=16, num_kv_heads=2, head_dim=16,
    dtype="float32", quant="int8",
)
TORN_LAYOUT = KvLayoutConfig(
    num_layers=1, page_size=4, num_kv_heads=1, head_dim=4, dtype="float32"
)

# The crash-drill child: pushes a chain of blocks through offer → G2 →
# G3 (persist), printing "STORED <i>" once block i's bytes AND sidecar
# entry are durable; the parent SIGKILLs it mid-chain.
TORN_CHILD = r'''
import asyncio, sys
import numpy as np
from dynamo_tpu_torch.block_manager import KvbmConfig, KvBlockManager, KvLayoutConfig

LAYOUT = KvLayoutConfig(num_layers=1, page_size=4, num_kv_heads=1, head_dim=4,
                        dtype="float32")


async def main(path, blocks):
    kvbm = await KvBlockManager(KvbmConfig(
        layout=LAYOUT, host_blocks=blocks + 4, disk_blocks=blocks + 4,
        disk_path=path, disk_persist=True, offload_concurrency=1)).start()
    parent = None
    for i in range(blocks):
        h = 1000 + i
        kvbm.offer(h, parent, [i] * LAYOUT.page_size,
                   np.full((LAYOUT.block_elems,), float(i + 1), np.float32))
        await kvbm.drain_offers(10.0)
        await kvbm._g2_to_g3.drain()
        parent = h
        print(f"STORED {i}", flush=True)
        await asyncio.sleep(0.05)
    print("DONE", flush=True)


asyncio.run(main(sys.argv[1], int(sys.argv[2])))
'''


def _data(seed: float) -> np.ndarray:
    return np.full((LAYOUT.block_elems,), seed, np.float32)


@pytest.fixture(autouse=True)
def _reset_integrity():
    """The integrity ledger is process-global."""
    INTEGRITY.reset()
    yield
    INTEGRITY.reset()
    FAULTS.clear()


def test_checksum_primitives():
    arr = np.arange(64, dtype=np.float32)
    crc = block_checksum(arr)
    assert crc == block_checksum(arr.tobytes())
    assert verify_block(arr, crc)
    assert verify_block(arr.tobytes(), crc)
    assert verify_block(arr, None)
    rotten = arr.copy()
    rotten.view(np.uint8)[17] ^= 0x01
    assert not verify_block(rotten, crc)
    assert CHECKSUM_ALGO == j_integrity.CHECKSUM_ALGO == "crc32-v1"


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_checksum_equals_the_jax_envelope(seed):
    """The same bytes get the same envelope in both packages, whatever
    their dtype view (f32 rows, uint16 bf16 bits, packed uint8 rows)."""
    rng = np.random.default_rng(seed)
    for arr in (rng.standard_normal(97).astype(np.float32),
                rng.integers(0, 1 << 16, 64).astype(np.uint16),
                rng.integers(0, 256, 300).astype(np.uint8)):
        assert block_checksum(arr) == j_integrity.block_checksum(arr)
        assert block_checksum(arr.tobytes()) == j_integrity.block_checksum(arr.tobytes())


async def test_store_stamps_once_and_match_host_quarantines():
    kvbm = await KvBlockManager(KvbmConfig(layout=LAYOUT, host_blocks=8)).start()
    try:
        d = _data(3.0)
        kvbm.offer(42, None, tuple(range(16)), d)
        await kvbm.drain_offers(10.0)
        blk = kvbm.host_pool.get_by_hash(42)
        assert blk is not None
        assert blk.checksum == block_checksum(d)
        got = kvbm.match_host([42])
        assert len(got) == 1 and np.array_equal(got[0][3], d)
        assert INTEGRITY.snapshot()["integrity_failures_total"] == 0

        row = kvbm.host_pool.storage.read_block(blk.idx)
        row.view(np.uint8)[7] ^= 0x01
        assert kvbm.match_host([42]) == []
        snap = INTEGRITY.snapshot()
        assert snap["integrity_failures_host"] == 1
        assert snap["integrity_failures_total"] == 1
        assert kvbm.host_pool.get_by_hash(42) is None
        assert 42 not in kvbm.registered_hashes()
        assert all(h != 42 for h, _, _ in kvbm.host_entries())

        kvbm.offer(42, None, tuple(range(16)), d)
        await kvbm.drain_offers(10.0)
        assert 42 in kvbm.registered_hashes()
        got = kvbm.match_host([42])
        assert len(got) == 1 and np.array_equal(got[0][3], d)
    finally:
        await kvbm.stop()


async def test_quantized_packed_row_envelope():
    """quant="int8" tiers stamp the CRC over the PACKED row (int8 data ‖
    float32 scales) — the row the JAX package packs from the same values;
    rot anywhere in it, scales included, is caught."""
    kvbm = await KvBlockManager(KvbmConfig(layout=QLAYOUT, host_blocks=4)).start()
    try:
        d = np.linspace(-2.0, 2.0, QLAYOUT.block_elems, dtype=np.float32)
        kvbm.offer(7, None, tuple(range(16)), d)
        await kvbm.drain_offers(10.0)
        blk = kvbm.host_pool.get_by_hash(7)
        stored = np.asarray(kvbm.host_pool.storage.read_block(blk.idx))
        assert stored.dtype == np.uint8
        assert stored.nbytes == QLAYOUT.block_bytes
        want = j_bq.quantize_block(d, JKvLayoutConfig(**dataclasses.asdict(QLAYOUT)))
        np.testing.assert_array_equal(stored, want)
        assert blk.checksum == block_checksum(stored) == j_integrity.block_checksum(want)
        got = kvbm.match_host([7])
        assert len(got) == 1 and np.array_equal(got[0][3], stored)

        kvbm.host_pool.storage.read_block(blk.idx)[-1] ^= 0x01
        assert kvbm.match_host([7]) == []
        assert INTEGRITY.snapshot()["integrity_failures_host"] == 1
    finally:
        await kvbm.stop()


async def test_disk_promotion_verifies_envelope(tmp_path):
    host = BlockPool(HostStorage(4, LAYOUT))
    disk = BlockPool(DiskStorage(4, LAYOUT, tmp_path / "kv.bin"))
    mgr = OffloadManager(host, disk)
    for i, h in enumerate((10, 11)):
        b = host.allocate_blocks(1)[0]
        host.storage.write_block(b.idx, _data(float(i + 1)))
        b = host.register_block(
            b, h, 10 if i else None, tuple(range(16)),
            checksum=block_checksum(_data(float(i + 1))),
        )
        mgr.offload(b)
        host.release(b)
    await mgr.drain()
    assert disk.get_by_hash(10).checksum == block_checksum(_data(1.0))

    stor = disk.storage
    off = disk.get_by_hash(11).idx * LAYOUT.block_bytes + 13
    stor._map[off] = stor._map[off] ^ 0x01
    up = await mgr.onboard([10, 11])
    try:
        assert [b.sequence_hash for b in up] == [10]
        assert np.array_equal(np.asarray(host.storage.read_block(up[0].idx)), _data(1.0))
    finally:
        for b in up:
            host.release(b)
    assert INTEGRITY.snapshot()["integrity_failures_disk"] == 1
    assert disk.get_by_hash(11) is None
    assert disk.get_by_hash(10) is not None


async def test_scrub_loop_detects_and_paces(tmp_path):
    cfg = KvbmConfig(
        layout=LAYOUT, host_blocks=8, disk_blocks=8,
        disk_path=str(tmp_path / "kv.bin"),
        scrub_blocks_per_tick=4, scrub_interval_s=0.075,
    )
    kvbm = KvBlockManager(cfg)
    sleeps: list[float] = []

    async def pace(interval: float) -> None:
        sleeps.append(interval)
        await asyncio.sleep(0.005)

    kvbm._scrub_sleep = pace
    await kvbm.start()
    try:
        parent = None
        for i in range(3):
            kvbm.offer(100 + i, parent, tuple(range(16)), _data(float(i + 1)))
            parent = 100 + i
        await kvbm.drain_offers(10.0)
        await kvbm._g2_to_g3.drain()

        blk = kvbm.disk_pool.get_by_hash(101)
        stor = kvbm.disk_pool.storage
        off = blk.idx * LAYOUT.block_bytes + 11
        stor._map[off] = stor._map[off] ^ 0x01

        deadline = time.monotonic() + 10.0
        while INTEGRITY.snapshot()["scrub_detected_total"] < 1:
            assert time.monotonic() < deadline, "scrubber never caught the planted rot"
            await asyncio.sleep(0.01)
        snap = INTEGRITY.snapshot()
        assert snap["integrity_failures_disk"] == 1
        assert snap["scrub_scanned_total"] >= 1
        assert kvbm.disk_pool.get_by_hash(101) is None
        assert kvbm.disk_pool.get_by_hash(100) is not None
        assert kvbm.disk_pool.get_by_hash(102) is not None
        assert sleeps and set(sleeps) == {cfg.scrub_interval_s}
    finally:
        await kvbm.stop()


def test_sidecar_recovery_drops_torn_tail(tmp_path):
    path = tmp_path / "g3.kv"
    stor = DiskStorage(4, LAYOUT, path, persist=True)
    for i in range(3):
        d = _data(float(i + 1))
        stor.write_block(i, d)
        stor.record_block(i, 100 + i, (99 + i) if i else None, tuple(range(16)),
                          block_checksum(d))
    stor.close()
    with open(path, "r+b") as fh:
        fh.seek(2 * LAYOUT.block_bytes + 5)
        byte = fh.read(1)[0]
        fh.seek(-1, 1)
        fh.write(bytes([byte ^ 0x01]))

    INTEGRITY.reset()
    stor2 = DiskStorage(4, LAYOUT, path, persist=True)
    try:
        entries = stor2.recovered_entries()
        assert {h for _, h, *_ in entries} == {100, 101}
        for idx, _h, _parent, _tokens, crc in entries:
            assert block_checksum(stor2.read_block(idx)) == crc
        snap = INTEGRITY.snapshot()
        assert snap["integrity_failures_disk"] == 1
        assert snap["scrub_detected_total"] == 1
    finally:
        stor2.close()


def test_torn_write_fault_truncates_block_recovery_drops_it(tmp_path):
    """Armed ``kvbm.torn_write`` at the G3 write seam: half the row lands
    but the sidecar names it with its full checksum — recovery drops
    exactly that block."""
    path = tmp_path / "g3.kv"
    stor = DiskStorage(4, LAYOUT, path, persist=True)
    for i in range(2):
        d = _data(float(i + 1))
        stor.write_block(i, d)
        stor.record_block(i, 100 + i, None, tuple(range(16)), block_checksum(d))
    torn = _data(9.0)
    before = FAULTS.injected.get("kvbm.torn_write", 0)
    FAULTS.arm("kvbm.torn_write", "truncate", times=1)
    stor.write_block(2, torn)
    stor.record_block(2, 102, None, tuple(range(16)), block_checksum(torn))
    assert FAULTS.injected["kvbm.torn_write"] == before + 1
    stor.close()

    INTEGRITY.reset()
    stor2 = DiskStorage(4, LAYOUT, path, persist=True)
    try:
        assert {h for _, h, *_ in stor2.recovered_entries()} == {100, 101}
        assert INTEGRITY.snapshot()["integrity_failures_disk"] == 1
    finally:
        stor2.close()


def test_torn_write_fault_tears_sidecar_recovery_starts_fresh(tmp_path):
    """Armed ``kvbm.torn_write`` at the sidecar flush: the index JSON is
    cut mid-document; recovery degrades to an empty tier."""
    path = tmp_path / "g3.kv"
    stor = DiskStorage(4, LAYOUT, path, persist=True)
    d = _data(1.0)
    stor.write_block(0, d)
    stor.record_block(0, 100, None, tuple(range(16)), block_checksum(d))
    d2 = _data(2.0)
    stor.write_block(1, d2)
    before = FAULTS.injected.get("kvbm.torn_write", 0)
    FAULTS.arm("kvbm.torn_write", "truncate", times=1)
    stor.record_block(1, 101, None, tuple(range(16)), block_checksum(d2))
    assert FAULTS.injected["kvbm.torn_write"] == before + 1
    stor.close()
    stor2 = DiskStorage(4, LAYOUT, path, persist=True)
    try:
        assert stor2.recovered_entries() == []
    finally:
        stor2.close()


def test_corrupt_disk_fault_is_caught_at_promotion(tmp_path):
    """Armed ``kvbm.corrupt_disk`` (flip) at the G3 write: the envelope
    stamped upstream catches it when the block is promoted."""
    host = BlockPool(HostStorage(4, LAYOUT))
    disk = BlockPool(DiskStorage(4, LAYOUT, tmp_path / "kv.bin"))
    stor = disk.storage
    d = _data(5.0)
    FAULTS.arm("kvbm.corrupt_disk", "flip", times=1)
    b = disk.allocate_blocks(1)[0]
    stor.write_block(b.idx, d)
    disk.release(disk.register_block(b, 77, None, tuple(range(16)),
                                     checksum=block_checksum(d)))
    assert FAULTS.injected["kvbm.corrupt_disk"] >= 1
    mgr = OffloadManager(host, disk)
    assert mgr._onboard_blocking([77]) == []
    assert INTEGRITY.snapshot()["integrity_failures_disk"] == 1


async def test_torn_write_crash_drill(tmp_path):
    """kill -9 mid-offload, then restart: the reopened tier serves a
    contiguous, byte-identical prefix of the chain — at least everything
    the child acknowledged, never a torn block."""
    path = str(tmp_path / "g3.kv")
    proc = await asyncio.create_subprocess_exec(
        sys.executable, "-c", TORN_CHILD, path, "8",
        stdout=asyncio.subprocess.PIPE, stderr=asyncio.subprocess.STDOUT,
        cwd=str(REPO),
    )
    stored = -1
    try:
        while stored < 2:
            line = await asyncio.wait_for(proc.stdout.readline(), 60)
            assert line, "offload child died before storing 3 blocks"
            text = line.decode().strip()
            if text.startswith("STORED "):
                stored = int(text.split()[1])
        proc.kill()
    finally:
        if proc.returncode is None:
            proc.kill()
        await proc.wait()

    kvbm = await KvBlockManager(KvbmConfig(
        layout=TORN_LAYOUT, host_blocks=12, disk_blocks=12, disk_path=path,
        disk_persist=True,
    )).start()
    try:
        adopted = sorted(kvbm.disk_pool.registered_hashes())
        k = len(adopted)
        assert k >= stored + 1
        assert adopted == [1000 + j for j in range(k)]
        chain = [1000 + j for j in range(8)]
        assert await kvbm.onboard_from_disk(chain) == k
        got = kvbm.match_host(chain)
        assert len(got) == k
        for j, (h, _parent, _tokens, data) in enumerate(got):
            assert h == 1000 + j
            want = np.full((TORN_LAYOUT.block_elems,), float(j + 1), np.float32)
            assert np.array_equal(np.asarray(data), want)
        assert INTEGRITY.snapshot()["integrity_failures_total"] == 0
    finally:
        await kvbm.stop()


def _prefill_worker(head_dim=16, kv_quant=None):
    pw = PrefillWorker.__new__(PrefillWorker)
    pw.engine = SimpleNamespace(cfg=SimpleNamespace(
        model=SimpleNamespace(num_layers=2, num_kv_heads=2, head_dim=head_dim),
        block_size=16, dtype="float32", kv_quant=kv_quant))
    return pw


def _decode_layout(operator_cls, head_dim, runner_head_dim=None, kv_quant=None):
    """A decode operator's advertised layout (its _layout over a stub
    engine of the tiny geometry)."""
    op = operator_cls.__new__(operator_cls)
    model = SimpleNamespace(num_layers=2, num_kv_heads=2, num_cache_heads=2,
                            head_dim=head_dim)
    op.engine = SimpleNamespace(
        cfg=SimpleNamespace(model=model, block_size=16, dtype="float32",
                            kv_quant=kv_quant, kv_sp=False),
        runner=SimpleNamespace(cache_head_dim=runner_head_dim or head_dim, mesh=None))
    return op._layout()


def test_disagg_layout_checksum_handshake(caplog):
    pw = _prefill_worker()
    base = {"num_layers": 2, "num_kv_heads": 2, "block_size": 16,
            "dtype": "float32", "kv_quant": None}
    assert pw._check_layout({"layout": dict(base)})
    assert pw._check_layout({"layout": {**base, "checksum": CHECKSUM_ALGO}})
    with caplog.at_level(logging.ERROR, logger="dynamo_tpu_torch.disagg.worker"):
        ok = pw._check_layout(
            {"request_id": "r1", "layout": {**base, "checksum": "crc32-v0"}})
    assert not ok
    assert "mixed integrity fleet" in caplog.text


def test_layout_handshake_accepts_an_equal_peer_and_refuses_a_padded_one():
    """The port advertises its unpadded layout; a JAX decode operator on
    the CPU (its cache not lane-padded) advertises the same one and is
    accepted, a TPU one (head dim padded to 128 lanes) is refused, as is a
    precision mismatch."""
    pw = _prefill_worker()
    mine = _decode_layout(DecodeOperator, 16)
    jax_cpu = _decode_layout(JDecodeOperator, 16)
    assert {k: mine[k] for k in jax_cpu} == jax_cpu
    assert pw._check_layout({"layout": mine})
    assert pw._check_layout({"layout": jax_cpu})
    tpu = _decode_layout(JDecodeOperator, 16, runner_head_dim=128)
    assert tpu["head_dim"] == 128
    assert not pw._check_layout({"layout": tpu})
    assert not pw._check_layout({"layout": {**mine, "kv_quant": "int8"}})
    assert not pw._check_layout({"layout": {**mine, "dtype": "bfloat16"}})


def test_integrity_metric_surface_parity():
    """Every integrity ledger key is surfaced — as a ForwardPassMetrics
    field and a standalone-exporter gauge — under the kvbm_ prefix."""
    from dynamo_tpu_torch.llm import metrics_exporter
    from dynamo_tpu_torch.llm.kv_router.protocols import ForwardPassMetrics

    snap_keys = set(INTEGRITY.snapshot())
    assert snap_keys == set(j_integrity.INTEGRITY.snapshot()) == {
        "integrity_failures_total", "integrity_failures_host",
        "integrity_failures_disk", "integrity_failures_peer",
        "integrity_failures_frame", "scrub_scanned_total", "scrub_detected_total",
    }
    gauge_names = {name for name, _ in metrics_exporter._GAUGES}
    fpm_fields = {f.name for f in dataclasses.fields(ForwardPassMetrics)}
    for key in snap_keys:
        assert f"kvbm_{key}" in gauge_names
        assert f"kvbm_{key}" in fpm_fields
