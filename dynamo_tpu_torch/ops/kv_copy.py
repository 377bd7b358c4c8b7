"""Device-side KV block gather/scatter — the G1 edge of the KVBM and
disagg paths (port of dynamo_tpu/ops/kv_copy.py).

The cache is per layer ``(K, V)`` of shape ``[num_blocks·bs, kvH, D]``
(engine/runner.py), plus, under int8 KV, ``kv_scales [L, 2, num_blocks,
kvH]`` float32. A block snapshot is ``[N, L, 2, bs, kvH, D]`` and a scale
row batch ``[N, L, 2, kvH]``, as in the reference.

Gathers are ``index_select`` over the flat slot axis, so a snapshot is a
tensor of its own: the source blocks may be released (and rewritten) as
soon as it is enqueued. Scatters are ``index_copy_`` and write IN PLACE:
the runner's captured CUDA graphs read ``kv_caches`` and ``kv_scales``
through the storage they were captured over, so rebinding those tensors
would leave every later replay on the old cache. Every op is enqueued on
the caller's current stream, after the steps already issued there and
before the ones issued later; nothing here synchronizes the device.

Host bytes: bfloat16 moves as its ``uint16`` bit pattern (numpy has no
bfloat16), float32 and int8 as themselves. ``HostCopy`` is an
asynchronous device→host copy into pinned memory with its completion
event: ``np.asarray`` on it waits for that event only (the KVBM pump
thread's materialization), never for the whole device.
"""

from __future__ import annotations

import numpy as np
import torch

#: Host numpy dtype of each cache dtype's bytes.
_HOST = {torch.bfloat16: np.uint16, torch.float32: np.float32,
         torch.int8: np.int8, torch.float16: np.float16}


def host_dtype(dtype: torch.dtype) -> np.dtype:
    return np.dtype(_HOST[dtype])


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """A CPU tensor's host bytes as numpy (bf16 as its uint16 bits), a
    view, no copy."""
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def from_numpy(arr: np.ndarray, dtype: torch.dtype) -> torch.Tensor:
    """Host bytes → a CPU tensor of ``dtype``: same-width bytes are
    reinterpreted (uint16 ↔ bfloat16), other widths convert by value."""
    arr = np.ascontiguousarray(arr)
    if not arr.flags.writeable:  # wire payloads are read-only buffers
        arr = arr.copy()
    want = host_dtype(dtype)
    if arr.dtype.itemsize == want.itemsize and arr.dtype != want:
        arr = arr.view(want)
    if arr.dtype != want:
        return torch.from_numpy(arr.astype(np.float32)).to(dtype)
    if dtype == torch.bfloat16:
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


class HostCopy:
    """A device tensor's copy into pinned host memory, enqueued with
    ``non_blocking=True`` on the current stream, and the event recorded
    after it. ``np.asarray(copy)`` waits on that event, then views the
    bytes. On the CPU the copy is the tensor itself (already a snapshot)."""

    def __init__(self, t: torch.Tensor) -> None:
        self.event = None
        if t.device.type == "cuda":
            host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            host.copy_(t, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record()
            t = host
        self.host = t

    def numpy(self) -> np.ndarray:
        if self.event is not None:
            self.event.synchronize()
        return to_numpy(self.host)

    def __array__(self, dtype=None, copy=None):
        arr = self.numpy()
        return arr if dtype is None else arr.astype(dtype)


def _slot_index(block_idxs, block_size: int, device) -> torch.Tensor:
    """[N·bs] flat slot indices of N blocks, built on the host and copied
    asynchronously (pinned) so the engine thread never waits on it."""
    blocks = np.asarray(block_idxs, np.int64)
    idx = (blocks[:, None] * block_size + np.arange(block_size)[None, :]).reshape(-1)
    return _to_device(idx, device)


def _to_device(arr, device) -> torch.Tensor:
    """Host numpy or CPU tensor → ``device``; to a card through a pinned
    staging copy, asynchronously (the caching host allocator keeps the
    staging buffer until the copy has run)."""
    t = arr if isinstance(arr, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(arr))
    if torch.device(device).type != "cuda":
        return t.to(device)
    if t.is_pinned():
        return t.to(device, non_blocking=True)
    staged = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    staged.copy_(t)
    return staged.to(device, non_blocking=True)


def gather_blocks_device(kv_caches, block_idxs, block_size: int) -> torch.Tensor:
    """N blocks of every layer as one device tensor [N, L, 2, bs, H, D]
    (a copy: the blocks may be rewritten once this is enqueued)."""
    k0 = kv_caches[0][0]
    n, L = len(block_idxs), len(kv_caches)
    H, D = k0.shape[1], k0.shape[2]
    idx = _slot_index(block_idxs, block_size, k0.device)
    out = torch.empty((n, L, 2, block_size, H, D), dtype=k0.dtype, device=k0.device)
    for li, (k, v) in enumerate(kv_caches):
        out[:, li, 0] = k.index_select(0, idx).view(n, block_size, H, D)
        out[:, li, 1] = v.index_select(0, idx).view(n, block_size, H, D)
    return out


def gather_blocks(kv_caches, block_idxs, block_size: int) -> np.ndarray:
    """N blocks to host [N, L, 2, bs, H, D] (waits for this copy only)."""
    return np.asarray(HostCopy(gather_blocks_device(kv_caches, block_idxs, block_size)))


def scatter_blocks(kv_caches, block_idxs, block_size: int, data) -> None:
    """Write N blocks [N, L, 2, bs, H, D] IN PLACE. ``data`` is a device
    tensor (any dtype; cast on the device) or host bytes (copied through
    pinned memory, asynchronously)."""
    k0 = kv_caches[0][0]
    n = len(block_idxs)
    if n == 0:
        return
    H, D = k0.shape[1], k0.shape[2]
    if not isinstance(data, torch.Tensor):
        data = from_numpy(np.asarray(data), k0.dtype)
    if data.device != k0.device:
        data = _to_device(data, k0.device)
    data = data.to(k0.dtype).reshape(n, len(kv_caches), 2, block_size, H, D)
    idx = _slot_index(block_idxs, block_size, k0.device)
    for li, (k, v) in enumerate(kv_caches):
        k.index_copy_(0, idx, data[:, li, 0].reshape(n * block_size, H, D))
        v.index_copy_(0, idx, data[:, li, 1].reshape(n * block_size, H, D))


def gather_scales_device(kv_scales: torch.Tensor, block_idxs) -> torch.Tensor:
    """[N, L, 2, kvH] scale rows of N blocks (a device copy)."""
    idx = _to_device(np.asarray(block_idxs, np.int64), kv_scales.device)
    return kv_scales.index_select(2, idx).permute(2, 0, 1, 3).contiguous()


def gather_scales(kv_scales: torch.Tensor, block_idxs) -> np.ndarray:
    return np.asarray(HostCopy(gather_scales_device(kv_scales, block_idxs)))


def scatter_scales(kv_scales: torch.Tensor, block_idxs, rows) -> None:
    """Write N blocks' scale rows [N, L, 2, kvH] (host or device) IN
    PLACE."""
    if len(block_idxs) == 0:
        return
    if not isinstance(rows, torch.Tensor):
        rows = torch.from_numpy(np.array(rows, np.float32))
    if rows.device != kv_scales.device:
        rows = _to_device(rows, kv_scales.device)
    rows = rows.to(torch.float32)
    idx = _to_device(np.asarray(block_idxs, np.int64), kv_scales.device)
    kv_scales.index_copy_(2, idx, rows.permute(1, 2, 0, 3))
