"""Key-value store with leases and prefix watches — the discovery plane
(port of dynamo_tpu/runtime/transports/store.py).

Plays etcd's role: instance registration keys are bound to a worker's
lease; when the lease expires (worker death) the keys vanish and every
watcher sees the worker disappear.

- ``MemoryStore`` — in-process, for single-process serving and tests;
- ``ControlPlaneClient`` (transports/control_client.py) — the same
  protocol over the control-plane server.
"""

from __future__ import annotations

import asyncio
import enum
import itertools
import time
from dataclasses import dataclass, field
from typing import AsyncIterator, Protocol


class EventKind(enum.Enum):
    PUT = "put"
    DELETE = "delete"


@dataclass(frozen=True)
class WatchEvent:
    kind: EventKind
    key: str
    value: bytes | None = None


class Watch:
    """A live prefix watch: initial snapshot + async event stream."""

    def __init__(self, initial: dict[str, bytes]) -> None:
        self.initial = initial
        self._queue: asyncio.Queue[WatchEvent | None] = asyncio.Queue()
        self.cancelled = False

    def _emit(self, ev: WatchEvent) -> None:
        if not self.cancelled:
            self._queue.put_nowait(ev)

    def cancel(self) -> None:
        self.cancelled = True
        self._queue.put_nowait(None)

    def __aiter__(self) -> AsyncIterator[WatchEvent]:
        return self

    async def __anext__(self) -> WatchEvent:
        ev = await self._queue.get()
        if ev is None:
            raise StopAsyncIteration
        return ev


class KeyValueStore(Protocol):
    async def put(self, key: str, value: bytes, lease_id: int | None = None) -> None: ...
    async def create(self, key: str, value: bytes, lease_id: int | None = None) -> bool: ...
    async def get(self, key: str) -> bytes | None: ...
    async def get_prefix(self, prefix: str) -> dict[str, bytes]: ...
    async def delete(self, key: str) -> None: ...
    async def delete_prefix(self, prefix: str) -> None: ...
    async def grant_lease(self, ttl_s: float) -> int: ...
    async def keep_alive(self, lease_id: int) -> bool: ...
    async def revoke_lease(self, lease_id: int) -> None: ...
    async def watch_prefix(self, prefix: str) -> Watch: ...


@dataclass
class _Lease:
    id: int
    ttl_s: float
    expires_at: float
    keys: set[str] = field(default_factory=set)


class MemoryStore:
    """In-process KeyValueStore with real lease-expiry semantics."""

    def __init__(self) -> None:
        self._data: dict[str, bytes] = {}
        self._key_lease: dict[str, int] = {}
        self._leases: dict[int, _Lease] = {}
        self._watches: list[tuple[str, Watch]] = []
        self._lease_ids = itertools.count(0x1000)
        self._reaper: asyncio.Task | None = None

    # -- internals ----------------------------------------------------------
    def _notify(self, ev: WatchEvent) -> None:
        for prefix, watch in list(self._watches):
            if watch.cancelled:
                self._watches.remove((prefix, watch))
            elif ev.key.startswith(prefix):
                watch._emit(ev)

    def _delete_key(self, key: str) -> None:
        if key in self._data:
            del self._data[key]
            lease = self._key_lease.pop(key, None)
            if lease is not None and lease in self._leases:
                self._leases[lease].keys.discard(key)
            self._notify(WatchEvent(EventKind.DELETE, key))

    def _ensure_reaper(self) -> None:
        if self._reaper is None or self._reaper.done():
            self._reaper = asyncio.ensure_future(self._reap_loop())

    async def _reap_loop(self) -> None:
        while self._leases:
            now = time.monotonic()
            for lease in list(self._leases.values()):
                if lease.expires_at <= now:
                    await self.revoke_lease(lease.id)
            await asyncio.sleep(0.05)

    def _attach_lease(self, key: str, lease_id: int | None) -> None:
        if lease_id is None:
            return
        lease = self._leases.get(lease_id)
        if lease is None:
            raise KeyError(f"unknown lease {lease_id:#x}")
        lease.keys.add(key)
        self._key_lease[key] = lease_id

    # -- KeyValueStore ------------------------------------------------------
    async def put(self, key: str, value: bytes, lease_id: int | None = None) -> None:
        self._data[key] = value
        self._attach_lease(key, lease_id)
        self._notify(WatchEvent(EventKind.PUT, key, value))

    async def create(self, key: str, value: bytes, lease_id: int | None = None) -> bool:
        if key in self._data:
            return False
        await self.put(key, value, lease_id)
        return True

    async def get(self, key: str) -> bytes | None:
        return self._data.get(key)

    async def get_prefix(self, prefix: str) -> dict[str, bytes]:
        return {k: v for k, v in self._data.items() if k.startswith(prefix)}

    async def delete(self, key: str) -> None:
        self._delete_key(key)

    async def delete_prefix(self, prefix: str) -> None:
        for key in [k for k in self._data if k.startswith(prefix)]:
            self._delete_key(key)

    async def grant_lease(self, ttl_s: float) -> int:
        lease_id = next(self._lease_ids)
        self._leases[lease_id] = _Lease(
            id=lease_id, ttl_s=ttl_s, expires_at=time.monotonic() + ttl_s
        )
        self._ensure_reaper()
        return lease_id

    async def keep_alive(self, lease_id: int) -> bool:
        lease = self._leases.get(lease_id)
        if lease is None:
            return False
        lease.expires_at = time.monotonic() + lease.ttl_s
        return True

    async def revoke_lease(self, lease_id: int) -> None:
        lease = self._leases.pop(lease_id, None)
        if lease is None:
            return
        for key in list(lease.keys):
            self._delete_key(key)

    async def watch_prefix(self, prefix: str) -> Watch:
        watch = Watch(await self.get_prefix(prefix))
        self._watches.append((prefix, watch))
        return watch


class KvCache:
    """A watched, locally cached view of a prefix — live dynamic config.

    Mirrors the reference's EtcdKvCache used for runtime-updatable disagg
    thresholds (reference: lib/runtime/src/transports/etcd.rs:471-597).
    """

    def __init__(self, store: KeyValueStore, prefix: str) -> None:
        self._store = store
        self._prefix = prefix
        self._cache: dict[str, bytes] = {}
        self._task: asyncio.Task | None = None

    async def start(self) -> None:
        watch = await self._store.watch_prefix(self._prefix)
        self._cache = dict(watch.initial)
        self._task = asyncio.ensure_future(self._pump(watch))

    async def _pump(self, watch: Watch) -> None:
        async for ev in watch:
            if ev.kind is EventKind.PUT:
                self._cache[ev.key] = ev.value or b""
            else:
                self._cache.pop(ev.key, None)

    def get(self, key: str) -> bytes | None:
        return self._cache.get(self._prefix + key)

    def snapshot(self) -> dict[str, bytes]:
        return dict(self._cache)

    def stop(self) -> None:
        if self._task:
            self._task.cancel()
