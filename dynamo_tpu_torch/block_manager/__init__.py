"""KVBM — multi-tier KV block manager (port of dynamo_tpu/block_manager).

Tiers: G1 device memory (the engine's paged cache), G2 host DRAM, G3
local disk. Blocks move through the Reset → Partial → Complete →
Registered lifecycle with register/remove events, per-tier pools with
sequence-hash reuse, and an offload manager demoting registered blocks
down-tier and onboarding them back; every tier crossing is checksummed
(integrity.py). G1↔G2 movement is a device gather/scatter plus a
host copy through pinned memory (ops/kv_copy.py); G2↔G3 is mmap IO.

Not in the port yet: the G4 tiers (remote blocksets and peer pulls).
"""

from dynamo_tpu_torch.block_manager.config import KvbmConfig, KvLayoutConfig
from dynamo_tpu_torch.block_manager.manager import KvBlockManager
from dynamo_tpu_torch.block_manager.pool import BlockPool
from dynamo_tpu_torch.block_manager.storage import (
    DeviceStorage,
    DiskStorage,
    HostStorage,
    NullStorage,
)

__all__ = [
    "BlockPool",
    "DeviceStorage",
    "DiskStorage",
    "HostStorage",
    "KvBlockManager",
    "KvbmConfig",
    "KvLayoutConfig",
    "NullStorage",
]
