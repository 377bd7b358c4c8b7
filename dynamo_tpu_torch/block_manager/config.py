"""KVBM configuration (port of dynamo_tpu/block_manager/config.py:
runtime config + per-tier block layout).

``KvLayoutConfig.for_engine`` describes the port's own G1 block: the
model's head dim as the cache holds it (the CUDA kernels need no
128-lane pad) and numpy dtype names. A JAX engine on the CPU holds the
same unpadded layout; a TPU engine's lane-padded one differs, so the
disagg layout handshake refuses it (disagg/worker.py)."""

from __future__ import annotations

from dataclasses import dataclass


#: Explicit bytes-per-element per logical dtype — the ONE table storage
#: sizing reads, so a tier can never silently assume a different width
#: than capacity accounting used (the mixed-precision-pool bug class).
DTYPE_BYTES = {"bfloat16": 2, "float16": 2, "float32": 4, "int8": 1}

#: Bytes per scale element in a quantized block's sidecar (float32).
SCALE_BYTES_PER_ELEM = 4


@dataclass(frozen=True)
class KvLayoutConfig:
    """Shape of one KV block (reference: config.rs:71-85 — num_layers,
    outer_dim, page_size, inner_dim).

    ``dtype`` is the COMPUTE dtype of the KV values. ``quant`` selects
    the tier's STORAGE precision (docs/architecture/kv_quant.md): with
    ``quant="int8"`` a stored block is a packed row of
    ``[int8 data || float32 per-(layer, K/V, head) scales]`` — the
    explicit ``bytes_per_element`` + ``scale_bytes`` accounting below is
    what keeps host/disk capacity and occupancy correct for
    mixed-precision pools instead of silently assuming one dtype per
    arena."""

    num_layers: int
    page_size: int          # tokens per block
    num_kv_heads: int
    head_dim: int
    dtype: str = "bfloat16"
    quant: str | None = None   # None = store in `dtype`; "int8" = packed

    @classmethod
    def for_engine(
        cls, engine_cfg, quant: str | None = "int8"
    ) -> "KvLayoutConfig":
        """The layout of one of an engine's G1 blocks — ONE definition
        shared by the runner's packed-row wire form, the mocker's
        advertised precision ratio and the disagg staging arena. Its
        heads and head dim are the cache's own (MLA: one shared latent
        entry of kv_lora_rank + qk_rope_head_dim); the port's cache is
        never lane-padded."""
        m = engine_cfg.model
        return cls(
            num_layers=m.num_layers,
            page_size=engine_cfg.block_size,
            num_kv_heads=m.num_cache_heads,
            head_dim=m.kv_cache_head_dim,
            dtype=engine_cfg.dtype,
            quant=quant,
        )

    @property
    def outer_dim(self) -> int:
        return 2  # K and V

    @property
    def block_elems(self) -> int:
        return (
            self.num_layers
            * self.outer_dim
            * self.page_size
            * self.num_kv_heads
            * self.head_dim
        )

    @property
    def bytes_per_element(self) -> int:
        """STORAGE bytes per KV element in this tier (1 when quantized,
        regardless of the compute dtype)."""
        if self.quant == "int8":
            return 1
        return DTYPE_BYTES[self.dtype]

    @property
    def scale_elems(self) -> int:
        """Scale-sidecar entries per block: one per (layer, K/V, head);
        0 for unquantized layouts."""
        if self.quant != "int8":
            return 0
        return self.num_layers * self.outer_dim * self.num_kv_heads

    @property
    def scale_bytes(self) -> int:
        return self.scale_elems * SCALE_BYTES_PER_ELEM

    @property
    def data_bytes(self) -> int:
        return self.block_elems * self.bytes_per_element

    @property
    def block_bytes(self) -> int:
        """Total stored bytes per block: data + scale sidecar."""
        return self.data_bytes + self.scale_bytes

    @property
    def unquantized_block_bytes(self) -> int:
        """What the block would cost stored in the compute dtype — the
        baseline for bytes-saved telemetry."""
        return self.block_elems * DTYPE_BYTES[self.dtype]


@dataclass
class KvbmConfig:
    worker_id: int = 0
    layout: KvLayoutConfig | None = None
    device_blocks: int = 0          # G1 (0 = tier disabled)
    host_blocks: int = 0            # G2
    disk_blocks: int = 0            # G3
    disk_path: str | None = None
    enable_offload: bool = True
    offload_concurrency: int = 4    # reference: offload.rs MAX_CONCURRENT_TRANSFERS
    offload_batch: int = 16         # reference: offload.rs MAX_TRANSFER_BATCH_SIZE
    # Crash-consistent G3 (docs/architecture/integrity.md): keep a
    # block-index sidecar beside disk_path (tmp+os.replace+fsync) and
    # re-adopt the checksum-valid blocks at restart instead of
    # truncating the tier.
    disk_persist: bool = False
    # Background G3 scrubber: blocks verified per sweep tick (0 = off)
    # and the pacing interval between ticks (clock-injectable — tests
    # call scrub_tick() directly).
    scrub_blocks_per_tick: int = 0
    scrub_interval_s: float = 0.25
