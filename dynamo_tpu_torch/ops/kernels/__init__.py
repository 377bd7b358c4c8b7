"""Hand-written Hopper kernels of the port, one module per kernel; each
keeps its plain PyTorch version beside it and a launch counter."""

KERNEL_SOURCES = [
    "ragged_attention", "paged_decode_attention", "paged_prefill_attention",
]
