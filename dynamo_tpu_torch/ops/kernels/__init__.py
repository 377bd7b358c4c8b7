"""Hand-written Hopper kernels of the port, one module per kernel; each
keeps its plain PyTorch version beside it and a launch counter.

A wrapper counts its launches in Python, and Python does not run when a
CUDA graph replays. So the runner reads ``launch_counts()`` around each
capture, keeps the difference with the graph, puts the counters back
(a capture launches nothing) and adds the difference with
``add_launch_counts`` once per replay: the counters keep meaning kernel
launches on the card, whether eager or replayed.
"""

KERNEL_SOURCES = [
    "ragged_attention", "paged_decode_attention", "paged_prefill_attention",
]


def _counters():
    """(wrapper, counter attribute) of every kernel's launch counters."""
    from dynamo_tpu_torch.ops.kernels.paged_decode_attention import (
        paged_decode_attention_cuda,
    )
    from dynamo_tpu_torch.ops.kernels.paged_prefill_attention import (
        paged_prefill_attention_cuda,
    )
    from dynamo_tpu_torch.ops.kernels.ragged_attention import (
        ragged_paged_attention_cuda,
    )

    return [
        (ragged_paged_attention_cuda, "launches"),
        (ragged_paged_attention_cuda, "launches_tc"),
        (ragged_paged_attention_cuda, "launches_walk"),
        (ragged_paged_attention_cuda, "launches_split"),
        (paged_decode_attention_cuda, "launches"),
        (paged_prefill_attention_cuda, "launches"),
        (paged_prefill_attention_cuda, "launches_tc"),
    ]


def launch_counts() -> dict[str, int]:
    """Every launch counter, keyed ``wrapper.attribute``."""
    return {f"{fn.__name__}.{attr}": getattr(fn, attr) for fn, attr in _counters()}


def set_launch_counts(counts: dict[str, int]) -> None:
    for fn, attr in _counters():
        setattr(fn, attr, counts[f"{fn.__name__}.{attr}"])


def add_launch_counts(delta: dict[str, int]) -> None:
    """Add a captured graph's launches, once per replay."""
    for fn, attr in _counters():
        key = f"{fn.__name__}.{attr}"
        if delta.get(key):
            setattr(fn, attr, getattr(fn, attr) + delta[key])
