"""dynamo_tpu_torch: the PyTorch/CUDA port of dynamo_tpu for NVIDIA Hopper.

The JAX package (``dynamo_tpu``) is the reference this package is held
against; the module layout mirrors it so each port module's counterpart
is found by name (``dynamo_tpu_torch.models.llama`` ↔
``dynamo_tpu.models.llama``). This package imports ``torch`` and never
``jax`` or anything of ``dynamo_tpu``.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
without a CUDA device and without that request they raise (see
``resolve_device``).
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """The device an entry point runs on: ``cuda`` by default, the CPU
    only when the caller asks for it. A CUDA request on a machine with
    no CUDA device raises — the port never carries on quietly on the
    CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "dynamo_tpu_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run the plain PyTorch path"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev
