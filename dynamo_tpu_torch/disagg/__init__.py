"""Disaggregated prefill/decode serving (port of dynamo_tpu/disagg).

Decode workers keep their inter-token latency by pushing long prefills
to dedicated prefill workers; the computed KV blocks come back over the
transfer plane into the decode worker's pre-allocated blocks: the
device channel within one process (device_transfer.py), the C++ agent
(native_transfer.py) or TCP (transfer.py) across processes.
"""

from dynamo_tpu_torch.disagg.queue import PrefillQueue
from dynamo_tpu_torch.disagg.router import DisaggConfig, DisaggRouter
from dynamo_tpu_torch.disagg.transfer import KvReceiver, KvSender
from dynamo_tpu_torch.disagg.worker import DecodeOperator, PrefillWorker

__all__ = [
    "DecodeOperator",
    "DisaggConfig",
    "DisaggRouter",
    "KvReceiver",
    "KvSender",
    "PrefillQueue",
    "PrefillWorker",
]
