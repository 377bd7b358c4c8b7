"""KV-cache-aware routing (port of dynamo_tpu/llm/kv_router/).

A global radix index of which worker holds KV for which token-block
prefix, fed by the workers' KV events over the bus events plane, plus
scraped per-worker load metrics, picks the best worker per request.
Every decision is audited (``ROUTE_OBS``, ``/debug/routes``) and joined
against the engine's actual reuse by tools/route_audit.py. The router
replica set of the reference (``replicas.py``) is not ported yet.
"""

from dynamo_tpu_torch.llm.kv_router.audit import (
    ROUTE_OBS,
    RouteAuditRecord,
    RouteObservatory,
)
from dynamo_tpu_torch.llm.kv_router.indexer import KvIndexer, KvIndexerSharded, RadixTree
from dynamo_tpu_torch.llm.kv_router.protocols import (
    ForwardPassMetrics,
    KvCacheEventData,
    RouterEvent,
)
from dynamo_tpu_torch.llm.kv_router.publisher import (
    KvEventPublisher,
    WorkerMetricsPublisher,
)
from dynamo_tpu_torch.llm.kv_router.router import KvRouter, KvRouterConfig
from dynamo_tpu_torch.llm.kv_router.scheduler import DefaultWorkerSelector

__all__ = [
    "DefaultWorkerSelector",
    "ForwardPassMetrics",
    "KvCacheEventData",
    "KvEventPublisher",
    "KvIndexer",
    "KvIndexerSharded",
    "KvRouter",
    "KvRouterConfig",
    "ROUTE_OBS",
    "RadixTree",
    "RouteAuditRecord",
    "RouteObservatory",
    "RouterEvent",
    "WorkerMetricsPublisher",
]
