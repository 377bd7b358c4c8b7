"""Namespace → Component → Endpoint component model (port of
dynamo_tpu/runtime/component.py).

Mirrors the reference hierarchy (reference: lib/runtime/src/component.rs:106,
docs/architecture/distributed_runtime.md:22-29): a deployment is organized as
namespaces containing components exposing endpoints. A live *instance* is an
endpoint served by one worker, registered in the discovery store under
``instances/{ns}/{comp}/{endpoint}:{lease_id_hex}`` (reference:
component.rs:62-64,318-325) with the key bound to the worker's lease, so
worker death auto-deregisters it.

Endpoints are addressed as ``dyn://namespace.component.endpoint``
(reference: lib/runtime/src/protocols.rs:35-171).
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import TYPE_CHECKING, Any

if TYPE_CHECKING:
    from dynamo_tpu_torch.runtime.distributed import DistributedRuntime

INSTANCE_ROOT = "instances/"


@dataclass(frozen=True)
class EndpointId:
    namespace: str
    component: str
    name: str

    @staticmethod
    def parse(path: str) -> "EndpointId":
        """Parse ``dyn://ns.component.endpoint`` or ``ns.component.endpoint``."""
        if path.startswith("dyn://"):
            path = path[len("dyn://") :]
        parts = path.split(".")
        if len(parts) < 3:
            raise ValueError(
                f"endpoint path {path!r} must be namespace.component.endpoint"
            )
        return EndpointId(parts[0], ".".join(parts[1:-1]), parts[-1])

    def __str__(self) -> str:
        return f"dyn://{self.namespace}.{self.component}.{self.name}"

    @property
    def etcd_prefix(self) -> str:
        return f"{INSTANCE_ROOT}{self.namespace}/{self.component}/{self.name}:"


@dataclass(frozen=True)
class Instance:
    """A live served endpoint: identity + bus subject for requests."""

    endpoint: EndpointId
    lease_id: int
    subject: str
    # What the instance says of itself in discovery (a router replica:
    # ``routes_to`` and ``replica_id``); not part of its identity.
    metadata: dict = field(default_factory=dict, compare=False)

    @property
    def instance_id(self) -> int:
        # Workers are identified by their lease id (reference: worker_id ==
        # lease_id throughout the KV-router protocols).
        return self.lease_id

    @property
    def store_key(self) -> str:
        return f"{self.endpoint.etcd_prefix}{self.lease_id:x}"

    def to_json(self) -> bytes:
        d = {
            "namespace": self.endpoint.namespace,
            "component": self.endpoint.component,
            "endpoint": self.endpoint.name,
            "lease_id": self.lease_id,
            "subject": self.subject,
        }
        if self.metadata:
            d["metadata"] = self.metadata
        return json.dumps(d).encode()

    @staticmethod
    def from_json(raw: bytes) -> "Instance":
        d = json.loads(raw)
        return Instance(
            endpoint=EndpointId(d["namespace"], d["component"], d["endpoint"]),
            lease_id=d["lease_id"],
            subject=d["subject"],
            metadata=dict(d.get("metadata") or {}),
        )


class Namespace:
    def __init__(self, drt: "DistributedRuntime", name: str) -> None:
        self._drt = drt
        self.name = name

    def component(self, name: str) -> "Component":
        return Component(self._drt, self, name)


class Component:
    def __init__(self, drt: "DistributedRuntime", ns: Namespace, name: str) -> None:
        self._drt = drt
        self.namespace = ns
        self.name = name

    @property
    def service_name(self) -> str:
        return f"{self.namespace.name}_{self.name}"

    def endpoint(self, name: str) -> "Endpoint":
        return Endpoint(self._drt, self, name)

    def event_subject(self, plane: str) -> str:
        """Component-scoped broadcast subject (kv_events, kv-hit-rate)."""
        return f"{self.service_name}.events.{plane}"


class Endpoint:
    def __init__(self, drt: "DistributedRuntime", comp: Component, name: str) -> None:
        self._drt = drt
        self.component = comp
        self.name = name

    @property
    def id(self) -> EndpointId:
        return EndpointId(
            self.component.namespace.name, self.component.name, self.name
        )

    def subject_for(self, lease_id: int) -> str:
        """Per-instance request subject (reference: component.rs:335-346)."""
        return f"{self.component.service_name}.{self.name}-{lease_id:x}"

    async def serve(self, engine: Any, metadata: dict | None = None):
        """Register this endpoint instance (with ``metadata`` in its
        discovery record) and start handling requests. Returns a
        `ServedInstance` handle (stop() deregisters)."""
        from dynamo_tpu_torch.runtime.ingress import serve_endpoint

        return await serve_endpoint(self._drt, self, engine, metadata)
