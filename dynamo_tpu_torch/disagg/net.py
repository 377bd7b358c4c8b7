"""Shared network policy for the KV transfer planes (port of
dynamo_tpu/disagg/net.py)."""

from __future__ import annotations

_LOOPBACK = ("127.0.0.1", "localhost", "::1")


def bind_for_advertise(host: str) -> str:
    """Bind address for a receiver advertising `host`.

    A loopback advertise address keeps the listener loopback-only; anything
    else (NAT/VIP/service name or a real interface) implies remote peers,
    so bind all interfaces. One policy for both the native (C++ agent) and
    TCP-fallback planes — it is security-sensitive and must not drift.
    """
    return host if host in _LOOPBACK else "0.0.0.0"
