"""Process-global address registry for the port's in-memory transport
(reference memory/server_singleton.py: a process-global dict of servers)."""

from __future__ import annotations

import itertools
import threading
from typing import TYPE_CHECKING, Dict, Optional

if TYPE_CHECKING:  # pragma: no cover
    from p2pfl_tpu_torch.comm.memory.memory_protocol import InMemoryCommunicationProtocol


class InMemoryRegistry:
    _lock = threading.Lock()
    _servers: Dict[str, "InMemoryCommunicationProtocol"] = {}
    _counter = itertools.count()

    @classmethod
    def fresh_addr(cls) -> str:
        return f"mem://node-{next(cls._counter)}"

    @classmethod
    def register(cls, addr: str, server: "InMemoryCommunicationProtocol") -> None:
        with cls._lock:
            if addr in cls._servers:
                raise ValueError(f"address {addr} already registered")
            cls._servers[addr] = server

    @classmethod
    def unregister(cls, addr: str, server: Optional["InMemoryCommunicationProtocol"] = None) -> None:
        """Remove ``addr``. When ``server`` is given, remove only if it is
        still the registered instance — a crashed-and-restarted node at the
        same address must not be torn out of the registry by the OLD
        instance's (late) stop."""
        with cls._lock:
            if server is None or cls._servers.get(addr) is server:
                cls._servers.pop(addr, None)

    @classmethod
    def lookup(cls, addr: str) -> Optional["InMemoryCommunicationProtocol"]:
        with cls._lock:
            return cls._servers.get(addr)

    @classmethod
    def reset(cls) -> None:
        with cls._lock:
            cls._servers.clear()
