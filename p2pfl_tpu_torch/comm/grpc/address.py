"""Address parsing for the gRPC transport (the port's copy of
``p2pfl_tpu/comm/grpc/address.py``).

Parity with reference grpc/address.py:26-114: IPv4 / IPv6 / unix-socket
targets, random free port assignment when none is given.
"""

from __future__ import annotations

import ipaddress
import socket
from typing import Optional, Tuple


def free_port(host: str = "127.0.0.1") -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind((host, 0))
        return s.getsockname()[1]


def parse_address(addr: Optional[str]) -> Tuple[str, str]:
    """Normalize an address into (bind_target, public_addr).

    Accepts ``None`` (fresh localhost:random-port), ``"host"``,
    ``"host:port"``, ``"[ipv6]:port"`` and ``"unix:..."`` / ``"unix://..."``.
    """
    if addr is None or addr == "":
        port = free_port()
        return f"127.0.0.1:{port}", f"127.0.0.1:{port}"
    if addr.startswith("unix:"):
        return addr, addr
    host: str
    port: Optional[str]
    if addr.startswith("["):  # [ipv6]:port
        closing = addr.index("]")
        host = addr[1:closing]
        rest = addr[closing + 1 :]
        port = rest[1:] if rest.startswith(":") else None
    elif addr.count(":") > 1:  # bare ipv6 without port
        host, port = addr, None
    elif ":" in addr:
        host, port = addr.rsplit(":", 1)
    else:
        host, port = addr, None
    if port is None:
        port = str(free_port())
    try:
        is_v6 = isinstance(ipaddress.ip_address(host), ipaddress.IPv6Address)
    except ValueError:
        is_v6 = False  # hostname
    target = f"[{host}]:{port}" if is_v6 else f"{host}:{port}"
    return target, target
