"""In-memory communication protocol (the port's copy of
``p2pfl_tpu/comm/memory/memory_protocol.py``).

Parity with reference memory/memory_communication_protocol.py:33-66 +
memory_client.py:30-87: same envelope semantics as the gRPC transport but
delivery is a registry lookup + handoff to the receiver's executor (which
models the gRPC server's thread pool, so handlers never run reentrantly on
the sender's stack — avoiding the lock-inversion deadlocks a purely
synchronous in-proc transport would create).
"""

from __future__ import annotations

import concurrent.futures
import time
from dataclasses import replace
from typing import Optional

from p2pfl_tpu_torch.comm.envelope import Envelope
from p2pfl_tpu_torch.comm.memory.registry import InMemoryRegistry
from p2pfl_tpu_torch.comm.neighbors import Neighbors
from p2pfl_tpu_torch.comm.protocol import CommunicationProtocol
from p2pfl_tpu_torch.exceptions import CommunicationError


class _InMemoryNeighbors(Neighbors):
    def connect_to(self, addr: str, *, handshake: bool):
        peer = InMemoryRegistry.lookup(addr)
        if peer is None:
            raise CommunicationError(f"no in-memory server at {addr}")
        if handshake:
            peer.accept_handshake(self.self_addr)
        return addr  # connection object is just the address

    def disconnect_from(self, addr: str, conn, *, notify: bool) -> None:
        if notify:
            peer = InMemoryRegistry.lookup(addr)
            if peer is not None:
                peer.accept_disconnect(self.self_addr)


class InMemoryCommunicationProtocol(CommunicationProtocol):
    """Single-process transport backed by a global registry."""

    def __init__(self, addr: Optional[str] = None) -> None:
        self._executor: Optional[concurrent.futures.ThreadPoolExecutor] = None
        super().__init__(addr)

    def _default_addr(self) -> str:
        return InMemoryRegistry.fresh_addr()

    def _build_neighbors(self, addr: str) -> Neighbors:
        return _InMemoryNeighbors(addr)

    # --- server side --------------------------------------------------------

    def _server_start(self) -> None:
        self._executor = concurrent.futures.ThreadPoolExecutor(
            max_workers=4, thread_name_prefix=f"memsrv-{self.addr}"
        )
        InMemoryRegistry.register(self.addr, self)

    def _server_stop(self) -> None:
        # Unregister FIRST (identity-guarded: a restarted node at the same
        # address must not be torn out by this old instance), so no new
        # deliver() can reach a dying executor; then shut the executor down
        # and bound-join its workers so crash-simulating tests don't leak
        # handler threads or registry entries across cases even when
        # handlers are in flight at stop() time.
        InMemoryRegistry.unregister(self.addr, self)
        executor, self._executor = self._executor, None
        if executor is not None:
            executor.shutdown(wait=False, cancel_futures=True)
            deadline = time.monotonic() + 3.0
            for t in list(getattr(executor, "_threads", ())):
                t.join(timeout=max(0.0, deadline - time.monotonic()))

    def accept_handshake(self, source_addr: str) -> None:
        """Remote side of connect (reference grpc_server.py:135-143)."""
        if not self._running:
            raise CommunicationError(f"{self.addr} is not started")
        self.neighbors.add(source_addr, non_direct=False, handshake=False)

    def accept_disconnect(self, source_addr: str) -> None:
        # The peer said goodbye: graceful, not a failure departure — it owes
        # no heal and must not enter the recovery probe pool.
        self.neighbors.remove(source_addr, notify=False, departed=False)

    def deliver(self, env: Envelope) -> None:
        """Entry point for inbound envelopes (the "RPC")."""
        executor = self._executor
        if not self._running or executor is None:
            raise CommunicationError(f"{self.addr} is not started")
        try:
            executor.submit(self._handle_safely, env)
        except RuntimeError as exc:  # shut down between the check and submit
            raise CommunicationError(f"{self.addr} is stopping") from exc

    def _handle_safely(self, env: Envelope) -> None:
        try:
            self.handle_envelope(env)
        except Exception:
            import logging

            logging.getLogger("p2pfl_tpu_torch").exception(
                "error handling %s from %s at %s", env.cmd, env.source, self.addr
            )

    # --- client side --------------------------------------------------------

    def _transport_send(self, nei: str, env: Envelope) -> None:
        peer = InMemoryRegistry.lookup(nei)
        if peer is None:
            raise CommunicationError(f"no in-memory server at {nei}")
        # Copy the envelope so receivers can't mutate the sender's view.
        # The trace and digest slots travel natively (str fields copied by
        # replace); the gRPC transport maps them onto reserved trailing
        # control args instead — same wire semantics either way.
        peer.deliver(replace(env, args=list(env.args), contributors=list(env.contributors)))
