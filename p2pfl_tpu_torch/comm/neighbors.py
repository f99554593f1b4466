"""Thread-safe neighbor table (the port's copy of ``p2pfl_tpu/comm/neighbors.py``).

Parity with reference communication/protocols/neighbors.py:27-167: direct
neighbors (we hold a live connection) vs non-direct neighbors (learned about
via heartbeat gossip); refresh-or-add keeps last-seen timestamps for the
failure detector.
"""

from __future__ import annotations

import logging
import threading
import time
from collections import OrderedDict
from typing import Any, Callable, Dict, List, Optional, Tuple

log = logging.getLogger("p2pfl_tpu_torch")

#: Bound on the remembered failure-departed set (heal-detection probe pool).
_DEPARTED_CAP = 256


class Neighbors:
    """addr -> (connection, direct, last_seen). Transports subclass to build
    real connections in :meth:`connect_to`."""

    def __init__(self, self_addr: str) -> None:
        self.self_addr = self_addr
        self._lock = threading.RLock()
        self._neighbors: Dict[str, Tuple[Any, bool, float]] = {}
        # Fired (with the removed address) AFTER an entry actually leaves the
        # table — the death-propagation hook: heartbeat sweeps and send-
        # failure write-offs both land here, so one callback covers every way
        # a peer can die mid-round. Listeners run on the removing thread
        # (heartbeater/transport) outside the table lock and must be cheap.
        self._removal_listeners: List[Callable[[str], None]] = []
        # Durable recovery plane: addresses that left the table via FAILURE
        # paths (heartbeat timeout, send write-off, peer crash) — the
        # heal-detection probe pool. A graceful disconnect is NOT a
        # departure: the peer said goodbye and owes no heal. Bounded FIFO.
        self._departed: "OrderedDict[str, float]" = OrderedDict()
        # Fired when a departed peer comes BACK (a probe round-tripped, a
        # handshake re-arrived, or a heartbeat resumed): the heal hook —
        # observatory recover events and reconcile pings hang off this.
        self._recovery_listeners: List[Callable[[str], None]] = []

    # --- transport hooks ----------------------------------------------------

    def connect_to(self, addr: str, *, handshake: bool) -> Any:
        """Build a transport connection object. Default: no connection state.
        Raising here aborts :meth:`add`."""
        return None

    def disconnect_from(self, addr: str, conn: Any, *, notify: bool) -> None:
        """Tear down a transport connection object."""

    # --- table --------------------------------------------------------------

    def add(self, addr: str, *, non_direct: bool = False, handshake: bool = True) -> bool:
        if addr == self.self_addr:
            return False
        with self._lock:
            existing = self._neighbors.get(addr)
            if existing is not None:
                conn, direct, _ = existing
                if direct or non_direct:
                    # Already at least as connected as requested: refresh.
                    self._neighbors[addr] = (conn, direct, time.time())
                    self._note_returned(addr)
                    return True
        # Build the connection outside the lock (may do network IO).
        conn = None
        if not non_direct:
            conn = self.connect_to(addr, handshake=handshake)
        with self._lock:
            self._neighbors[addr] = (conn, not non_direct, time.time())
        # A peer we wrote off as dead is demonstrably back (the connect /
        # handshake / heartbeat that re-added it succeeded): heal.
        self._note_returned(addr)
        return True

    def _note_returned(self, addr: str) -> None:
        """Fire the recovery listeners iff ``addr`` was failure-departed.
        Listeners run outside the table lock on the re-adding thread."""
        with self._lock:
            if self._departed.pop(addr, None) is None:
                return
        log.warning(
            "(%s) peer %s reappeared after being written off — heal",
            self.self_addr, addr,
        )
        for fn in list(self._recovery_listeners):
            try:
                fn(addr)
            except Exception:  # a listener bug must not break membership
                log.exception("neighbor-recovery listener failed for %s", addr)

    def refresh_or_add(self, addr: str) -> None:
        """Heartbeat path (reference heartbeater.py:66-80): update last_seen,
        or learn a new non-direct neighbor."""
        with self._lock:
            existing = self._neighbors.get(addr)
            if existing is not None:
                conn, direct, _ = existing
                self._neighbors[addr] = (conn, direct, time.time())
                return
        self.add(addr, non_direct=True)

    def add_removal_listener(self, fn: Callable[[str], None]) -> None:
        self._removal_listeners.append(fn)

    def add_recovery_listener(self, fn: Callable[[str], None]) -> None:
        """Heal hook: fired (with the address) when a failure-departed peer
        demonstrably returns — a probe round-tripped, its handshake
        re-arrived, or its heartbeats resumed."""
        self._recovery_listeners.append(fn)

    def departed(self, limit: Optional[int] = None) -> List[str]:
        """Oldest-first addresses that left via failure paths (the heal
        probe pool)."""
        with self._lock:
            out = list(self._departed)
        return out[: limit] if limit is not None else out

    def remove(
        self, addr: str, *, notify: bool = False, departed: Optional[bool] = None
    ) -> None:
        """Drop ``addr``. ``departed`` marks the removal as a FAILURE
        (peer presumed dead/unreachable → eligible for heal probing);
        default: infer from ``notify`` — a notified disconnect is graceful,
        an unnotified one is a write-off."""
        with self._lock:
            entry = self._neighbors.pop(addr, None)
            if entry is not None and (departed if departed is not None else not notify):
                self._departed[addr] = time.monotonic()
                self._departed.move_to_end(addr)
                while len(self._departed) > _DEPARTED_CAP:
                    self._departed.popitem(last=False)
        if entry is None:
            return
        if entry[0] is not None:
            try:
                self.disconnect_from(addr, entry[0], notify=notify)
            except Exception:
                pass
        for fn in list(self._removal_listeners):
            try:
                fn(addr)
            except Exception:  # a listener bug must not break membership
                log.exception("neighbor-removal listener failed for %s", addr)

    def exists(self, addr: str, *, only_direct: bool = False) -> bool:
        with self._lock:
            e = self._neighbors.get(addr)
            return e is not None and (e[1] or not only_direct)

    def get(self, addr: str) -> Optional[Any]:
        with self._lock:
            e = self._neighbors.get(addr)
            return e[0] if e else None

    def get_all(self, only_direct: bool = False) -> List[str]:
        with self._lock:
            return [a for a, (_, direct, _) in self._neighbors.items() if direct or not only_direct]

    def last_seen(self) -> Dict[str, float]:
        with self._lock:
            return {a: t for a, (_, _, t) in self._neighbors.items()}

    def clear(self, *, notify: bool = True) -> None:
        """Drop every neighbor; ``notify=False`` models an abrupt crash (no
        disconnect RPCs — peers must discover the death via heartbeats).
        Teardown is never a peer departure: this table is dying, not them."""
        for addr in self.get_all():
            self.remove(addr, notify=notify, departed=False)
