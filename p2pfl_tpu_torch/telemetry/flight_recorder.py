"""Flight recorder: a bounded ring of structured events, dumped postmortem (the port's framework-free copy of
``p2pfl_tpu/telemetry/flight_recorder.py``, its imports rerouted to ``p2pfl_tpu_torch``).

Every node keeps the last ``Settings.FLIGHTREC_CAPACITY`` notable events —
stage transitions, model-plane sends/recvs, admission rejections, injected
chaos faults, peer deaths, digest deltas — cheaply in memory. Nobody reads
it while things work; when a node crashes (``Node.crash()``, a workflow
exception) or the aggregation stall patience fires, the ring dumps to
``artifacts/flightrec_<node>.json`` so the postmortem for exactly the
failures the chaos plane injects is a file, not N processes' interleaved
logs.

Recording is a deque append under a small lock (the deque's ``maxlen``
drops the oldest event; drops are counted in
``p2pfl_flightrec_events_dropped_total``). Dumping never raises — a broken
disk must not break the crash path it is documenting.
"""

from __future__ import annotations

import json
import logging
import os
import re
import threading
import time
import weakref
from collections import deque
from typing import Any, Dict, List, Optional

from p2pfl_tpu_torch.config import Settings
from p2pfl_tpu_torch.telemetry.metrics import REGISTRY

log = logging.getLogger("p2pfl_tpu_torch")

#: dump-doc schema: v2 added the common versioned "header" block
#: (run_id / schema_version / node / clock era). v1 readers that only
#: know the legacy top-level keys keep working — those keys are retained.
FLIGHTREC_SCHEMA_VERSION = 2

# Live-recorder registry: the evidence-bundle writer needs to dump every
# recorder in the process, not just the one owned by the failing
# component. Weak references — a recorder's lifetime is its owner's.
_LIVE: "weakref.WeakSet[FlightRecorder]" = weakref.WeakSet()
_LIVE_LOCK = threading.Lock()


def live_recorders() -> List["FlightRecorder"]:
    """Every recorder still alive in this process, sorted by node address
    (stable member ordering for bundle manifests)."""
    with _LIVE_LOCK:
        recs = list(_LIVE)
    return sorted(recs, key=lambda r: r._addr)


def reset_live_recorders() -> None:
    """Forget all live recorders (test/scenario isolation — a stale ring
    from a previous scenario must not leak into the next bundle)."""
    with _LIVE_LOCK:
        _LIVE.clear()

_DROPPED = REGISTRY.counter(
    "p2pfl_flightrec_events_dropped_total",
    "Flight-recorder events evicted by the ring bound (oldest first)",
    labels=("node",),
)
_DUMPS = REGISTRY.counter(
    "p2pfl_flightrec_dumps_total",
    "Flight-recorder postmortem dumps written, by trigger",
    labels=("node", "trigger"),
)


def _safe_name(addr: str) -> str:
    """Address -> filesystem-safe dump-file stem ("127.0.0.1:50051" and
    in-memory "node-3" both must map to a writable name)."""
    return re.sub(r"[^A-Za-z0-9_.-]", "_", addr) or "node"


class FlightRecorder:
    """Per-node bounded event ring + postmortem dumper."""

    def __init__(self, addr: str, capacity: Optional[int] = None) -> None:
        self._addr = addr
        cap = int(capacity if capacity is not None else Settings.FLIGHTREC_CAPACITY)
        self._events: deque = deque(maxlen=max(1, cap))
        self._lock = threading.Lock()
        self._dropped = _DROPPED.labels(addr)
        with _LIVE_LOCK:
            _LIVE.add(self)

    @property
    def capacity(self) -> int:
        return self._events.maxlen or 0

    def record(self, kind: str, **detail: Any) -> None:
        """Append one event. ``detail`` values must be JSON-able (strings /
        numbers — callers pass addresses, rounds, byte counts).

        Timestamps are stored on the MONOTONIC clock only; the mono->wall
        mapping is computed when events are read (:meth:`events` /
        :meth:`dump`), not frozen at construction — an NTP step mid-run
        therefore shifts all reported wall times consistently instead of
        splitting the ring across two clock eras.
        """
        ev = {"t_mono": round(time.monotonic(), 6), "kind": kind}
        ev.update(detail)
        with self._lock:
            if len(self._events) == self._events.maxlen:
                self._dropped.inc()
            self._events.append(ev)

    @staticmethod
    def _mono_to_wall_epoch() -> float:
        """CURRENT mono->wall mapping (wall seconds at monotonic 0)."""
        return time.time() - time.monotonic()

    def events(self) -> List[Dict[str, Any]]:
        """Ring contents, oldest first, with wall-clock ``t`` derived from
        the stored monotonic stamp at READ time."""
        epoch = self._mono_to_wall_epoch()
        with self._lock:
            raw = [dict(e) for e in self._events]
        for e in raw:
            e["t"] = round(e["t_mono"] + epoch, 6)
        return raw

    def clear(self) -> None:
        with self._lock:
            self._events.clear()

    # --- postmortem ----------------------------------------------------------

    def dump_path(self, directory: str = "artifacts") -> str:
        return os.path.join(directory, f"flightrec_{_safe_name(self._addr)}.json")

    def dump(self, trigger: str, directory: str = "artifacts") -> Optional[str]:
        """Write the ring (newest last) to ``flightrec_<node>.json``.

        Called from crash paths and transport threads: swallows every error
        (logged) and returns ``None`` on failure, the path on success. A
        later dump for the same node overwrites — the freshest postmortem
        wins.
        """
        try:
            from p2pfl_tpu_torch.telemetry.bundle import artifact_header

            events = self.events()
            path = self.dump_path(directory)
            os.makedirs(directory, exist_ok=True)
            # pid alone collides when two threads dump into one bundle dir
            tmp = f"{path}.tmp.{os.getpid()}.{threading.get_ident()}"
            with open(tmp, "w") as f:
                json.dump(
                    {
                        "header": artifact_header(
                            node=self._addr,
                            kind="flightrec",
                            schema_version=FLIGHTREC_SCHEMA_VERSION,
                        ),
                        "node": self._addr,
                        "trigger": trigger,
                        # Both clocks at dump time plus the mapping used for
                        # the events' wall "t": a postmortem reader can both
                        # line events up with other hosts' logs (wall) and
                        # compute exact in-process gaps (mono, step-free).
                        "dumped_at": time.time(),
                        "dumped_at_mono": time.monotonic(),
                        "mono_to_wall_epoch": self._mono_to_wall_epoch(),
                        "dropped_before_ring": self._dropped.value,
                        "events": events,
                    },
                    f,
                    indent=1,
                )
            os.replace(tmp, path)
            _DUMPS.labels(self._addr, trigger).inc()
            log.warning(
                "(%s) flight recorder dumped %d events to %s (trigger=%s)",
                self._addr, len(events), path, trigger,
            )
            return path
        except Exception:  # noqa: BLE001 — never break the crash path
            log.exception("(%s) flight-recorder dump failed", self._addr)
            return None


__all__ = [
    "FLIGHTREC_SCHEMA_VERSION",
    "FlightRecorder",
    "live_recorders",
    "reset_live_recorders",
]
