"""Heartbeat-based membership / failure detector (the port's copy of
``p2pfl_tpu/comm/heartbeater.py``).

Parity with reference communication/protocols/heartbeater.py:33-113: a thread
broadcasts a ``beat`` every ``HEARTBEAT_PERIOD``; every second tick it sweeps
neighbors whose last_seen is older than ``HEARTBEAT_TIMEOUT``. Incoming beats
call :meth:`beat` -> ``neighbors.refresh_or_add`` — this is how non-direct
neighbors are discovered.

Telemetry: the sender's ``timestamp`` (previously discarded) now feeds a
per-peer clock-skew gauge — in-process federations read ~0, a real
deployment surfaces NTP drift, the thing that silently breaks timeout-based
failure detection — plus a beat inter-arrival gauge (receive-side jitter),
a live-peer gauge and a missed-beat counter.

Observatory piggyback: when a digest source is wired (``digest_fn``) and
``Settings.DIGEST_ENABLED``, every ``DIGEST_EVERY_BEATS``-th beat carries
the node's encoded health digest in ``Envelope.digest`` — the heartbeat was
already the one frame every peer sees periodically, so fleet observability
rides it for free. Beats without a digest stay byte-identical to the
pre-digest wire format.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Callable, Dict, Optional

log = logging.getLogger("p2pfl_tpu_torch")

from p2pfl_tpu_torch.comm.envelope import Envelope
from p2pfl_tpu_torch.comm.neighbors import Neighbors
from p2pfl_tpu_torch.config import Settings
from p2pfl_tpu_torch.telemetry import REGISTRY

HEARTBEAT_CMD = "beat"

_LIVE_PEERS = REGISTRY.gauge(
    "p2pfl_heartbeat_live_peers",
    "Neighbors with a fresh heartbeat at the last sweep",
    labels=("node",),
)
_MISSED = REGISTRY.counter(
    "p2pfl_heartbeat_missed_total",
    "Neighbors dropped for missing heartbeats past HEARTBEAT_TIMEOUT",
    labels=("node", "peer"),
)
_CLOCK_SKEW = REGISTRY.gauge(
    "p2pfl_heartbeat_clock_skew_seconds",
    "Receiver wall-clock minus the sender-stamped beat timestamp",
    labels=("node", "peer"),
)
_INTERARRIVAL = REGISTRY.gauge(
    "p2pfl_heartbeat_interarrival_seconds",
    "Seconds between consecutive beats from the same peer",
    labels=("node", "peer"),
)


class Heartbeater:
    def __init__(
        self,
        self_addr: str,
        neighbors: Neighbors,
        broadcast_fn: Callable[[Envelope], None],
        digest_fn: Optional[Callable[[], Optional[str]]] = None,
        probe_fn: Optional[Callable[[], None]] = None,
    ) -> None:
        self._self_addr = self_addr
        self._neighbors = neighbors
        self._broadcast = broadcast_fn
        # Returns the node's ENCODED health digest (or None to skip this
        # beat). Settable after construction (protocol.set_digest_source);
        # None keeps beats digest-free — the pre-observatory wire format.
        self._digest_fn = digest_fn
        # Heal detection (protocol._probe_departed): invoked on every sweep
        # tick so write-offs that were a PARTITION, not a death, are
        # rediscovered once the partition heals — beats alone cannot carry
        # a peer back after the failed send dropped the last link to it.
        self._probe_fn = probe_fn
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._last_beat_at: Dict[str, float] = {}  # peer -> local monotonic
        self._clock_skew: Dict[str, float] = {}  # peer -> our wall - theirs
        self._live_peers = _LIVE_PEERS.labels(self_addr)

    def clock_skews(self) -> Dict[str, float]:
        """Latest per-peer clock skew (our wall clock minus the sender's
        stamped beat time, seconds). The snapshot trace export
        (``CommunicationProtocol.export_trace``) annotates dumps with this
        so the critical-path merge can align per-process timelines."""
        return dict(self._clock_skew)

    def set_digest_source(self, digest_fn: Optional[Callable[[], Optional[str]]]) -> None:
        self._digest_fn = digest_fn

    def start(self) -> None:
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._run, name=f"heartbeater-{self._self_addr}", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None

    def beat(self, source: str, timestamp: float) -> None:
        """Incoming heartbeat (reference heartbeater.py:66-80)."""
        if source == self._self_addr:
            return
        if timestamp > 0.0:
            # Skew folds in one-way latency; for drift detection that noise
            # floor (ms) is far below the drift that matters (seconds).
            skew = time.time() - timestamp
            self._clock_skew[source] = skew
            _CLOCK_SKEW.labels(self._self_addr, source).set(skew)
        now = time.monotonic()
        prev = self._last_beat_at.get(source)
        self._last_beat_at[source] = now
        if prev is not None:
            _INTERARRIVAL.labels(self._self_addr, source).set(now - prev)
        self._neighbors.refresh_or_add(source)

    def _run(self) -> None:
        tick = 0
        while not self._stop.is_set():
            try:
                env = Envelope.message(
                    self._self_addr, HEARTBEAT_CMD, args=[str(time.time())]
                )
                if (
                    self._digest_fn is not None
                    and Settings.DIGEST_ENABLED
                    and tick % Settings.DIGEST_EVERY_BEATS == 0
                ):
                    try:
                        env.digest = self._digest_fn() or ""
                    except Exception:  # digest trouble must not stop the beat
                        log.exception(
                            "(%s) health-digest source failed", self._self_addr
                        )
                self._broadcast(env)
            except Exception:
                pass
            tick += 1
            if tick % 2 == 0:  # sweep stale neighbors (reference :85-105)
                now = time.time()
                last_seen = self._neighbors.last_seen()
                for addr, seen in last_seen.items():
                    if now - seen > Settings.HEARTBEAT_TIMEOUT:
                        _MISSED.labels(self._self_addr, addr).inc()
                        self._last_beat_at.pop(addr, None)
                        self._clock_skew.pop(addr, None)
                        log.warning(
                            "(%s) declaring %s dead: no heartbeat for %.1fs "
                            "(timeout %.1fs)",
                            self._self_addr, addr, now - seen,
                            Settings.HEARTBEAT_TIMEOUT,
                        )
                        # remove() fires the protocol's death callbacks, so
                        # vote/aggregation waits re-evaluate immediately
                        # instead of sleeping out their fixed timeouts.
                        self._neighbors.remove(addr, notify=False)
                self._live_peers.set(
                    sum(1 for s in last_seen.values() if now - s <= Settings.HEARTBEAT_TIMEOUT)
                )
                if self._probe_fn is not None:
                    try:
                        self._probe_fn()
                    except Exception:  # probes must not stop the beat
                        log.exception(
                            "(%s) heal-detection probe failed", self._self_addr
                        )
            if self._stop.wait(Settings.HEARTBEAT_PERIOD):
                return
