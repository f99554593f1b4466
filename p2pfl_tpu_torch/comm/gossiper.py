"""Gossip engine: async message diffusion + synchronous model gossip (the
port's copy of ``p2pfl_tpu/comm/gossiper.py``, with the same metric families).

Parity with reference communication/protocols/gossiper.py:31-239:

* **async path** — pending (envelope, targets) pairs drained every
  ``GOSSIP_PERIOD``, at most ``GOSSIP_MESSAGES_PER_PERIOD`` per tick
  (:124-155 in the reference), with a bounded dedup ring of recently-seen
  message ids (:101-122),
* **sync path** — ``gossip_weights``: a paced loop that asks for candidate
  peers, exits when candidates are empty or progress stalls for
  ``GOSSIP_EXIT_ON_X_EQUAL_ROUNDS`` consecutive rounds, and sends
  ``GOSSIP_MODELS_PER_ROUND`` models per tick (:163-239).
"""

from __future__ import annotations

import logging
import random
import threading
from collections import OrderedDict, deque
from typing import Any, Callable, Dict, List, Optional, Tuple

from p2pfl_tpu_torch.comm.envelope import Envelope
from p2pfl_tpu_torch.config import Settings
from p2pfl_tpu_torch.exceptions import ProtocolNotStartedError
from p2pfl_tpu_torch.telemetry import REGISTRY

log = logging.getLogger("p2pfl_tpu_torch")

# Model-plane TX accounting, exposed through the telemetry registry (the
# Prometheus/JSON exposition surface every subsystem shares). The gossiper
# ALSO keeps a per-instance (cmd, round) table: per-round queries
# (``bytes_for_round``, read by RoundFinishedStage and bench --wire) must be
# scoped to THIS gossiper's lifetime, and registry series — keyed by node
# label — would bleed across tests that reuse an address.
_TX_BYTES = REGISTRY.counter(
    "p2pfl_gossip_tx_bytes_total",
    "Model-plane payload bytes sent, by command, round and wire codec "
    "(topk / topk-int8 / topk-int4 / dense)",
    labels=("node", "cmd", "round", "codec"),
)
_TX_FRAMES = REGISTRY.counter(
    "p2pfl_gossip_tx_frames_total",
    "Model-plane frames sent, by command, round and wire codec",
    labels=("node", "cmd", "round", "codec"),
)
_MSGS_SENT = REGISTRY.counter(
    "p2pfl_gossip_msgs_sent_total",
    "Control-plane messages fanned out by the async gossip thread",
    labels=("node",),
)
_QUEUE_DEPTH = REGISTRY.gauge(
    "p2pfl_gossip_queue_depth",
    "Pending (envelope, targets) pairs awaiting the next gossip tick",
    labels=("node",),
)
_ABANDONED = REGISTRY.counter(
    "p2pfl_gossip_abandoned_total",
    "Model gossip loops that gave up with candidates still unreached "
    "(GOSSIP_EXIT_ON_X_EQUAL_ROUNDS stall trips)",
    labels=("node",),
)


class Gossiper:
    """Owns the async gossip thread; the sync weights gossip runs on the
    caller's thread (stage machine)."""

    def __init__(
        self,
        self_addr: str,
        send_fn: Callable[[str, Envelope], None],
        get_direct_neighbors_fn: Callable[[], List[str]],
        recorder: Optional[Any] = None,
    ) -> None:
        self._self_addr = self_addr
        self._send = send_fn
        self._get_direct = get_direct_neighbors_fn
        # Optional flight recorder (comm/protocol.py wires its own): model-
        # plane sends and gossip give-ups become postmortem events.
        self._recorder = recorder
        self._pending: deque[Tuple[Envelope, List[str]]] = deque()
        self._pending_lock = threading.Lock()
        self._processed: "OrderedDict[int, None]" = OrderedDict()
        self._processed_lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # Model-plane TX accounting: (cmd, round, codec) -> [frames, bytes].
        # The sparse delta wire path's bytes-per-round metric reads this
        # (surfaced per round by RoundFinishedStage and by bench.py --wire);
        # the registry mirror (module-level counters above) is the process-
        # wide exposition surface.
        self._tx_lock = threading.Lock()
        self._tx: Dict[Tuple[str, int, str], List[int]] = {}
        self._msgs_sent = _MSGS_SENT.labels(self_addr)
        self._queue_depth = _QUEUE_DEPTH.labels(self_addr)

    # --- lifecycle ----------------------------------------------------------

    def start(self) -> None:
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._run, name=f"gossiper-{self._self_addr}", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None

    # --- wire accounting ----------------------------------------------------

    def _record_tx(self, env: Envelope, nei: str = "") -> None:
        if env.payload is None:
            return
        codec = getattr(env, "codec", "") or "dense"
        with self._tx_lock:
            row = self._tx.setdefault((env.cmd, env.round, codec), [0, 0])
            row[0] += 1
            row[1] += len(env.payload)
        _TX_FRAMES.labels(self._self_addr, env.cmd, env.round, codec).inc()
        _TX_BYTES.labels(self._self_addr, env.cmd, env.round, codec).inc(
            len(env.payload)
        )
        if self._recorder is not None:
            self._recorder.record(
                "send", cmd=env.cmd, peer=nei,
                round=env.round, bytes=len(env.payload), codec=codec,
            )

    def wire_stats(self) -> Dict[Tuple[str, int, str], Tuple[int, int]]:
        """Copy of the model-plane TX table:
        (cmd, round, codec) -> (frames, bytes)."""
        with self._tx_lock:
            return {k: (v[0], v[1]) for k, v in self._tx.items()}

    def bytes_for_round(self, round: int) -> int:
        """Total model-plane payload bytes sent for ``round``."""
        with self._tx_lock:
            return sum(v[1] for (_, r, _c), v in self._tx.items() if r == round)

    def bytes_by_codec(self) -> Dict[str, int]:
        """Model-plane payload bytes per wire codec — the per-encoder
        attribution ``bench.py --wire`` and ``fed_top`` surface."""
        with self._tx_lock:
            out: Dict[str, int] = {}
            for (_, _, codec), v in self._tx.items():
                out[codec] = out.get(codec, 0) + v[1]
            return out

    def total_tx_bytes(self) -> int:
        with self._tx_lock:
            return sum(v[1] for v in self._tx.values())

    # --- dedup (reference gossiper.py:101-122) ------------------------------

    def check_and_set_processed(self, msg_id: int) -> bool:
        """True if unseen (and records it); False if duplicate."""
        if msg_id == 0:
            return True
        with self._processed_lock:
            if msg_id in self._processed:
                return False
            self._processed[msg_id] = None
            while len(self._processed) > Settings.AMOUNT_LAST_MESSAGES_SAVED:
                self._processed.popitem(last=False)
            return True

    # --- async message gossip ----------------------------------------------

    def add_message(self, env: Envelope, targets: Optional[List[str]] = None) -> None:
        """Queue a message for diffusion to ``targets`` (default: direct
        neighbors except the message source)."""
        if targets is None:
            targets = [n for n in self._get_direct() if n != env.source]
        if not targets:
            return
        with self._pending_lock:
            self._pending.append((env, targets))
            self._queue_depth.set(len(self._pending))

    def _run(self) -> None:
        while not self._stop.wait(Settings.GOSSIP_PERIOD):
            budget = Settings.GOSSIP_MESSAGES_PER_PERIOD
            while budget > 0:
                with self._pending_lock:
                    if not self._pending:
                        break
                    env, targets = self._pending.popleft()
                    self._queue_depth.set(len(self._pending))
                for t in targets:
                    try:
                        self._send(t, env)
                    except ProtocolNotStartedError:
                        return  # protocol stopping under us — normal shutdown
                    except Exception:
                        # transport failures are already swallowed and logged
                        # by protocol.send (raise_error=False); this guard
                        # only keeps the gossip thread alive on local bugs
                        log.exception("gossip send to %s failed unexpectedly", t)
                self._msgs_sent.inc(len(targets) or 1)
                budget -= len(targets) or 1

    # --- sync model gossip (reference gossiper.py:163-239) ------------------

    def gossip_weights(
        self,
        early_stopping_fn: Callable[[], bool],
        get_candidates_fn: Callable[[], List[str]],
        status_fn: Callable[[], Any],
        model_fn: Callable[[str], Optional[Envelope]],
        period: Optional[float] = None,
        max_rounds: Optional[int] = None,
    ) -> None:
        """Paced diffusion of model weights until convergence.

        Each tick: stop if ``early_stopping_fn`` or no candidates; stop if
        ``status_fn()`` hasn't changed for ``GOSSIP_EXIT_ON_X_EQUAL_ROUNDS``
        ticks; otherwise sample ``GOSSIP_MODELS_PER_ROUND`` candidates and
        send each ``model_fn(candidate)``.
        """
        period = Settings.GOSSIP_MODELS_PERIOD if period is None else period
        equal_rounds = 0
        last_status: Any = None
        ticker = threading.Event()
        rounds = 0
        while True:
            if early_stopping_fn():
                return
            if max_rounds is not None and rounds >= max_rounds:
                return
            rounds += 1
            candidates = get_candidates_fn()
            if not candidates:
                return
            status = status_fn()
            if status == last_status:
                equal_rounds += 1
                if equal_rounds >= Settings.GOSSIP_EXIT_ON_X_EQUAL_ROUNDS:
                    # NOT the normal exit (that is candidates == []): progress
                    # stalled with peers still unreached — e.g. a dead peer
                    # that never confirms. Previously silent; a vanished model
                    # transfer was undiagnosable.
                    log.warning(
                        "(%s) model gossip ABANDONED after %d stalled ticks; "
                        "unreached candidates: %s",
                        self._self_addr, equal_rounds, candidates,
                    )
                    _ABANDONED.labels(self._self_addr).inc()
                    if self._recorder is not None:
                        self._recorder.record(
                            "gossip_abandoned", candidates=list(candidates)
                        )
                    return
            else:
                equal_rounds = 0
                last_status = status
            sample = random.sample(
                candidates, min(Settings.GOSSIP_MODELS_PER_ROUND, len(candidates))
            )
            for nei in sample:
                env = model_fn(nei)
                if env is None:
                    continue
                try:
                    self._send(nei, env)
                    self._record_tx(env, nei)
                except ProtocolNotStartedError:
                    return  # protocol stopping under us — normal shutdown
                except Exception:
                    log.exception("model gossip to %s failed unexpectedly", nei)
            if ticker.wait(period):  # plain sleep, interruptible-style
                return
