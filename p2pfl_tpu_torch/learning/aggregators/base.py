"""Round-scoped model accumulator (counterpart of
``p2pfl_tpu/learning/aggregators/base.py``, framework-free but for the
handles it holds).

Capability parity with the reference Aggregator base
(p2pfl/learning/aggregators/aggregator.py:35-270): a per-round accumulator
that nodes and gossip handlers feed models into, with

* contributor-set dedup (a model is redundant if its contributors are a
  subset of what we already merged — reference :113-175),
* trainset membership checks,
* a completion event set once every trainset member is covered,
* ``wait_and_get_aggregation`` blocking with timeout and aggregating whatever
  arrived (reference :177-207),
* ``get_partial_model(except_nodes)`` for partial-aggregation gossip
  (reference :219-270): combine everything the peer hasn't seen.

Thread-safety: a single RLock guards the model table; completion is an Event.
The JAX package's sketch feeds (``SKETCHES``: the aggregation-wait sketch and
the distinct-contributor estimator) wait for the port's
``telemetry/sketches.py``.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Callable, List, Optional, Sequence

from p2pfl_tpu_torch.config import Settings
from p2pfl_tpu_torch.models.model_handle import ModelHandle
from p2pfl_tpu_torch.telemetry import REGISTRY
from p2pfl_tpu_torch.telemetry.ledger import LEDGERS

log = logging.getLogger("p2pfl_tpu_torch")

_AGG_WAIT = REGISTRY.histogram(
    "p2pfl_aggregation_wait_seconds",
    "Time blocked in wait_and_get_aggregation before aggregating",
    labels=("node",),
)
_AGG_CONTRIBUTORS = REGISTRY.gauge(
    "p2pfl_aggregation_contributors",
    "Contributors merged into the last aggregation",
    labels=("node",),
)
_AGG_MISSING = REGISTRY.counter(
    "p2pfl_aggregation_timeout_partials_total",
    "Aggregations that proceeded with trainset members missing (timeout)",
    labels=("node",),
)
_AGG_DEAD = REGISTRY.counter(
    "p2pfl_aggregation_dead_contributors_total",
    "Trainset members dropped from the expected set after being declared dead",
    labels=("node",),
)
_AGG_STALL = REGISTRY.counter(
    "p2pfl_aggregation_stall_partials_total",
    "Aggregations cut short by the JIT stall patience (no progress while "
    "contributions were still missing)",
    labels=("node",),
)


class Aggregator:
    """Base class; subclasses implement :meth:`aggregate`."""

    #: whether intermediate subsets may be merged eagerly and re-gossiped
    #: (FedAvg-style linear rules) — reference ``partial_aggregation`` flag.
    partial_aggregation: bool = False

    def __init__(self) -> None:
        self.node_addr = "unknown-node"
        self._lock = threading.RLock()
        self._finish_event = threading.Event()
        self._train_set: List[str] = []
        self._models: List[ModelHandle] = []
        self._round: Optional[int] = None  # ledger stamp for this round's folds
        # Retired round snapshot (round, train_set, models) kept after
        # retire_round() so overlap drains can serve laggards post-boundary.
        self._retired: Optional[tuple] = None
        # monotonic timestamp of the last round progress (a stored model, a
        # death-shrink, or the round opening) — drives the JIT stall patience.
        self._last_progress = time.monotonic()
        # Optional stall hook (set by Node): called with the missing-
        # contributor list when the JIT stall patience fires — the trigger
        # that dumps the flight recorder, because a stalled aggregation is
        # exactly the postmortem the event ring exists for.
        self.on_stall: Optional[Callable[[List[str]], None]] = None

    # --- learner integration -------------------------------------------------

    def get_required_callbacks(self) -> List[str]:
        """Learner callbacks this rule depends on (reference
        CallbackFactory contract, callback_factory.py:16-101)."""
        return []

    def set_addr(self, addr: str) -> None:
        self.node_addr = addr

    # --- round lifecycle -----------------------------------------------------

    def set_nodes_to_aggregate(
        self, train_set: Sequence[str], round: Optional[int] = None
    ) -> None:
        """Open the round: declare whose contributions we expect
        (reference :66-81). ``round`` stamps this round's trajectory-ledger
        contribution events (None keeps the ledger's current round)."""
        with self._lock:
            if self._train_set:
                raise RuntimeError("aggregation already in progress — clear() first")
            self._train_set = list(train_set)
            self._models = []
            self._round = round
            self._finish_event.clear()
            self._last_progress = time.monotonic()

    def clear(self) -> None:
        with self._lock:
            self._train_set = []
            self._models = []
            self._retired = None
            self._finish_event.clear()

    def retire_round(self) -> None:
        """Close the round for NEW contributions but keep an immutable
        snapshot of its model table (train<->diffuse overlap,
        stages/base_node.py): the background partial-model drain keeps
        serving laggards out of the retired snapshot while the live side is
        already collecting the next round. Replacing an earlier snapshot
        implicitly ends any drain still reading it
        (:meth:`get_partial_model_for_round` starts returning ``None``)."""
        with self._lock:
            if self._train_set or self._models:
                self._retired = (self._round, list(self._train_set), list(self._models))
            self._train_set = []
            self._models = []
            self._finish_event.clear()

    def serves_round(self, round: int) -> bool:
        """True while this aggregator can still produce partials for
        ``round`` (it is the live round or the retired snapshot)."""
        with self._lock:
            if self._train_set and self._round == round:
                return True
            return self._retired is not None and self._retired[0] == round

    def get_aggregated_models(self) -> List[str]:
        """Addresses whose contributions have been merged so far."""
        with self._lock:
            out: List[str] = []
            for m in self._models:
                # Attribute access, not get_contributors(): a stored handle
                # whose contributor list was raced to empty (full-model
                # adoption mutating a shared handle) must degrade to "no
                # contributors", not blow up round bookkeeping from a
                # heartbeat or gossip thread.
                out.extend(m.contributors)
            return sorted(set(out))

    def get_missing_models(self) -> List[str]:
        with self._lock:
            return sorted(set(self._train_set) - set(self.get_aggregated_models()))

    def remove_node(self, addr: str) -> bool:
        """Death callback: shrink the round's expected-contributor set.

        Called when ``addr`` is declared dead mid-round (heartbeat timeout or
        send-failure write-off). If its contribution already arrived it is
        KEPT (the training happened); otherwise the node leaves the expected
        set, and — the whole point — the finish condition is re-evaluated so
        ``wait_and_get_aggregation`` wakes immediately instead of sleeping
        out ``AGGREGATION_TIMEOUT``. Returns True when the expected set
        actually shrank.
        """
        with self._lock:
            if addr not in self._train_set:
                return False
            if addr in self.get_aggregated_models():
                return False  # its model arrived before it died — keep it
            self._train_set.remove(addr)
            _AGG_DEAD.labels(self.node_addr).inc()
            self._last_progress = time.monotonic()
            if set(self.get_aggregated_models()) >= set(self._train_set):
                self._finish_event.set()
            return True

    # --- feeding models ------------------------------------------------------

    def add_model(self, model: ModelHandle, round: Optional[int] = None) -> List[str]:
        """Merge a (possibly partially-aggregated) model into the round.

        Returns the updated list of aggregated contributors (the caller
        broadcasts it as round progress — reference train_stage.py:79-85).
        Duplicate/subset contributions and contributors outside the trainset
        are ignored, matching reference :113-175. When the caller knows the
        frame's round (the wire handlers do), a mismatch against the OPEN
        round is dropped — under train<->diffuse overlap the table for round
        r stays populated while peers already gossip r+1 frames, and merging
        across generations would corrupt both.
        """
        contributors = set(model.contributors)
        if not contributors:
            return []  # anonymous model: nothing to account it against
        with self._lock:
            if (
                round is not None
                and self._round is not None
                and round != self._round
            ):
                return []  # cross-round frame: the sender's gossip re-ships
            if not self._train_set:
                # Round not open yet (e.g. model gossip raced ahead of the
                # vote result) — the caller may retry; reference logs this.
                return []
            if not contributors <= set(self._train_set):
                return self.get_aggregated_models()
            already = set(self.get_aggregated_models())
            if contributors <= already:
                return sorted(already)  # nothing new
            # Drop stored models that are now subsets of the incoming one.
            self._models = [
                m for m in self._models if not set(m.contributors) <= contributors
            ]
            self._models.append(model)
            self._last_progress = time.monotonic()
            # Trajectory ledger: one fold event per model actually merged
            # (dedup'd/subset frames returned above and never reach here),
            # so the event stream is the round's contribution set, not the
            # gossip traffic. Merged partials ledger as their sorted
            # contributor tuple; sync folds are zero-lag by construction.
            LEDGERS.emit(
                self.node_addr,
                "contribution_folded",
                round=self._round,
                sender="+".join(sorted(contributors)),
                lag=0,
                num_samples=model.get_num_samples(),
            )
            agg = self.get_aggregated_models()
            if set(agg) >= set(self._train_set):
                self._finish_event.set()
            return agg

    # --- consuming the result ------------------------------------------------

    def wait_and_get_aggregation(self, timeout: Optional[float] = None) -> ModelHandle:
        """Block until the round completes (or timeout) then aggregate
        whatever arrived (reference :177-207)."""
        timeout = Settings.AGGREGATION_TIMEOUT if timeout is None else timeout
        t0 = time.perf_counter()
        deadline = t0 + timeout
        patience = Settings.AGGREGATION_STALL_PATIENCE
        # Sliced wait so the finish condition is RE-EVALUATED on death
        # callbacks (remove_node sets the event) and the JIT stall patience
        # can fire: if nothing has advanced the round for ``patience``
        # seconds while we hold at least one model, aggregate what arrived
        # (Just-in-Time Aggregation) instead of sleeping out the timeout.
        while not self._finish_event.wait(timeout=0.25):
            if time.perf_counter() >= deadline:
                break
            if patience > 0:
                with self._lock:
                    stalled = (
                        bool(self._models)
                        and time.monotonic() - self._last_progress >= patience
                    )
                if stalled:
                    _AGG_STALL.labels(self.node_addr).inc()
                    missing = self.get_missing_models()
                    log.warning(
                        "(%s) aggregation stalled for %.1fs with %s still "
                        "missing — JIT-aggregating what arrived",
                        self.node_addr, patience, missing,
                    )
                    if self.on_stall is not None:
                        try:
                            self.on_stall(missing)
                        except Exception:  # a hook bug must not break the round
                            log.exception("(%s) on_stall hook failed", self.node_addr)
                    break
        wait_s = time.perf_counter() - t0
        _AGG_WAIT.labels(self.node_addr).observe(wait_s)
        with self._lock:
            if not self._models:
                raise RuntimeError("no models to aggregate")
            missing = self.get_missing_models()
            if missing:
                # Timeout path: proceed with partial participation (matches
                # reference behavior of aggregating what it has).
                _AGG_MISSING.labels(self.node_addr).inc()
            _AGG_CONTRIBUTORS.labels(self.node_addr).set(
                len(self.get_aggregated_models())
            )
            return self.aggregate(list(self._models))

    def get_partial_model(self, except_nodes: Sequence[str]) -> Optional[ModelHandle]:
        """Model to gossip to a peer that already merged ``except_nodes``.

        With ``partial_aggregation``: merge every stored model the peer has
        not seen into one. Otherwise return one unseen raw model
        (reference :219-270).
        """
        except_set = set(except_nodes)
        with self._lock:
            return self._partial_from(self._models, except_set)

    def get_partial_model_for_round(
        self, round: int, except_nodes: Sequence[str]
    ) -> Optional[ModelHandle]:
        """Round-scoped :meth:`get_partial_model` for overlap drains: serves
        the live table while ``round`` is open, the retired snapshot after
        the boundary, and ``None`` once the aggregator has moved on."""
        except_set = set(except_nodes)
        with self._lock:
            if self._train_set and self._round == round:
                return self._partial_from(self._models, except_set)
            if self._retired is not None and self._retired[0] == round:
                return self._partial_from(self._retired[2], except_set)
            return None

    def _partial_from(
        self, models: List[ModelHandle], except_set: set
    ) -> Optional[ModelHandle]:
        unseen = [m for m in models if not (set(m.contributors) & except_set)]
        if not unseen:
            return None
        if not self.partial_aggregation:
            return unseen[0]
        if len(unseen) == 1:
            return unseen[0]
        merged = self.aggregate(unseen)
        return merged

    # --- rule ---------------------------------------------------------------

    def aggregate(self, models: List[ModelHandle]) -> ModelHandle:
        """Combine models into one; contributors = union, num_samples = sum."""
        raise NotImplementedError

    @staticmethod
    def _merge_metadata(models: List[ModelHandle]) -> tuple[List[str], int]:
        contributors: List[str] = []
        for m in models:
            contributors.extend(m.contributors)
        total = sum(m.get_num_samples() for m in models)
        return sorted(set(contributors)), total
