"""Per-node shared state and synchronization primitives.

Capability parity with reference p2pfl/node_state.py:26-136: the state object
is shared between the stage machine, the command handlers (which run on
transport threads) and the public Node API, so every cross-thread handoff is
an explicit ``threading.Event`` here.

Design departure from the reference: the reference coordinates with raw
``threading.Lock`` objects acquired at init and "released" to signal
(node_state.py:74-80), a pattern that throws if a lock is released twice.
Events are idempotent and state their intent; the aggregation handoff is an
Event in the reference too (``aggregated_model_event``).

The port's copy of ``p2pfl_tpu/node_state.py``: the delta codec decodes,
and the privacy plane runs its full-size passes, on the node's device.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional

from p2pfl_tpu_torch.device import DeviceLike
from p2pfl_tpu_torch.experiment import Experiment


class NodeState:
    """Mutable state of one federated node during an experiment.

    Attributes:
        addr: This node's address string.
        status: Human-readable lifecycle tag ("Idle" / "Learning").
        experiment: Active :class:`Experiment` or ``None``.
        simulation: Whether the learner is being simulated on the mesh backend.
        models_aggregated: addr -> list of contributors that peer has merged
            (tracks partial-aggregation progress; reference node_state.py:60).
        nei_status: addr -> last round that neighbor reported finishing
            (-1 right after the peer announced an initialized model).
        train_set: Committee (trainset) elected for the current round.
        train_set_votes: addr -> {candidate: weight} votes received.
        learner: The node's learner (set by Node).
        wire: Sparse-delta wire codec (round anchor + error-feedback
            residuals, :class:`~p2pfl_tpu_torch.comm.delta.DeltaWireCodec`).
            Anchors are snapshotted by the stage machine at every round
            boundary; active only under ``Settings.WIRE_COMPRESSION="topk"``.
        admission: Wire admission controller (structural/NaN/norm screening
            of inbound model frames,
            :class:`~p2pfl_tpu_torch.comm.admission.AdmissionController`).
    """

    def __init__(self, addr: str, device: DeviceLike = "cuda") -> None:
        from p2pfl_tpu_torch.comm.admission import AdmissionController
        from p2pfl_tpu_torch.comm.delta import DeltaWireCodec
        from p2pfl_tpu_torch.privacy.secagg import PrivacyPlane

        self.addr = addr
        self.device = device
        self.status = "Idle"
        self.experiment: Optional[Experiment] = None
        self.simulation = False
        # Decodes (and holds its anchors) on the node's device.
        self.wire = DeltaWireCodec(addr, device=device)
        # Byzantine defense: inbound model-plane frames are screened here
        # (structure/dtype/NaN/norm-bound, comm/admission.py) between
        # decode_frame and aggregator.add_model / apply_frame.
        self.admission = AdmissionController(addr)
        # Privacy plane (p2pfl_tpu_torch/privacy/): session DH keypair,
        # pairwise mask state, EF residual of the masked lattice codec, repair
        # shares. Active only under Settings.PRIVACY_SECAGG, but the key
        # material exists unconditionally so handshakes from masked peers
        # always have something to answer with.
        self.privacy = PrivacyPlane(addr, device=device)
        # Federation-wide trace id of the running experiment: minted by the
        # initiator, adopted by peers from the start_learning frame's span
        # context (telemetry/tracing.py). None -> the workflow opens a
        # fresh local trace.
        self.trace_id: Optional[str] = None
        # Stage the workflow is currently executing ("" outside a session) —
        # gossiped to the fleet in the node's health digest so peers can see
        # WHERE a stalled node is stuck, not just that it lags.
        self.current_stage: str = ""
        # Scheduler of the running experiment: "sync" (barrier rounds) or
        # "async" (elastic windows, stages/async_node.py). Set by
        # Node.start_learning_thread; meaningful only while an experiment is
        # in progress.
        self.fed_mode: str = "sync"
        # Epochs per round/window — kept so a mid-experiment joiner can be
        # welcomed with the session's parameters (AsyncJoinCommand).
        self.epochs: int = 1
        # Async peers that announced they finished their windows
        # (async_done): the window fill target stops counting them — a
        # finished peer produces no more contributions, and waiting on one
        # would burn the window timeout (the last-node-standing case).
        self.async_done_peers: set = set()

        # --- durable recovery plane (stages/recovery.py) --------------------
        # True while the node is PARKED in quorum-aware degraded mode: below
        # the live-peer quorum it makes no vote/window progress (heartbeats
        # continue, state is journaled) instead of burning timeout rounds.
        self.parked: bool = False
        # Every address (self included) seen live during this experiment —
        # the quorum denominator. Grows monotonically per session; reset by
        # set_experiment.
        self.session_members: set = set()
        # Partition-heal reconciliation: a dense catch-up model offered by
        # the ahead side of a healed split, adopted ATOMICALLY at the next
        # round boundary (applying it mid-stage would race the stage's own
        # model writes). {"round", "params", "contributors", "source"}.
        self._reconcile_lock = threading.Lock()
        self._pending_reconcile: Optional[Dict[str, Any]] = None

        # Learning info (populated by commands / stages).
        self.models_aggregated: Dict[str, List[str]] = {}
        # Previous-round partial-aggregation coverage: under train<->diffuse
        # overlap (Settings.OVERLAP_TRAIN_DIFFUSE) the round-r partial-model
        # drain keeps serving laggards after increase_round() replaced the
        # live coverage table — their progress announcements (round r, our
        # round r+1) land here so the drain's candidate set still shrinks to
        # empty instead of stalling out.
        self.models_aggregated_prev: Dict[str, List[str]] = {}
        self.prev_coverage_round: int = -1
        # Background diffusion drains (stages/base_node.py): the partial- and
        # full-model gossip loops the overlap path runs off the stage thread.
        # Threads deregister themselves implicitly (join_drains prunes dead
        # ones); joined bounded at experiment finish and node stop.
        self._drains_lock = threading.Lock()
        self._drains: List[threading.Thread] = []
        # Pre-dispatched training segment (train<->diffuse overlap): when the
        # committee election is deterministic (TRAIN_SET_SIZE covers every
        # candidate), VoteTrainSetStage dispatches the round's fit during the
        # vote RTT — overlapped with the previous round's diffusion drains —
        # and TrainStage joins it before touching the aggregator.
        self.prefit: Optional[tuple] = None  # (round, threading.Thread)
        self.nei_status: Dict[str, int] = {}
        self.train_set: List[str] = []
        self.train_set_votes: Dict[str, Dict[str, int]] = {}
        self.learner: Any = None

        # Synchronization.
        self.train_set_votes_lock = threading.Lock()
        self.start_thread_lock = threading.Lock()
        # Guards the last_full_model_round monotonic update: the stage
        # machine (workflow thread) and the full_model / async_catchup
        # handlers (transport threads) all advance it with a read-modify-
        # write max(); unguarded, two concurrent writers can regress the
        # high-water mark and reopen the first-wins adoption window.
        self.full_model_round_lock = threading.Lock()
        # Set when all expected votes have (possibly) arrived — consumers
        # re-check the vote table and clear it again while polling.
        self.votes_ready_event = threading.Event()
        # Set once the model has been initialized (own weights or received
        # via an init-model gossip). Reference models this as a lock acquired
        # at __init__ (node_state.py:77-79).
        self.model_initialized_event = threading.Event()
        # Set when an aggregated (full) model for this round has been adopted.
        self.aggregated_model_event = threading.Event()
        # Highest round for which a full aggregated model was adopted — lets
        # WaitAggregatedModelsStage skip its wait if the model raced ahead of
        # the stage transition (clear-then-wait race).
        self.last_full_model_round = -1

    def note_full_model_round(self, round: int) -> None:
        """Advance the highest round whose full aggregated model we hold.

        Monotonic and locked: callers race from the workflow thread
        (TrainStage / AsyncWindowStage marking their own aggregate) and from
        transport threads (full_model / async_catchup adoption), and an
        interleaved ``max()`` read-modify-write could regress the mark —
        letting a later (possibly Byzantine) full-model frame re-win a round
        that first-wins already closed."""
        with self.full_model_round_lock:
            if round > self.last_full_model_round:
                self.last_full_model_round = round

    # --- partition-heal reconciliation (stages/recovery.py) -----------------

    def offer_reconcile(
        self, round: int, params: Any, contributors: List[str], source: str
    ) -> bool:
        """Store a reconcile catch-up (transport thread). Kept only when it
        is ahead of both the current round and any already-pending offer —
        the freshest generation wins, stale offers are dropped."""
        with self._reconcile_lock:
            current = self.round
            if current is None or round <= current:
                return False
            if (
                self._pending_reconcile is not None
                and round <= self._pending_reconcile["round"]
            ):
                return False
            self._pending_reconcile = {
                "round": int(round),
                "params": params,
                "contributors": list(contributors),
                "source": source,
            }
            return True

    def reconcile_ahead(self) -> bool:
        """True when a pending catch-up targets a round ahead of us — the
        signal sliced stage waits use to wind the current round down fast."""
        with self._reconcile_lock:
            return (
                self._pending_reconcile is not None
                and self.round is not None
                and self._pending_reconcile["round"] > self.round
            )

    def take_reconcile(self) -> Optional[Dict[str, Any]]:
        """Pop the pending catch-up iff still ahead of the current round
        (stale offers — we caught up naturally — are discarded)."""
        with self._reconcile_lock:
            p, self._pending_reconcile = self._pending_reconcile, None
            if p is None or self.round is None or p["round"] <= self.round:
                return None
            return p

    # --- round bookkeeping (proxied off Experiment; reference :84-97) -------

    @property
    def round(self) -> Optional[int]:
        return self.experiment.round if self.experiment is not None else None

    @property
    def total_rounds(self) -> Optional[int]:
        return self.experiment.total_rounds if self.experiment is not None else None

    def set_experiment(self, exp_name: str, total_rounds: int) -> None:
        """Start (or restart) an experiment and flip status to Learning."""
        self.status = "Learning"
        self.async_done_peers = set()
        self.parked = False
        self.session_members = {self.addr}
        with self._reconcile_lock:
            self._pending_reconcile = None
        self.experiment = Experiment(exp_name=exp_name, total_rounds=total_rounds)

    def increase_round(self) -> None:
        if self.experiment is None:
            raise ValueError("no experiment in progress")
        finished = self.round
        self.experiment.increase_round()
        # Retire (don't discard) the finished round's coverage table: the
        # overlap drain for that round reads it until its candidates empty.
        self.models_aggregated_prev = self.models_aggregated
        self.prev_coverage_round = -1 if finished is None else int(finished)
        self.models_aggregated = {}

    def coverage(self, round: int) -> Dict[str, List[str]]:
        """Partial-aggregation coverage table for ``round``: the live table
        for the current round, the retired one for the round just finished
        (the overlap drain's view), empty otherwise."""
        if self.round is not None and round == self.round:
            return self.models_aggregated
        if round == self.prev_coverage_round:
            return self.models_aggregated_prev
        return {}

    def take_prefit(self, round: int) -> Optional[threading.Thread]:
        """Pop the pre-dispatched fit thread iff it belongs to ``round``.
        A STALE one (reconcile fast-forward, abandoned round) is aborted and
        joined here — its thread mutates the learner model, and letting it
        run unowned would race whatever adoption superseded the round."""
        p, self.prefit = self.prefit, None
        if p is None:
            return None
        if p[0] != round:
            try:
                if self.learner is not None:
                    self.learner.interrupt_fit()
            except Exception:  # noqa: BLE001 — cleanup must not break the stage
                pass
            p[1].join(timeout=30.0)
            return None
        return p[1]

    # --- diffusion drains (train<->diffuse overlap) --------------------------

    def add_drain(self, thread: threading.Thread) -> None:
        with self._drains_lock:
            self._drains = [t for t in self._drains if t.is_alive()]
            self._drains.append(thread)

    def join_drains(self, timeout: Optional[float] = None) -> None:
        """Bounded join of outstanding diffusion drains (each terminates on
        its own via empty candidates / stall exit / early stop — the join
        only bounds how long a finish or stop waits for that)."""
        with self._drains_lock:
            drains, self._drains = self._drains, []
        for t in drains:
            if t.is_alive():
                t.join(timeout)
        alive = [t for t in drains if t.is_alive()]
        if alive:
            with self._drains_lock:
                self._drains.extend(alive)

    def clear(self) -> None:
        """Reset to the post-construction state (reference :125-127)."""
        self.__init__(self.addr, self.device)  # type: ignore[misc]

    def __str__(self) -> str:
        exp = str(self.experiment) if self.experiment else "None"
        return f"NodeState(addr={self.addr}, status={self.status}, {exp})"
