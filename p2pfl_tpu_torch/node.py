"""Node — the user-facing facade.

Capability parity with reference p2pfl/node.py:57-413: wires protocol,
learner, aggregator, state and commands; exposes
``start/connect/set_start_learning/set_stop_learning/stop``. Kickoff
semantics mirror node.py:342-382: broadcast ``start_learning``, mark the own
model initialized, broadcast ``model_initialized``, then run the stage
machine on a daemon thread.

The node's learner defaults to
:class:`~p2pfl_tpu_torch.learning.learner.TorchLearner` on the card; for
simulation of hundreds of nodes prefer
:mod:`p2pfl_tpu_torch.parallel.simulation`, which runs the whole population
as one batched round instead of per-node threads.

The port's copy of ``p2pfl_tpu/node.py``; :meth:`Node.resume` rebuilds a
crashed node from its write-ahead journal
(:class:`~p2pfl_tpu_torch.management.checkpoint.NodeJournal`).
"""

from __future__ import annotations

import threading
import time
from typing import List, Optional, Type

from p2pfl_tpu_torch.comm.commands.impl import (
    AsyncCatchupCommand,
    AsyncContributionCommand,
    AsyncDoneCommand,
    AsyncJoinCommand,
    AsyncWelcomeCommand,
    FullModelCommand,
    InitModelCommand,
    MetricsCommand,
    ModelInitializedCommand,
    ModelsAggregatedCommand,
    ModelsReadyCommand,
    PartialModelCommand,
    PrivacyKeyCommand,
    PrivacyRepairCommand,
    ReconcileCommand,
    ReconcileModelCommand,
    StartLearningCommand,
    StopLearningCommand,
    VoteTrainSetCommand,
)
from p2pfl_tpu_torch.comm.memory.memory_protocol import InMemoryCommunicationProtocol
from p2pfl_tpu_torch.comm.protocol import CommunicationProtocol
from p2pfl_tpu_torch.config import Settings
from p2pfl_tpu_torch.exceptions import LearningRunningException, ZeroRoundsException
from p2pfl_tpu_torch.learning.aggregators import Aggregator, FedAvg
from p2pfl_tpu_torch.learning.dataset.dataset import FederatedDataset
from p2pfl_tpu_torch.device import DeviceLike
from p2pfl_tpu_torch.learning.learner import Learner, TorchLearner
from p2pfl_tpu_torch.management.logger import logger
from p2pfl_tpu_torch.models.model_handle import ModelHandle
from p2pfl_tpu_torch.node_state import NodeState
from p2pfl_tpu_torch.stages.workflow import LearningWorkflow, scheduler_start_stage
from p2pfl_tpu_torch.telemetry import TRACER, tracing
from p2pfl_tpu_torch.telemetry.bundle import establish_run


class Node:
    """One federated participant.

    Args:
        model: initial :class:`ModelHandle`.
        data: this node's local dataset partition.
        addr: transport address (default: fresh in-memory address).
        learner: learner class (default :class:`TorchLearner`).
        aggregator: aggregation rule instance (default :class:`FedAvg`).
        protocol: communication protocol class (default in-memory).
        executor: fit/eval execution venue. ``True`` (default) submits jobs
            to the process-shared :class:`~p2pfl_tpu_torch.parallel.executor.
            LearnerExecutor` (capacity-bounded, crash-isolated — the
            reference wraps learners in Ray virtual learners the same way,
            simulation/__init__.py:14-31); pass a ``LearnerExecutor`` to
            share an explicit pool, or ``False`` for inline fit.
        device: where the node trains and decodes frames (default
            ``"cuda"``; ``"cpu"`` only when asked for), forwarded to the
            learner as ``device=``.
        learner_kwargs: forwarded to the learner constructor.
    """

    def __init__(
        self,
        model: ModelHandle,
        data: FederatedDataset,
        addr: Optional[str] = None,
        learner: Type[Learner] = TorchLearner,
        aggregator: Optional[Aggregator] = None,
        protocol: Type[CommunicationProtocol] = InMemoryCommunicationProtocol,
        executor=True,
        device: DeviceLike = "cuda",
        **learner_kwargs,
    ) -> None:
        self.protocol = protocol(addr)
        self.state = NodeState(self.protocol.get_address(), device=device)
        if aggregator is None:
            if Settings.PRIVACY_SECAGG:
                from p2pfl_tpu_torch.learning.aggregators import MaskedFedAvg

                aggregator = MaskedFedAvg()
            else:
                aggregator = FedAvg()
        elif Settings.PRIVACY_SECAGG and not aggregator.partial_aggregation:
            # The admission-vs-secrecy tension, resolved the DisAgg/Papaya
            # way: robust rules (Krum, TrimmedMean, ...) need INDIVIDUAL
            # updates, and secure aggregation exists to hide exactly those.
            # Clipping-at-sender + the committee-side range check replace
            # them on masked rounds — a non-linear rule here would silently
            # score uniform ring noise.
            raise ValueError(
                "PRIVACY_SECAGG requires a linear (partial-aggregation) "
                f"rule; {type(aggregator).__name__} inspects individual "
                "updates, which masked frames hide by design"
            )
        self.aggregator = aggregator
        self.aggregator.set_addr(self.addr)
        required = self.aggregator.get_required_callbacks()
        if required:
            learner_kwargs.setdefault("callbacks", required)
        self.learner: Learner = learner(
            model=model, data=data, self_addr=self.addr, device=device, **learner_kwargs
        )
        if executor and Settings.EXECUTOR_MAX_WORKERS > 0:
            from p2pfl_tpu_torch.parallel.executor import LearnerExecutor, VirtualNodeLearner

            pool = executor if isinstance(executor, LearnerExecutor) else None
            self.learner = VirtualNodeLearner(self.learner, pool, addr=self.addr)
        self.state.learner = self.learner
        self.learner.metric_reporter = self._report_learner_metric

        self._workflow: Optional[LearningWorkflow] = None
        self._learning_thread: Optional[threading.Thread] = None
        self._running = False
        # Buffered async aggregator (elastic async mode only): built per
        # experiment by start_learning_thread, fed by AsyncContributionCommand
        # on transport threads, drained by AsyncWindowStage.
        self.async_agg = None
        # Fired (with this node) after each round completes; used by e.g.
        # checkpoint.attach_node_checkpointing.
        self.round_end_hooks: List = []
        # Durable recovery plane: the write-ahead journal (set by
        # checkpoint.attach_node_journal / Node.resume) and the restored
        # snapshot metadata resume_learning re-enters the experiment from.
        self.recovery_journal = None
        self._resume_meta: Optional[dict] = None
        # Rate limit for reconcile pings per recovered peer.
        self._reconcile_ping_at: dict = {}

        # Round-survival: any neighbor removal (heartbeat-declared death,
        # send-failure write-off, disconnect) shrinks this round's
        # expectations immediately — vote waits, the aggregation finish
        # condition and partial-gossip candidate sets all re-evaluate
        # instead of sleeping out their fixed timeouts.
        self.protocol.on_neighbor_removed(self._on_peer_death)
        # Partition heal: a failure-departed peer coming back triggers the
        # reconcile progress exchange (ahead side ships dense catch-up).
        self.protocol.on_neighbor_recovered(self._on_peer_heal)

        # Federation observatory: replace the protocol's registry-only
        # digest source with the state-aware one (round/stage/total_rounds
        # only the node knows), wire admission rejections and aggregation
        # stalls into the flight recorder, and dump the ring when the stall
        # patience fires — that stall IS the postmortem worth keeping.
        from p2pfl_tpu_torch.telemetry import digest as _digest

        self.protocol.set_digest_source(
            lambda: _digest.collect(self.addr, self.state)
        )
        self.state.admission.recorder = self.protocol.flight_recorder
        self.aggregator.on_stall = self._on_aggregation_stall

        # Register the command handlers (reference node.py:121-134).
        self.protocol.add_command(
            [
                StartLearningCommand(self),
                StopLearningCommand(self),
                ModelInitializedCommand(self),
                VoteTrainSetCommand(self),
                ModelsAggregatedCommand(self),
                ModelsReadyCommand(self),
                MetricsCommand(self),
                InitModelCommand(self),
                PartialModelCommand(self),
                FullModelCommand(self),
                # Elastic async federation (stages/async_node.py).
                AsyncContributionCommand(self),
                AsyncJoinCommand(self),
                AsyncWelcomeCommand(self),
                AsyncCatchupCommand(self),
                AsyncDoneCommand(self),
                # Durable recovery plane (stages/recovery.py): partition-heal
                # progress exchange + dense catch-up adoption.
                ReconcileCommand(self),
                ReconcileModelCommand(self),
                # Privacy plane (p2pfl_tpu_torch/privacy/): pairwise-mask key
                # agreement + masker-dropout repair shares.
                PrivacyKeyCommand(self),
                PrivacyRepairCommand(self),
            ]
        )

    # --- identity -----------------------------------------------------------

    @property
    def addr(self) -> str:
        return self.protocol.get_address()

    @property
    def observatory(self):
        """This node's federation observatory (fleet view assembled from
        peers' gossiped health digests — telemetry/observatory.py)."""
        return self.protocol.observatory

    def __repr__(self) -> str:
        return f"Node({self.addr}, running={self._running})"

    # --- lifecycle (reference node.py:210-253) ------------------------------

    def start(self, wait: bool = False) -> None:
        if self._running:
            from p2pfl_tpu_torch.exceptions import NodeRunningException

            raise NodeRunningException(f"{self.addr} already running")
        logger.register_node(self.addr, simulation=self.state.simulation)
        self.protocol.start()
        self._running = True
        if wait:  # block until stopped (reference honors wait=True)
            while self._running:
                threading.Event().wait(1.0)

    def stop(self) -> None:
        if not self._running:
            return
        try:
            if self.learning_in_progress():
                self.stop_learning_locally()
            # Join the workflow thread before tearing down the protocol so a
            # stage can't broadcast into a stopped transport. Diffusion
            # drains (train<->diffuse overlap) observe the cleared experiment
            # via their early-stop predicate within one gossip tick — the
            # bounded join below keeps their last sends off a dead protocol.
            if self._learning_thread is not None:
                self._learning_thread.join(timeout=5.0)
            self.state.join_drains(timeout=2.0)
            self.protocol.stop()
        finally:
            self._running = False
            logger.unregister_node(self.addr)

    def crash(self) -> None:
        """Simulate abrupt process death mid-round (chaos tests / bench):
        no stop_learning broadcast, no disconnect notifications, no graceful
        workflow join — the transport just vanishes, and peers must discover
        it via heartbeat timeouts or send failures. The in-process pieces
        are still reclaimed (threads stopped, registry entry released) so
        crash-simulating tests don't leak across cases."""
        if not self._running:
            return
        self.learner.interrupt_fit()
        self.aggregator.clear()
        if self.async_agg is not None:
            self.async_agg.clear()
        self.state.experiment = None  # stage machine exits via early-stop
        self.state.votes_ready_event.set()
        self.state.aggregated_model_event.set()
        self.protocol.crash()
        self._running = False
        logger.unregister_node(self.addr)

    # --- membership ---------------------------------------------------------

    def connect(self, addr: str) -> bool:
        return self.protocol.connect(addr)

    def disconnect(self, addr: str) -> None:
        self.protocol.disconnect(addr)

    def get_neighbors(self, only_direct: bool = False) -> List[str]:
        return self.protocol.get_neighbors(only_direct=only_direct)

    # --- learning control (reference node.py:333-397) -----------------------

    def set_start_learning(
        self, rounds: int = 1, epochs: int = 1, mode: str = "sync"
    ) -> None:
        """Kick off a federation-wide learning session.

        ``mode`` selects the scheduler every node runs: ``"sync"`` — the
        barrier round machine (vote → train → aggregate → gossip); or
        ``"async"`` — elastic windows with buffered staleness-weighted
        aggregation and first-class mid-experiment join/leave
        (stages/async_node.py). ``rounds`` counts windows in async mode.
        """
        if rounds < 1:
            raise ZeroRoundsException("rounds must be >= 1")
        if mode not in ("sync", "async"):
            raise ValueError(f"mode must be 'sync' or 'async', got {mode!r}")
        if self.learning_in_progress():
            raise LearningRunningException("learning already in progress")
        # Establish the federation-wide run id (fresh: each kickoff is a
        # new experiment). The start_learning broadcast below carries it as
        # a reserved control arg, and every receiver force-adopts it — so
        # all artifacts of this session share one correlation key.
        establish_run(name=self.addr, fresh=True)
        # Mint the federation-wide trace id: the kickoff broadcasts run
        # inside this span, so the start_learning frames carry its context
        # and every peer's experiment adopts the same trace
        # (start_learning_thread captures it from the ambient span).
        with TRACER.span(
            "set_start_learning", node=self.addr, trace_id=TRACER.new_trace_id()
        ):
            # Kick off peers first, then ourselves (reference node.py:359-370).
            self.protocol.broadcast(
                self.protocol.build_msg(
                    StartLearningCommand.get_name(),
                    args=[str(rounds), str(epochs), mode],
                )
            )
            # The initiator's weights seed the federation: mark our model
            # initialized and announce it; every other node adopts these weights
            # via InitModelCommand before round 0 (reference node.py:366-368 +
            # init_model_command.py:31-97) — a common round-0 starting point is
            # what SCAFFOLD's control-variate math assumes.
            self.state.model_initialized_event.set()
            self.protocol.broadcast(
                self.protocol.build_msg(ModelInitializedCommand.get_name())
            )
            self.start_learning_thread(rounds, epochs, mode=mode)
        # The kickoff must survive message loss: start_learning is a single
        # fire-once control frame, and in a star topology there is no second
        # path that can re-deliver it — one dropped frame leaves an alive
        # node that never joins the experiment, wins committee votes and
        # burns every stage timeout for the whole federation. Re-broadcast a
        # couple of times (fresh msg_id each, handler idempotent) so a peer
        # missing the first frame still joins during round 0's vote window.
        threading.Thread(
            target=self._rebroadcast_kickoff,
            args=(rounds, epochs, mode),
            name=f"kickoff-{self.addr}",
            daemon=True,
        ).start()

    def _rebroadcast_kickoff(self, rounds: int, epochs: int, mode: str = "sync") -> None:
        for _ in range(2):
            time.sleep(max(0.25, Settings.HEARTBEAT_PERIOD))
            if self.state.experiment is None or not self._running:
                return
            try:
                self.protocol.broadcast(
                    self.protocol.build_msg(
                        StartLearningCommand.get_name(),
                        args=[str(rounds), str(epochs), mode],
                    )
                )
            except Exception:  # protocol stopping — nothing to re-deliver to
                return

    def set_stop_learning(self) -> None:
        self.protocol.broadcast(self.protocol.build_msg(StopLearningCommand.get_name()))
        self.stop_learning_locally()

    def start_learning_thread(
        self,
        rounds: int,
        epochs: int,
        mode: str = "sync",
        start_round: int = 0,
        resuming: bool = False,
    ) -> None:
        """Spawn the stage machine on a daemon thread (idempotent per
        session; also the handler body of the start_learning command).

        ``mode`` picks the scheduler over the shared stage machine
        (``scheduler_start_stage``); ``start_round`` fast-forwards a
        mid-experiment async joiner to the window its welcome reported;
        ``resuming`` enters through :class:`~p2pfl_tpu_torch.stages.recovery.
        ResumeStage` instead — the crash-restart path, which re-announces
        the journaled identity and skips session bootstrap entirely."""
        with self.state.start_thread_lock:
            if self.learning_in_progress():
                return
            # Adopt the federation trace: on the initiator this is the
            # set_start_learning span's trace; on peers it is the sender's
            # context attached around start_learning dispatch. Outside any
            # span (direct API use) it stays None -> fresh local trace.
            self.state.trace_id = tracing.current_trace_id()
            self.state.set_experiment(f"experiment-{self.addr}", rounds)
            if start_round > 0:
                self.state.experiment.round = int(start_round)
            self.state.fed_mode = mode
            self.state.epochs = int(epochs)
            if mode == "async":
                from p2pfl_tpu_torch.learning.aggregators import AsyncBufferedAggregator

                # Linear rules use the staleness-weighted kernel; non-linear
                # (robust) rules see the buffered individuals, same as sync.
                rule = (
                    None
                    if isinstance(self.aggregator, FedAvg)
                    else self.aggregator.aggregate
                )
                self.async_agg = AsyncBufferedAggregator(self.addr, rule)
            logger.experiment_started(self.addr, self.state.experiment)
            self.learner.set_epochs(epochs)
            if resuming:
                from p2pfl_tpu_torch.stages.recovery import ResumeStage

                start_stage = ResumeStage
            else:
                start_stage = scheduler_start_stage(mode)
            self._workflow = LearningWorkflow(start_stage)
            self._learning_thread = threading.Thread(
                target=self._workflow.run,
                kwargs={"node": self},
                name=f"learning-{self.addr}",
                daemon=True,
            )
            self._learning_thread.start()

    # --- durable recovery (management/checkpoint.py NodeJournal) -------------

    @classmethod
    def resume(
        cls,
        model: ModelHandle,
        data: FederatedDataset,
        journal,
        addr: Optional[str] = None,
        **kwargs,
    ) -> "Node":
        """Rebuild a crashed node from its write-ahead journal — AS ITSELF.

        The journal's newest restorable snapshot supplies the identity
        (address), model params, sparse-delta anchor + error-feedback
        residuals (bit-exact), round/window position and known membership.
        The returned node is constructed but not started; the full restart
        sequence is::

            node = Node.resume(fresh_model, data, journal)
            node.start()
            node.resume_learning()   # reconnect + re-enter mid-experiment

        ``journal`` is a :class:`~p2pfl_tpu_torch.management.checkpoint.
        NodeJournal`; it stays attached, so the resumed node keeps
        journaling from where it left off.
        """
        from p2pfl_tpu_torch.management.checkpoint import attach_node_journal

        meta = journal.latest_meta()
        node = cls(model, data, addr=addr or meta.get("addr"), **kwargs)
        journal.restore_into(node)
        attach_node_journal(node, journal)
        return node

    def resume_learning(self) -> None:
        """Re-enter the journaled experiment mid-flight: reconnect to the
        journaled membership, then run the scheduler from the journaled
        round/window through :class:`~p2pfl_tpu_torch.stages.recovery.ResumeStage`
        (which re-announces this identity to the fleet). Requires a prior
        :meth:`resume` (or ``NodeJournal.restore_into``) and a started
        node."""
        meta = self._resume_meta
        if not meta:
            raise ValueError(
                f"{self.addr}: no journal snapshot restored — build the node "
                "via Node.resume(...) first"
            )
        for peer in meta.get("membership") or []:
            if peer == self.addr:
                continue
            try:
                self.protocol.connect(peer)
            except Exception:  # noqa: BLE001 — that peer may be gone too
                logger.warning(self.addr, f"resume reconnect to {peer} failed")
        total = int(meta.get("total_rounds") or 0)
        start_round = int(meta.get("round") or 0)
        if total <= 0 or start_round >= total:
            logger.warning(
                self.addr,
                f"journal is at round {start_round}/{total} — nothing to resume",
            )
            return
        self.start_learning_thread(
            total,
            int(meta.get("epochs") or 1),
            mode=meta.get("fed_mode") or "sync",
            start_round=start_round,
            resuming=True,
        )
        # Quorum baseline: the journaled membership is the session's known
        # fleet (set_experiment reset it to {self}).
        self.state.session_members |= set(meta.get("membership") or [])
        # Announce our journaled position to every reconnected peer: while
        # we were down the federation moved on, and whichever peer is ahead
        # replies with its round anchor as a dense catch-up — the resumed
        # node folds back in within a round instead of limping behind the
        # fleet (the heal pings peers sent while we were still booting hit
        # an experiment-less node and were rightly ignored).
        for peer in meta.get("membership") or []:
            self.send_reconcile_ping(peer)

    def journal_now(self) -> None:
        """Snapshot the recovery closure on demand (quorum parking journals
        before going quiet). No-op without an attached journal."""
        journal = self.recovery_journal
        if journal is None:
            return
        try:
            journal.snapshot(self)
        except Exception as e:  # noqa: BLE001 — journaling must not kill stages
            logger.warning(self.addr, f"journal snapshot failed: {e!r}")

    def request_async_join(self) -> None:
        """Ask a running elastic async federation to take this node in:
        broadcast a (TTL-gossiped) join request; any member replies with the
        session parameters and a dense full-model catch-up. Call after
        :meth:`connect`-ing to at least one member. Idempotent — duplicate
        welcomes no-op once learning is in progress."""
        self.protocol.broadcast(
            self.protocol.build_msg(AsyncJoinCommand.get_name())
        )

    def stop_learning_locally(self) -> None:
        """Abort the in-progress session (reference stop semantics: clear
        experiment state; stages observe it via check_early_stop)."""
        self.learner.interrupt_fit()
        self.aggregator.clear()
        if self.async_agg is not None:
            self.async_agg.clear()  # also wakes any in-flight window wait
        self.state.experiment = None
        self.state.train_set = []
        self.state.votes_ready_event.set()
        self.state.aggregated_model_event.set()
        logger.experiment_finished(self.addr)

    def learning_in_progress(self) -> bool:
        return (
            self._learning_thread is not None
            and self._learning_thread.is_alive()
            and self.state.experiment is not None
        )

    def wait_learning_finished(self, timeout: Optional[float] = None) -> None:
        if self._learning_thread is not None:
            self._learning_thread.join(timeout)

    @property
    def learning_workflow(self) -> Optional[LearningWorkflow]:
        return self._workflow

    # --- round survival ------------------------------------------------------

    def _on_aggregation_stall(self, missing: List[str]) -> None:
        """JIT stall patience fired: the round is limping. Record and dump
        the flight recorder — the ring currently holds exactly the events
        (sends, rejections, faults, peer deaths) that explain the stall."""
        rec = self.protocol.flight_recorder
        rec.record("agg_stall", missing=list(missing), round=self.state.round)
        rec.dump("stall")

    def _on_peer_heal(self, addr: str) -> None:
        """Heal callback (runs on the probing/handshake thread): a peer we
        wrote off came back. Exchange round/window progress so a healed
        split reconciles — each side pings its position; whichever side is
        ahead ships its round anchor as dense catch-up (ReconcileCommand).
        Rate-limited per peer; both sides ping, so one lost frame only
        delays the exchange by the peer's own ping."""
        self.send_reconcile_ping(addr)

    def send_reconcile_ping(self, addr: str) -> bool:
        """Tell ``addr`` our round/window position so whichever side of a
        heal is ahead ships its dense catch-up. Rate-limited per peer via
        ``RECOVERY_RECONCILE_COOLDOWN_S``; no-op outside an experiment."""
        state = self.state
        if state.experiment is None or state.round is None or addr == self.addr:
            return False
        now = time.monotonic()
        if now - self._reconcile_ping_at.get(addr, 0.0) < Settings.RECOVERY_RECONCILE_COOLDOWN_S:
            return False
        self._reconcile_ping_at[addr] = now
        state.session_members.add(addr)
        try:
            self.protocol.send(
                addr,
                self.protocol.build_msg(
                    ReconcileCommand.get_name(),
                    args=[str(state.round), state.fed_mode],
                    round=state.round,
                ),
                create_connection=True,
                raise_error=False,
                remove_on_error=False,
            )
        except Exception:  # noqa: BLE001 — the peer may flap right back out
            return False
        from p2pfl_tpu_torch.stages.recovery import reconcile_metric

        reconcile_metric(self.addr, "ping_tx")
        self.protocol.flight_recorder.record(
            "reconcile", role="ping_tx", peer=addr, round=state.round
        )
        return True

    def _on_peer_death(self, addr: str) -> None:
        """Death callback (runs on the heartbeater/transport thread that
        removed the neighbor): shrink every wait this round still has open
        on ``addr``. A contribution that already arrived is kept — only the
        EXPECTATION of one dies with the peer."""
        state = self.state
        if state.experiment is None:
            return
        if self.async_agg is not None:
            # Async windows have no per-peer expectation — but the fill
            # target counts live membership, so wake the window wait to
            # re-evaluate it without the dead peer.
            self.async_agg.notify()
        in_train_set = addr in state.train_set
        if in_train_set:
            # Rebind (don't mutate): stages iterate the current binding.
            state.train_set = [n for n in state.train_set if n != addr]
        shrunk = self.aggregator.remove_node(addr)
        if shrunk and Settings.PRIVACY_SECAGG and state.round is not None:
            # Masker dropout: the dead committee member's pairwise mask
            # shares are now uncancelled in every aggregator's lattice sum.
            # Reveal OUR round-scoped pair secret with it (privacy_repair
            # broadcast) so finalize can subtract our share; every other
            # survivor does the same for theirs. shrunk=True means its
            # contribution never entered OUR sum — but death detection is
            # local, not fleet-consistent: under a partition or heartbeat
            # flap another peer may already hold the "dead" node's masked
            # frame, and whoever holds both that frame and every survivor's
            # reveal can unmask the individual update (the false-dropout
            # attack). So reveal only when no other peer's coverage report
            # for this round lists the peer as merged; the residual wire-
            # observer exposure stays (the JAX package's privacy doc states it).
            held = any(
                addr in (merged or ())
                for peer, merged in list(state.models_aggregated.items())
                if peer != addr
            )
            if held:
                logger.warning(
                    self.addr,
                    f"masker {addr} died mid-round {state.round} but a peer "
                    "already merged its frame — withholding the mask-repair "
                    "reveal (round may fall back to plaintext)",
                )
            else:
                secret = state.privacy.repair_secrets_for(addr, state.round)
                if secret is not None:
                    self.protocol.broadcast(
                        self.protocol.build_msg(
                            PrivacyRepairCommand.get_name(),
                            args=[addr, secret],
                            round=state.round,
                        )
                    )
                    logger.warning(
                        self.addr,
                        f"masker {addr} died mid-round {state.round}: "
                        "revealed our round-scoped pair secret for mask "
                        "repair",
                    )
        state.models_aggregated.pop(addr, None)
        # The retired coverage table too: an overlap drain must stop trying
        # to serve a dead laggard (its candidate filter reads this).
        state.models_aggregated_prev.pop(addr, None)
        # Wake the vote wait: it recomputes its expected-voter set from live
        # membership, which no longer includes the dead peer.
        state.votes_ready_event.set()
        if in_train_set or shrunk:
            logger.warning(
                self.addr,
                f"trainset member {addr} died mid-round {state.round}: "
                f"expectations shrunk (aggregation re-evaluated: {shrunk})",
            )

    # --- hooks used by stages/commands --------------------------------------

    def finish_learning(self) -> None:
        """Normal end of the last round (reference round_finished_stage
        wrap-up): reset state for the next experiment."""
        self.state.experiment = None
        self.state.status = "Idle"
        self.state.train_set = []
        self.state.models_aggregated = {}
        logger.experiment_finished(self.addr)

    def log_metric(self, name: str, value: float, step: Optional[int] = None) -> None:
        logger.log_metric(self.addr, name, value, step=step, round=self.state.round)

    def _report_learner_metric(self, name: str, value: float, step: Optional[int] = None) -> None:
        logger.log_metric(self.addr, name, value, step=step, round=self.state.round)

    def log_remote_metric(self, source: str, round: int, name: str, value: float) -> None:
        logger.log_metric(source, name, value, round=round)

    def log_round_finished(self) -> None:
        r = self.state.round
        logger.round_finished_info(self.addr, (r - 1) if r is not None else -1)
        for hook in self.round_end_hooks:
            try:
                hook(self)
            except Exception as e:  # a failing hook must not kill the round loop
                logger.warning(self.addr, f"round_end_hook failed: {e!r}")
