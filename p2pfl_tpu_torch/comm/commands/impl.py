"""The framework's command set.

Parity with the reference's commands (SURVEY.md §2.3, p2pfl/communication/
commands/message/*.py and weights/*.py). Each command captures the node
facade and manipulates its state / learner / aggregator exactly like the
reference handlers:

* control plane: start_learning, stop_learning, model_initialized,
  vote_train_set, models_aggregated, models_ready, metrics
* model plane (weights payloads): init_model, partial_model, full_model

The port's copy of ``p2pfl_tpu/comm/commands/impl.py``. Frames decode on
the node's device; a masked lattice frame's planes stay numpy on the host,
where the privacy plane sums them. A received partial or async contribution
carries the frame's ``additional_info`` (the sender's SCAFFOLD deltas); the
JAX package's copies the receiver's own onto it.
"""

from __future__ import annotations

import logging
from typing import TYPE_CHECKING, Any, List

from p2pfl_tpu_torch.comm.commands.command import Command
from p2pfl_tpu_torch.comm.delta import DELTA_META_KEY
from p2pfl_tpu_torch.config import Settings
from p2pfl_tpu_torch.exceptions import DeltaAnchorError
from p2pfl_tpu_torch.privacy.secagg import MASKED_META_KEY, PrivacyPlane
from p2pfl_tpu_torch.telemetry import TRACER, tracing

if TYPE_CHECKING:  # pragma: no cover
    from p2pfl_tpu_torch.node import Node

log = logging.getLogger("p2pfl_tpu_torch")


class StartLearningCommand(Command):
    """Kick off a learning session on this node
    (reference message/start_learning_command.py:26-79)."""

    def __init__(self, node: "Node") -> None:
        self._node = node

    @staticmethod
    def get_name() -> str:
        return "start_learning"

    def execute(self, source: str, round: int, *args: str, **kwargs: Any) -> None:
        rounds, epochs = int(args[0]), int(args[1])
        # Third arg (absent on older peers) selects the scheduler: "sync"
        # rounds (default) or "async" elastic windows (stages/async_node.py).
        mode = args[2] if len(args) > 2 else "sync"
        self._node.start_learning_thread(rounds, epochs, mode=mode)


class StopLearningCommand(Command):
    """(reference message/stop_learning_command.py:30)"""

    def __init__(self, node: "Node") -> None:
        self._node = node

    @staticmethod
    def get_name() -> str:
        return "stop_learning"

    def execute(self, source: str, round: int, *args: str, **kwargs: Any) -> None:
        self._node.stop_learning_locally()


class ModelInitializedCommand(Command):
    """Peer announced an initialized model: nei_status[src] = -1
    (reference message/model_initialized_command.py:25)."""

    def __init__(self, node: "Node") -> None:
        self._node = node

    @staticmethod
    def get_name() -> str:
        return "model_initialized"

    def execute(self, source: str, round: int, *args: str, **kwargs: Any) -> None:
        self._node.state.nei_status[source] = -1


class VoteTrainSetCommand(Command):
    """Store a peer's committee votes; args are a flat
    [candidate, weight, ...] list (reference
    message/vote_train_set_command.py:28-56: accept round r or r+1 because
    votes may arrive before the local round increments)."""

    def __init__(self, node: "Node") -> None:
        self._node = node

    @staticmethod
    def get_name() -> str:
        return "vote_train_set"

    def execute(self, source: str, round: int, *args: str, **kwargs: Any) -> None:
        state = self._node.state
        current = state.round
        if current is None or round not in (current, current + 1):
            log.debug("vote from %s for round %s ignored (local round %s)", source, round, current)
            return
        votes = {args[i]: int(args[i + 1]) for i in range(0, len(args) - 1, 2)}
        with state.train_set_votes_lock:
            state.train_set_votes[source] = votes
        state.votes_ready_event.set()


class ModelsAggregatedCommand(Command):
    """Track a trainset peer's partial-aggregation progress
    (reference message/models_agregated_command.py:26)."""

    def __init__(self, node: "Node") -> None:
        self._node = node

    @staticmethod
    def get_name() -> str:
        return "models_aggregated"

    def execute(self, source: str, round: int, *args: str, **kwargs: Any) -> None:
        state = self._node.state
        if state.round is not None and round == state.round:
            state.models_aggregated[source] = list(args)
        elif round == state.prev_coverage_round:
            # Train<->diffuse overlap: a laggard still in the round we just
            # closed reports progress — the background drain reads this
            # retired coverage table, so its candidate set keeps shrinking.
            state.models_aggregated_prev[source] = list(args)


class ModelsReadyCommand(Command):
    """Peer finished its round (reference message/models_ready_command.py:26:
    accept round-1 or round)."""

    def __init__(self, node: "Node") -> None:
        self._node = node

    @staticmethod
    def get_name() -> str:
        return "models_ready"

    def execute(self, source: str, round: int, *args: str, **kwargs: Any) -> None:
        state = self._node.state
        current = state.round
        if current is None or round not in (current - 1, current):
            return
        state.nei_status[source] = round


class MetricsCommand(Command):
    """Peer metrics broadcast (reference message/metrics_command.py:26);
    args = flat [name, value, ...]."""

    def __init__(self, node: "Node") -> None:
        self._node = node

    @staticmethod
    def get_name() -> str:
        return "metrics"

    def execute(self, source: str, round: int, *args: str, **kwargs: Any) -> None:
        for i in range(0, len(args) - 1, 2):
            self._node.log_remote_metric(source, round, args[i], float(args[i + 1]))


class InitModelCommand(Command):
    """Adopt initial weights if we don't have a model yet
    (reference weights/init_model_command.py:31-97)."""

    def __init__(self, node: "Node") -> None:
        self._node = node

    @staticmethod
    def get_name() -> str:
        return "init_model"

    def execute(self, source: str, round: int, *args: str, **kwargs: Any) -> None:
        from p2pfl_tpu_torch.models.model_handle import decode_wire_frame

        state = self._node.state
        if state.model_initialized_event.is_set():
            return
        weights: bytes = kwargs["weights"]
        try:
            arrays, meta = decode_wire_frame(weights, state.device)
        except Exception as exc:  # corrupt/truncated init frame
            log.debug("init_model from %s undecodable: %s", source, exc)
            state.admission.record("corrupt", source, "init_model")
            return
        # Round-0 weights define every peer's starting point — a poisoned
        # init outlives any later defense, so screen structure/finiteness
        # plus the init-scale weight-norm sanity bound here.
        if state.admission.screen_init(
            arrays, self._node.learner.get_model(), source=source
        ):
            return
        try:
            self._node.learner.get_model().apply_frame(arrays, meta)
            state.model_initialized_event.set()
            self._node.protocol.broadcast(
                self._node.protocol.build_msg(ModelInitializedCommand.get_name())
            )
        except Exception:
            log.exception("init_model from %s failed", source)


class PartialModelCommand(Command):
    """Merge a partially-aggregated model from a trainset peer, then
    re-announce progress (reference weights/partial_model_command.py:33-112)."""

    def __init__(self, node: "Node") -> None:
        self._node = node

    @staticmethod
    def get_name() -> str:
        return "partial_model"

    def execute(self, source: str, round: int, *args: str, **kwargs: Any) -> None:
        node = self._node
        state = node.state
        if state.round is None:
            return
        if round != state.round:
            log.debug("partial model for round %s ignored (local %s)", round, state.round)
            return
        weights: bytes = kwargs["weights"]
        contributors: List[str] = list(kwargs.get("contributors", []))
        # Clamp the unauthenticated wire claim before it can weight FedAvg.
        num_samples: int = state.admission.clamp_num_samples(
            int(kwargs.get("num_samples", 1)), source
        )
        try:
            # Frames decode through the node's delta codec: dense frames pass
            # straight through; sparse top-k deltas reconstruct against this
            # round's anchor (a scatter-add on the node's device). Masked
            # lattice frames (privacy plane) carry neither delta nor codec
            # spec and pass through untouched — they are handled below.
            arrays, meta = state.wire.decode_frame(weights)
        except DeltaAnchorError as exc:
            # Out of phase, not corrupt: drop it, the gossip loop re-ships.
            log.debug("partial model from %s dropped: %s", source, exc)
            return
        except Exception as exc:  # corrupt/truncated frame: reject, don't raise
            # Decode failures used to escape onto the transport thread; a
            # Byzantine (or bit-flipped) frame must be a counted rejection,
            # not an exception storm.
            log.debug("partial model from %s undecodable: %s", source, exc)
            state.admission.record("corrupt", source, "partial_model")
            return
        if PrivacyPlane.is_masked_frame(meta):
            # Masked lattice frame: structural screening only (uniform ring
            # values cannot be norm-screened — the committee-side range
            # check at finalize owns the rest), then straight into the
            # lattice-summing aggregator. Never touches the model or the
            # delta anchor.
            if not Settings.PRIVACY_SECAGG:
                state.admission.record("masked_structure", source, "partial_model")
                return
            if not state.train_set:
                # Out of phase, not hostile: the round's committee is not
                # elected here yet (vote in progress), so the frame's
                # declared geometry CANNOT be validated — drop silently and
                # let the sender's gossip loop re-ship, exactly like a
                # sparse frame ahead of our anchor. Rejecting would both
                # poison the honest sender's suspect score and stall its
                # gossip coverage into an abandonment.
                log.debug(
                    "masked partial from %s dropped: round %s committee not "
                    "elected yet", source, round,
                )
                return
            try:
                lattices = PrivacyPlane.parse_frame(arrays, meta)
            except Exception as exc:  # hostile plane geometry
                log.debug("masked partial from %s unparseable: %s", source, exc)
                state.admission.record("corrupt", source, "partial_model")
                return
            try:
                leaves = node.learner.get_model().get_parameters()
                supports = PrivacyPlane.supports(round, [tuple(p.shape) for p in leaves],
                                                 [p.is_floating_point() for p in leaves])
                expected_ks = [0 if s is None else int(s.size) for s in supports]
            except Exception:  # noqa: BLE001 — geometry failure = reject
                state.admission.record("masked_structure", source, "partial_model")
                return
            if state.admission.screen_masked(
                lattices,
                meta.get(MASKED_META_KEY),
                committee=state.train_set,
                contributors=contributors,
                expected_ks=expected_ks,
                source=source,
                cmd="partial_model",
            ):
                return
            handle = PrivacyPlane.handle_from_frame(
                lattices, meta, contributors, num_samples
            )
            agg = node.aggregator.add_model(handle, round=round)
            if agg:
                node.protocol.broadcast(
                    node.protocol.build_msg(
                        ModelsAggregatedCommand.get_name(), args=agg, round=state.round
                    )
                )
            return
        # Admission control: screen the RECONSTRUCTED arrays (post sparse-
        # delta decode) against the local model spec + adaptive norm bound
        # before anything reaches the aggregator.
        if state.admission.screen(
            arrays, node.learner.get_model(), source=source, cmd="partial_model"
        ):
            return
        # Trace context: the envelope slot (in-memory) is already attached by
        # handle_envelope; the PFLT header slot covers gRPC weights frames.
        wire_ctx = meta.get(tracing.TRACE_META_KEY, "") or tracing.current_wire()
        with TRACER.recv_span(
            "apply:partial_model", node.addr, wire_ctx, source=source, round=round
        ):
            model = node.learner.get_model().build_copy(
                params=arrays, contributors=contributors, num_samples=num_samples
            )
            # The sender's side channels (SCAFFOLD's deltas), not ours: the
            # copy above starts from the local model's additional_info.
            model.additional_info = dict(meta.get("additional_info", {}))
            # Round-scoped: under overlap the previous round's table stays
            # populated (retired) while peers gossip the new round — the
            # aggregator drops a frame whose round is not the OPEN one
            # (the sender's gossip loop re-ships until we open it).
            agg = node.aggregator.add_model(model, round=round)
            if agg:
                node.protocol.broadcast(
                    node.protocol.build_msg(
                        ModelsAggregatedCommand.get_name(), args=agg, round=state.round
                    )
                )


class FullModelCommand(Command):
    """Adopt the round's fully-aggregated model
    (reference weights/full_model_command.py:31-89)."""

    def __init__(self, node: "Node") -> None:
        self._node = node

    @staticmethod
    def get_name() -> str:
        return "full_model"

    def execute(self, source: str, round: int, *args: str, **kwargs: Any) -> None:
        node = self._node
        state = node.state
        if state.round is None:
            return
        if round < state.round:
            return
        if round <= state.last_full_model_round:
            # Redundant re-delivery: we already hold this round's full model
            # (adopted from the wire, or our own aggregate — TrainStage marks
            # it). FIRST WINS: never re-apply — a later frame for the same
            # round can legitimately differ (aggregation-order epsilon) or
            # maliciously differ (a Byzantine peer overwriting the honest
            # aggregate in the post-aggregation window), and we have no basis
            # to prefer it. The sender keeps gossiping because it never saw
            # our round progress — our fire-once models_ready broadcast was
            # probably lost. Re-announce so the sender's candidate set
            # shrinks instead of it re-shipping full models until its stall
            # exit trips (ack repair under message loss).
            node.protocol.broadcast(
                node.protocol.build_msg(ModelsReadyCommand.get_name(), round=round)
            )
            return
        weights: bytes = kwargs["weights"]
        try:
            try:
                arrays, meta = state.wire.decode_frame(weights)
            except DeltaAnchorError as exc:
                # Sparse frame for a round we hold no anchor for (we lag or
                # lead the sender) — drop; the sender's gossip loop retries
                # and falls back to a dense frame for out-of-round peers.
                log.debug("full model from %s dropped: %s", source, exc)
                return
            except Exception as exc:  # corrupt/truncated frame
                log.debug("full model from %s undecodable: %s", source, exc)
                state.admission.record("corrupt", source, "full_model")
                return
            # Structure + finiteness screening BEFORE adoption and before the
            # anchor resync below, so a poisoned frame can never become the
            # next round's delta anchor. No norm bound here: a rejoining node
            # must be able to adopt an aggregate arbitrarily far from its
            # stale local weights (admission.py module docstring).
            if state.admission.screen(
                arrays, node.learner.get_model(),
                source=source, cmd="full_model", check_norm=False,
            ):
                return
            wire_ctx = meta.get(tracing.TRACE_META_KEY, "") or tracing.current_wire()
            with TRACER.recv_span(
                "apply:full_model", node.addr, wire_ctx, source=source, round=round
            ):
                # Checked again under the adoption lock, then installed as
                # one step: this frame may have passed the checks above while
                # the round was open and reach this point after the node
                # committed the round and fitted the next one.
                with state.adoption_lock:
                    if (
                        state.round is None
                        or round < state.round
                        or round <= state.last_full_model_round
                    ):
                        return
                    node.learner.get_model().apply_frame(arrays, meta)
                    state.note_full_model_round(round)
                    from p2pfl_tpu_torch.telemetry.ledger import (
                        LEDGERS,
                        canonical_params_hash,
                    )

                    if LEDGERS.enabled():
                        # Non-trainers commit the round aggregate here — the
                        # trainer-side analogue (own aggregate) is in TrainStage.
                        adopted = node.learner.get_model()
                        LEDGERS.get(node.addr).emit(
                            "aggregate_committed",
                            round=round,
                            dedup_key=("commit", round),
                            hash=canonical_params_hash(adopted.get_parameters()),
                            contributors=sorted(adopted.contributors),
                            num_samples=adopted.get_num_samples(),
                            origin="full_model",
                        )
                    # Rejoin/round-anchor resync: adopting a DENSE full model for
                    # round r means we now hold the exact model every in-phase
                    # node will anchor round r+1 against — so a crashed-and-
                    # restarted (or partition-healed) node whose anchor lags
                    # fast-forwards here, and subsequent sparse top-k frames for
                    # r+1 decode instead of being dropped forever. Sparse frames
                    # skip this: decoding one already required a current anchor,
                    # and a trainer's error-feedback residuals must survive the
                    # normal round boundary (RoundFinishedStage advances those).
                    if meta.get(DELTA_META_KEY) is None and round + 1 > state.wire.anchor_round:
                        state.wire.resync(
                            node.learner.get_model().get_parameters(), round + 1
                        )
                    state.aggregated_model_event.set()
        except Exception:
            log.exception("full_model from %s failed", source)


class ReconcileCommand(Command):
    """Partition-heal progress exchange (control plane).

    Sent by a node's heal handler when a failure-departed peer demonstrably
    returns: ``args = [sender_round, sender_mode]``. Both sides of a healed
    split detect the heal and ping, so each handler only has to answer one
    question — *am I ahead?* If this node leads the sender by at least
    ``Settings.RECOVERY_RECONCILE_MIN_LEAD`` rounds/windows, it ships its
    current ROUND ANCHOR (the round-start model every in-phase node deltas
    against) as a dense ``reconcile_model`` catch-up; the behind side adopts
    it at its next round boundary and fast-forwards. Equal-round splits
    exchange nothing — the next round's normal aggregation merges the two
    branches (and the async buffer folds both halves staleness-weighted)."""

    def __init__(self, node: "Node") -> None:
        self._node = node

    @staticmethod
    def get_name() -> str:
        return "reconcile"

    def execute(self, source: str, round: int, *args: str, **kwargs: Any) -> None:
        node = self._node
        state = node.state
        my_round = state.round
        if my_round is None or source == node.addr:
            return
        try:
            sender_round = int(args[0]) if args else int(round)
        except ValueError:
            return
        if sender_round - my_round >= Settings.RECOVERY_RECONCILE_MIN_LEAD:
            # THEY are ahead: request the catch-up by pinging our own
            # position back (covers asymmetric heal detection — only one
            # side noticed the return). Cooldown-guarded on the node.
            node.send_reconcile_ping(source)
            return
        if my_round - sender_round < Settings.RECOVERY_RECONCILE_MIN_LEAD:
            return
        anchor = state.wire.anchor_model()
        if anchor is None:
            return
        leaves, anchor_round = anchor
        if anchor_round <= sender_round:
            return
        model = node.learner.get_model()
        catchup = model.build_copy(
            params=leaves,
            contributors=model.contributors or [node.addr],
            num_samples=model.get_num_samples(),
        )
        env = node.protocol.build_weights(
            ReconcileModelCommand.get_name(),
            anchor_round,
            catchup.encode_parameters(),  # always dense: generations diverged
            catchup.contributors,
            catchup.get_num_samples(),
        )
        try:
            node.protocol.send(
                source, env, create_connection=True,
                raise_error=False, remove_on_error=False,
            )
        except Exception:  # noqa: BLE001 — a failed catch-up must not hurt us
            log.exception("reconcile catch-up to %s failed", source)
            return
        from p2pfl_tpu_torch.stages.recovery import reconcile_metric

        reconcile_metric(node.addr, "catchup_tx")
        node.protocol.flight_recorder.record(
            "reconcile", role="catchup_tx", peer=source,
            round=anchor_round, behind=sender_round,
        )
        log.warning(
            "%s: healed peer %s is %d behind (round %s vs %s) — shipped the "
            "round-%s anchor as dense catch-up",
            node.addr, source, my_round - sender_round, sender_round, my_round,
            anchor_round,
        )


class ReconcileModelCommand(Command):
    """Dense catch-up from the ahead side of a healed split (model plane).

    The payload is the sender's round anchor for ``round``. Adoption is
    deferred: the screened arrays are parked in the node state and applied
    ATOMICALLY at the next round/window boundary
    (:func:`p2pfl_tpu_torch.stages.recovery.apply_pending_reconcile`) — applying
    mid-stage would race the stage's own model writes. The sliced stage
    waits are woken so the dead-branch round winds down fast."""

    def __init__(self, node: "Node") -> None:
        self._node = node

    @staticmethod
    def get_name() -> str:
        return "reconcile_model"

    def execute(self, source: str, round: int, *args: str, **kwargs: Any) -> None:
        from p2pfl_tpu_torch.models.model_handle import decode_wire_frame

        node = self._node
        state = node.state
        if state.round is None or int(round) <= state.round:
            return
        weights: bytes = kwargs["weights"]
        try:
            arrays, meta = decode_wire_frame(weights, state.device)
        except Exception as exc:
            log.debug("reconcile_model from %s undecodable: %s", source, exc)
            state.admission.record("corrupt", source, "reconcile_model")
            return
        # Structure + finiteness screening; no norm bound — our stale branch
        # is arbitrarily far from the surviving generation (same rationale
        # as full_model / async_catchup adoption).
        if state.admission.screen(
            arrays, node.learner.get_model(),
            source=source, cmd="reconcile_model", check_norm=False,
        ):
            return
        if state.offer_reconcile(
            int(round), arrays, list(kwargs.get("contributors", [])), source
        ):
            # Wind the dead-branch round down: sliced waits re-check
            # reconcile_ahead() and exit instead of sleeping out deadlines.
            state.votes_ready_event.set()
            state.aggregated_model_event.set()
            node.protocol.flight_recorder.record(
                "reconcile", role="offer", peer=source, round=int(round)
            )
            log.info(
                "%s: reconcile catch-up for round %s staged (from %s)",
                node.addr, round, source,
            )


class PrivacyKeyCommand(Command):
    """Session public key for the privacy plane's pairwise mask agreement.

    ``args = [pubkey_hex]``. TTL-gossiped at session bootstrap
    (``establish_initial_model``); the handler answers a FIRST-seen key with
    its own key sent directly back, so a joiner (or a peer whose broadcast
    was dropped) converges on a symmetric pair secret without a dedicated
    handshake round. Idempotent: repeated keys no-op."""

    def __init__(self, node: "Node") -> None:
        self._node = node

    @staticmethod
    def get_name() -> str:
        return "privacy_key"

    def execute(self, source: str, round: int, *args: str, **kwargs: Any) -> None:
        node = self._node
        if source == node.addr or not args:
            return
        if node.state.privacy.learn_key(source, args[0]):
            # New peer: answer with our key so the pair secret is derivable
            # on both ends even if our bootstrap broadcast never reached it.
            try:
                node.protocol.send(
                    source,
                    node.protocol.build_msg(
                        PrivacyKeyCommand.get_name(),
                        args=[node.state.privacy.key_payload()],
                    ),
                    create_connection=True,
                    raise_error=False,
                    remove_on_error=False,
                )
            except Exception:  # noqa: BLE001 — a failed reply must not hurt us
                log.debug("privacy_key reply to %s failed", source)


class PrivacyRepairCommand(Command):
    """Mask-repair share for a dead masker (privacy plane).

    ``args = [dead_addr, round_secret_hex]``, ``round`` = the masked round
    being repaired. The payload is the survivor's ROUND-SCOPED pair secret
    (``H(pair_secret, round)``) — never the pair secret itself, so a wire
    capture opens exactly one round's mask streams. Broadcast by every
    survivor whose pairwise mask with the dead committee member would
    otherwise stay uncancelled in the round's lattice sum (withheld when
    coverage shows the "dead" peer's frame already circulated — the
    false-dropout gate in ``Node._on_peer_death``); every aggregating node
    stores the share first-write-wins with both parties validated against
    the round's committee (:meth:`PrivacyPlane.note_repair` — the claimed
    survivor is bound to the transport source here), and
    :meth:`PrivacyPlane.finalize` subtracts the reconstructed mask."""

    def __init__(self, node: "Node") -> None:
        self._node = node

    @staticmethod
    def get_name() -> str:
        return "privacy_repair"

    def execute(self, source: str, round: int, *args: str, **kwargs: Any) -> None:
        node = self._node
        if len(args) < 2 or source == node.addr:
            return
        dead, secret_hex = args[0], args[1]
        if node.state.privacy.note_repair(int(round), source, dead, secret_hex):
            node.protocol.flight_recorder.record(
                "privacy_repair", survivor=source, dead=dead, round=int(round)
            )


class AsyncContributionCommand(Command):
    """Fold a peer's async contribution into the buffered aggregator.

    The envelope ``round`` is the WINDOW the sender trained against; the
    receiver computes the lag against its own window at fold time. Every
    contribution passes the same wire path as sync partial models — delta
    decode (against the multi-window anchor history), admission screening,
    sample-count clamping — before it can weigh an aggregate, and the
    observatory's suspect score gates admission on top (detect→act: a peer
    the fleet attributes rejections to stops being folded at all)."""

    def __init__(self, node: "Node") -> None:
        self._node = node

    @staticmethod
    def get_name() -> str:
        return "async_model"

    def execute(self, source: str, round: int, *args: str, **kwargs: Any) -> None:
        node = self._node
        state = node.state
        agg = node.async_agg
        if state.round is None or state.fed_mode != "async" or agg is None:
            return  # not in an async session (mixed-mode peers tolerate)
        gate = Settings.ASYNC_SUSPECT_GATE
        if gate > 0:
            try:
                suspicion = node.protocol.observatory.suspect_score(source)
            except Exception:  # noqa: BLE001
                suspicion = 0.0
            if suspicion >= gate:
                agg.drop(source, "suspect")
                node.protocol.flight_recorder.record(
                    "async_drop", peer=source, reason="suspect", round=round
                )
                return
        weights: bytes = kwargs["weights"]
        contributors: List[str] = list(kwargs.get("contributors", [])) or [source]
        num_samples: int = state.admission.clamp_num_samples(
            int(kwargs.get("num_samples", 1)), source
        )
        try:
            arrays, meta = state.wire.decode_frame(weights)
        except DeltaAnchorError as exc:
            # Anchored beyond the history window (sender lags or leads too
            # far): drop — it keeps emitting every window, a later frame
            # will land inside the history.
            agg.drop(source, "anchor")
            log.debug("async contribution from %s dropped: %s", source, exc)
            return
        except Exception as exc:  # corrupt/truncated frame
            log.debug("async contribution from %s undecodable: %s", source, exc)
            state.admission.record("corrupt", source, "async_model")
            return
        if state.admission.screen(
            arrays, node.learner.get_model(), source=source, cmd="async_model"
        ):
            return
        wire_ctx = meta.get(tracing.TRACE_META_KEY, "") or tracing.current_wire()
        with TRACER.recv_span(
            "apply:async_model", node.addr, wire_ctx, source=source, round=round
        ):
            model = node.learner.get_model().build_copy(
                params=arrays, contributors=contributors, num_samples=num_samples
            )
            model.additional_info = dict(meta.get("additional_info", {}))
            agg.fold(model, round, source)


class AsyncDoneCommand(Command):
    """A peer completed all of its async windows. The window fill target
    stops counting it (it will produce no further contributions) and any
    in-flight window wait re-evaluates immediately — without this, the last
    nodes standing would burn ``ASYNC_WINDOW_TIMEOUT`` per remaining window
    waiting on peers that already went home."""

    def __init__(self, node: "Node") -> None:
        self._node = node

    @staticmethod
    def get_name() -> str:
        return "async_done"

    def execute(self, source: str, round: int, *args: str, **kwargs: Any) -> None:
        node = self._node
        node.state.async_done_peers.add(source)
        if node.async_agg is not None:
            node.async_agg.notify()


class AsyncJoinCommand(Command):
    """A peer wants to enter the running async experiment.

    Every member that receives the (TTL-gossiped) join request replies with
    the session parameters (``async_welcome``) plus a DENSE full-model
    catch-up frame (``async_catchup``) — the joiner keeps the first of each,
    the rest are idempotent no-ops. Sync experiments ignore joins: elastic
    membership is exactly what the sync barrier cannot offer."""

    def __init__(self, node: "Node") -> None:
        self._node = node

    @staticmethod
    def get_name() -> str:
        return "async_join"

    def execute(self, source: str, round: int, *args: str, **kwargs: Any) -> None:
        node = self._node
        state = node.state
        if state.round is None or state.fed_mode != "async" or source == node.addr:
            return
        w = state.round or 0
        node.protocol.flight_recorder.record("membership", event="join_request", peer=source)
        try:
            node.protocol.send(
                source,
                node.protocol.build_msg(
                    AsyncWelcomeCommand.get_name(),
                    args=[str(state.total_rounds or 0), str(state.epochs)],
                    round=w,
                ),
                create_connection=True,
                raise_error=False,
                remove_on_error=False,
            )
            model = node.learner.get_model()
            env = node.protocol.build_weights(
                AsyncCatchupCommand.get_name(),
                w,
                model.encode_parameters(),  # always dense: the joiner holds no anchor
                model.contributors or [node.addr],
                model.get_num_samples(),
            )
            node.protocol.send(
                source, env, create_connection=True,
                raise_error=False, remove_on_error=False,
            )
        except Exception:  # noqa: BLE001 — a failed welcome must not hurt us
            log.exception("async_join reply to %s failed", source)


class AsyncWelcomeCommand(Command):
    """Session parameters for a joiner: total windows + epochs in ``args``,
    the sender's current window in ``round``. The joiner's experiment starts
    fast-forwarded to that window; duplicate welcomes no-op."""

    def __init__(self, node: "Node") -> None:
        self._node = node

    @staticmethod
    def get_name() -> str:
        return "async_welcome"

    def execute(self, source: str, round: int, *args: str, **kwargs: Any) -> None:
        node = self._node
        if node.learning_in_progress():
            return
        total = int(args[0])
        epochs = int(args[1]) if len(args) > 1 else 1
        if total <= 0 or int(round) >= total:
            return  # session is over (or malformed) — nothing to join
        log.info(
            "%s: joining async experiment at window %s/%s (welcomed by %s)",
            node.addr, round, total, source,
        )
        node.start_learning_thread(
            total, epochs, mode="async", start_round=int(round)
        )


class AsyncCatchupCommand(Command):
    """Dense full-model bootstrap for a cold joiner: adopt the weights,
    resync the sparse-delta anchor to the sender's window (residual-dropping
    :meth:`DeltaWireCodec.resync` — the rejoin path), and mark
    the model initialized so :class:`AsyncStartStage` proceeds. A node that
    already holds an initialized model ignores catch-ups — rejoining live
    nodes converge through the normal staleness-weighted folds instead."""

    def __init__(self, node: "Node") -> None:
        self._node = node

    @staticmethod
    def get_name() -> str:
        return "async_catchup"

    def execute(self, source: str, round: int, *args: str, **kwargs: Any) -> None:
        from p2pfl_tpu_torch.models.model_handle import decode_wire_frame

        node = self._node
        state = node.state
        if state.model_initialized_event.is_set():
            return
        weights: bytes = kwargs["weights"]
        try:
            arrays, meta = decode_wire_frame(weights, state.device)
        except Exception as exc:
            log.debug("async_catchup from %s undecodable: %s", source, exc)
            state.admission.record("corrupt", source, "async_catchup")
            return
        # Structure + finiteness screening; no norm bound — a joiner's local
        # random init is arbitrarily far from the trained federation model
        # (same rationale as full_model adoption, comm/admission.py).
        if state.admission.screen(
            arrays, node.learner.get_model(),
            source=source, cmd="async_catchup", check_norm=False,
        ):
            return
        try:
            node.learner.get_model().apply_frame(arrays, meta)
            state.wire.resync(node.learner.get_model().get_parameters(), int(round))
            state.note_full_model_round(int(round))
            state.model_initialized_event.set()
            node.protocol.flight_recorder.record(
                "membership", event="catchup", peer=source, window=int(round)
            )
        except Exception:
            log.exception("async_catchup from %s failed", source)
