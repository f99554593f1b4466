"""The six stages of a federated round.

Round trip (reference docs/source/components/workflows.md:12-24 and SURVEY.md
§2.2): StartLearning → [Vote → (Train | WaitAgg) → GossipModel →
RoundFinished] * rounds. Stage names match the reference's history pattern so
the e2e assertions are comparable (test/node_test.py:114-120).

The port's copy of ``p2pfl_tpu/stages/base_node.py``. Ledger hashes are
taken over the canonical leaves.
"""

from __future__ import annotations

import logging
import random
import threading
import time
from typing import TYPE_CHECKING, Callable, List, Optional, Type

from p2pfl_tpu_torch.comm.commands.impl import (
    FullModelCommand,
    InitModelCommand,
    MetricsCommand,
    ModelInitializedCommand,
    ModelsAggregatedCommand,
    ModelsReadyCommand,
    PartialModelCommand,
    VoteTrainSetCommand,
)
from p2pfl_tpu_torch.comm.envelope import Envelope
from p2pfl_tpu_torch.config import Settings
from p2pfl_tpu_torch.population.cohort import wire_cohort_filter
from p2pfl_tpu_torch.stages.stage import Stage, check_early_stop
from p2pfl_tpu_torch.telemetry import TRACER, tracing
from p2pfl_tpu_torch.telemetry.ledger import LEDGERS, canonical_params_hash

if TYPE_CHECKING:  # pragma: no cover
    from p2pfl_tpu_torch.node import Node

log = logging.getLogger("p2pfl_tpu_torch")


def establish_initial_model(node: "Node") -> bool:
    """Shared session bootstrap for BOTH schedulers (sync rounds and async
    windows): wait until this node holds an initialized model, let heartbeat
    membership converge, snapshot the round-0 delta anchor, and diffuse the
    initial weights to uninitialized direct neighbors. Returns False when
    learning was stopped mid-bootstrap.

    The initiator set the event in ``set_start_learning``; everyone else
    adopts the initiator's weights via InitModelCommand (which announces for
    us). Mirrors the reference's model_initialized_lock wait
    (start_learning_stage.py:44-113) — a shared round-0 starting model is
    required for SCAFFOLD and for meaningful FedAvg round counts.
    """
    state = node.state
    deadline = time.time() + Settings.VOTE_TIMEOUT
    while not state.model_initialized_event.wait(timeout=0.5):
        if check_early_stop(node):
            return False
        if time.time() >= deadline:
            log.warning(
                "%s: init-model wait timed out — proceeding with local weights",
                node.addr,
            )
            state.model_initialized_event.set()
            node.protocol.broadcast(
                node.protocol.build_msg(ModelInitializedCommand.get_name())
            )
            break
    # Let heartbeats propagate membership before voting
    # (reference start_learning_stage.py:78-84).
    time.sleep(Settings.WAIT_HEARTBEATS_CONVERGENCE)

    # Privacy plane: exchange session public keys BEFORE the first committee
    # is elected — a masked round needs a pair secret with every committee
    # member, and a missing key at encode time degrades that sender to a
    # plaintext (unmaskable) contribution. Bounded wait; the PrivacyKey
    # handler answers first-seen keys directly, so one broadcast converges.
    if Settings.PRIVACY_SECAGG:
        from p2pfl_tpu_torch.comm.commands.impl import PrivacyKeyCommand

        node.protocol.broadcast(
            node.protocol.build_msg(
                PrivacyKeyCommand.get_name(),
                args=[state.privacy.key_payload()],
            )
        )
        key_deadline = time.time() + Settings.PRIVACY_KEY_WAIT_S
        while True:
            missing = state.privacy.missing_keys(
                node.protocol.get_neighbors(only_direct=False)
            )
            if not missing or time.time() >= key_deadline:
                break
            if check_early_stop(node):
                return False
            time.sleep(0.2)
        if missing:
            log.warning(
                "%s: privacy keys still missing from %s after %.1fs — "
                "masked rounds with them fall back to plaintext",
                node.addr, missing, Settings.PRIVACY_KEY_WAIT_S,
            )

    # Diffuse initial weights to direct neighbors that haven't announced
    # an initialized model yet (reference :86-113).
    def candidates() -> List[str]:
        return [
            n
            for n in node.protocol.get_neighbors(only_direct=True)
            if n not in state.nei_status
        ]

    # The model doesn't change during this stage — serialize once, not
    # per candidate per gossip tick.
    model = node.learner.get_model()
    # Round-0 anchor for the sparse delta wire path: every node holds the
    # initiator's weights at this point (own for the initiator, adopted
    # via InitModelCommand otherwise), so deltas anchored here reconstruct
    # on every peer. Init frames themselves always ship dense — their
    # receivers have no anchor yet by definition.
    #
    # Train<->diffuse overlap keeps ONE retired anchor around (sync default
    # is a single live anchor): a background drain still serving round r
    # after the boundary encodes sparse against the retired r anchor instead
    # of degrading to dense frames. The async scheduler raises the depth
    # further (AsyncStartStage) — never lower it here.
    if Settings.OVERLAP_TRAIN_DIFFUSE:
        state.wire.anchor_history = max(state.wire.anchor_history, 2)
    state.wire.set_anchor(model.get_parameters(), state.round or 0)
    payload = model.encode_parameters()
    env = node.protocol.build_weights(
        InitModelCommand.get_name(),
        state.round or 0,
        payload,
        model.contributors or [node.addr],
        model.get_num_samples(),
    )

    with TRACER.span("diffuse:init_model", node=node.addr, round=state.round):
        node.protocol.gossip_weights(
            early_stopping_fn=lambda: check_early_stop(node),
            get_candidates_fn=candidates,
            status_fn=lambda: sorted(candidates()),
            model_fn=lambda nei: env,
        )
    return not check_early_stop(node)


def spawn_diffusion_drain(node: "Node", name: str, body: Callable[[], None]) -> None:
    """Run a model-diffusion gossip loop on a background DRAIN thread
    (train<->diffuse overlap, ROADMAP item 3): the stage machine proceeds to
    the aggregation wait — and the next round's local training — while the
    paced gossip loop keeps serving laggards. The caller's span context is
    re-attached inside the thread so ``diffuse:*`` spans stay parented into
    the experiment trace (the critical-path overlap report measures these
    spans against ``fit`` spans). Drains terminate on their own (empty
    candidates / gossip stall exit / early stop / the aggregator moving two
    rounds on); ``NodeState.join_drains`` only bounds teardown."""
    wire_ctx = tracing.current_wire()

    def run() -> None:
        try:
            with tracing.attach_wire(wire_ctx):
                body()
        except Exception:  # noqa: BLE001 — a drain bug must not kill the node
            log.exception("(%s) diffusion drain %s failed", node.addr, name)

    t = threading.Thread(
        target=run, name=f"drain-{name}-{node.addr}", daemon=True
    )
    node.state.add_drain(t)
    t.start()


class StartLearningStage(Stage):
    """Set up the experiment, announce/diffuse the initial model
    (reference stages/base_node/start_learning_stage.py:35-113)."""

    name = "StartLearningStage"

    @staticmethod
    def execute(node: "Node") -> Optional[Type[Stage]]:
        if not establish_initial_model(node):
            return None
        return VoteTrainSetStage


class VoteTrainSetStage(Stage):
    """Committee election by random weighted voting
    (reference stages/base_node/vote_train_set_stage.py:34-184)."""

    name = "VoteTrainSetStage"

    @staticmethod
    def execute(node: "Node") -> Optional[Type[Stage]]:
        from p2pfl_tpu_torch.stages.recovery import (
            apply_pending_reconcile,
            park_until_quorum,
        )

        state = node.state
        # Quorum-aware degraded mode: below the live-peer quorum, park here
        # (no vote progress, state journaled, heartbeats + heal probes keep
        # running) instead of burning a vote timeout per unwinnable round.
        if not park_until_quorum(node):
            return None
        # Partition-heal catch-up lands at the round boundary: adopt the
        # ahead side's generation, fast-forward, and sit the jump round out
        # as a non-trainer (its committee was elected before we returned).
        if apply_pending_reconcile(node):
            return WaitAggregatedModelsStage
        if check_early_stop(node):
            return None

        # --- cast votes (reference :80-106) ---------------------------------
        # One span covers cast -> all ballots in: its duration IS the vote
        # RTT, and peers' recv:vote_train_set spans share its trace id.
        with TRACER.span("vote_rtt", node=node.addr, round=state.round):
            candidates = list(node.protocol.get_neighbors(only_direct=False)) + [node.addr]
            # Population-scale cohort sampling (population/cohort.py): when a
            # cohort plan is active, only the round's hash-sampled cohort is
            # electable — every node derives the SAME cohort from (seed,
            # round, names), so ballots agree on the candidate pool and, with
            # TRAIN_SET_SIZE == K, the election is deterministic. No-op
            # (identity) when sampling is off; an empty intersection (stale
            # neighbor view during churn) falls back to the unfiltered pool
            # rather than stalling the vote.
            cohort = wire_cohort_filter(state.round or 0, candidates)
            if cohort:
                candidates = cohort
            num_votes = min(Settings.TRAIN_SET_SIZE, len(candidates))
            chosen = random.sample(candidates, num_votes)
            weights = [int((random.randint(0, 1000) / (i + 1))) for i in range(num_votes)]
            my_votes = dict(zip(chosen, weights))
            with state.train_set_votes_lock:
                state.train_set_votes[node.addr] = my_votes
            flat: List[str] = []
            for cand, w in my_votes.items():
                flat.extend([cand, str(w)])
            node.protocol.broadcast(
                node.protocol.build_msg(
                    VoteTrainSetCommand.get_name(), args=flat, round=state.round or 0
                )
            )

            # Train<->diffuse overlap, compute half: when TRAIN_SET_SIZE
            # covers every live candidate the election is DETERMINISTIC —
            # every node is in the committee whatever the ballots say — so
            # the round's local-training segment dispatches NOW, overlapped
            # with the vote RTT and the previous round's still-draining
            # diffusion (CUDA launches return at once anyway; here
            # the whole fit rides a thread). TrainStage joins it before the
            # aggregator sees anything: "synchronize before aggregation".
            if (
                Settings.OVERLAP_TRAIN_DIFFUSE
                and num_votes == len(candidates)
                # Under cohort sampling the deterministic election covers
                # only cohort members — a non-member must not prefit (its
                # learner is not scheduled for this round).
                and node.addr in candidates
                and state.prefit is None
            ):
                TrainStage._dispatch_prefit(node, state.round or 0)

            # --- aggregate votes (reference :108-168) -----------------------
            # The expected-voter set is recomputed from LIVE membership every
            # pass, and the death callback (Node._on_peer_death) sets
            # votes_ready_event — so a voter dying mid-election shrinks the
            # expectation and wakes this wait immediately instead of the
            # stage burning the remainder of VOTE_TIMEOUT.
            deadline = time.time() + Settings.VOTE_TIMEOUT
            while True:
                if check_early_stop(node):
                    return None
                expected = set(node.protocol.get_neighbors(only_direct=False)) | {node.addr}
                with state.train_set_votes_lock:
                    have = set(state.train_set_votes)
                if expected <= have:
                    break
                if time.time() >= deadline:
                    log.info("%s: vote timeout — missing %s", node.addr, expected - have)
                    break
                if state.reconcile_ahead():
                    # A healed peer's catch-up targets a later round: this
                    # round belongs to a dead branch — wind it down now.
                    log.info(
                        "%s: reconcile catch-up pending — abandoning the "
                        "round-%s vote wait", node.addr, state.round,
                    )
                    break
                # Short slices: the deadline overshoot is bounded by one
                # slice, so the stage ends within ~VOTE_TIMEOUT even when the
                # last ballots never arrive.
                state.votes_ready_event.wait(timeout=0.5)
                state.votes_ready_event.clear()

        with state.train_set_votes_lock:
            all_votes = {n: dict(v) for n, v in state.train_set_votes.items()}
            state.train_set_votes = {}

        tally: dict[str, int] = {}
        for votes in all_votes.values():
            for cand, w in votes.items():
                tally[cand] = tally.get(cand, 0) + int(w)
        # top-K by weight, alphabetical tie-break (reference :150-160)
        ranked = sorted(tally.items(), key=lambda kv: (-kv[1], kv[0]))
        train_set = [cand for cand, _ in ranked[: Settings.TRAIN_SET_SIZE]]
        # validate against live membership (reference :170-181)
        live = set(node.protocol.get_neighbors(only_direct=False)) | {node.addr}
        state.train_set = [n for n in train_set if n in live]
        log.info("%s: round %s trainset %s", node.addr, state.round, state.train_set)
        # Trajectory ledger: the round opens with its elected committee —
        # the first event parity_diff aligns a round on.
        LEDGERS.emit(
            node.addr, "round_open", round=state.round or 0,
            members=sorted(state.train_set),
        )

        if check_early_stop(node):
            return None
        return TrainStage if node.addr in state.train_set else WaitAggregatedModelsStage


class TrainStage(Stage):
    """Local training + partial-aggregation gossip
    (reference stages/base_node/train_stage.py:35-187)."""

    name = "TrainStage"

    @staticmethod
    def _train_segment(node: "Node") -> None:
        """Evaluate + share metrics + fit (reference :102-116): the round's
        local-training segment. Runs on the stage thread in the serialized
        path, or pre-dispatched on a thread during the vote RTT when the
        election is deterministic (train<->diffuse overlap)."""
        state = node.state
        TrainStage._evaluate_and_broadcast(node)
        if check_early_stop(node):
            return

        # Continuous profiling: with PERF_TRACE_DIR set, the first fit this
        # process runs is captured as a windowed torch.profiler trace (capture-
        # once + never-raising, so the hook is safe to leave enabled).
        from p2pfl_tpu_torch.management.profiler import device_trace_window

        with TRACER.span("fit", node=node.addr, round=state.round):
            with device_trace_window(Settings.PERF_TRACE_DIR, label="fit"):
                node.learner.fit()

    @staticmethod
    def _dispatch_prefit(node: "Node", r: int) -> None:
        """Dispatch the round-``r`` training segment on a background thread
        (called from VoteTrainSetStage under a deterministic election).
        The caller's span context is re-attached so the ``fit`` span stays
        inside the experiment trace."""
        wire_ctx = tracing.current_wire()

        def run() -> None:
            try:
                with tracing.attach_wire(wire_ctx):
                    TrainStage._train_segment(node)
            except Exception:  # noqa: BLE001 — surfaces as a missed round, not a crash
                log.exception("(%s) pre-dispatched fit failed", node.addr)

        t = threading.Thread(target=run, name=f"prefit-{node.addr}", daemon=True)
        node.state.prefit = (r, t)
        t.start()

    @staticmethod
    def execute(node: "Node") -> Optional[Type[Stage]]:
        state = node.state
        node.aggregator.set_nodes_to_aggregate(state.train_set, round=state.round or 0)

        prefit = state.take_prefit(state.round or 0)
        if prefit is not None:
            # The training segment was dispatched during the vote RTT —
            # SYNCHRONIZE here, before anything touches the aggregator.
            prefit.join()
        else:
            TrainStage._train_segment(node)
        if check_early_stop(node):
            return None

        # Snapshot COPY, not the live learner handle: a racing full-model
        # adoption (FullModelCommand.apply_frame) mutates the learner's
        # model in place — contributors included — and would corrupt the
        # aggregator's stored entry mid-round (observed under chaos as
        # contributor lists raced to empty).
        live = node.learner.get_model()
        own = live.build_copy(
            params=live.get_parameters(),
            contributors=live.contributors or [node.addr],
            num_samples=live.get_num_samples(),
        )
        # Privacy plane: on masked rounds the aggregator's table holds
        # LATTICE frames, so our own contribution enters masked too (the
        # plaintext `own` copy stays local — it is the fallback when the
        # masked aggregate cannot be finalized). The committee is captured
        # HERE, pre-death-shrink: finalize must reason about the set the
        # masks were generated against, not the set that survived. So is
        # the round anchor: a peer that finished first may ship its dense
        # full model while this node still waits, and adopting it advances
        # the codec's anchor to the next round before finalize runs.
        committee = sorted(set(state.train_set))
        contribution = own
        mask_anchor = None
        if Settings.PRIVACY_SECAGG:
            mask_anchor = state.wire.anchor_model()
            contribution = TrainStage._mask_contribution(
                node, own, state.round or 0, committee, mask_anchor
            )
        agg_list = node.aggregator.add_model(contribution)
        node.protocol.broadcast(
            node.protocol.build_msg(
                ModelsAggregatedCommand.get_name(), args=agg_list, round=state.round or 0
            )
        )

        if Settings.OVERLAP_TRAIN_DIFFUSE:
            # Train<->diffuse overlap: the partial-model diffusion drains on
            # a background thread while this thread proceeds straight to the
            # aggregation wait — and, next round, to the next fit. The drain
            # keeps serving laggards across the round boundary out of the
            # aggregator's retired snapshot (RoundFinishedStage) against the
            # codec's retired anchor.
            r = state.round or 0
            train_set = list(state.train_set)
            spawn_diffusion_drain(
                node,
                f"partial-r{r}",
                lambda: TrainStage._gossip_partial_models(node, r, train_set),
            )
        else:
            TrainStage._gossip_partial_models(
                node, state.round or 0, list(state.train_set)
            )
        if check_early_stop(node):
            return None

        # Adopt the aggregated model (reference :90-96). The span exposes
        # aggregation stalls (the wait dominates when peers lag).
        try:
            with TRACER.span("aggregation_wait", node=node.addr, round=state.round):
                aggregated = node.aggregator.wait_and_get_aggregation(
                    Settings.AGGREGATION_TIMEOUT
                )
        except RuntimeError:
            log.warning("%s: aggregation produced nothing this round", node.addr)
            aggregated = own
        # Masked round: the merged handle is still in the lattice domain —
        # unmask it (repairing dead maskers' shares from the revealed pair
        # secrets) into model-shaped parameters. A round that cannot be
        # finalized (unrepaired pair, range-check trip) falls back to the
        # plaintext own model: the federation loses one round of averaging,
        # never its correctness.
        aggregated = TrainStage._finalize_masked(node, aggregated, own, committee, mask_anchor)
        node.learner.get_model().set_parameters(aggregated.params)
        node.learner.get_model().set_contribution(
            aggregated.contributors, aggregated.get_num_samples()
        )
        node.learner.get_model().additional_info.update(aggregated.additional_info)
        # Mark the round's full model as held: a later full_model frame for
        # this round is a redundant delivery and must NOT overwrite our own
        # aggregate (first wins — FullModelCommand honors this; it also
        # closes the window where a Byzantine peer's corrupted full model
        # could clobber an honest aggregate post-aggregation).
        state.note_full_model_round(state.round or 0)
        if LEDGERS.enabled():
            # Content hash of the committed round aggregate: the value the
            # parity gate compares bit-for-bit against the fused mesh.
            # dedup: ONE commit per round, first wins — mirrors the
            # note_full_model_round adoption contract (a racing full_model
            # frame that beat us to adoption already committed this round).
            LEDGERS.get(node.addr).emit(
                "aggregate_committed",
                round=state.round or 0,
                dedup_key=("commit", state.round or 0),
                hash=canonical_params_hash(aggregated.get_parameters()),
                contributors=sorted(aggregated.contributors),
                num_samples=aggregated.get_num_samples(),
                origin="train",
            )
        state.aggregated_model_event.set()
        node.protocol.broadcast(
            node.protocol.build_msg(ModelsReadyCommand.get_name(), round=state.round or 0)
        )
        return GossipModelStage

    @staticmethod
    def _mask_contribution(node: "Node", own, r: int, committee: List[str], anchor=None):
        """Masked lattice handle of ``own`` for round ``r`` against
        ``anchor`` (``(leaves, round)``, the codec's round anchor taken at
        masking time) — or ``own`` itself (plaintext, warned) when masking
        is impossible: no round anchor, a committee member's pubkey missing,
        or a committee too large for the ring. A plaintext contribution in a
        masked round is dropped by peers' masked merges, so this node just
        reads as a missing contributor there — degraded, never corrupting."""
        state = node.state
        if anchor is None or anchor[1] != r:
            log.warning(
                "%s: no round-%s anchor — contributing plaintext to the "
                "masked round", node.addr, r,
            )
            return own
        try:
            return state.privacy.mask_own(own, anchor[0], r, committee)
        except ValueError as exc:
            log.warning(
                "%s: cannot mask round %s (%s) — contributing plaintext",
                node.addr, r, exc,
            )
            return own

    @staticmethod
    def _finalize_masked(node: "Node", aggregated, own, committee: List[str], anchor=None):
        """Unmask a lattice-domain aggregate into a model-shaped handle
        (identity for plaintext aggregates) onto ``anchor``, the round
        anchor the masks were computed against (taken at masking time: the
        live codec anchor may have moved on under a racing full-model
        adoption)."""
        from p2pfl_tpu_torch.privacy.secagg import masked_info

        if masked_info(aggregated) is None:
            return aggregated
        state = node.state
        if anchor is None:
            log.warning(
                "%s: masked aggregate with no anchor — falling back to the "
                "local model", node.addr,
            )
            return own
        # anchor[1] is the anchor's round: finalize refuses (counted as a
        # structure outcome) when it disagrees with the aggregate's declared
        # round — mask_own checks this at encode time, and a stale or
        # advanced anchor at finalize would scatter the committee mean onto
        # the wrong base silently.
        params, outcome = state.privacy.finalize(
            aggregated, committee, anchor[0], anchor_round=anchor[1]
        )
        if params is None:
            log.warning(
                "%s: masked round %s not finalizable (%s) — falling back to "
                "the local model", node.addr, state.round, outcome,
            )
            return own
        return own.build_copy(
            params=params,
            contributors=sorted(aggregated.contributors),
            num_samples=aggregated.get_num_samples(),
        )

    @staticmethod
    def _evaluate_and_broadcast(node: "Node") -> None:
        metrics = node.learner.evaluate()
        if metrics:
            flat: List[str] = []
            for k, v in metrics.items():
                flat.extend([k, str(v)])
                node.log_metric(k, v)
            node.protocol.broadcast(
                node.protocol.build_msg(
                    MetricsCommand.get_name(), args=flat, round=node.state.round or 0
                )
            )

    #: Drain re-delivery cadence: a byte-identical re-send to a peer whose
    #: coverage has not changed is suppressed for this many gossip ticks
    #: (lost-frame repair still happens, just not every 100 ms). Serialized
    #: (non-overlap) gossip keeps the reference's every-tick behavior.
    REDELIVER_TICKS = 4

    @staticmethod
    def _gossip_partial_models(node: "Node", r: int, train_set: List[str]) -> None:
        """Partial-aggregation gossip to trainset peers
        (reference train_stage.py:118-168). ``r``/``train_set`` are captured
        by value: under overlap this body runs on a drain thread that may
        outlive the round boundary, and must keep describing round ``r``
        while ``state.round`` moves on."""
        state = node.state
        members = set(train_set)
        drain = Settings.OVERLAP_TRAIN_DIFFUSE
        # (peer -> (suppressed ticks, last content key)): the drain avoids
        # re-shipping an IDENTICAL partial to a peer whose coverage hasn't
        # moved — off the critical path, re-sends every tick only burn the
        # bytes the quantized codec just saved.
        sent_state: dict = {}

        def early_stop() -> bool:
            # Keep gossiping until every trainset peer reports full coverage —
            # exiting on own completion would starve peers a round behind
            # (reference train_stage.py:118-168 loops on peer progress). A
            # drain additionally stops once the aggregator no longer holds
            # round r (two boundaries passed: nothing left to serve).
            return check_early_stop(node) or not node.aggregator.serves_round(r)

        def candidates() -> List[str]:
            # trainset peers that haven't reported merging everyone
            cov = state.coverage(r)
            return [
                n
                for n in train_set
                if n != node.addr and set(cov.get(n, [])) < members
            ]

        def status() -> list:
            cov = state.coverage(r)
            return sorted((n, tuple(sorted(cov.get(n, [])))) for n in train_set)

        def model_fn(nei: str) -> Optional[Envelope]:
            cov_nei = state.coverage(r).get(nei, [])
            partial = node.aggregator.get_partial_model_for_round(
                r, except_nodes=cov_nei
            )
            if partial is None:
                return None
            if drain:
                key = (tuple(sorted(cov_nei)), tuple(sorted(partial.contributors)))
                skipped, prev = sent_state.get(nei, (0, None))
                if prev == key and skipped < TrainStage.REDELIVER_TICKS:
                    sent_state[nei] = (skipped + 1, prev)
                    return None
                sent_state[nei] = (0, key)
            # Masked lattice partials (privacy plane) have their own wire
            # codec: lattice planes only, zero index bytes (the support is
            # derived from public round state on both ends).
            from p2pfl_tpu_torch.privacy.secagg import PrivacyPlane, masked_info

            if masked_info(partial) is not None:
                return node.protocol.build_weights(
                    PartialModelCommand.get_name(),
                    r,
                    PrivacyPlane.encode_frame(partial, tracing.current_wire()),
                    partial.contributors,
                    partial.get_num_samples(),
                    codec="masked",
                )
            # Sparse delta wire path (WIRE_COMPRESSION="topk"): trainset
            # peers share this round's anchor, so partials ship as
            # error-feedback top-k deltas (int8/int4-quantized values and a
            # coalesced multi-tensor body when enabled); encode_tagged
            # returns None on the dense-only schemes or when no anchor —
            # live or retired — exists for round r.
            tagged = state.wire.encode_tagged(partial, r)
            if tagged is None:
                payload, codec = partial.encode_parameters(), "dense"
            else:
                payload, codec = tagged
            return node.protocol.build_weights(
                PartialModelCommand.get_name(),
                r,
                payload,
                partial.contributors,
                partial.get_num_samples(),
                codec=codec,
            )

        with TRACER.span("diffuse:partial_model", node=node.addr, round=r):
            node.protocol.gossip_weights(
                early_stopping_fn=early_stop,
                get_candidates_fn=candidates,
                status_fn=status,
                model_fn=model_fn,
            )


class WaitAggregatedModelsStage(Stage):
    """Non-trainers wait for a full model
    (reference stages/base_node/wait_agg_models_stage.py:31-67)."""

    name = "WaitAggregatedModelsStage"

    @staticmethod
    def execute(node: "Node") -> Optional[Type[Stage]]:
        state = node.state
        r = state.round if state.round is not None else 0
        # Defensive: a pre-dispatched fit must never race a full-model
        # adoption (it only exists when the election was deterministic, in
        # which case this stage is unreachable — but a mid-vote membership
        # change could in principle route here). Abort and join it.
        stray = state.take_prefit(r)
        if stray is not None:
            node.learner.interrupt_fit()
            stray.join(timeout=30.0)
        if state.last_full_model_round >= r:
            # The full model already arrived before this stage started
            # (clear-then-wait race) — nothing to wait for.
            got_it = True
        else:
            state.aggregated_model_event.clear()
            if state.last_full_model_round >= r:  # re-check after clear
                got_it = True
            else:
                # Sliced wait that re-evaluates liveness: if every trainset
                # member has been declared dead there is no one left to
                # produce a full model — give up immediately instead of
                # burning the whole AGGREGATION_TIMEOUT (the death callbacks
                # already shrank state.train_set).
                with TRACER.span("full_model_wait", node=node.addr, round=r):
                    deadline = time.time() + Settings.AGGREGATION_TIMEOUT
                    got_it = False
                    while time.time() < deadline:
                        if state.aggregated_model_event.wait(timeout=0.5):
                            got_it = True
                            break
                        if check_early_stop(node):
                            return None
                        if state.reconcile_ahead():
                            # A fresher generation is staged for adoption at
                            # the next round boundary — stop waiting for this
                            # dead branch's full model.
                            break
                        live = set(
                            node.protocol.get_neighbors(only_direct=False)
                        ) | {node.addr}
                        if state.train_set and not (set(state.train_set) & live):
                            log.warning(
                                "%s: every trainset member died — abandoning "
                                "full-model wait for round %s",
                                node.addr, r,
                            )
                            break
        if not got_it:
            log.warning("%s: no aggregated model arrived within timeout", node.addr)
        if check_early_stop(node):
            return None
        node.protocol.broadcast(
            node.protocol.build_msg(ModelsReadyCommand.get_name(), round=state.round or 0)
        )
        return GossipModelStage


class GossipModelStage(Stage):
    """Diffuse the full aggregated model to lagging neighbors
    (reference stages/base_node/gossip_model_stage.py:32-87)."""

    name = "GossipModelStage"

    @staticmethod
    def execute(node: "Node") -> Optional[Type[Stage]]:
        state = node.state
        r = state.round or 0
        if Settings.OVERLAP_TRAIN_DIFFUSE:
            # Overlap: the drain may outlive this stage AND the round — the
            # live learner handle mutates at the next adoption, so freeze a
            # copy of the round-r full model for the drain to serve.
            live = node.learner.get_model()
            model = live.build_copy(
                params=live.get_parameters(),
                contributors=live.contributors or [node.addr],
                num_samples=live.get_num_samples(),
            )
            spawn_diffusion_drain(
                node,
                f"full-r{r}",
                lambda: GossipModelStage._gossip_full_model(node, model, r),
            )
        else:
            GossipModelStage._gossip_full_model(node, node.learner.get_model(), r)
        if check_early_stop(node):
            return None
        return RoundFinishedStage

    @staticmethod
    def _gossip_full_model(node: "Node", model, r: int) -> None:
        state = node.state
        drain = Settings.OVERLAP_TRAIN_DIFFUSE
        sent_state: dict = {}  # peer -> suppressed ticks (content is constant)

        def candidates() -> List[str]:
            return [
                n
                for n in node.protocol.get_neighbors(only_direct=True)
                if state.nei_status.get(n, -1) < r
            ]

        def early_stop() -> bool:
            # Drains bound their own life: two boundaries past r, every
            # laggard will be served by the round-r+1 diffusion instead.
            cur = state.round
            return check_early_stop(node) or (cur is not None and cur > r + 1)

        # Serialize the (stage-constant) dense full model once for all
        # ticks/peers; the sparse delta variant is chosen per neighbor.
        dense_env: List[Optional[Envelope]] = [None]  # lazy: sparse runs may never need it

        def _dense() -> Envelope:
            if dense_env[0] is None:
                dense_env[0] = node.protocol.build_weights(
                    FullModelCommand.get_name(),
                    r,
                    model.encode_parameters(),
                    model.contributors or [node.addr],
                    model.get_num_samples(),
                )
            return dense_env[0]

        def model_fn(nei: str) -> Optional[Envelope]:
            if drain:
                # The full model for round r never changes: suppress
                # re-sends to an unresponsive peer to the re-delivery
                # cadence (its models_ready ack is what ends the loop).
                skipped = sent_state.get(nei, TrainStage.REDELIVER_TICKS)
                if skipped < TrainStage.REDELIVER_TICKS:
                    sent_state[nei] = skipped + 1
                    return None
                sent_state[nei] = 0
            # Sparse delta only for peers known to be in THIS round (they
            # reported finishing r-1, or announced an initialized model for
            # round 0) — a lagging peer holds an older anchor and must get
            # the dense frame it can always adopt.
            status = state.nei_status.get(nei)
            if status == r - 1 or (r == 0 and status == -1):
                tagged = state.wire.encode_tagged(model, r)
                if tagged is not None:
                    payload, codec = tagged
                    return node.protocol.build_weights(
                        FullModelCommand.get_name(),
                        r,
                        payload,
                        model.contributors or [node.addr],
                        model.get_num_samples(),
                        codec=codec,
                    )
            return _dense()

        with TRACER.span("diffuse:full_model", node=node.addr, round=r):
            node.protocol.gossip_weights(
                early_stopping_fn=early_stop,
                get_candidates_fn=candidates,
                status_fn=lambda: sorted(candidates()),
                model_fn=model_fn,
            )


class RoundFinishedStage(Stage):
    """Close the round; loop or finish
    (reference stages/base_node/round_finished_stage.py:33-91)."""

    name = "RoundFinishedStage"

    @staticmethod
    def execute(node: "Node") -> Optional[Type[Stage]]:
        state = node.state
        if check_early_stop(node):
            return None
        # Surface the finished round's model-plane wire traffic (bytes-per-
        # round is the sparse wire path's primary metric; counted at the
        # gossip send point, comm/gossiper.py).
        finished = state.round or 0
        node.log_metric(
            "wire_tx_bytes", float(node.protocol.gossiper.bytes_for_round(finished))
        )
        LEDGERS.emit(node.addr, "round_close", round=finished)
        if Settings.OVERLAP_TRAIN_DIFFUSE:
            # Keep the finished round's model table as an immutable retired
            # snapshot: the background partial-model drain keeps serving
            # laggards from it while the next round opens on a clean table.
            node.aggregator.retire_round()
        else:
            node.aggregator.clear()
        state.increase_round()
        # New round, new delta anchor: every node enters round r holding the
        # round-(r-1) aggregate, which is what senders will delta against.
        state.wire.set_anchor(
            node.learner.get_model().get_parameters(), state.round or 0
        )
        node.log_round_finished()

        r, total = state.round, state.total_rounds
        if r is not None and total is not None and r < total:
            return VoteTrainSetStage

        # Final evaluation + wrap-up (reference :60-91). Outstanding overlap
        # drains get a bounded window to finish serving laggards BEFORE the
        # experiment state is torn down (finish_learning flips the early-stop
        # predicate, which would cut a laggard's last full-model delivery).
        state.join_drains(Settings.OVERLAP_DRAIN_JOIN_S)
        TrainStage._evaluate_and_broadcast(node)
        node.finish_learning()
        return None
