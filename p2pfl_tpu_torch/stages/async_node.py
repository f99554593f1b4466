"""The elastic async scheduler: windows instead of rounds, no vote barrier.

Second scheduler over the same pluggable stage machine (the ROADMAP refactor
note: sync and async are two schedulers over one stage set). Where the sync
scheduler runs StartLearning → [Vote → (Train | WaitAgg) → GossipModel →
RoundFinished] with a vote barrier and an aggregation deadline per round, the
async scheduler (Papaya, arxiv 2111.04877; FedBuff buffering) runs

    AsyncStart → [AsyncWindow → AsyncWindowFinished] * windows

per node, with NO cross-node barrier anywhere:

* every node trains at its own pace and broadcasts each contribution tagged
  with the window it trained against;
* inbound contributions fold into the node's
  :class:`~p2pfl_tpu_torch.learning.aggregators.async_buffer.AsyncBufferedAggregator`
  as they arrive, staleness-weighted — a straggler contributes LATE (at a
  discount) instead of gating the fleet;
* a window closes on a fill target (``ASYNC_BUFFER_K`` distinct
  contributors, shrunk live by peer deaths) or ``ASYNC_WINDOW_TIMEOUT``;
* membership is elastic: nodes join mid-experiment (``async_join`` →
  welcome + dense full-model catch-up + anchor resync), leave or crash
  without stalling any window (death callbacks re-evaluate the fill target);
* participation is observatory-driven (closes the observatory's detect→act loop):
  peers whose fleet suspect score crosses ``ASYNC_SUSPECT_GATE`` are not
  solicited and their contributions are dropped; peers whose straggler score
  crosses ``ASYNC_STRAGGLER_GATE`` are deprioritized — still folded on
  arrival, but the fill target never waits on them.

Telemetry: each window runs inside the ``AsyncWindowStage`` stage span
(tagged with the window as ``round``), with ``fit`` / ``diffuse:async_model``
/ ``async_window_wait`` child spans — the critical-path analyzer
attributes gating nodes per window exactly as it does per round. The
``p2pfl_async_*`` registry section carries window durations, contribution
freshness, staleness and drops.

The port's copy of ``p2pfl_tpu/stages/async_node.py``.
"""

from __future__ import annotations

import logging
import time
from typing import TYPE_CHECKING, List, Optional, Tuple, Type

from p2pfl_tpu_torch.comm.commands.impl import AsyncContributionCommand, AsyncDoneCommand
from p2pfl_tpu_torch.config import Settings
from p2pfl_tpu_torch.population.cohort import wire_cohort_filter
from p2pfl_tpu_torch.stages.base_node import TrainStage, establish_initial_model
from p2pfl_tpu_torch.stages.stage import Stage, check_early_stop
from p2pfl_tpu_torch.telemetry import REGISTRY, TRACER
from p2pfl_tpu_torch.telemetry.ledger import LEDGERS, canonical_params_hash

if TYPE_CHECKING:  # pragma: no cover
    from p2pfl_tpu_torch.node import Node

log = logging.getLogger("p2pfl_tpu_torch")

_WINDOW_SECONDS = REGISTRY.histogram(
    "p2pfl_async_window_seconds",
    "Wall-clock per completed async window (train + diffuse + fold wait)",
    labels=("node",),
)


def select_participants(node: "Node") -> Tuple[List[str], List[str]]:
    """Observatory-gated participation for the next window.

    Returns ``(solicit, countable)``: ``solicit`` — peers our contribution
    is sent to and whose contributions we accept (suspects excluded);
    ``countable`` — the subset the window fill target may wait on
    (stragglers excluded; their late contributions still fold on arrival).
    """
    peers = node.protocol.get_neighbors(only_direct=False)
    # Population-scale cohort sampling (population/cohort.py): with a plan
    # active, this window solicits only its hash-sampled cohort — the
    # Papaya fan-in bound, applied at the async scheduler's single
    # solicitation choke point. Self is included in the candidate pool so
    # every node derives the same cohort; an empty intersection (stale
    # membership under churn) falls back to the unfiltered peer set.
    cohort = wire_cohort_filter(node.state.round or 0, list(peers) + [node.addr])
    if cohort:
        in_cohort = set(cohort)
        peers = [p for p in peers if p in in_cohort]
    obs = node.observatory
    done = node.state.async_done_peers
    try:
        scores = obs.scores()
    except Exception:  # noqa: BLE001 — scoring must never break the window
        scores = {}
    s_gate = Settings.ASYNC_SUSPECT_GATE
    g_gate = Settings.ASYNC_STRAGGLER_GATE
    solicit: List[str] = []
    countable: List[str] = []
    for p in peers:
        if p in done:
            # Finished its windows: produces nothing further — don't ship
            # to it, never wait on it.
            continue
        # suspect_score answers for digest-less peers too — an adversary
        # that never reports digests must still be gateable.
        if s_gate > 0 and obs.suspect_score(p) >= s_gate:
            continue
        solicit.append(p)
        if g_gate > 0 and scores.get(p, {}).get("straggler", 0.0) >= g_gate:
            continue
        countable.append(p)
    return solicit, countable


class AsyncStartStage(Stage):
    """Session bootstrap for the async scheduler.

    Round-0 cohort members run the same initial-model establishment as the
    sync scheduler (shared helper). A mid-experiment JOINER — recognizable
    by the welcome having fast-forwarded its window past 0 — instead waits
    for the dense ``async_catchup`` frame (which adopts the model and
    resyncs the delta anchor to the current window)."""

    name = "AsyncStartStage"

    @staticmethod
    def execute(node: "Node") -> Optional[Type[Stage]]:
        state = node.state
        # Lagging peers' sparse frames must stay decodable: windows advance
        # per node, so keep a few anchors instead of sync's single one.
        state.wire.anchor_history = Settings.ASYNC_ANCHOR_HISTORY
        if Settings.PRIVACY_SECAGG:
            # Pairwise masks need a round-scoped committee whose members all
            # fold into ONE sum; async windows fold dynamic, per-node
            # subsets, so mask cancellation has no place to happen. This is
            # Papaya's production split exactly: buffered async aggregation
            # pairs with CLIENT-side DP (clipping + noise at the sender,
            # which this scheduler keeps — the budget ledger and epsilon
            # digest ride every async fit), while committee masking runs on
            # the sync scheduler. Warn once, proceed unmasked.
            log.warning(
                "%s: PRIVACY_SECAGG is sync-only — async windows run the DP "
                "half of the privacy plane (clipping-at-sender + noise + "
                "budget ledger), contributions ride the wire unmasked",
                node.addr,
            )
        if (state.round or 0) > 0:
            # Mid-experiment joiner: wait for the catch-up model.
            deadline = time.time() + Settings.VOTE_TIMEOUT
            while not state.model_initialized_event.wait(timeout=0.5):
                if check_early_stop(node):
                    return None
                if time.time() >= deadline:
                    log.warning(
                        "%s: async catch-up wait timed out — joining with "
                        "local weights", node.addr,
                    )
                    state.model_initialized_event.set()
                    break
            if state.wire.anchor_round < (state.round or 0):
                # Catch-up resyncs the anchor; on the timeout path (or a
                # rejoiner that kept its model) anchor the local weights.
                state.wire.set_anchor(
                    node.learner.get_model().get_parameters(), state.round or 0
                )
            node.protocol.flight_recorder.record(
                "membership", event="join", window=state.round
            )
        else:
            if not establish_initial_model(node):
                return None
        return AsyncWindowStage


class AsyncWindowStage(Stage):
    """One async window: train, broadcast the contribution, fold what
    arrived, adopt the staleness-weighted aggregate. No barrier: the fill
    target shrinks live as peers die, a timeout bounds the worst case, and
    the window completes on the own contribution alone when every trainer
    is gone."""

    name = "AsyncWindowStage"

    @staticmethod
    def execute(node: "Node") -> Optional[Type[Stage]]:
        from p2pfl_tpu_torch.management.profiler import device_trace_window
        from p2pfl_tpu_torch.stages.recovery import (
            apply_pending_reconcile,
            park_until_quorum,
        )

        state = node.state
        agg = node.async_agg
        if agg is None:  # stopped under our feet
            return None
        # Quorum-aware degraded mode: below the live-peer quorum, park
        # between windows (state journaled, heartbeats + heal probes keep
        # running) instead of closing empty windows on the timeout.
        if not park_until_quorum(node):
            return None
        # Partition-heal catch-up: adopt the ahead side's generation and
        # fast-forward the window counter, then run this window from the
        # fresh model — no committee bookkeeping to skip in async mode, and
        # both halves' in-flight contributions keep folding through the
        # staleness-weighted buffer.
        apply_pending_reconcile(node)
        w = state.round or 0
        t0 = time.perf_counter()
        agg.open_window(w)
        solicit, _ = select_participants(node)
        # Trajectory ledger: async windows are the scheduler's rounds — the
        # fill target's peer set is the closest analogue of a committee.
        LEDGERS.emit(
            node.addr, "window_open", round=w,
            members=sorted(solicit + [node.addr]),
        )

        with TRACER.span("fit", node=node.addr, round=w):
            with device_trace_window(Settings.PERF_TRACE_DIR, label="fit"):
                node.learner.fit()
        if check_early_stop(node):
            return None

        # Snapshot COPY (same race rationale as the sync TrainStage): the
        # live handle mutates when a window aggregate or catch-up lands.
        live = node.learner.get_model()
        own = live.build_copy(
            params=live.get_parameters(),
            contributors=[node.addr],
            num_samples=live.get_num_samples(),
        )
        agg.fold(own, w, node.addr)

        # One frame for every solicited peer: sparse delta against this
        # window's anchor when the codec is active (the async wire gets the
        # same int8/int4-quantized, coalesced codec as sync partials — a
        # laggard's window may already be retired into the anchor history,
        # which encode_tagged serves statelessly), dense otherwise.
        tagged = state.wire.encode_tagged(own, w)
        if tagged is None:
            payload, codec = own.encode_parameters(), "dense"
        else:
            payload, codec = tagged
        env = node.protocol.build_weights(
            AsyncContributionCommand.get_name(),
            w,
            payload,
            [node.addr],
            own.get_num_samples(),
            codec=codec,
        )
        with TRACER.span("diffuse:async_model", node=node.addr, round=w):
            node.protocol.broadcast(env, node_list=solicit)

        def fill_target() -> int:
            # Re-evaluated on every wake: live membership minus suspects and
            # stragglers, capped at the buffer size. Peer deaths and joins
            # move it between waits (death callbacks call agg.notify()).
            _, countable = select_participants(node)
            return min(Settings.ASYNC_BUFFER_K, 1 + len(countable))

        with TRACER.span("async_window_wait", node=node.addr, round=w):
            aggregated = agg.wait_window(
                fill_target,
                Settings.ASYNC_WINDOW_TIMEOUT,
                early_stop_fn=lambda: check_early_stop(node),
            )
        if aggregated is None:
            return None
        # Zero-duration marker span carrying the window's close diagnosis —
        # the critical-path analyzer's window report reads these for the
        # close-reason breakdown and the staleness-discount attribution
        # (span args ride the chrome export, so offline merges see them too).
        with TRACER.span(
            "window_close", node=node.addr, round=w,
            reason=agg.last_close_reason, mean_lag=round(agg.last_mean_lag, 4),
            fill=agg.last_fill,
        ):
            pass

        if LEDGERS.enabled():
            LEDGERS.get(node.addr).emit(
                "aggregate_committed",
                round=w,
                dedup_key=("commit", w),
                hash=canonical_params_hash(aggregated.get_parameters()),
                contributors=sorted(aggregated.contributors),
                num_samples=aggregated.get_num_samples(),
                origin="window",
                reason=agg.last_close_reason,
            )
        model = node.learner.get_model()
        model.set_parameters(aggregated.params)
        model.set_contribution(aggregated.contributors, aggregated.get_num_samples())
        model.additional_info.update(aggregated.additional_info)
        # A later full-model frame for this window is redundant (first wins,
        # same contract as the sync TrainStage).
        state.note_full_model_round(w)
        _WINDOW_SECONDS.labels(node.addr).observe(time.perf_counter() - t0)
        return AsyncWindowFinishedStage


class AsyncWindowFinishedStage(Stage):
    """Close the window; loop or finish. The next window's delta anchor is
    this window's adopted aggregate — peers that folded a different subset
    drift by epsilon, which the codec's fingerprint-tolerant anchor matching
    absorbs (comm/delta.py module docstring)."""

    name = "AsyncWindowFinishedStage"

    @staticmethod
    def execute(node: "Node") -> Optional[Type[Stage]]:
        state = node.state
        if check_early_stop(node):
            return None
        finished = state.round or 0
        node.log_metric(
            "wire_tx_bytes", float(node.protocol.gossiper.bytes_for_round(finished))
        )
        if node.async_agg is not None:
            node.log_metric(
                "async_window_staleness", float(node.async_agg.last_mean_lag)
            )
        LEDGERS.emit(node.addr, "window_close", round=finished)
        state.increase_round()
        state.wire.set_anchor(
            node.learner.get_model().get_parameters(), state.round or 0
        )
        node.log_round_finished()

        r, total = state.round, state.total_rounds
        if r is not None and total is not None and r < total:
            return AsyncWindowStage

        # Tell the fleet this node's contribution stream is over, so no
        # peer's fill target ever waits on it again (last-node-standing:
        # without this the stragglers burn a window timeout per window once
        # the fast cohort goes home).
        node.protocol.broadcast(
            node.protocol.build_msg(AsyncDoneCommand.get_name(), round=r or 0)
        )
        TrainStage._evaluate_and_broadcast(node)
        node.finish_learning()
        return None
