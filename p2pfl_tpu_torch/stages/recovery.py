"""Durable recovery stages: crash-restart resume, quorum parking, and the
round-boundary application of partition-heal catch-ups.

Three pieces, shared by BOTH schedulers (sync rounds and async windows):

* :class:`ResumeStage` — the entry stage of a crash-restarted node
  (``Node.resume_learning``): the node re-enters the stage machine
  MID-experiment holding its journaled identity, model, round position and
  delta-codec state, re-announces itself so peers' gossip picks it back up,
  and drops into the scheduler's per-round/per-window stage.
* :func:`park_until_quorum` — quorum-aware degraded mode (gate at the top of
  every round/window): below ``Settings.RECOVERY_QUORUM_FRACTION`` of the
  session's known membership the node PARKS — no vote/window progress, state
  journaled, heartbeats (and heal probes) keep running — and unparks the
  moment membership recovers, instead of burning a vote timeout per
  unwinnable round.
* :func:`apply_pending_reconcile` — split-brain repair: when a healed
  partition's ahead side has sent its round anchor as a dense catch-up
  (``reconcile_model``), the behind node adopts it ATOMICALLY at the next
  round boundary — params, delta-anchor resync, round fast-forward — then
  abstains from the jump round's vote and waits for its full model like any
  non-trainer. Async windows fold both halves through the staleness-weighted
  buffer instead (bit-exact FedAvg at zero lag), so their apply is just the
  model/window jump with no committee bookkeeping.

The port's copy of ``p2pfl_tpu/stages/recovery.py``.
"""

from __future__ import annotations

import logging
import math
import time
from typing import TYPE_CHECKING, Optional, Type

from p2pfl_tpu_torch.comm.commands.impl import (
    ModelInitializedCommand,
    ModelsReadyCommand,
    VoteTrainSetCommand,
)
from p2pfl_tpu_torch.config import Settings
from p2pfl_tpu_torch.stages.stage import Stage, check_early_stop
from p2pfl_tpu_torch.telemetry import REGISTRY

if TYPE_CHECKING:  # pragma: no cover
    from p2pfl_tpu_torch.node import Node

log = logging.getLogger("p2pfl_tpu_torch")

_PARKS = REGISTRY.counter(
    "p2pfl_recovery_parks_total",
    "Times a node entered quorum-aware degraded mode (parked)",
    labels=("node",),
)
_PARKED = REGISTRY.gauge(
    "p2pfl_recovery_parked",
    "1 while the node is parked below the live-peer quorum, else 0",
    labels=("node",),
)
_PARKED_SECONDS = REGISTRY.counter(
    "p2pfl_recovery_parked_seconds_total",
    "Cumulative wall-clock spent parked below quorum",
    labels=("node",),
)
_RESUMES = REGISTRY.counter(
    "p2pfl_recovery_resumes_total",
    "Crash-restart resumes: nodes re-entering the stage machine from their "
    "write-ahead journal as their previous identity",
    labels=("node",),
)
_RECONCILES = REGISTRY.counter(
    "p2pfl_recovery_reconcile_total",
    "Partition-heal reconciliation steps, by role: ping_tx (heal detected, "
    "progress exchanged), catchup_tx (ahead side shipped its round anchor), "
    "catchup_rx (behind side adopted it and fast-forwarded)",
    labels=("node", "role"),
)


def reconcile_metric(node_addr: str, role: str) -> None:
    """Count one reconcile step (shared with the command handlers)."""
    _RECONCILES.labels(node_addr, role).inc()


def quorum_status(node: "Node") -> tuple:
    """(have, need): live members (self included) vs the quorum bar derived
    from the session's known membership. ``need == 0`` when parking is
    disabled."""
    state = node.state
    frac = Settings.RECOVERY_QUORUM_FRACTION
    try:
        live = set(node.protocol.get_neighbors(only_direct=False))
    except Exception:  # noqa: BLE001 — protocol stopping
        live = set()
    state.session_members |= live | {node.addr}
    if frac <= 0.0:
        return (1 + len(live), 0)
    need = max(1, math.ceil(frac * len(state.session_members)))
    return (1 + len(live), need)


def park_until_quorum(node: "Node") -> bool:
    """Quorum gate at the top of every round/window. Returns False only on
    early stop; True when the node may progress (quorum met, parking
    disabled, or the park cap expired — a federation that never heals must
    still terminate, degraded)."""
    state = node.state
    have, need = quorum_status(node)
    if need == 0 or have >= need:
        return not check_early_stop(node)
    # --- park ---------------------------------------------------------------
    state.parked = True
    _PARKS.labels(node.addr).inc()
    parked_gauge = _PARKED.labels(node.addr)
    parked_gauge.set(1)
    node.protocol.flight_recorder.record(
        "park", round=state.round, have=have, need=need
    )
    log.warning(
        "%s: parking at round %s — %d/%d members live (quorum %.2f of %d "
        "known); journaling state, heartbeats continue",
        node.addr, state.round, have, need,
        Settings.RECOVERY_QUORUM_FRACTION, len(state.session_members),
    )
    node.journal_now()
    t0 = time.monotonic()
    cap = Settings.RECOVERY_PARK_MAX_S
    proceed = True
    try:
        while True:
            if check_early_stop(node):
                proceed = False
                break
            have, need = quorum_status(node)
            if have >= need:
                break
            if cap > 0.0 and time.monotonic() - t0 >= cap:
                log.warning(
                    "%s: park cap %.0fs expired with %d/%d live — proceeding "
                    "degraded", node.addr, cap, have, need,
                )
                break
            time.sleep(Settings.RECOVERY_PARK_POLL_S)
    finally:
        dt = time.monotonic() - t0
        state.parked = False
        parked_gauge.set(0)
        _PARKED_SECONDS.labels(node.addr).inc(dt)
        node.protocol.flight_recorder.record(
            "unpark", round=state.round, parked_s=round(dt, 3),
            have=have, need=need,
        )
        log.warning(
            "%s: unparked after %.1fs (%d/%d live)", node.addr, dt, have, need
        )
    return proceed


def apply_pending_reconcile(node: "Node") -> bool:
    """Adopt a pending partition-heal catch-up at the round boundary.

    Returns True when the node fast-forwarded (sync callers then skip the
    jump round's committee and wait for its full model; async callers just
    run the window from the fresh generation). The adopted payload is the
    ahead side's ROUND ANCHOR — the round-start model every in-phase node
    deltas against — so the resynced codec decodes the jump round's sparse
    frames immediately."""
    state = node.state
    pending = state.take_reconcile()
    if pending is None:
        return False
    target = int(pending["round"])
    model = node.learner.get_model()
    model.set_parameters(pending["params"])
    model.set_contribution(
        list(pending["contributors"]) or [pending["source"]],
        model.get_num_samples(),
    )
    # The adopted model IS the target round's anchor generation; residuals
    # and retired anchors accumulated against our dead branch are dropped.
    state.wire.resync(model.get_parameters(), target)
    if state.experiment is not None:
        state.experiment.round = target
    state.models_aggregated = {}
    state.train_set = []
    with state.train_set_votes_lock:
        state.train_set_votes = {}
    # We hold the target round's starting model == the (target-1) aggregate.
    state.note_full_model_round(target - 1)
    reconcile_metric(node.addr, "catchup_rx")
    node.protocol.flight_recorder.record(
        "reconcile", role="adopted", round=target, peer=pending["source"]
    )
    log.warning(
        "%s: partition-heal catch-up adopted from %s — fast-forwarded to "
        "round %s", node.addr, pending["source"], target,
    )
    try:
        # Announce the new position so the ahead half's gossip treats us as
        # in-phase; in sync mode also ABSTAIN from the jump round's vote so
        # any peer still in its vote window stops waiting on a ballot we
        # will never cast.
        node.protocol.broadcast(
            node.protocol.build_msg(
                ModelsReadyCommand.get_name(), round=target - 1
            )
        )
        if state.fed_mode == "sync":
            node.protocol.broadcast(
                node.protocol.build_msg(
                    VoteTrainSetCommand.get_name(), args=[], round=target
                )
            )
    except Exception:  # noqa: BLE001 — protocol stopping
        pass
    return True


class ResumeStage(Stage):
    """Entry stage of a crash-restarted node (``Node.resume_learning``).

    The node already holds its journaled closure (identity, model, round
    position, delta anchor + EF residuals, peer round-status) — this stage
    re-announces it to the fleet, lets heartbeat membership reconverge, and
    drops into the scheduler mid-experiment: sync at the next committee
    election, async at the next window."""

    name = "ResumeStage"

    @staticmethod
    def execute(node: "Node") -> Optional[Type[Stage]]:
        state = node.state
        state.model_initialized_event.set()
        # Membership reconvergence: Node.resume_learning reconnected to the
        # journaled membership; give heartbeats one convergence window so
        # vote expectations and gossip candidate sets see the live fleet.
        time.sleep(Settings.WAIT_HEARTBEATS_CONVERGENCE)
        if check_early_stop(node):
            return None
        r = state.round or 0
        try:
            node.protocol.broadcast(
                node.protocol.build_msg(ModelInitializedCommand.get_name())
            )
            if r > 0:
                # Advertise our position (we hold the r-1 generation), so
                # peers' full-model gossip counts us as a candidate for r.
                node.protocol.broadcast(
                    node.protocol.build_msg(
                        ModelsReadyCommand.get_name(), round=r - 1
                    )
                )
        except Exception:  # noqa: BLE001 — protocol stopping
            return None
        _RESUMES.labels(node.addr).inc()
        node.protocol.flight_recorder.record("resume", round=r, mode=state.fed_mode)
        log.warning(
            "%s: resumed from journal at %s %s (mode=%s) — re-entering the "
            "stage machine", node.addr,
            "window" if state.fed_mode == "async" else "round", r, state.fed_mode,
        )
        if state.fed_mode == "async":
            from p2pfl_tpu_torch.stages.async_node import AsyncWindowStage

            # Lagging peers' sparse frames must stay decodable mid-run.
            state.wire.anchor_history = Settings.ASYNC_ANCHOR_HISTORY
            return AsyncWindowStage
        from p2pfl_tpu_torch.stages.base_node import (
            VoteTrainSetStage,
            WaitAggregatedModelsStage,
        )

        try:
            live = node.protocol.get_neighbors(only_direct=False)
        except Exception:  # noqa: BLE001 — protocol stopping
            live = []
        if live:
            # Fold into the fleet's CURRENT round instead of re-running the
            # journaled one out of phase: the fleet is mid-round r (its
            # committee was elected while we were down), so sit r out as a
            # non-trainer — our models_ready(r-1) announcement makes us a
            # full-model gossip candidate — and adopt r's aggregate when it
            # lands. The round then closes in step with the fleet and we
            # vote for r+1 IN PHASE. Re-running r's vote instead would leave
            # us permanently offset: our partials would always be one round
            # stale and never land in anyone's aggregate. If the fleet is
            # further ahead, the reconcile catch-up (resume_learning pinged
            # every journaled peer) fast-forwards us at the next boundary.
            return WaitAggregatedModelsStage
        # Nobody else is reachable: progress alone (quorum parking, if
        # configured, gates the next round until the fleet returns).
        return VoteTrainSetStage
