"""fed_doctor — automated root-cause diagnosis over evidence bundles (the port's framework-free copy of
``p2pfl_tpu/telemetry/diagnosis.py``, its imports rerouted to ``p2pfl_tpu_torch``).

The streams a bundle joins (trajectory ledger, flight recorder, metrics
snapshot, observatory snapshot, parity report, trigger context) each
answer a narrow question; incidents live in their INTERSECTION. This
module holds the evidence-joined rule catalog: every rule states the
anomaly it claims, cites the member signals that support it (the
*evidence chain*), runs the checks that could disprove it (the
*exonerating checks*), and reports a confidence that grows with
independent corroboration. ``diagnose`` ranks surviving findings by
(severity, confidence) and the result renders both machine-readable
(``incident.json``, consumed by the fed_top DIAGNOSIS banner) and
human-readable (``scripts/fed_doctor.py``).

Calibration contract (enforced by ``make doctor-check``): a clean run
yields ZERO findings — every rule requires an explicit anomaly signal,
never just "metrics exist" — and on the seeded fault scenarios the
injected fault must rank first.
"""

from __future__ import annotations

import glob
import json
import os
from dataclasses import asdict, dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

from p2pfl_tpu_torch.config import Settings
from p2pfl_tpu_torch.telemetry.metrics import REGISTRY

#: bump when the incident-report shape changes
INCIDENT_SCHEMA_VERSION = 1

_DIAGNOSES = REGISTRY.counter(
    "p2pfl_doctor_diagnoses_total",
    "Diagnosis findings emitted by the fed_doctor rule catalog, by rule",
    labels=("rule",),
)

# --- rule thresholds (module constants — doctor-check calibrates against
# these; a clean 3-node control run must clear every one of them) -------------

#: admission rejections attributed to one sender before byzantine_active fires
BYZANTINE_REJECTION_BURST = 2
#: share of all rejections the top sender must hold (a *concentrated* burst)
BYZANTINE_CONCENTRATION = 0.6
#: observatory straggler score at/above which straggler_gating engages
STRAGGLER_SCORE_MIN = 1.5
#: decode-flavored rejection events before codec_corruption_storm fires
CODEC_STORM_EVENTS = 3
#: flight-recorder "recompile" events before recompile_storm fires
RECOMPILE_STORM_EVENTS = 3
#: rejection reasons that indicate structural corruption, not adversarial
#: content — they route to codec_corruption_storm instead of byzantine_active
CODEC_REASONS = ("decode", "codec", "corrupt", "deserialize", "dtype", "shape")


@dataclass
class Finding:
    """One diagnosed incident cause."""

    rule: str
    severity: str  # "critical" | "warning" | "info"
    confidence: float  # 0..1, grows with independent corroboration
    summary: str
    #: evidence chain: which bundle members said what, in support
    evidence: List[str] = field(default_factory=list)
    #: exonerating checks that RAN and came back clean (what was ruled out)
    exonerated: List[str] = field(default_factory=list)
    #: machine-readable specifics (peers, counts, rounds)
    data: Dict[str, Any] = field(default_factory=dict)


@dataclass
class Evidence:
    """Everything a bundle (or a live artifacts/ dir) yields, parsed."""

    source: str = ""
    run_id: str = ""
    manifest: Optional[Dict[str, Any]] = None
    #: node -> ledger events (ledger_<node>.jsonl bodies, headers stripped)
    ledgers: Dict[str, List[Dict[str, Any]]] = field(default_factory=dict)
    #: node -> flightrec doc (flightrec_<node>.json)
    flightrecs: Dict[str, Dict[str, Any]] = field(default_factory=dict)
    #: federation_snapshot.json (observatory / population / supervisor doc)
    snapshot: Optional[Dict[str, Any]] = None
    #: metrics.json "families" section (export.snapshot shape)
    metrics: Dict[str, Any] = field(default_factory=dict)
    #: parity_diff.json
    parity: Optional[Dict[str, Any]] = None
    #: context.json (trigger + optional error block)
    context: Optional[Dict[str, Any]] = None

    # --- joined accessors ---------------------------------------------------

    def ledger_events(self, kind: Optional[str] = None) -> List[Dict[str, Any]]:
        out: List[Dict[str, Any]] = []
        for evs in self.ledgers.values():
            for ev in evs:
                if kind is None or ev.get("kind") == kind:
                    out.append(ev)
        return out

    def flight_events(self, kind: Optional[str] = None) -> List[Dict[str, Any]]:
        out: List[Dict[str, Any]] = []
        for doc in self.flightrecs.values():
            for ev in doc.get("events", ()):
                if kind is None or ev.get("kind") == kind:
                    out.append(ev)
        return out

    def metric_total(self, name: str, **labels: str) -> float:
        fam = self.metrics.get(name)
        if not fam:
            return 0.0
        total = 0.0
        for s in fam.get("samples", ()):
            slabels = s.get("labels", {})
            if all(slabels.get(k) == v for k, v in labels.items()):
                total += float(s.get("value", 0.0))
        return total

    def metric_group(self, name: str, by: str) -> Dict[str, float]:
        """Sum a counter/gauge family's samples grouped by one label."""
        fam = self.metrics.get(name)
        out: Dict[str, float] = {}
        if not fam:
            return out
        for s in fam.get("samples", ()):
            key = s.get("labels", {}).get(by, "")
            out[key] = out.get(key, 0.0) + float(s.get("value", 0.0))
        return out

    def peer_scores(self) -> Dict[str, Dict[str, float]]:
        if not self.snapshot:
            return {}
        out: Dict[str, Dict[str, float]] = {}
        for peer, entry in (self.snapshot.get("peers") or {}).items():
            scores = entry.get("scores") or {
                k: entry[k] for k in ("straggler", "suspect", "link") if k in entry
            }
            if scores:
                out[peer] = {k: float(v) for k, v in scores.items()}
        return out

    def trigger(self) -> str:
        return str((self.context or {}).get("trigger", ""))


def _read_json(path: str) -> Optional[Any]:
    try:
        with open(path, "r", encoding="utf-8") as f:
            return json.load(f)
    except Exception:
        return None


def load_evidence(path: str) -> Evidence:
    """Parse a bundle directory OR a live ``artifacts/`` directory — same
    member naming either way, a bundle just guarantees completeness and
    run-id coherence (its manifest records both)."""
    ev = Evidence(source=path)
    ev.manifest = _read_json(os.path.join(path, "manifest.json"))
    if ev.manifest:
        ev.run_id = str(ev.manifest.get("run_id", ""))
    for lpath in sorted(glob.glob(os.path.join(path, "ledger_*.jsonl"))):
        events: List[Dict[str, Any]] = []
        node = os.path.basename(lpath)[len("ledger_"):-len(".jsonl")]
        try:
            with open(lpath, "r", encoding="utf-8") as f:
                for i, line in enumerate(f):
                    line = line.strip()
                    if not line:
                        continue
                    doc = json.loads(line)
                    if i == 0 and doc.get("ledger") == "trajectory":
                        node = str(doc.get("node", node))
                        if not ev.run_id:
                            ev.run_id = str(doc.get("run_id", ""))
                        continue
                    events.append(doc)
        except Exception:
            continue
        ev.ledgers[node] = events
    for fpath in sorted(glob.glob(os.path.join(path, "flightrec_*.json"))):
        doc = _read_json(fpath)
        if isinstance(doc, dict):
            ev.flightrecs[str(doc.get("node", os.path.basename(fpath)))] = doc
            if not ev.run_id:
                ev.run_id = str((doc.get("header") or {}).get("run_id", ""))
    snap = _read_json(os.path.join(path, "federation_snapshot.json"))
    if isinstance(snap, dict):
        ev.snapshot = snap
        if not ev.run_id:
            ev.run_id = str((snap.get("header") or {}).get("run_id", ""))
    metrics_doc = _read_json(os.path.join(path, "metrics.json"))
    if isinstance(metrics_doc, dict):
        ev.metrics = metrics_doc.get("families", metrics_doc)
    parity = _read_json(os.path.join(path, "parity_diff.json"))
    if isinstance(parity, dict):
        ev.parity = parity
    ctx = _read_json(os.path.join(path, "context.json"))
    if isinstance(ctx, dict):
        ev.context = ctx
    return ev


# --- the rule catalog ---------------------------------------------------------
#
# Each rule: Evidence -> Optional[Finding]. Rules must be conservative —
# fire only on explicit anomaly signals, cite every member consulted, and
# record the checks that could have disproved them.


def _rejections(ev: Evidence) -> Tuple[Dict[str, int], Dict[str, int]]:
    """(per-sender event counts, per-reason event counts) from the
    deduped ledger admission stream (the metric keeps raw counts; the
    ledger keeps one fact per (round, sender, reason) — better for
    burst shape)."""
    by_sender: Dict[str, int] = {}
    by_reason: Dict[str, int] = {}
    for e in ev.ledger_events("admission_rejected"):
        s, r = str(e.get("sender", "?")), str(e.get("reason", "?"))
        by_sender[s] = by_sender.get(s, 0) + 1
        by_reason[r] = by_reason.get(r, 0) + 1
    return by_sender, by_reason


def _codec_flavored(reason: str) -> bool:
    reason = reason.lower()
    return any(tag in reason for tag in CODEC_REASONS)


def _chaos_byzantine(ev: Evidence) -> Tuple[float, List[str]]:
    """(count, evidence lines) for injected byzantine behavior — chaos
    metric + chaos_fault ledger events."""
    lines: List[str] = []
    count = 0.0
    for fault, n in ev.metric_group("p2pfl_chaos_faults_total", "fault").items():
        if fault.startswith("byzantine") and n > 0:
            count += n
            lines.append(f"metrics: p2pfl_chaos_faults_total{{fault={fault}}} = {n:g}")
    byz_events = [
        e for e in ev.ledger_events("chaos_fault")
        if str(e.get("fault", "")).startswith("byzantine")
    ]
    if byz_events:
        count += len(byz_events)
        peers = sorted({str(e.get("peer", "?")) for e in byz_events})
        lines.append(f"ledger: chaos_fault byzantine events for {', '.join(peers)}")
    return count, lines


def rule_byzantine_active(ev: Evidence) -> Optional[Finding]:
    """A concentrated admission-rejection burst attributed to one sender,
    corroborated by suspect score and/or injected chaos adversaries."""
    by_sender, by_reason = _rejections(ev)
    if not by_sender:
        return None
    # Structural-corruption storms are a different disease (codec rule).
    codec_n = sum(n for r, n in by_reason.items() if _codec_flavored(r))
    total = sum(by_sender.values())
    if codec_n > total / 2:
        return None
    top_sender, top_n = max(by_sender.items(), key=lambda kv: kv[1])
    if top_n < BYZANTINE_REJECTION_BURST or top_n < BYZANTINE_CONCENTRATION * total:
        return None
    evidence = [
        f"ledger: {top_n} admission_rejected event(s) name {top_sender} "
        f"as sender ({top_n}/{total} of all rejections)",
    ]
    metric_n = ev.metric_total("p2pfl_updates_rejected_total", source=top_sender)
    if metric_n:
        evidence.append(
            f"metrics: p2pfl_updates_rejected_total{{source={top_sender}}} "
            f"= {metric_n:g} raw frames"
        )
    confidence = 0.6
    suspect = ev.peer_scores().get(top_sender, {}).get("suspect", 0.0)
    if suspect > 0:
        confidence += 0.15
        evidence.append(
            f"snapshot: observatory suspect score {suspect:g} for {top_sender}"
        )
    chaos_n, chaos_lines = _chaos_byzantine(ev)
    if chaos_n:
        confidence += 0.2
        evidence.extend(chaos_lines)
    exonerated = []
    if not any(_codec_flavored(r) for r in by_reason):
        exonerated.append(
            "codec corruption ruled out: every rejection reason is "
            "admission-plane (norm/claim screening), none decode-flavored"
        )
    lost = {str(e.get("peer")) for e in ev.flight_events("peer_lost")}
    if top_sender not in lost:
        exonerated.append(
            f"churn ruled out: no peer_lost event for {top_sender} — it kept "
            "heartbeating while its frames were rejected"
        )
    return Finding(
        rule="byzantine_active",
        severity="critical",
        confidence=min(0.95, confidence),
        summary=(
            f"{top_sender} is behaving adversarially: the fleet rejected "
            f"{top_n} of its model-plane frames"
            + (" (seeded chaos adversary confirmed)" if chaos_n else "")
        ),
        evidence=evidence,
        exonerated=exonerated,
        data={"peer": top_sender, "rejections": top_n, "suspect_score": suspect},
    )


def rule_adversary_under_rejection(ev: Evidence) -> Optional[Finding]:
    """Chaos says an adversary is injecting poisoned frames, yet admission
    rejected (almost) nothing — the defense is not engaging."""
    chaos_n, chaos_lines = _chaos_byzantine(ev)
    if not chaos_n:
        return None
    by_sender, _ = _rejections(ev)
    rejected = sum(by_sender.values())
    metric_rej = sum(ev.metric_group("p2pfl_updates_rejected_total", "source").values())
    if rejected > 0 or metric_rej > 0:
        return None
    return Finding(
        rule="adversary_under_rejection",
        severity="critical",
        confidence=0.8,
        summary=(
            f"an active adversary ({chaos_n:g} corrupted frame(s) injected) "
            "produced ZERO admission rejections — screening is not engaging"
        ),
        evidence=chaos_lines
        + ["ledger+metrics: no admission_rejected events, rejected_total = 0"],
        exonerated=[],
        data={"injected": chaos_n, "rejections": 0},
    )


def rule_codec_corruption_storm(ev: Evidence) -> Optional[Finding]:
    """Decode-flavored rejections across multiple frames/senders: wire or
    codec corruption, not one adversary's content."""
    by_sender, by_reason = _rejections(ev)
    codec_events = [
        e for e in ev.ledger_events("admission_rejected")
        if _codec_flavored(str(e.get("reason", "")))
    ]
    if len(codec_events) < CODEC_STORM_EVENTS:
        return None
    senders = sorted({str(e.get("sender", "?")) for e in codec_events})
    reasons = sorted({str(e.get("reason", "?")) for e in codec_events})
    return Finding(
        rule="codec_corruption_storm",
        severity="critical",
        confidence=0.6 + (0.2 if len(senders) > 1 else 0.0),
        summary=(
            f"{len(codec_events)} structurally-undecodable frames from "
            f"{len(senders)} sender(s) — codec/wire corruption, not "
            "adversarial content"
        ),
        evidence=[
            f"ledger: {len(codec_events)} decode-flavored admission_rejected "
            f"event(s), reasons: {', '.join(reasons)}",
            f"senders involved: {', '.join(senders)}",
        ],
        exonerated=(
            ["single-adversary hypothesis weakened: corruption spans "
             f"{len(senders)} independent senders"] if len(senders) > 1 else []
        ),
        data={"events": len(codec_events), "senders": senders, "reasons": reasons},
    )


def rule_straggler_gating(ev: Evidence) -> Optional[Finding]:
    """One peer runs far behind the fleet AND aggregation measurably waited
    on (or gave up on) someone — lateness alone is not an incident."""
    scores = ev.peer_scores()
    if not scores:
        return None
    top_peer, top = max(
        scores.items(), key=lambda kv: kv[1].get("straggler", 0.0)
    )
    s = top.get("straggler", 0.0)
    if s < STRAGGLER_SCORE_MIN:
        return None
    gating: List[str] = []
    stalls = ev.metric_total("p2pfl_aggregation_stall_partials_total")
    timeouts = ev.metric_total("p2pfl_aggregation_timeout_partials_total")
    if stalls:
        gating.append(
            f"metrics: p2pfl_aggregation_stall_partials_total = {stalls:g}"
        )
    if timeouts:
        gating.append(
            f"metrics: p2pfl_aggregation_timeout_partials_total = {timeouts:g}"
        )
    slow_evs = [
        e for e in ev.ledger_events("chaos_fault")
        if str(e.get("fault", "")) in ("slow", "delay")
    ]
    fault_delays = ev.metric_group("p2pfl_chaos_faults_total", "fault").get("delay", 0)
    if not gating and not slow_evs and not fault_delays:
        return None
    confidence = 0.55 + 0.15 * bool(gating) + 0.1 * bool(slow_evs or fault_delays)
    evidence = [
        f"snapshot: observatory straggler score {s:g} for {top_peer} "
        "(round lag + late entry + step-time z-score)",
        *gating,
    ]
    if slow_evs or fault_delays:
        evidence.append(
            "chaos: injected slow-host/delay faults present "
            f"(delay count {fault_delays:g})"
        )
    exonerated = []
    if top_peer not in {str(e.get("peer")) for e in ev.flight_events("peer_lost")}:
        exonerated.append(
            f"death ruled out: {top_peer} kept heartbeating (no peer_lost)"
        )
    if scores.get(top_peer, {}).get("suspect", 0.0) == 0.0:
        exonerated.append(
            f"byzantine ruled out: suspect score 0 for {top_peer} — slow, "
            "not malicious"
        )
    return Finding(
        rule="straggler_gating",
        severity="warning",
        confidence=min(0.9, confidence),
        summary=(
            f"{top_peer} straggles the fleet (score {s:g}) and round "
            "progress is gated on it"
        ),
        evidence=evidence,
        exonerated=exonerated,
        data={"peer": top_peer, "straggler_score": s},
    )


def rule_churn_starved_cohort(ev: Evidence) -> Optional[Finding]:
    """Peers died mid-round without recovering, and aggregation had to
    proceed without (or wait for) their contributions."""
    lost = {str(e.get("peer")) for e in ev.flight_events("peer_lost")}
    recovered = {str(e.get("peer")) for e in ev.flight_events("peer_recovered")}
    dead = sorted(lost - recovered)
    if not dead:
        return None
    dead_contrib = ev.metric_total("p2pfl_aggregation_dead_contributors_total")
    stalls = ev.metric_total("p2pfl_aggregation_stall_partials_total")
    timeouts = ev.metric_total("p2pfl_aggregation_timeout_partials_total")
    crash_n = ev.metric_group("p2pfl_chaos_faults_total", "fault").get("crash", 0.0)
    if not (dead_contrib or stalls or timeouts or crash_n):
        return None
    evidence = [
        f"flightrec: peer_lost without recovery for {', '.join(dead)}",
    ]
    confidence = 0.6
    if dead_contrib:
        evidence.append(
            "metrics: p2pfl_aggregation_dead_contributors_total = "
            f"{dead_contrib:g} — aggregation dropped dead peers' shares"
        )
        confidence += 0.1
    if stalls or timeouts:
        evidence.append(
            f"metrics: stall/timeout partial aggregations = {stalls + timeouts:g}"
        )
        confidence += 0.05
    if crash_n:
        evidence.append(
            f"chaos: {crash_n:g} frame(s) blackholed by injected crash faults"
        )
        confidence += 0.15
    return Finding(
        rule="churn_starved_cohort",
        severity="critical",
        confidence=min(0.95, confidence),
        summary=(
            f"{len(dead)} peer(s) died mid-run without recovering "
            f"({', '.join(dead)}); the cohort aggregated without them"
        ),
        evidence=evidence,
        exonerated=[
            "heartbeat false-death ruled out: no peer_recovered follows the "
            "loss — the peers are genuinely gone"
        ],
        data={"dead": dead, "dead_contributors": dead_contrib},
    )


def rule_heartbeat_false_death(ev: Evidence) -> Optional[Finding]:
    """Peers declared dead then observed alive again, with no injected
    crash to explain the loss: the failure detector flapped."""
    lost = {str(e.get("peer")) for e in ev.flight_events("peer_lost")}
    recovered = {str(e.get("peer")) for e in ev.flight_events("peer_recovered")}
    flapped = sorted(lost & recovered)
    if not flapped:
        return None
    crash_n = ev.metric_group("p2pfl_chaos_faults_total", "fault").get("crash", 0.0)
    partition_n = ev.metric_group("p2pfl_chaos_faults_total", "fault").get(
        "partition", 0.0
    )
    if crash_n or partition_n:
        return None  # the flap has a legitimate cause — not a detector bug
    return Finding(
        rule="heartbeat_false_death",
        severity="warning",
        confidence=0.6,
        summary=(
            f"{len(flapped)} peer(s) were declared dead then recovered "
            f"({', '.join(flapped)}) with no injected crash/partition — "
            "heartbeat patience is too tight for this link"
        ),
        evidence=[
            f"flightrec: peer_lost AND peer_recovered for {', '.join(flapped)}",
            "chaos: zero crash/partition faults — nothing explains the loss",
        ],
        exonerated=[],
        data={"peers": flapped},
    )


def rule_partition_heal_asymmetry(ev: Evidence) -> Optional[Finding]:
    """After an injected partition, some observers healed a peer and
    others that lost it did not — the heal did not propagate fleet-wide."""
    partition_n = ev.metric_group("p2pfl_chaos_faults_total", "fault").get(
        "partition", 0.0
    )
    if not partition_n:
        return None
    lost_by: Dict[str, set] = {}
    rec_by: Dict[str, set] = {}
    for node, doc in ev.flightrecs.items():
        for e in doc.get("events", ()):
            if e.get("kind") == "peer_lost":
                lost_by.setdefault(str(e.get("peer")), set()).add(node)
            elif e.get("kind") == "peer_recovered":
                rec_by.setdefault(str(e.get("peer")), set()).add(node)
    asym = {
        peer: sorted(lost_by[peer] - rec_by.get(peer, set()))
        for peer in lost_by
        if rec_by.get(peer) and (lost_by[peer] - rec_by.get(peer, set()))
    }
    if not asym:
        return None
    lines = [
        f"flightrec: {peer} recovered at {sorted(rec_by[peer])} but not at "
        f"{still}" for peer, still in sorted(asym.items())
    ]
    return Finding(
        rule="partition_heal_asymmetry",
        severity="warning",
        confidence=0.65,
        summary=(
            f"partition healed asymmetrically: {len(asym)} peer(s) "
            "recovered on one side of the fleet but stayed dead on the other"
        ),
        evidence=[
            f"chaos: {partition_n:g} frame(s) blocked by injected partition",
            *lines,
        ],
        exonerated=[],
        data={"peers": {p: s for p, s in asym.items()}},
    )


def rule_oom_degrade_ladder(ev: Evidence) -> Optional[Finding]:
    """The supervisor restarted on OOM and climbed the degrade ladder —
    the configured shape does not fit the device."""
    oom = ev.metric_total("p2pfl_supervisor_restarts_total", kind="oom")
    err = ((ev.context or {}).get("error") or {}).get("message", "")
    ctx_oom = "RESOURCE_EXHAUSTED" in str(err)
    if not oom and not ctx_oom:
        return None
    degrades = sum(
        ev.metric_group("p2pfl_supervisor_degrade_steps_total", "action").values()
    )
    evidence = []
    if oom:
        evidence.append(
            f"metrics: p2pfl_supervisor_restarts_total{{kind=oom}} = {oom:g}"
        )
    if ctx_oom:
        evidence.append("context: RESOURCE_EXHAUSTED in the triggering error")
    if degrades:
        evidence.append(
            f"metrics: {degrades:g} degrade-ladder step(s) taken "
            "(chunk/cohort shrinking)"
        )
    return Finding(
        rule="oom_degrade_ladder",
        severity="critical",
        confidence=min(0.9, 0.7 + 0.1 * bool(degrades) + 0.1 * (oom > 1)),
        summary=(
            "device memory exhausted: the supervisor restarted on OOM"
            + (f" and took {degrades:g} degrade step(s)" if degrades else "")
            + " — the population shape does not fit this accelerator"
        ),
        evidence=evidence,
        exonerated=[],
        data={"oom_restarts": oom, "degrade_steps": degrades},
    )


def rule_parity_divergence(ev: Evidence) -> Optional[Finding]:
    """The two backends' trajectory ledgers diverged — localized to the
    first differing event."""
    if not ev.parity or ev.parity.get("status") != "DIVERGED":
        return None
    first = ev.parity.get("first_divergence") or {}
    where = ", ".join(
        f"{k}={first[k]}" for k in ("round", "kind", "sender") if k in first
    )
    return Finding(
        rule="parity_divergence",
        severity="critical",
        confidence=0.9,
        summary=(
            "wire and fused backends diverged"
            + (f" — first at {where}" if where else "")
        ),
        evidence=[
            "parity_diff: status DIVERGED after "
            f"{ev.parity.get('compared_events', '?')} aligned event(s)",
            f"parity_diff: first_divergence {first}" if first else
            "parity_diff: no aligned prefix at all",
        ],
        exonerated=[],
        data={"first_divergence": first},
    )


def rule_recompile_storm(ev: Evidence) -> Optional[Finding]:
    """Repeated recompilation mid-run — a shape/donation bug turning
    every chunk into a compile."""
    recompiles = [
        e for e in ev.flight_events()
        if "recompile" in str(e.get("kind", "")).lower()
    ]
    if len(recompiles) < RECOMPILE_STORM_EVENTS:
        return None
    return Finding(
        rule="recompile_storm",
        severity="warning",
        confidence=0.7,
        summary=(
            f"{len(recompiles)} recompilation events mid-run — static "
            "shapes are varying across chunks (cache-defeating)"
        ),
        evidence=[
            f"flightrec: {len(recompiles)} 'recompile' event(s) recorded",
        ],
        exonerated=[],
        data={"events": len(recompiles)},
    )


def rule_device_tripwire(ev: Evidence) -> Optional[Finding]:
    """The device observatory tripped (non-finite params / loss
    divergence) — numeric fault localized by the trip context."""
    trig = ev.trigger()
    ctx = (ev.context or {}).get("context") or {}
    trips = ev.flight_events("devobs_trip")
    if trig != "devobs_trip" and not trips:
        return None
    kind = str(ctx.get("kind") or (trips[0].get("trip_kind") if trips else "?"))
    where = ctx.get("round", trips[0].get("round") if trips else "?")
    evidence = []
    if trig == "devobs_trip":
        evidence.append(f"context: trigger devobs_trip (kind={kind}, round={where})")
    if trips:
        evidence.append(f"flightrec: {len(trips)} devobs_trip event(s)")
    mesh_trips = sum(ev.metric_group("p2pfl_mesh_trips_total", "kind").values())
    if mesh_trips:
        evidence.append(f"metrics: p2pfl_mesh_trips_total = {mesh_trips:g}")
    return Finding(
        rule="device_tripwire",
        severity="critical",
        confidence=0.85,
        summary=(
            f"device health guard tripped: {kind} at round {where} — "
            "the parameter stream went numerically bad in-scan"
        ),
        evidence=evidence,
        exonerated=[],
        data={"kind": kind, "round": where},
    )


_SEVERITY_RANK = {"critical": 0, "warning": 1, "info": 2}

RULES: Tuple[Callable[[Evidence], Optional[Finding]], ...] = (
    rule_device_tripwire,
    rule_parity_divergence,
    rule_oom_degrade_ladder,
    rule_byzantine_active,
    rule_adversary_under_rejection,
    rule_codec_corruption_storm,
    rule_churn_starved_cohort,
    rule_straggler_gating,
    rule_partition_heal_asymmetry,
    rule_heartbeat_false_death,
    rule_recompile_storm,
)


def diagnose(ev: Evidence) -> List[Finding]:
    """Run the full catalog, drop findings below
    ``Settings.DOCTOR_MIN_CONFIDENCE``, rank by (severity, confidence)."""
    findings: List[Finding] = []
    floor = float(Settings.DOCTOR_MIN_CONFIDENCE)
    for rule in RULES:
        try:
            f = rule(ev)
        except Exception:  # a broken rule must not hide the others
            continue
        if f is not None and f.confidence >= floor:
            findings.append(f)
            _DIAGNOSES.labels(f.rule).inc()
    findings.sort(
        key=lambda f: (_SEVERITY_RANK.get(f.severity, 9), -f.confidence, f.rule)
    )
    return findings


def incident_doc(
    findings: List[Finding], run_id: str = "", source: str = ""
) -> Dict[str, Any]:
    """Machine-readable incident report (what ``incident.json`` holds and
    the fed_top DIAGNOSIS banner consumes)."""
    return {
        "incident": "fed_doctor",
        "v": INCIDENT_SCHEMA_VERSION,
        "run_id": run_id,
        "source": source,
        "findings": [asdict(f) for f in findings],
        "top": findings[0].rule if findings else None,
    }


def render_report(doc: Dict[str, Any]) -> str:
    """Human-readable rendering of an incident doc."""
    lines: List[str] = []
    rid = doc.get("run_id") or "-"
    lines.append(f"fed_doctor incident report  (run {rid})")
    lines.append(f"source: {doc.get('source') or '-'}")
    findings = doc.get("findings") or []
    if not findings:
        lines.append("")
        lines.append("no findings — every rule came back clean.")
        return "\n".join(lines)
    lines.append(f"findings: {len(findings)} (ranked)")
    for i, f in enumerate(findings, 1):
        lines.append("")
        lines.append(
            f"#{i} [{f.get('severity', '?').upper()}] {f.get('rule')} "
            f"(confidence {float(f.get('confidence', 0)):.0%})"
        )
        lines.append(f"   {f.get('summary')}")
        for e in f.get("evidence") or []:
            lines.append(f"   + {e}")
        for x in f.get("exonerated") or []:
            lines.append(f"   - {x}")
    return "\n".join(lines)


__all__ = [
    "INCIDENT_SCHEMA_VERSION",
    "Evidence",
    "Finding",
    "RULES",
    "diagnose",
    "incident_doc",
    "load_evidence",
    "render_report",
]
