"""Round critical-path analysis over the federation span DAG (the port's framework-free copy of
``p2pfl_tpu/telemetry/critical_path.py``, its imports rerouted to ``p2pfl_tpu_torch``).

Every remaining ROADMAP frontier (async aggregation, comm/compute overlap,
population scale) is a wall-clock problem, and the per-stage spans from the
telemetry plane already record where each node's time went — but attribution
was manual: "which span on WHICH node gated this round?" had to be answered
by eyeballing a Perfetto timeline. This module answers it mechanically.

The model: a federated round is a DAG of spans. Within a node, stage spans
are sequential (the workflow runs them one after another). Across nodes, a
*wait* span (``aggregation_wait``, ``full_model_wait``, ``vote_rtt``, the
``diffuse:*`` gossip loops) ends because a frame ARRIVED — and the receiving
``recv:*``/``apply:*`` span is parented onto the sender's span through the
wire trace context, so the edge back to the gating sender is already in the
span table. The critical path is a backward walk from the round's
last-finishing span: a wait span is resolved through the recv span that
ended it (jumping to the sender's then-active span); a compute span is
resolved to its same-node predecessor. Each hop attributes the walked
wall-clock interval to the span that actually occupied it, so a node that
merely *waited* contributes ~nothing while the straggler whose ``fit`` held
everyone up carries the time — the gating node falls out as an argmax.

Clock domains: spans recorded by ONE tracer share one monotonic clock and
need no correction. Traces exported by DIFFERENT processes (a real gRPC
deployment) are merged via each export's wall-clock epoch anchor
(``Tracer.wall_epoch``), with residual NTP skew corrected from the
heartbeater's per-peer clock-skew measurements — either passed explicitly
(``skew_s``) or read from the ``peer_clock_skew_s`` annotation that
``CommunicationProtocol.export_trace`` stamps onto each dump.

Outputs (``CriticalPathAnalyzer.report()``):

* per-round critical paths: the gating node + the span chain with per-hop
  attributed seconds,
* per-round and aggregate stage wall-clock shares (where does a round's
  node-time actually go),
* a train<->diffuse overlap report: how much model diffusion time overlaps
  local training on the same node (today: ~0 — the measured headroom
  ROADMAP item 4 claims by overlapping them).
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

from p2pfl_tpu_torch.telemetry.metrics import REGISTRY, MetricsRegistry
from p2pfl_tpu_torch.telemetry.tracing import TRACER, Span, Tracer

#: Fine-grained stage-work spans that carry a round and form path segments.
#: Async-scheduler spans ride the same machinery — a WINDOW is a round to
#: the walk (the ``round`` span arg carries the window index).
FINE_SPANS = (
    "vote_rtt",
    "fit",
    "aggregation_wait",
    "full_model_wait",
    "diffuse:init_model",
    "diffuse:partial_model",
    "diffuse:full_model",
    "diffuse:async_model",
    "async_window_wait",
)

#: Zero-duration diagnosis markers the async scheduler drops per window
#: (close reason, mean folded lag, fill) — consumed by the window report,
#: never path segments.
WINDOW_MARKER = "window_close"

#: Spans that end because a remote frame arrived, and the recv/apply span
#: names that can resolve them. Order matters: earlier names are preferred
#: (``recv:*`` before ``apply:*`` — the recv span's parent IS the sender's
#: span, while an apply span parents onto the local recv around it).
WAIT_RESOLVERS: Dict[str, Tuple[str, ...]] = {
    "aggregation_wait": ("recv:partial_model", "apply:partial_model"),
    "full_model_wait": ("recv:full_model", "apply:full_model"),
    "vote_rtt": ("recv:vote_train_set",),
    "diffuse:init_model": ("recv:model_initialized",),
    # Partial-model gossip relays CONTENT: what a node can send at time t
    # is bounded by the partials that reached it by t, so content arrivals
    # are preferred over coverage acks — the walk then chases a relayed
    # contribution back through intermediate nodes to its slow origin.
    "diffuse:partial_model": (
        "recv:partial_model",
        "apply:partial_model",
        "recv:models_aggregated",
        "recv:models_ready",
    ),
    "diffuse:full_model": ("recv:models_ready",),
    # An async window's fill wait ends because a contribution arrived; the
    # recv span's parent link crosses the wire to the (possibly slow)
    # contributor whose frame closed the window.
    "async_window_wait": ("recv:async_model", "apply:async_model"),
}

#: Container spans (whole-stage / whole-experiment) — never path segments.
_CONTAINER_SUFFIXES = ("Stage",)
_CONTAINER_NAMES = ("experiment", "set_start_learning")


def _is_recv(name: str) -> bool:
    return name.startswith("recv:") or name.startswith("apply:")


def _is_container(name: str) -> bool:
    return name in _CONTAINER_NAMES or name.endswith(_CONTAINER_SUFFIXES)


@dataclass
class Seg:
    """One normalized span on the merged timeline (start/end in shared s)."""

    name: str
    node: str
    start_s: float
    end_s: float
    span_id: str
    parent_id: str
    trace_id: str
    round: Optional[int]
    #: raw span args (close reason, mean lag, ... — window markers carry
    #: their diagnosis here; empty for most spans).
    extra: Dict[str, Any] = field(default_factory=dict)

    @property
    def dur_s(self) -> float:
        return self.end_s - self.start_s


@dataclass
class PathHop:
    """One hop of a round's critical path, earliest first.

    ``attributed_s`` is the slice of round wall-clock this hop is
    responsible for ON the path (a wait span resolved by a remote arrival
    is attributed only its post-arrival tail, not the whole wait).
    """

    node: str
    name: str
    start_s: float
    end_s: float
    attributed_s: float
    kind: str  # "compute" | "wait" | "recv"

    def to_dict(self) -> Dict[str, Any]:
        return {
            "node": self.node,
            "name": self.name,
            "start_s": round(self.start_s, 6),
            "end_s": round(self.end_s, 6),
            "attributed_s": round(self.attributed_s, 6),
            "kind": self.kind,
        }


@dataclass
class RoundPath:
    round: int
    gating_node: Optional[str]
    hops: List[PathHop] = field(default_factory=list)
    wall_s: float = 0.0
    attributed_by_node: Dict[str, float] = field(default_factory=dict)
    coverage: float = 0.0  # attributed path time / round wall-clock

    def to_dict(self) -> Dict[str, Any]:
        return {
            "round": self.round,
            "gating_node": self.gating_node,
            "wall_s": round(self.wall_s, 6),
            "coverage": round(self.coverage, 4),
            "attributed_by_node": {
                n: round(v, 6) for n, v in self.attributed_by_node.items()
            },
            "path": [h.to_dict() for h in self.hops],
        }


def skew_from_registry(
    reference_node: str, registry: MetricsRegistry = REGISTRY
) -> Dict[str, float]:
    """Per-node skew corrections from the heartbeat clock-skew gauge.

    The gauge records ``receiver wall - sender-stamped beat timestamp``; for
    ``reference_node`` as receiver that is (up to one-way latency) how far
    each peer's wall clock lags the reference's. Adding the returned value
    to a peer's wall-clock timestamps maps them into the reference's clock
    domain — the convention :class:`CriticalPathAnalyzer` expects.
    """
    out: Dict[str, float] = {}
    fam = registry.get("p2pfl_heartbeat_clock_skew_seconds")
    if fam is None:
        return out
    for labels, child in fam.samples():
        if labels.get("node") == reference_node and labels.get("peer"):
            out[labels["peer"]] = float(child.value)
    return out


class CriticalPathAnalyzer:
    """Assemble the per-round span DAG and walk its critical paths.

    Args:
        segs: normalized spans on ONE shared timeline (see the
            ``from_tracer`` / ``from_chrome_traces`` constructors).
        slack_s: causal tolerance when matching arrivals to waits and
            predecessors to successors — covers the 0.5 s event-wait slices
            in the stage machine plus gossip tick jitter.
    """

    def __init__(self, segs: Sequence[Seg], slack_s: float = 1.0) -> None:
        self.slack_s = float(slack_s)
        self._fine = sorted(
            (s for s in segs if s.name in FINE_SPANS), key=lambda s: s.start_s
        )
        self._recv = sorted(
            (s for s in segs if _is_recv(s.name)), key=lambda s: s.end_s
        )
        self._markers = [s for s in segs if s.name == WINDOW_MARKER]
        self._by_id = {s.span_id: s for s in segs if s.span_id}
        self._fine_by_node: Dict[str, List[Seg]] = {}
        for s in self._fine:
            self._fine_by_node.setdefault(s.node, []).append(s)

    # --- constructors --------------------------------------------------------

    @classmethod
    def from_tracer(
        cls,
        tracer: Tracer = TRACER,
        skew_s: Optional[Dict[str, float]] = None,
        slack_s: float = 1.0,
    ) -> "CriticalPathAnalyzer":
        """All spans share the tracer's clock; ``skew_s`` is for tests."""
        skew = skew_s or {}
        segs = [
            Seg(
                name=s.name,
                node=s.node,
                start_s=s.start_s + skew.get(s.node, 0.0),
                end_s=s.start_s + s.dur_s + skew.get(s.node, 0.0),
                span_id=s.span_id,
                parent_id=s.parent_id,
                trace_id=s.trace_id,
                round=_round_of(s.args),
                extra=dict(s.args),
            )
            for s in tracer.spans()
        ]
        return cls(segs, slack_s=slack_s)

    @classmethod
    def from_chrome_traces(
        cls,
        docs: Iterable[Dict[str, Any]],
        skew_s: Optional[Dict[str, float]] = None,
        auto_skew: bool = True,
        slack_s: float = 1.0,
    ) -> "CriticalPathAnalyzer":
        """Merge per-process ``export_chrome_trace`` documents.

        Each document's µs timestamps are mapped onto the wall clock through
        its ``metadata.wall_epoch_s`` anchor. The FIRST document is the
        reference clock domain; with ``auto_skew`` (default), other
        documents whose ``metadata.node`` appears in the reference's
        ``peer_clock_skew_s`` annotation (written by
        ``CommunicationProtocol.export_trace``) are shifted by that measured
        skew. Explicit ``skew_s`` entries (node -> seconds to add) win over
        the automatic ones.
        """
        docs = list(docs)
        ref_skews: Dict[str, float] = {}
        if docs:
            ref_skews = dict(
                (docs[0].get("metadata") or {}).get("peer_clock_skew_s") or {}
            )
        segs: List[Seg] = []
        for i, doc in enumerate(docs):
            meta = doc.get("metadata") or {}
            epoch = float(meta.get("wall_epoch_s", 0.0))
            doc_node = meta.get("node", "")
            pid_names: Dict[int, str] = {}
            for ev in doc.get("traceEvents", []):
                if ev.get("ph") == "M" and ev.get("name") == "process_name":
                    pid_names[ev["pid"]] = ev.get("args", {}).get("name", "")
            for ev in doc.get("traceEvents", []):
                if ev.get("ph") != "X":
                    continue
                node = pid_names.get(ev.get("pid"), "") or doc_node
                shift = 0.0
                if i > 0 and auto_skew:
                    # Auto-correction keys on the EXPORTING node's identity:
                    # per-process deployments have one node per document.
                    key = doc_node or node
                    shift = ref_skews.get(key, 0.0)
                if skew_s and node in skew_s:
                    shift = skew_s[node]
                elif skew_s and doc_node in skew_s:
                    shift = skew_s[doc_node]
                args = ev.get("args", {})
                start = ev["ts"] / 1e6 + epoch + shift
                segs.append(
                    Seg(
                        name=ev.get("name", ""),
                        node=node,
                        start_s=start,
                        end_s=start + ev.get("dur", 0.0) / 1e6,
                        span_id=str(args.get("span_id", "")),
                        parent_id=str(args.get("parent_id", "")),
                        trace_id=str(args.get("trace_id", "")),
                        round=_round_of(args),
                        extra={
                            k: v for k, v in args.items()
                            if k not in ("trace_id", "span_id", "parent_id")
                        },
                    )
                )
        return cls(segs, slack_s=slack_s)

    # --- round inventory -----------------------------------------------------

    def rounds(self) -> List[int]:
        return sorted({s.round for s in self._fine if s.round is not None})

    def nodes(self) -> List[str]:
        return sorted(self._fine_by_node)

    # --- the backward gating walk -------------------------------------------

    def round_path(self, rnd: int, max_hops: int = 256) -> RoundPath:
        spans_r = [s for s in self._fine if s.round == rnd]
        if not spans_r:
            return RoundPath(round=rnd, gating_node=None)
        terminal = max(spans_r, key=lambda s: s.end_s)
        round_start = min(s.start_s for s in spans_r)

        hops: List[PathHop] = []
        visited: set = set()
        cur: Optional[Seg] = terminal
        cursor = terminal.end_s  # walked-down-to time on the path

        def clamp(upper: float, lower: float) -> float:
            # Attribution counts only time inside THIS round's window: the
            # walk may continue through earlier rounds for continuity, but
            # a prior round's span must not inflate this round's totals.
            return max(0.0, min(upper, terminal.end_s) - max(lower, round_start))

        while cur is not None and len(hops) < max_hops:
            visited.add(cur.span_id)

            # A wait span's END was caused by a remote arrival: jump to the
            # sender — unless the sender chain cycles back onto a span
            # already on the path (ack loops: our send -> peer's ack -> us),
            # in which case the wait falls through to the predecessor rule.
            resolver = WAIT_RESOLVERS.get(cur.name)
            # A wait span the walk entered within a sliver of its START
            # explains nothing by its arrivals — the cause is upstream of
            # the span itself (it started late). Skip arrival resolution
            # and chain to the same-node predecessor (e.g. the slow fit
            # that delayed this node's own gossip).
            can_jump = resolver is not None and cursor - cur.start_s >= 0.3
            if can_jump:
                jumped = False
                # Latest-first: the most recent arrival explains the wait's
                # end, but when its sender is already on the path (gossip
                # relays bounce content both ways), the next-latest arrival
                # — e.g. the slow origin's own contribution — still does.
                for arrival in self._resolving_arrivals(cur, resolver, rnd, cursor):
                    sender = self._sender_span(arrival, arrival.start_s, rnd)
                    if sender is None or sender.span_id in visited:
                        continue
                    boundary = max(cur.start_s, min(cursor, arrival.start_s))
                    hops.append(
                        PathHop(
                            node=cur.node, name=cur.name,
                            start_s=cur.start_s, end_s=cur.end_s,
                            attributed_s=clamp(min(cursor, cur.end_s), boundary),
                            kind="wait",
                        )
                    )
                    hops.append(
                        PathHop(
                            node=arrival.node, name=arrival.name,
                            start_s=arrival.start_s, end_s=arrival.end_s,
                            attributed_s=0.0, kind="recv",
                        )
                    )
                    cursor = boundary
                    cur = sender
                    jumped = True
                    break
                if jumped:
                    continue

            # Compute hop (or wait with no resolvable/fresh sender):
            # attribute [start, cursor], then walk the same-node
            # predecessor chain; a dead end falls back to the globally
            # latest unvisited span before this one (the walk must reach
            # round start, not stop at the first bookkeeping gap).
            # A span explains at most its own interval: time between its
            # end and the cursor is an unexplained gap, left unattributed
            # (visible as coverage < 1) rather than mis-charged here.
            hops.append(
                PathHop(
                    node=cur.node, name=cur.name,
                    start_s=cur.start_s, end_s=cur.end_s,
                    attributed_s=clamp(min(cursor, cur.end_s), cur.start_s),
                    kind="wait" if resolver is not None else "compute",
                )
            )
            cursor = min(cursor, cur.start_s)
            if cursor <= round_start + 1e-9:
                break
            nxt = self._predecessor(cur, visited, rnd)
            if nxt is None:
                nxt = self._global_predecessor(cur, visited, rnd)
            cur = nxt

        hops.reverse()
        attributed: Dict[str, float] = {}
        for h in hops:
            attributed[h.node] = attributed.get(h.node, 0.0) + h.attributed_s
        wall = terminal.end_s - round_start
        gating = max(attributed, key=lambda n: attributed[n]) if attributed else None
        return RoundPath(
            round=rnd,
            gating_node=gating,
            hops=hops,
            wall_s=wall,
            attributed_by_node=attributed,
            coverage=(sum(attributed.values()) / wall) if wall > 0 else 0.0,
        )

    def _resolving_arrivals(
        self, wait: Seg, names: Tuple[str, ...], rnd: int, cursor: float,
        limit: int = 8,
    ) -> List[Seg]:
        """Matching recv/apply spans on the waiting node that ended inside
        the wait window, AS OF the walk cursor (a span reached mid-interval
        via a relay jump is resolved by what had arrived by that moment,
        not by later traffic). ``names`` are tried in preference order
        (recv before apply: the recv span's parent link crosses the wire
        to the sender); within a name, latest arrivals first."""
        upper = min(wait.end_s, cursor) + self.slack_s
        for name in names:
            found = [
                s
                for s in self._recv
                if s.node == wait.node
                and s.name == name
                and (s.round is None or s.round == rnd)
                and wait.start_s - self.slack_s < s.end_s <= upper
            ]
            if found:
                found.sort(key=lambda s: s.end_s, reverse=True)
                return found[:limit]
        return []

    def _sender_span(self, arrival: Seg, cursor: float, rnd: int) -> Optional[Seg]:
        """Continue the walk on the sender: the frame left the sender around
        ``arrival.start_s``, so the gating span is the sender's fine span
        active (or last finished) at that moment. The arrival's parent link
        names the sender's span directly; a receiver-side parent (an apply
        nested in its recv) is walked up first, and a container parent (a
        whole-stage span) is refined to the sender's then-current fine
        span. Spans from LATER rounds are never picked — a backward walk
        must not wander into the future."""
        parent = self._by_id.get(arrival.parent_id)
        walked = 0
        while parent is not None and walked < 4 and _is_recv(parent.name):
            parent = self._by_id.get(parent.parent_id)
            walked += 1
        if (
            parent is not None
            and parent.name in FINE_SPANS
            and not self._future(parent, rnd)
        ):
            return parent
        node = parent.node if parent is not None else ""
        if not node:
            return None
        future_slack = min(0.25, self.slack_s)
        cands = [
            s
            for s in self._fine_by_node.get(node, [])
            if s.start_s <= cursor + future_slack and not self._future(s, rnd)
        ]
        if not cands:
            return None
        # Prefer a span actually covering the cursor; else the latest one.
        covering = [s for s in cands if s.end_s >= cursor - self.slack_s]
        pool = covering or cands
        return max(pool, key=lambda s: s.start_s)

    @staticmethod
    def _future(s: Seg, rnd: int) -> bool:
        return s.round is not None and s.round > rnd

    def _predecessor(self, cur: Seg, visited: set, rnd: int) -> Optional[Seg]:
        """Latest same-node fine span ending at or before ``cur`` starts."""
        best: Optional[Seg] = None
        for s in self._fine_by_node.get(cur.node, []):
            if s is cur or s.span_id in visited or self._future(s, rnd):
                continue
            if s.end_s <= cur.start_s + self.slack_s and s.start_s < cur.start_s:
                if best is None or s.end_s > best.end_s:
                    best = s
        return best

    def _global_predecessor(self, cur: Seg, visited: set, rnd: int) -> Optional[Seg]:
        """Cross-node fallback when a node's own history runs dry: the
        latest unvisited fine span (any node) that ended before ``cur``
        started — "what was the fleet doing just before this"."""
        best: Optional[Seg] = None
        for s in self._fine:
            if s.span_id in visited or self._future(s, rnd):
                continue
            if s.end_s <= cur.start_s + self.slack_s and s.start_s < cur.start_s:
                if best is None or s.end_s > best.end_s:
                    best = s
        return best

    # --- aggregate reports ---------------------------------------------------

    def stage_shares(self, rnd: Optional[int] = None) -> Dict[str, Any]:
        """Summed wall-clock by stage-span name (across nodes), with shares
        of the total — where a round's node-time goes, path or not."""
        spans = [
            s
            for s in self._fine
            if rnd is None or s.round == rnd
        ]
        totals: Dict[str, float] = {}
        for s in spans:
            totals[s.name] = totals.get(s.name, 0.0) + s.dur_s
        grand = sum(totals.values())
        return {
            "total_span_s": round(grand, 6),
            "by_stage_s": {k: round(v, 6) for k, v in sorted(totals.items())},
            "shares": {
                k: round(v / grand, 4) if grand > 0 else 0.0
                for k, v in sorted(totals.items())
            },
        }

    def overlap_report(self, rnd: Optional[int] = None) -> Dict[str, Any]:
        """Train<->diffuse overlap: how much of each node's ``diffuse:*``
        time overlaps its OWN ``fit`` time (the comm/compute overlap ROADMAP
        item 4 wants to create — ~0 while the stage machine serializes
        train -> gossip), plus the fleet-level fraction of diffusion time
        during which ANY node was fitting (the coordination headroom)."""
        fits: Dict[str, List[Tuple[float, float]]] = {}
        diffs: Dict[str, List[Tuple[float, float]]] = {}
        for s in self._fine:
            if rnd is not None and s.round != rnd:
                continue
            if s.name == "fit":
                fits.setdefault(s.node, []).append((s.start_s, s.end_s))
            elif s.name.startswith("diffuse:"):
                diffs.setdefault(s.node, []).append((s.start_s, s.end_s))
        all_fit = _merge_intervals([iv for l in fits.values() for iv in l])
        per_node = {}
        fit_total = sum(e - s for l in fits.values() for s, e in l)
        diff_total = 0.0
        same_node_overlap = 0.0
        fleet_overlap = 0.0
        for node, dl in diffs.items():
            dl_m = _merge_intervals(dl)
            node_diff = sum(e - s for s, e in dl_m)
            node_overlap = _intersection_s(dl_m, _merge_intervals(fits.get(node, [])))
            fleet = _intersection_s(dl_m, all_fit)
            diff_total += node_diff
            same_node_overlap += node_overlap
            fleet_overlap += fleet
            per_node[node] = {
                "diffuse_s": round(node_diff, 6),
                "overlap_with_own_fit_s": round(node_overlap, 6),
                "overlap_with_any_fit_s": round(fleet, 6),
            }
        return {
            "fit_total_s": round(fit_total, 6),
            "diffuse_total_s": round(diff_total, 6),
            "train_diffuse_overlap_s": round(same_node_overlap, 6),
            "train_diffuse_overlap_fraction": round(
                same_node_overlap / diff_total, 4
            )
            if diff_total > 0
            else 0.0,
            "diffuse_under_any_fit_fraction": round(fleet_overlap / diff_total, 4)
            if diff_total > 0
            else 0.0,
            "serialized_diffuse_s": round(diff_total - same_node_overlap, 6),
            "per_node": per_node,
            "note": "overlap_fraction ~0 means train -> diffuse is fully "
            "serialized on every node; serialized_diffuse_s is the headroom "
            "ROADMAP item 4 (comm/compute overlap) can reclaim",
        }

    # --- async window attribution --------------------------------------------

    def has_windows(self) -> bool:
        """True when the trace came from the async scheduler (window spans
        or close markers present)."""
        return bool(self._markers) or any(
            s.name in ("async_window_wait", "diffuse:async_model")
            for s in self._fine
        )

    def window_report(self, staleness_alpha: Optional[float] = None) -> Dict[str, Any]:
        """Per-window attribution for async (Papaya/FedBuff) traces.

        A window is a round to the backward gating walk — the async spans
        (``fit``, ``diffuse:async_model``, ``async_window_wait``) are
        registered fine spans, so :meth:`round_path` already answers "which
        CONTRIBUTOR gated this window" (the wait resolves through the
        ``recv:async_model`` whose arrival closed it, chasing back to the
        slow origin). On top of the walk, each window's ``window_close``
        marker (close reason, mean folded lag, fill) yields:

        * **close-reason breakdown** — fill target met vs live-shrunk
          target vs timeout, per window and aggregated;
        * **staleness-discount vs wall-clock attribution** — the two
          currencies the async scheduler can pay a straggler in: waiting
          for it (``wait_s``, wall-clock on the window's critical path) or
          accepting its stale contribution at a discount
          (``discount_fraction = 1 - (1+mean_lag)^-alpha``, aggregate
          weight given up to staleness). A fleet paying mostly wall-clock
          wants a smaller fill target; one paying mostly discount wants a
          larger alpha or a staleness cap.
        """
        if staleness_alpha is None:
            from p2pfl_tpu_torch.config import Settings

            staleness_alpha = Settings.ASYNC_STALENESS_ALPHA
        # Markers by window, newest-wins per (window, node); windows come
        # from markers AND fine spans (a window that died before its close
        # marker still shows its path).
        marks: Dict[int, List[Seg]] = {}
        for m in self._markers:
            if m.round is not None:
                marks.setdefault(m.round, []).append(m)
        windows = sorted(set(self.rounds()) | set(marks))
        out_windows: Dict[str, Any] = {}
        reason_counts: Dict[str, int] = {}
        gating_counts: Dict[str, int] = {}
        total_wait_s = 0.0
        discount_weighted = 0.0
        for w in windows:
            path = self.round_path(w)
            if path.gating_node:
                gating_counts[path.gating_node] = (
                    gating_counts.get(path.gating_node, 0) + 1
                )
            wait_s = sum(
                s.dur_s
                for s in self._fine
                if s.round == w and s.name == "async_window_wait"
            )
            total_wait_s += wait_s
            wmarks = marks.get(w, [])
            reasons = sorted({str(m.extra.get("reason", "")) for m in wmarks} - {""})
            for r in reasons:
                reason_counts[r] = reason_counts.get(r, 0) + 1
            lags = [
                float(m.extra.get("mean_lag", 0.0))
                for m in wmarks
                if m.extra.get("mean_lag") is not None
            ]
            mean_lag = sum(lags) / len(lags) if lags else 0.0
            discount = 1.0 - (1.0 + mean_lag) ** (-float(staleness_alpha))
            discount_weighted += discount
            fills = [
                int(m.extra.get("fill", 0)) for m in wmarks if m.extra.get("fill")
            ]
            out_windows[str(w)] = {
                "gating_contributor": path.gating_node,
                "wall_s": path.to_dict()["wall_s"],
                "coverage": path.to_dict()["coverage"],
                "wait_s": round(wait_s, 6),
                "close_reasons": reasons,
                "mean_lag": round(mean_lag, 4),
                "staleness_discount": round(discount, 4),
                "fill": max(fills) if fills else None,
                "attributed_by_node": path.to_dict()["attributed_by_node"],
            }
        top = (
            max(gating_counts, key=lambda n: gating_counts[n])
            if gating_counts
            else None
        )
        n_win = len(windows)
        return {
            "windows": out_windows,
            "close_reason_counts": dict(sorted(reason_counts.items())),
            "gating_counts": gating_counts,
            "top_gating_contributor": top,
            "top_gating_fraction": (
                round(gating_counts.get(top, 0) / n_win, 4) if top and n_win else 0.0
            ),
            "staleness_alpha": float(staleness_alpha),
            "wait_wall_s_total": round(total_wait_s, 6),
            "mean_staleness_discount": (
                round(discount_weighted / n_win, 4) if n_win else 0.0
            ),
            "note": "wait_wall_s_total is the wall-clock currency paid "
            "waiting on contributions; mean_staleness_discount is the "
            "aggregate-weight currency paid accepting stale ones",
        }

    def report(self) -> Dict[str, Any]:
        """The full attribution report: one entry per round plus aggregates."""
        rounds = self.rounds()
        paths = {r: self.round_path(r) for r in rounds}
        gating_counts: Dict[str, int] = {}
        for p in paths.values():
            if p.gating_node:
                gating_counts[p.gating_node] = gating_counts.get(p.gating_node, 0) + 1
        top = max(gating_counts, key=lambda n: gating_counts[n]) if gating_counts else None
        return {
            **({"window_report": self.window_report()} if self.has_windows() else {}),
            "rounds": {str(r): paths[r].to_dict() for r in rounds},
            "stage_shares_by_round": {
                str(r): self.stage_shares(r) for r in rounds
            },
            "stage_shares": self.stage_shares(),
            "overlap": self.overlap_report(),
            "gating_node_counts": gating_counts,
            "top_gating_node": top,
            "top_gating_fraction": round(
                gating_counts.get(top, 0) / len(rounds), 4
            )
            if top and rounds
            else 0.0,
            "nodes": self.nodes(),
        }


def _round_of(args: Dict[str, Any]) -> Optional[int]:
    r = args.get("round")
    try:
        return int(r) if r is not None else None
    except (TypeError, ValueError):
        return None


def _merge_intervals(ivs: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    if not ivs:
        return []
    ivs = sorted(ivs)
    out = [list(ivs[0])]
    for s, e in ivs[1:]:
        if s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def _intersection_s(
    a: List[Tuple[float, float]], b: List[Tuple[float, float]]
) -> float:
    total, i, j = 0.0, 0, 0
    while i < len(a) and j < len(b):
        lo = max(a[i][0], b[j][0])
        hi = min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def load_chrome_trace(path: str) -> Dict[str, Any]:
    """Read one exported trace document from disk (tiny convenience so the
    offline merge story is one import)."""
    with open(path) as f:
        return json.load(f)


__all__ = [
    "CriticalPathAnalyzer",
    "PathHop",
    "RoundPath",
    "Seg",
    "FINE_SPANS",
    "WAIT_RESOLVERS",
    "WINDOW_MARKER",
    "skew_from_registry",
    "load_chrome_trace",
]
