"""Federation observatory: assemble gossiped health digests into a fleet view (the port's framework-free copy of
``p2pfl_tpu/telemetry/observatory.py``, its imports rerouted to ``p2pfl_tpu_torch``).

Every node runs one :class:`Observatory` (owned by its communication
protocol). Peers' :class:`~p2pfl_tpu_torch.telemetry.digest.HealthDigest` frames
arrive on the heartbeat path (``CommunicationProtocol.handle_envelope``
feeds :meth:`Observatory.ingest`); the observatory keeps the latest digest
per peer plus enough history to derive federation-level health nobody
reports directly:

* **straggler score** — how far behind the fleet a peer is running, three
  components summed: round lag behind the fleet-max round; the positive
  z-score of the peer's ROUND-ENTRY LATENESS (seconds between the fleet
  leader entering the current round and this peer entering it — persistent
  for the whole round, unlike raw round lag, which the vote barrier erases
  within seconds when a straggler catches up); and the positive z-score of
  its step time against the fleet's step-time distribution (a peer in the
  current round whose steps crawl scores high too). APPFL's server does
  this centrally (arxiv 2409.11585); here every node derives it from
  gossip.
* **suspect score** — Byzantine suspicion: admission rejections the fleet
  attributes to this peer (``p2pfl_updates_rejected_total`` carries a
  ``source`` label exactly so digests can carry per-sender attribution),
  summed across every reporting observer.
* **link score** — local link quality to the peer: missed heartbeats and
  clock skew, read from the heartbeater's own gauges (these are facts about
  OUR link, so they come from the local registry, not from digests).

Population scale: the observatory is bounded in fleet size. Peers
whose digests stop arriving for ``Settings.OBS_PEER_TTL`` are EVICTED —
dropped from the per-peer table AND every scoring statistic (a crashed
peer must not skew straggler z-scores forever), counted
``p2pfl_fed_evicted_total``. Beyond ``Settings.OBS_MAX_TRACKED`` live
peers, new peers' digests fold into MERGED fleet sketches plus a bounded
worst-straggler candidate table instead of growing the per-peer dict — the
fleet quantile view (:meth:`fleet_quantiles`, built from the v2 digests'
mergeable sketches) stays exact-within-sketch-error while per-node memory
grows ~O(log n). Prometheus refreshes are rate-limited by
``Settings.OBS_REFRESH_MIN_S`` (each refresh is O(live peers)).

Exports: the ``p2pfl_fed_*`` Prometheus section, :meth:`snapshot` (the
JSON federation view ``scripts/fed_top.py`` renders live — now with a
``fleet`` quantile section), :meth:`top` (argmax helpers the benches
assert on), and :func:`write_snapshot_doc` (the atomic writer the fused-
mesh simulation reuses for its virtual-fleet snapshots).
"""

from __future__ import annotations

import json
import math
import os
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from collections import deque

from p2pfl_tpu_torch.config import Settings
from p2pfl_tpu_torch.telemetry.digest import HealthDigest
from p2pfl_tpu_torch.telemetry.metrics import REGISTRY
from p2pfl_tpu_torch.telemetry.sketches import DistinctEstimator, QuantileSketch

#: Membership churn tail kept (and snapshotted) per observatory.
MEMBERSHIP_EVENTS = 64

#: Top-N rows a population snapshot keeps per metric (and the unit of the
#: bounded overflow straggler-candidate table, which holds 4x this).
_TOP_CANDIDATES = 16

_PEER_ROUND = REGISTRY.gauge(
    "p2pfl_fed_peer_round",
    "Latest round a peer reported via its gossiped health digest",
    labels=("node", "peer"),
)
_STRAGGLER = REGISTRY.gauge(
    "p2pfl_fed_straggler_score",
    "Derived straggler score per peer (round lag + positive step-time "
    "z-score vs the fleet); higher = further behind",
    labels=("node", "peer"),
)
_SUSPECT = REGISTRY.gauge(
    "p2pfl_fed_suspect_score",
    "Derived Byzantine-suspect score per peer (admission rejections the "
    "fleet attributes to frames this peer sent)",
    labels=("node", "peer"),
)
_LINK = REGISTRY.gauge(
    "p2pfl_fed_link_score",
    "Local link-quality score per peer (missed heartbeats + |clock skew|); "
    "higher = worse link",
    labels=("node", "peer"),
)
_PEERS_KNOWN = REGISTRY.gauge(
    "p2pfl_fed_peers_known",
    "Peers (self included) with a live health digest in the observatory",
    labels=("node",),
)
_DIGESTS_RX = REGISTRY.counter(
    "p2pfl_fed_digests_rx_total",
    "Health digests ingested, by reporting peer",
    labels=("node", "peer"),
)
_EVICTED = REGISTRY.counter(
    "p2pfl_fed_evicted_total",
    "Peers evicted from the observatory after OBS_PEER_TTL with no digest "
    "(dead peers leave the scoring statistics instead of skewing them)",
    labels=("node",),
)
_OVERFLOW = REGISTRY.gauge(
    "p2pfl_fed_overflow_peers",
    "Peers folded into merged fleet sketches instead of per-peer tracking "
    "(population beyond OBS_MAX_TRACKED)",
    labels=("node",),
)

# --- device observatory (fused population engines) --------------------------
# The p2pfl_mesh_* family mirrors what the in-scan aux stream reports per
# chunk: the fused backends' headline vitals, scrapeable next to the wire's
# p2pfl_fed_* section. "node" is the engine label (mesh-sim /
# population-engine / asyncpop-engine).
_MESH_ROUND = REGISTRY.gauge(
    "p2pfl_mesh_round",
    "Absolute round/window cursor of a fused population engine",
    labels=("node",),
)
_MESH_LOSS = REGISTRY.gauge(
    "p2pfl_mesh_train_loss",
    "Cohort mean training loss of the last fused round/window, measured "
    "inside the compiled scan",
    labels=("node",),
)
_MESH_WEIGHT_MASS = REGISTRY.gauge(
    "p2pfl_mesh_weight_mass",
    "Fold-weight mass (sample-count x staleness discount) aggregated in "
    "the last fused round/window",
    labels=("node",),
)
_MESH_PARTICIPANTS = REGISTRY.counter(
    "p2pfl_mesh_participants_total",
    "Cumulative cohort members whose contributions folded into a fused "
    "aggregate",
    labels=("node",),
)
_MESH_TRIPS = REGISTRY.counter(
    "p2pfl_mesh_trips_total",
    "Health-tripwire trips inside the compiled scan, by kind "
    "(nonfinite | loss_diverge)",
    labels=("node", "kind"),
)
_MESH_PEAK_BYTES = REGISTRY.gauge(
    "p2pfl_mesh_device_peak_bytes",
    "Device memory watermark (peak bytes) observed around the last timed "
    "chunk of a fused run",
    labels=("node",),
)
_MESH_CHUNK_SECONDS = REGISTRY.gauge(
    "p2pfl_mesh_chunk_seconds",
    "Wall seconds of the last timed fused chunk (one _run_jit call)",
    labels=("node",),
)


def mesh_chunk_telemetry(
    node: str,
    *,
    round_cursor: Optional[int] = None,
    train_loss: Optional[float] = None,
    weight_mass: Optional[float] = None,
    participants: Optional[float] = None,
    chunk_seconds: Optional[float] = None,
    peak_bytes: Optional[float] = None,
) -> None:
    """Mirror one fused chunk's aux-stream summary into the p2pfl_mesh_*
    registry section. Never raises — a broken export must not break the
    chunk it was observing."""
    try:
        if round_cursor is not None:
            _MESH_ROUND.labels(node).set(float(round_cursor))
        if train_loss is not None:
            _MESH_LOSS.labels(node).set(float(train_loss))
        if weight_mass is not None:
            _MESH_WEIGHT_MASS.labels(node).set(float(weight_mass))
        if participants is not None and participants > 0:
            _MESH_PARTICIPANTS.labels(node).inc(float(participants))
        if chunk_seconds is not None:
            _MESH_CHUNK_SECONDS.labels(node).set(float(chunk_seconds))
        if peak_bytes is not None:
            _MESH_PEAK_BYTES.labels(node).set(float(peak_bytes))
    except Exception:  # noqa: BLE001
        pass


def mesh_trip(node: str, kind: str) -> None:
    """Count one tripwire trip (kind: nonfinite | loss_diverge)."""
    try:
        _MESH_TRIPS.labels(node, kind).inc()
    except Exception:  # noqa: BLE001
        pass

#: A digest older than this many seconds is stale: its peer stops counting
#: toward fleet statistics (it is probably dead and the heartbeater will
#: sweep it; keeping its frozen round would poison the round-lag baseline).
STALE_AFTER_S = 60.0

#: Round-entry lateness below this (seconds) never contributes to the
#: straggler score: every healthy fleet has a statistically-latest member,
#: and sub-second entry skew is gossip jitter, not straggling.
LATENESS_FLOOR_S = 1.0


class Observatory:
    """Per-node fleet view assembled from gossiped health digests.

    Thread-safe: ingest runs on transport threads, snapshots on whatever
    thread asks (bench pollers, ``fed_top`` writers, tests).
    """

    def __init__(self, addr: str, recorder: Optional[Any] = None) -> None:
        self._addr = addr
        self._lock = threading.Lock()
        #: peer -> (digest, local-monotonic arrival time)
        self._peers: Dict[str, Tuple[HealthDigest, float]] = {}
        #: peer -> (round, local-monotonic time the peer's digests FIRST
        #: reported that round) — the round-entry lateness base.
        self._entries: Dict[str, Tuple[int, float]] = {}
        #: membership churn tail: the last MEMBERSHIP_EVENTS join/rejoin/
        #: leave transitions this observatory witnessed (first digest from an
        #: unknown peer = join; after a forget = rejoin; forget = leave) —
        #: surfaced in the snapshot so ``fed_top`` shows churn live.
        self._membership: deque = deque(maxlen=MEMBERSHIP_EVENTS)
        self._ever_seen: set = set()
        #: peers that left via forget (suspected death) or TTL eviction —
        #: their NEXT appearance is a "recover" heal, not a plain rejoin,
        #: and their scoring state starts fresh.
        self._forgotten: set = set()
        #: peers whose "recover" event was already emitted (explicit
        #: peer_recovered from the heal detector) — the digest that follows
        #: must not emit a second membership event.
        self._returned: set = set()
        #: peer -> missed-beat counter value at its last recovery: the link
        #: score reads misses ABOVE this baseline, so a healed peer does not
        #: inherit every beat the partition ate.
        self._link_baseline: Dict[str, float] = {}
        #: optional flight recorder — membership transitions are postmortem-
        #: worthy events (Node/protocol wire the per-node recorder in).
        self.recorder = recorder
        self._peers_known = _PEERS_KNOWN.labels(addr)
        self._evicted = _EVICTED.labels(addr)
        self._overflow_gauge = _OVERFLOW.labels(addr)
        # Population-overflow state: beyond Settings.OBS_MAX_TRACKED live
        # peers, new peers' digests fold here instead of into _peers —
        # merged fleet sketches (mergeable by construction) + a bounded
        # worst-round-lag candidate table so the top-straggler question
        # still has an answer among untracked peers.
        self._overflow_sketches: Dict[str, QuantileSketch] = {}
        self._overflow_distinct: Optional[DistinctEstimator] = None
        self._overflow_seen: set = set()  # addresses folded at least once
        self._overflow_top: Dict[str, Tuple[float, int]] = {}  # peer -> (lag, round)
        self._last_evict = 0.0  # monotonic; eviction sweep throttle
        self._last_refresh = 0.0  # monotonic; Prometheus refresh throttle

    def _membership_event(self, event: str, peer: str) -> None:
        # caller holds the lock
        self._membership.append(
            {"event": event, "peer": peer, "ts": round(time.time(), 3)}
        )
        rec = self.recorder
        if rec is not None:
            try:
                rec.record("membership", event=event, peer=peer)
            except Exception:  # noqa: BLE001 — observability must not raise
                pass
        # Trajectory ledger: this method is THE membership choke point —
        # join/rejoin/leave/evict/recover all pass through here, so the
        # ledger's membership stream needs exactly one emission site.
        from p2pfl_tpu_torch.telemetry.ledger import LEDGERS

        LEDGERS.emit(self._addr, "membership", event=event, peer=peer)

    # --- ingest --------------------------------------------------------------

    def ingest(self, dig: HealthDigest) -> bool:
        """Record a peer's digest (or our own — the self view rides the same
        path). Returns True when the peer's round or stage CHANGED — the
        signal the flight recorder logs as a digest-delta event.

        Memory bounds: an unknown peer arriving while the per-peer table is
        at ``OBS_MAX_TRACKED`` folds into the overflow fleet sketches (and,
        when its round lag is among the worst, the bounded straggler-
        candidate table) instead of growing the table; peers silent past
        ``OBS_PEER_TTL`` are evicted by the sweep this call triggers.
        """
        now = time.monotonic()
        self._evict_expired(now)
        with self._lock:
            prev = self._peers.get(dig.node)
            # Out-of-order delivery (gossip re-forwarding): keep the newest
            # by sender timestamp when both carry one.
            if prev is not None and dig.ts and prev[0].ts and dig.ts < prev[0].ts:
                return False
            if prev is None and dig.node != self._addr:
                if len(self._peers) >= max(8, int(Settings.OBS_MAX_TRACKED)):
                    self._fold_overflow(dig)
                    return False
                if dig.node in self._returned:
                    # The heal detector already announced this recovery and
                    # reset the peer's stats — no second membership event.
                    self._returned.discard(dig.node)
                elif dig.node in self._forgotten:
                    # Reappearance after suspected death / TTL eviction: a
                    # heal. Scoring state starts fresh — stale pre-partition
                    # z-stats must not outlive the partition.
                    self._recover_locked(dig.node)
                else:
                    self._membership_event(
                        "rejoin" if dig.node in self._ever_seen else "join",
                        dig.node,
                    )
            self._ever_seen.add(dig.node)
            self._peers[dig.node] = (dig, now)
            entry = self._entries.get(dig.node)
            if entry is None or entry[0] != dig.round:
                self._entries[dig.node] = (dig.round, now)
        if dig.node != self._addr:
            _DIGESTS_RX.labels(self._addr, dig.node).inc()
        self._refresh()
        return prev is None or prev[0].round != dig.round or prev[0].stage != dig.stage

    def _fold_overflow(self, dig: HealthDigest) -> None:
        """Population-overflow path (caller holds the lock): merge the
        digest's sketches into the fleet aggregate and keep the peer only
        if it belongs in the bounded worst-straggler candidate table."""
        self._overflow_seen.add(dig.node)
        self._overflow_gauge.set(len(self._overflow_seen))
        for name in dig.sketches:
            if name == "__distinct__":
                est = dig.distinct()
                if est is not None:
                    if self._overflow_distinct is None:
                        self._overflow_distinct = est
                    else:
                        self._overflow_distinct.merge_in(est)
                continue
            sk = dig.sketch(name)
            if sk is None:
                continue
            mine = self._overflow_sketches.get(name)
            if mine is None:
                self._overflow_sketches[name] = sk
            else:
                mine.merge_in(sk)
        # Worst-straggler candidates among the untracked mass: keyed by raw
        # round index (the fleet-max baseline is applied at read time).
        cap = 4 * _TOP_CANDIDATES
        if dig.round >= 0:
            self._overflow_top[dig.node] = (float(dig.round), dig.round)
            if len(self._overflow_top) > cap:
                # Drop the LEAST-behind candidate (highest round).
                drop = max(self._overflow_top, key=lambda p: self._overflow_top[p][0])
                self._overflow_top.pop(drop, None)

    def _evict_expired(self, now: float) -> None:
        """Drop peers whose last digest is older than OBS_PEER_TTL — they
        leave the scoring statistics entirely (STALE_AFTER_S only hides a
        peer from the live set; eviction frees its memory and its round-
        entry record, which would otherwise skew lateness baselines
        forever). Throttled to ~1/s: the sweep is O(peers)."""
        ttl = float(Settings.OBS_PEER_TTL)
        if ttl <= 0.0 or now - self._last_evict < 1.0:
            return
        self._last_evict = now
        evicted: List[str] = []
        with self._lock:
            for peer, (_, seen) in list(self._peers.items()):
                if peer != self._addr and now - seen > ttl:
                    self._peers.pop(peer, None)
                    self._entries.pop(peer, None)
                    self._forgotten.add(peer)  # a return after TTL is a heal
                    evicted.append(peer)
                    self._membership_event("evict", peer)
        for _ in evicted:
            self._evicted.inc()

    def forget(self, peer: str) -> None:
        """Drop a peer's entry (heartbeat sweep declared it dead)."""
        with self._lock:
            known = self._peers.pop(peer, None) is not None
            self._entries.pop(peer, None)
            if known:
                self._membership_event("leave", peer)
                self._forgotten.add(peer)
        self._refresh()

    def _recover_locked(self, peer: str) -> None:
        """Heal bookkeeping (caller holds the lock): emit the "recover"
        membership event (mirrored to the flight recorder like every other
        membership transition) and reset the peer's scoring state — its
        round-entry clock restarts, and the link score's missed-beat
        baseline moves to NOW so partition-era misses stop counting."""
        self._forgotten.discard(peer)
        self._entries.pop(peer, None)
        self._link_baseline[peer] = self._missed_beats(peer)
        self._membership_event("recover", peer)

    def peer_recovered(self, peer: str) -> None:
        """Explicit heal notification (the protocol's heal detector saw a
        failure-departed peer come back): announce the recovery and reset
        the peer's scoring state. The digest that follows re-populates the
        table without a duplicate membership event."""
        with self._lock:
            self._recover_locked(peer)
            self._returned.add(peer)
        self._refresh()

    # --- derived health ------------------------------------------------------

    def _live(self) -> List[Tuple[HealthDigest, float]]:
        now = time.monotonic()
        with self._lock:
            return [
                (d, seen) for d, seen in self._peers.values()
                if now - seen <= STALE_AFTER_S
            ]

    def scores(self) -> Dict[str, Dict[str, float]]:
        """{peer: {straggler, suspect, link, round, age_s}} over live
        digests. Scores are comparable within one observatory; the bench
        contract is about the ARGMAX (top straggler / top suspect), not
        absolute values."""
        live = self._live()
        now = time.monotonic()
        if not live:
            return {}
        # Fleet baselines. Round lag is measured against the fleet-max
        # round among live digests; step times against the fleet mean/std.
        max_round = max(d.round for d, _ in live)
        step_times = [1.0 / d.steps_per_s for d, _ in live if d.steps_per_s > 0]
        mean_st = sum(step_times) / len(step_times) if step_times else 0.0
        var_st = (
            sum((t - mean_st) ** 2 for t in step_times) / len(step_times)
            if step_times
            else 0.0
        )
        std_st = math.sqrt(var_st)
        # Round-entry lateness: seconds behind the FIRST peer to enter the
        # fleet-max round. A straggler that catches up at the next vote
        # barrier erases its round-index lag within seconds, but its late
        # entry stays on the books for the whole round — this is what keeps
        # the straggler score up between the transient lag windows.
        with self._lock:
            entries = dict(self._entries)
        lead_entry: Optional[float] = None
        if max_round >= 0:
            at_max = [
                t for r, t in entries.values() if r == max_round
            ]
            if at_max:
                lead_entry = min(at_max)
        lateness: Dict[str, float] = {}
        for d, _ in live:
            if d.round < 0 or lead_entry is None:
                lateness[d.node] = 0.0
            elif d.round == max_round:
                lateness[d.node] = max(
                    0.0, entries.get(d.node, (max_round, now))[1] - lead_entry
                )
            else:  # still hasn't entered the fleet round — clock keeps running
                lateness[d.node] = max(0.0, now - lead_entry)
        mean_lt = sum(lateness.values()) / len(lateness) if lateness else 0.0
        var_lt = (
            sum((t - mean_lt) ** 2 for t in lateness.values()) / len(lateness)
            if lateness
            else 0.0
        )
        std_lt = math.sqrt(var_lt)
        # Suspect attribution: sum every observer's rejected_by_source.
        attributed: Dict[str, float] = {}
        for d, _ in live:
            for src, n in d.rejected_by_source.items():
                attributed[src] = attributed.get(src, 0.0) + float(n)
        out: Dict[str, Dict[str, float]] = {}
        for d, seen in live:
            lag = float(max(0, max_round - d.round)) if d.round >= 0 else 0.0
            z = 0.0
            if d.steps_per_s > 0 and std_st > 1e-9:
                z = max(0.0, ((1.0 / d.steps_per_s) - mean_st) / std_st)
            lz = 0.0
            lt = lateness.get(d.node, 0.0)
            if std_lt > 1e-9 and lt >= LATENESS_FLOOR_S:
                lz = max(0.0, (lt - mean_lt) / std_lt)
            straggler = lag + lz + z
            suspect = attributed.get(d.node, 0.0)
            link = 0.0
            if d.node != self._addr:
                link = self._link_score(d.node)
            out[d.node] = {
                "straggler": round(straggler, 4),
                "suspect": round(suspect, 4),
                "link": round(link, 4),
                "round": float(d.round),
                "age_s": round(now - seen, 3),
            }
        return out

    def _missed_beats(self, peer: str) -> float:
        missed = REGISTRY.get("p2pfl_heartbeat_missed_total")
        if missed is None:
            return 0.0
        return sum(
            child.value
            for labels, child in missed.samples()
            if labels.get("node") == self._addr and labels.get("peer") == peer
        )

    def _link_score(self, peer: str) -> float:
        """Missed beats + |clock skew| for OUR link to ``peer`` (heartbeater
        gauges — already computed locally, not gossiped). Misses below the
        peer's recovery baseline don't count: a healed partition survivor
        starts its link score fresh instead of inheriting every beat the
        partition ate."""
        score = max(
            0.0, self._missed_beats(peer) - self._link_baseline.get(peer, 0.0)
        )
        skew = REGISTRY.get("p2pfl_heartbeat_clock_skew_seconds")
        if skew is not None:
            for labels, child in skew.samples():
                if labels.get("node") == self._addr and labels.get("peer") == peer:
                    score += abs(child.value)
        return score

    def suspect_score(self, peer: str) -> float:
        """Fleet-attributed Byzantine suspicion for ``peer``: the sum of
        admission rejections every live digest attributes to frames it sent.
        Unlike :meth:`scores`, this answers for ANY address — an adversary
        that poisons the model plane while never reporting digests of its
        own must still be gateable (async participation control)."""
        total = 0.0
        for d, _ in self._live():
            total += float(d.rejected_by_source.get(peer, 0.0))
        return total

    def fleet_quantiles(self) -> Dict[str, Any]:
        """Fleet-level distribution view, merged from the v2 digests'
        sketches (live tracked peers + the population overflow aggregate):
        ``{metric: {p50, p90, p99, count, mean}}`` plus the HyperLogLog
        ``distinct_contributors`` estimate. Metrics nobody reported are
        absent; v1 peers simply contribute nothing here."""
        distinct: Optional[DistinctEstimator] = None
        now = time.monotonic()
        with self._lock:
            live = [
                d for d, seen in self._peers.values()
                if now - seen <= STALE_AFTER_S
            ]
            merged = {k: v.copy() for k, v in self._overflow_sketches.items()}
            if self._overflow_distinct is not None:
                distinct = DistinctEstimator(self._overflow_distinct.m)
                distinct._registers = bytearray(self._overflow_distinct._registers)
        for d in live:
            for name in d.sketches:
                if name == "__distinct__":
                    est = d.distinct()
                    if est is not None:
                        if distinct is None:
                            distinct = est
                        else:
                            distinct.merge_in(est)
                    continue
                sk = d.sketch(name)
                if sk is None:
                    continue
                mine = merged.get(name)
                if mine is None:
                    merged[name] = sk
                else:
                    mine.merge_in(sk)
        out: Dict[str, Any] = {}
        for name, sk in sorted(merged.items()):
            if sk.count <= 0:
                continue
            q = sk.quantiles()
            out[name] = {
                "p50": round(q["p50"], 6),
                "p90": round(q["p90"], 6),
                "p99": round(q["p99"], 6),
                "count": sk.count,
                "mean": round(sk.mean, 6),
            }
        if distinct is not None:
            out["distinct_contributors"] = round(distinct.estimate(), 1)
        return out

    def estimated_memory_bytes(self) -> int:
        """Rough per-node observatory footprint: encoded size of every
        tracked digest plus the overflow aggregate's wire size. The bench
        plots this against fleet size — it must plateau (tracked peers cap
        at OBS_MAX_TRACKED, overflow state is O(sketch bins))."""
        total = 0
        with self._lock:
            for d, _ in self._peers.values():
                try:
                    total += len(d.encode())
                except Exception:  # noqa: BLE001
                    total += 512
            for sk in self._overflow_sketches.values():
                total += len(json.dumps(sk.to_wire()))
            total += 64 * len(self._entries)
            total += 80 * len(self._overflow_top)
            if self._overflow_distinct is not None:
                total += self._overflow_distinct.m
        return total

    def top(self, metric: str) -> Optional[str]:
        """Peer (never self) with the highest nonzero ``metric`` score —
        ``"straggler"`` | ``"suspect"`` | ``"link"``. None when no peer
        scores above zero (a healthy fleet has no top straggler)."""
        best, best_score = None, 0.0
        for peer, s in self.scores().items():
            if peer == self._addr:
                continue
            if s.get(metric, 0.0) > best_score:
                best, best_score = peer, s[metric]
        return best

    # --- export --------------------------------------------------------------

    def _refresh(self) -> None:
        """Mirror the derived view into the p2pfl_fed_* registry section.

        Rate-limited by ``Settings.OBS_REFRESH_MIN_S``: the derivation is
        O(live peers), and at population scale a per-beat refresh would make
        ingest quadratic. 0 (default) refreshes on every ingest."""
        now = time.monotonic()
        min_s = float(Settings.OBS_REFRESH_MIN_S)
        if min_s > 0.0 and now - self._last_refresh < min_s:
            return
        self._last_refresh = now
        scores = self.scores()
        for peer, s in scores.items():
            _PEER_ROUND.labels(self._addr, peer).set(s["round"])
            _STRAGGLER.labels(self._addr, peer).set(s["straggler"])
            _SUSPECT.labels(self._addr, peer).set(s["suspect"])
            if peer != self._addr:
                _LINK.labels(self._addr, peer).set(s["link"])
        self._peers_known.set(len(scores))

    def snapshot(self) -> Dict[str, Any]:
        """JSON-able federation view: every live peer's latest digest plus
        the derived scores — what ``scripts/fed_top.py`` renders."""
        live = self._live()
        scores = self.scores()
        peers: Dict[str, Any] = {}
        for d, _ in live:
            stale_sk = d.sketch("staleness")
            entry = {
                "ts": d.ts,
                "version": d.version,
                "staleness_p90": (
                    round(stale_sk.quantile(0.9), 4)
                    if stale_sk is not None and stale_sk.count > 0
                    else None
                ),
                "round": d.round,
                "total_rounds": d.total_rounds,
                "stage": d.stage,
                "mode": d.mode,
                "staleness": d.staleness,
                "steps_per_s": d.steps_per_s,
                "jit_compile_s": d.jit_compile_s,
                "tx_bytes": d.tx_bytes,
                "tx_by_codec": dict(d.tx_by_codec),
                "rx_bytes": d.rx_bytes,
                "queue_depth": d.queue_depth,
                "agg_waits": d.agg_waits,
                "agg_wait_s": d.agg_wait_s,
                "contributors": d.contributors,
                "rejections": dict(d.rejections),
                "rejected_by_source": dict(d.rejected_by_source),
                "faults_seen": d.faults_seen,
                "dp_epsilon": d.dp_epsilon,
                # Supervisor vitals: None for unsupervised/older peers —
                # fed_top renders "-" (cross-version tolerance is the
                # digest decoder's absent-field default).
                "restarts": getattr(d, "restarts", None),
                "degrade": getattr(d, "degrade", None),
                "mem_bytes": d.mem_bytes,
                "scores": scores.get(d.node, {}),
            }
            peers[d.node] = entry
        with self._lock:
            membership = list(self._membership)
            overflow_peers = len(self._overflow_seen)
            # The most-behind untracked peers (lowest reported round): the
            # top-straggler question keeps an answer beyond the tracking cap.
            overflow_worst = [
                {"peer": p, "round": rnd}
                for p, (key, rnd) in sorted(
                    self._overflow_top.items(), key=lambda kv: kv[1][0]
                )[:_TOP_CANDIDATES]
            ]
        doc = {
            "observer": self._addr,
            "written_at": time.time(),
            "peers": peers,
            "fleet": {
                "tracked_peers": len(peers),
                "overflow_peers": overflow_peers,
                "size": len(peers) + overflow_peers,
                "overflow_stragglers": overflow_worst,
                "quantiles": self.fleet_quantiles(),
            },
            "membership_events": membership,
            "top_straggler": self.top("straggler"),
            "top_suspect": self.top("suspect"),
        }
        # Trajectory-ledger tail: the observer's last few canonical events
        # ride the snapshot so fed_top's PARITY panel shows what the
        # federation just DID (rounds opened, contributions folded,
        # aggregates committed) next to how it is doing.
        from p2pfl_tpu_torch.telemetry.ledger import LEDGERS

        led = LEDGERS.peek(self._addr)
        tail_n = int(Settings.LEDGER_SNAPSHOT_TAIL)
        if led is not None and tail_n > 0:
            doc["ledger"] = {
                "run_id": led.run_id,
                "events": led.tail(tail_n),
            }
        return doc

    def write_snapshot(self, path: str) -> str:
        """Atomically write :meth:`snapshot` as JSON to ``path`` (the file
        ``fed_top.py`` polls). Returns the path."""
        return write_snapshot_doc(path, self.snapshot())

    def reset(self) -> None:
        with self._lock:
            self._peers.clear()
            self._entries.clear()
            self._membership.clear()
            self._ever_seen.clear()
            self._forgotten.clear()
            self._returned.clear()
            self._link_baseline.clear()
            self._overflow_sketches.clear()
            self._overflow_top.clear()
            self._overflow_seen.clear()
            self._overflow_distinct = None
        self._peers_known.set(0)
        self._overflow_gauge.set(0)


#: snapshot-doc schema: v2 added the common versioned "header" block
#: (run_id / schema_version / node / clock era); old readers that only
#: know "observer"/"peers"/"fleet" keep working.
SNAPSHOT_SCHEMA_VERSION = 2


def write_snapshot_doc(path: str, doc: Dict[str, Any]) -> str:
    """Atomically write a federation-snapshot document (tmp + rename, the
    contract ``fed_top.py`` polls against). Shared by the real-wire
    observatory and the fused-mesh virtual-fleet snapshot — which makes it
    the single choke point stamping the run-correlated artifact header."""
    from p2pfl_tpu_torch.telemetry.bundle import artifact_header

    doc.setdefault(
        "header",
        artifact_header(
            node=str(doc.get("observer", "")),
            kind="snapshot",
            schema_version=SNAPSHOT_SCHEMA_VERSION,
        ),
    )
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    # pid alone collides when two node threads write the same doc path
    tmp = f"{path}.tmp.{os.getpid()}.{threading.get_ident()}"
    with open(tmp, "w") as f:
        json.dump(doc, f, indent=1, sort_keys=True)
    os.replace(tmp, path)
    return path


def population_snapshot(
    observer: str,
    node_names: List[str],
    metrics: Dict[str, Any],
    top_n: int = _TOP_CANDIDATES,
    rel_err: Optional[float] = None,
    extras: Optional[Dict[str, Any]] = None,
    extra_sketches: Optional[Dict[str, QuantileSketch]] = None,
) -> Dict[str, Any]:
    """Build a fed_top-renderable snapshot from PER-NODE metric arrays —
    through the REAL :class:`Observatory` ingestion path.

    The fused-mesh simulation's observability path: the jitted round
    program computes per-virtual-node health arrays (round lag, step time,
    participation, rejections), and this helper routes them through a real
    observatory exactly like the wire does — the worst ``top_n`` stragglers
    become synthesized :class:`HealthDigest` frames fed to
    :meth:`Observatory.ingest` (membership events, scoring, Prometheus
    refresh and all), while the remaining population mass takes the same
    overflow fold a beyond-``OBS_MAX_TRACKED`` wire fleet takes (merged
    fleet sketches + the bounded worst-straggler candidate table). The
    returned document therefore IS an ``Observatory.snapshot()`` — same
    producer, same shape — so a 100k-vnode mesh run renders in the same
    ``fed_top`` view as an 8-node real-wire federation, and
    :func:`snapshot_shape_diff` can assert the parity.

    ``metrics`` maps metric name -> array-like of length ``len(node_names)``.
    Straggler SELECTION (which vnodes get tracked) uses the full-population
    ordering ``round_lag + positive step-time z``; the per-peer scores in
    the document then come from the observatory's own scorer over the
    tracked set. Quantile mass is folded ONCE: the full arrays go into the
    overflow sketches via one vectorized ``add_many`` per metric, and the
    synthesized digests deliberately carry no sketches of their own.

    ``extras`` (optional) is the device-observatory side channel — cohort
    train loss, update-norm summary, device memory watermark, tripwire
    state — stamped onto every tracked vnode row (``loss`` / ``gnorm`` /
    ``trip`` / ``mem_bytes``) and echoed as ``doc["devobs"]`` for the
    bench. ``extra_sketches`` merges in-scan device sketches (e.g. the
    ``update_norm`` buckets folded through ``SKETCHES``) into the fleet
    quantile view.
    """
    import numpy as np

    if rel_err is None:
        rel_err = Settings.SKETCH_REL_ERR
    n = len(node_names)
    arrays = {
        k: np.asarray(v, np.float64).ravel() for k, v in metrics.items()
    }
    for k, a in arrays.items():
        if a.shape != (n,):
            raise ValueError(
                f"metric {k!r} has shape {a.shape}, expected ({n},)"
            )
    lag = arrays.get("round_lag", np.zeros(n))
    step = arrays.get("step_time", np.zeros(n))
    rej = arrays.get("rejections", np.zeros(n))
    rounds_arr = arrays.get("round")
    part = arrays.get("participation")
    stale = arrays.get("staleness")
    # Straggler SELECTION over the full population mirrors the real
    # observatory's score shape: round lag plus positive step-time z.
    std = float(step.std())
    z = np.maximum(0.0, (step - float(step.mean())) / std) if std > 1e-12 else np.zeros(n)
    straggler = lag + z
    full_order = np.argsort(-straggler, kind="stable")
    order = full_order[: max(1, int(top_n))].tolist()
    # Track the worst SUSPECTS too (nonzero fleet-attributed rejections): a
    # Byzantine vnode is postmortem-worthy even when it isn't a straggler,
    # and the wire's top_suspect question needs it in the per-peer table to
    # have an answer.
    for i in np.argsort(-rej, kind="stable")[: max(1, int(top_n))].tolist():
        if rej[i] > 0 and i not in order:
            order.append(i)
    tracked = {node_names[i] for i in order}

    obs = Observatory(observer)
    now = time.time()
    max_round = int(rounds_arr.max()) if rounds_arr is not None and n else -1
    # The observer's self view rides the same path as on the wire — and
    # carries the fleet's per-sender rejection attribution, which is how
    # the real scorer derives suspect scores.
    obs.ingest(
        HealthDigest(
            node=observer,
            ts=now,
            round=max_round,
            stage="observer",
            mode="fused",
            rejected_by_source={
                node_names[i]: float(rej[i]) for i in order if rej[i] > 0
            },
        )
    )
    for i in order:
        obs.ingest(
            HealthDigest(
                node=node_names[i],
                ts=now,
                round=int(rounds_arr[i]) if rounds_arr is not None else -1,
                stage="virtual",
                mode="",
                staleness=float(stale[i]) if stale is not None else 0.0,
                steps_per_s=(1.0 / float(step[i])) if step[i] > 0 else 0.0,
                contributors=float(part[i]) if part is not None else 0.0,
            )
        )
    # Everyone else takes the population-overflow path: ALL quantile mass
    # (tracked rows included — their digests carry no sketches, so nothing
    # is counted twice) folds into the merged fleet sketches in one
    # vectorized pass per metric, and the worst untracked stragglers fill
    # the bounded candidate table the snapshot's overflow section reads.
    with obs._lock:
        for k, a in sorted(arrays.items()):
            sk = QuantileSketch(
                rel_err=rel_err, max_bins=Settings.SKETCH_MAX_BINS
            )
            sk.add_many(a)
            obs._overflow_sketches[k] = sk
        if extra_sketches:
            for k, sk in sorted(extra_sketches.items()):
                if sk is None or sk.count <= 0:
                    continue
                mine = obs._overflow_sketches.get(k)
                if mine is None:
                    obs._overflow_sketches[k] = sk.copy()
                else:
                    mine.merge_in(sk.copy())
        obs._overflow_seen.update(
            nm for nm in node_names if nm not in tracked
        )
        cap = 4 * _TOP_CANDIDATES
        for i in full_order.tolist():
            if len(obs._overflow_top) >= cap:
                break
            if node_names[i] in tracked:
                continue
            rnd = int(rounds_arr[i]) if rounds_arr is not None else -1
            obs._overflow_top[node_names[i]] = (float(rnd), rnd)
    obs._overflow_gauge.set(len(obs._overflow_seen))

    doc = obs.snapshot()
    doc["virtual"] = True
    fill = arrays.get("cohort_fill")
    win = arrays.get("window")
    wfill = arrays.get("window_fill")
    for i in order:
        entry = doc["peers"].get(node_names[i])
        if entry is None:
            continue
        # Realized solicitation fraction under cohort sampling (the
        # population engine's fairness metric); None when the run carried
        # no cohort_fill array — fed_top prints "-" then. window /
        # window_fill likewise are async-population facts: the last window
        # this vnode folded into (-1: never) and its realized fold
        # fraction; None on sync runs.
        entry["cohort_fill"] = (
            round(float(fill[i]), 4) if fill is not None else None
        )
        entry["window"] = int(win[i]) if win is not None else None
        entry["window_fill"] = (
            round(float(wfill[i]), 4) if wfill is not None else None
        )
        if extras:
            entry["loss"] = extras.get("train_loss")
            entry["gnorm"] = extras.get("update_norm_p90")
            entry["trip"] = extras.get("tripped")
            if extras.get("mem_bytes"):
                entry["mem_bytes"] = float(extras["mem_bytes"])
    if extras:
        doc["devobs"] = dict(extras)
    return doc


def snapshot_shape_diff(
    fused: Dict[str, Any], wire: Dict[str, Any]
) -> List[str]:
    """Shape-parity check between a fused population snapshot and a wire
    ``Observatory.snapshot()``: every key family the wire document exposes
    must exist in the fused one (the fused doc may carry extras — cohort
    fill, devobs columns — but never less). Returns the missing keys,
    prefixed ``top-level:`` / ``peer:`` / ``fleet:``; empty means parity."""

    def peer_keys(doc: Dict[str, Any]) -> set:
        ks: set = set()
        for p in (doc.get("peers") or {}).values():
            if isinstance(p, dict):
                ks |= set(p)
        return ks

    out = [f"top-level:{k}" for k in sorted(set(wire) - set(fused))]
    out += [f"peer:{k}" for k in sorted(peer_keys(wire) - peer_keys(fused))]
    out += [
        f"fleet:{k}"
        for k in sorted(
            set(wire.get("fleet") or {}) - set(fused.get("fleet") or {})
        )
    ]
    return out


__all__ = [
    "Observatory",
    "SNAPSHOT_SCHEMA_VERSION",
    "STALE_AFTER_S",
    "mesh_chunk_telemetry",
    "mesh_trip",
    "population_snapshot",
    "snapshot_shape_diff",
    "write_snapshot_doc",
]
