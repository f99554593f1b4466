"""Gossiped health digests: one node's vitals, compact enough to ride a beat (the port's framework-free copy of
``p2pfl_tpu/telemetry/digest.py``, its imports rerouted to ``p2pfl_tpu_torch``).

In a decentralized federation there is no coordinator to scrape the
telemetry registry, so every node's rich local view is trapped in its
own process. The fix is to make observability itself ride the membership
wire: each node periodically snapshots a :class:`HealthDigest` — current
round/stage, learner throughput, wire traffic, aggregation progress,
admission rejections (attributed per sender), chaos faults, device memory —
and piggybacks it on the heartbeat it was already broadcasting.

Wire format: the encoded digest travels in ``Envelope.digest`` (carried
natively by the in-memory transport; the gRPC transport maps it onto a
reserved trailing control arg with :data:`WIRE_ARG_PREFIX`, exactly like
``Envelope.trace`` — see ``grpc_protocol._env_to_pb``). The payload itself
is versioned compact JSON:

* **absent digests are fine** — a digest-free (older) node's beats dispatch
  unchanged, and its peers simply have no fleet entry for it;
* **unknown versions are tolerated** — :func:`decode` keeps every field it
  recognizes and ignores the rest, so a newer node's digest still feeds an
  older observatory instead of breaking membership.

The federation-wide assembly of these digests lives in
:mod:`p2pfl_tpu_torch.telemetry.observatory`.
"""

from __future__ import annotations

import json
import logging
import os
import time
from dataclasses import asdict, dataclass, field
from typing import Any, Dict, Optional

from p2pfl_tpu_torch.telemetry.metrics import REGISTRY
from p2pfl_tpu_torch.telemetry.sketches import SKETCHES

log = logging.getLogger("p2pfl_tpu_torch")

#: Bump when the digest schema changes incompatibly. Decoders keep reading
#: newer digests best-effort (known fields only). v2 adds the ``sk`` sketch
#: table (mergeable quantile sketches + distinct-contributor estimator);
#: v1 digests decode with an empty table and stay first-class citizens.
DIGEST_VERSION = 2

#: Reserved prefix for the trailing gRPC control-frame digest arg (the
#: ``__trace__:`` pattern — the proto schema predates digests and protoc is
#: not in the image to regenerate it).
WIRE_ARG_PREFIX = "__digest__:"

#: Digest payloads above this are dropped at decode: a v2 digest is a few
#: KB of JSON (four bounded sketches + scalars — size is a function of the
#: bin cap, NOT of fleet size or stream length); anything larger is corrupt
#: or hostile (heartbeats must stay cheap — they are the failure detector).
MAX_DIGEST_BYTES = 16384

#: Per-sketch wire bucket cap inside a digest (in-memory sketches may hold
#: Settings.SKETCH_MAX_BINS; the wire form re-collapses to this).
DIGEST_SKETCH_BINS = 48


@dataclass
class HealthDigest:
    """One node's self-reported vitals at a point in time.

    All counters are cumulative process-lifetime values (the observatory
    differentiates); gauges are instantaneous. Unknown/unavailable values
    stay at their defaults — consumers must treat 0/-1/"" as "not reported".
    """

    node: str
    ts: float = 0.0  # sender wall clock (time.time())
    version: int = DIGEST_VERSION
    # Round machine.
    round: int = -1  # -1: no experiment in progress
    total_rounds: int = -1
    stage: str = ""
    # Scheduler ("sync" | "async"; "" when idle or from an older peer). In
    # async mode ``round`` counts WINDOWS and ``staleness`` is the mean
    # window lag folded in the node's last aggregation — the fleet sees who
    # is consuming fresh contributions and who is surviving on stale ones.
    mode: str = ""
    staleness: float = 0.0
    # Learner.
    steps_per_s: float = 0.0
    jit_compile_s: float = 0.0
    # Wire.
    tx_bytes: float = 0.0
    rx_bytes: float = 0.0
    queue_depth: float = 0.0
    # Model-plane TX bytes split by wire codec (topk / topk-int8 / topk-int4
    # / dense — comm/delta.py CODEC_LABELS): the attribution that tells the
    # fleet which encoder is actually carrying the model plane. Empty for
    # pre-codec-label (older) peers — always tolerated.
    tx_by_codec: Dict[str, float] = field(default_factory=dict)
    # Aggregation.
    agg_waits: int = 0  # completed aggregation waits (histogram count)
    agg_wait_s: float = 0.0  # cumulative seconds spent waiting
    contributors: float = 0.0  # contributors merged in the last aggregation
    # Defense / fault planes.
    rejections: Dict[str, float] = field(default_factory=dict)  # reason -> n
    rejected_by_source: Dict[str, float] = field(default_factory=dict)
    faults_seen: float = 0.0  # chaos faults injected at this node's sends
    # Privacy plane: cumulative (epsilon, PRIVACY_DELTA)-DP spend of this
    # node's training. None = the node never reported a budget (DP off /
    # pre-privacy peer — always tolerated, omitted on the wire); 0 = DP
    # active, nothing released yet (a genuine zero-spend claim); -1 = no
    # valid DP claim (noise off / non-private steps — JSON cannot carry
    # inf). None and 0 are distinct on purpose: absent telemetry must not
    # render as an active zero-spend guarantee.
    dp_epsilon: Optional[float] = None
    # Engine supervisor (fused engines): cumulative restarts and degrade-
    # ladder steps this node's supervisor performed. None = never
    # supervised (wire nodes, pre-supervisor peers — omitted on the wire,
    # always tolerated), distinct from a genuine 0 like dp_epsilon above.
    restarts: Optional[int] = None
    degrade: Optional[int] = None
    # Device.
    mem_bytes: float = 0.0
    # Distribution sketches (v2+): name -> QuantileSketch wire dict, plus
    # the HyperLogLog distinct-contributor estimator under "__distinct__".
    # Stored in WIRE form — decoding is lazy (the observatory decodes only
    # when it merges fleet quantiles), and absent/{} means a v1 peer.
    sketches: Dict[str, Any] = field(default_factory=dict)

    # --- sketch accessors ----------------------------------------------------

    def sketch(self, name: str):
        """Decode one carried quantile sketch (None when absent/invalid)."""
        from p2pfl_tpu_torch.telemetry.sketches import QuantileSketch

        return QuantileSketch.from_wire(self.sketches.get(name))

    def distinct(self):
        """Decode the distinct-contributor estimator (None when absent)."""
        from p2pfl_tpu_torch.telemetry.sketches import DistinctEstimator

        return DistinctEstimator.from_wire(self.sketches.get("__distinct__"))

    # --- wire codec ---------------------------------------------------------

    def encode(self) -> str:
        """Compact JSON, stable key order (diffable in flight-recorder
        dumps and deterministic for tests). An empty sketch table is
        omitted entirely — a v1-shaped digest encodes byte-identically to
        the v1 wire (modulo the version stamp)."""
        d = asdict(self)
        d["v"] = d.pop("version")
        sk = d.pop("sketches", None)
        if sk:
            d["sk"] = sk
        if not d.get("tx_by_codec"):
            d.pop("tx_by_codec", None)  # keep pre-codec-label beats byte-identical
        if d.get("dp_epsilon") is None:
            d.pop("dp_epsilon", None)  # no budget reported: omit, don't claim 0
        for opt in ("restarts", "degrade"):
            if d.get(opt) is None:
                d.pop(opt, None)  # unsupervised node: omit, keep old wire shape
        return json.dumps(d, separators=(",", ":"), sort_keys=True)


def decode(payload: str) -> Optional["HealthDigest"]:
    """Best-effort decode: ``None`` for malformed/oversized payloads; for a
    NEWER version, every recognized field is kept and the rest ignored, so
    version skew degrades to a sparser digest instead of a dead peer entry."""
    if not payload or len(payload) > MAX_DIGEST_BYTES:
        return None
    try:
        raw = json.loads(payload)
    except (ValueError, TypeError):
        return None
    if not isinstance(raw, dict) or not isinstance(raw.get("node"), str):
        return None
    dig = HealthDigest(node=raw["node"])
    try:
        dig.version = int(raw.get("v", raw.get("version", DIGEST_VERSION)))
    except (TypeError, ValueError):
        dig.version = DIGEST_VERSION
    for name, kind in (
        ("ts", float), ("round", int), ("total_rounds", int), ("stage", str),
        ("mode", str), ("staleness", float),
        ("steps_per_s", float), ("jit_compile_s", float),
        ("tx_bytes", float), ("rx_bytes", float), ("queue_depth", float),
        ("agg_waits", int), ("agg_wait_s", float), ("contributors", float),
        ("faults_seen", float), ("mem_bytes", float), ("dp_epsilon", float),
        ("restarts", int), ("degrade", int),
    ):
        v = raw.get(name)
        if v is None:
            continue
        try:
            setattr(dig, name, kind(v))
        except (TypeError, ValueError):
            pass  # a newer version may have retyped the field — keep default
    for name in ("rejections", "rejected_by_source", "tx_by_codec"):
        v = raw.get(name)
        if isinstance(v, dict):
            table = {}
            for k, n in v.items():
                try:
                    table[str(k)] = float(n)
                except (TypeError, ValueError):
                    continue
            setattr(dig, name, table)
    # v2 sketch table: kept in WIRE form (decoded lazily by consumers, so a
    # malformed sketch degrades to "absent" at merge time, never at ingest).
    # A v1 payload simply has no "sk" — empty table, fully functional digest.
    sk = raw.get("sk")
    if isinstance(sk, dict):
        dig.sketches = {
            str(k): v for k, v in sk.items()
            if isinstance(v, dict) or (k == "__distinct__" and isinstance(v, str))
        }
    return dig


# --- collection -------------------------------------------------------------


def _series_sum(name: str, node: str, group_by: Optional[str] = None) -> Any:
    """Sum a family's series for ``node``; with ``group_by``, a dict keyed by
    that label instead of a scalar."""
    fam = REGISTRY.get(name)
    if fam is None:
        return {} if group_by else 0.0
    if group_by:
        out: Dict[str, float] = {}
        for labels, child in fam.samples():
            if labels.get("node") != node:
                continue
            key = labels.get(group_by, "?")
            out[key] = out.get(key, 0.0) + child.value
        return out
    return sum(c.value for lbl, c in fam.samples() if lbl.get("node") == node)


def _gauge_value(name: str, node: str) -> float:
    fam = REGISTRY.get(name)
    if fam is None:
        return 0.0
    for labels, child in fam.samples():
        if labels.get("node") == node:
            return float(child.value)
    return 0.0


def _gauge_value_opt(name: str, node: str) -> Optional[float]:
    """Like :func:`_gauge_value` but ``None`` when the node has no series —
    'never reported' must stay distinguishable from a genuine 0.0."""
    fam = REGISTRY.get(name)
    if fam is None:
        return None
    for labels, child in fam.samples():
        if labels.get("node") == node:
            return float(child.value)
    return None


def device_mem_bytes() -> float:
    """Accelerator memory in use, best effort: the CUDA caching allocator's
    in-use bytes once the process has used a card; on the CPU, where the
    tensors live in host memory, the process's resident bytes
    (``/proc/self/statm``). Process-wide either way (in-process federations
    share one device). The digest never takes the live-tensor sweep behind
    :func:`~p2pfl_tpu_torch.management.profiler.device_memory_watermark`:
    the sweep walks every Python object, and on the heartbeat's thread
    (every beat carries a digest) it held beats back past
    ``HEARTBEAT_TIMEOUT`` under CPU load, so live peers were written off.
    0.0 when nothing can be read."""
    try:
        import torch

        if torch.cuda.is_available() and torch.cuda.is_initialized():
            return float(torch.cuda.memory_stats().get("allocated_bytes.all.current", 0) or 0)
        with open("/proc/self/statm") as f:
            return float(int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE"))
    except Exception:  # noqa: BLE001 — digest collection must never raise
        return 0.0


def collect(addr: str, state: Any = None) -> HealthDigest:
    """Snapshot ``addr``'s vitals from the process-wide registry (plus the
    node's :class:`~p2pfl_tpu_torch.node_state.NodeState` when provided — round,
    stage, total_rounds are state-only facts).

    Cheap: a handful of locked gauge reads; called once per heartbeat
    period. Never raises — a broken collector must not stop the beat.
    """
    dig = HealthDigest(node=addr, ts=time.time())
    try:
        if state is not None:
            r = getattr(state, "round", None)
            dig.round = -1 if r is None else int(r)
            t = getattr(state, "total_rounds", None)
            dig.total_rounds = -1 if t is None else int(t)
            dig.stage = str(getattr(state, "current_stage", "") or "")
            if getattr(state, "experiment", None) is not None:
                dig.mode = str(getattr(state, "fed_mode", "") or "")
        dig.steps_per_s = _gauge_value("p2pfl_learner_steps_per_second", addr)
        dig.jit_compile_s = _gauge_value("p2pfl_learner_jit_compile_seconds", addr)
        dig.tx_bytes = float(_series_sum("p2pfl_gossip_tx_bytes_total", addr))
        dig.tx_by_codec = _series_sum(
            "p2pfl_gossip_tx_bytes_total", addr, group_by="codec"
        )
        dig.rx_bytes = float(_series_sum("p2pfl_gossip_rx_bytes_total", addr))
        dig.queue_depth = _gauge_value("p2pfl_gossip_queue_depth", addr)
        wait = REGISTRY.get("p2pfl_aggregation_wait_seconds")
        if wait is not None:
            for labels, child in wait.samples():
                if labels.get("node") == addr:
                    dig.agg_waits = int(child.count)
                    dig.agg_wait_s = float(child.sum)
                    break
        dig.contributors = _gauge_value("p2pfl_aggregation_contributors", addr)
        dig.rejections = _series_sum(
            "p2pfl_updates_rejected_total", addr, group_by="reason"
        )
        by_source = _series_sum(
            "p2pfl_updates_rejected_total", addr, group_by="source"
        )
        # "?" is the unattributed bucket (direct API calls) — not a peer.
        by_source.pop("?", None)
        dig.rejected_by_source = by_source
        dig.staleness = _gauge_value("p2pfl_async_staleness", addr)
        dig.faults_seen = float(_series_sum("p2pfl_chaos_faults_total", addr))
        dig.dp_epsilon = _gauge_value_opt("p2pfl_privacy_epsilon", addr)
        # Supervisor vitals: only nodes that ever ran supervised have the
        # series — everyone else keeps None (omitted on the wire).
        for fam_name, attr in (
            ("p2pfl_supervisor_restarts_total", "restarts"),
            ("p2pfl_supervisor_degrade_steps_total", "degrade"),
        ):
            fam = REGISTRY.get(fam_name)
            if fam is not None:
                vals = [
                    c.value for lbl, c in fam.samples()
                    if lbl.get("node") == addr
                ]
                if vals:
                    setattr(dig, attr, int(sum(vals)))
        dig.mem_bytes = device_mem_bytes()
        # v2: the node's distribution sketches (step-time, staleness,
        # update-norm, agg-wait) + distinct-contributor estimator, wire
        # bins bounded so the beat stays cheap regardless of stream length.
        dig.sketches = SKETCHES.wire_for(addr, max_bins=DIGEST_SKETCH_BINS)
    except Exception:  # noqa: BLE001
        log.exception("(%s) health-digest collection failed", addr)
    return dig


__all__ = [
    "DIGEST_SKETCH_BINS",
    "DIGEST_VERSION",
    "HealthDigest",
    "MAX_DIGEST_BYTES",
    "WIRE_ARG_PREFIX",
    "collect",
    "decode",
    "device_mem_bytes",
]
