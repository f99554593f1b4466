"""Trajectory ledger — the canonical event stream both backends emit (the
port's copy of ``p2pfl_tpu/telemetry/ledger.py``: same schema, same
canonical dumps, same content hash).

The fused mesh (``parallel/simulation.py``) and the real gRPC/in-memory wire
are two execution paths that agree only by convention: nothing *certified*
that an n=512 fused result describes the same federation an 8-node wire run
does. This module is the observable half of that certification (ROADMAP
item 5; Papaya — arxiv 2111.04877 — trusts its simulator precisely because
sim and production share one recorded execution path): a deterministic,
seed-stable, append-only ledger of **versioned structured events**

========================  =====================================================
kind                      fields (beyond ``v``/``kind``/``round``)
========================  =====================================================
``round_open``            ``members`` — the elected committee, sorted
``window_open``           async: the window index in ``round``
``contribution_folded``   ``sender``, ``lag``, ``num_samples``
``aggregate_committed``   ``hash`` (content hash of the adopted params),
                          ``contributors`` (sorted), ``num_samples``;
                          optional ``origin`` (``train``/``full_model``/
                          ``window``) and ``reason`` (async close reason)
``round_close``           —
``window_close``          —
``membership``            ``event`` (join/rejoin/leave/evict/recover),
                          ``peer``
``chaos_fault``           ``fault`` (churn/recovery/byzantine), ``peer``,
                          step detail fields
``admission_rejected``    ``sender``, ``reason`` (deduped per
                          (round, sender, reason) — a gossip loop
                          re-shipping one bad frame is one trajectory fact)
========================  =====================================================

emitted (in the port so far) from the aggregators, the observatory, the
chaos plane and the fused-mesh round step (``MeshSimulation.attach_ledger``)
— the same schema the JAX package's schedulers and admission also emit. Events carry **no wall-clock**: the
ledger records *what the federation did*, not when, which is what makes the
same seeded scenario produce byte-identical ledgers across runs and across
backends (timing lives in the tracer / flight recorder).

Each per-node ledger is an append-only bounded ring with monotonic live
sequence numbers; :meth:`TrajectoryLedger.dump` writes
``artifacts/ledger_<node>.jsonl`` in **canonical** form — events sorted by
``(round, kind rank, sender, …)`` with canonical sequence numbers — so two
runs that produced the same event *set* produce byte-identical files
regardless of transport-thread interleaving (``canonical=False`` preserves
arrival order + live seq for debugging). ``scripts/parity_diff.py`` aligns
two dumps and localizes the first divergent event.
"""

from __future__ import annotations

import hashlib
import json
import os
import re
import threading
from collections import deque
from typing import Any, Dict, List, Mapping, Optional

from p2pfl_tpu_torch.config import Settings
from p2pfl_tpu_torch.telemetry.metrics import REGISTRY

#: bump when an event's field semantics change; readers tolerate (and skip)
#: versions they don't know.
LEDGER_SCHEMA_VERSION = 1

#: canonical within-round ordering of event kinds (scenario facts before the
#: contributions they shaped, contributions before the aggregate they fed).
KIND_RANK = {
    "round_open": 0,
    "window_open": 0,
    "chaos_fault": 1,
    "membership": 2,
    "admission_rejected": 3,
    "privacy_masked": 3,
    "contribution_folded": 4,
    "aggregate_committed": 5,
    "window_close": 6,
    "round_close": 6,
}

#: kinds parity_diff compares by default — the trajectory proper. The rest
#: (chaos faults, admission rejections, membership) are environment /
#: defense facts that legitimately differ between backends (the fused mesh
#: has no wire to drop frames from) and are compared only on request.
TRAJECTORY_KINDS = (
    "round_open",
    "window_open",
    "contribution_folded",
    "aggregate_committed",
    "window_close",
    "round_close",
)

#: provenance fields stripped from CANONICAL events/dumps: which code path
#: committed first (``origin``: own aggregate vs adopted full model — the
#: values are bit-identical, first wins) and why an async window closed
#: (``reason``) are timing facts, not trajectory facts; keeping them would
#: break byte-identical dumps across reruns. Raw events keep them.
NONCANONICAL_FIELDS = ("origin", "reason")

_EVENTS = REGISTRY.counter(
    "p2pfl_ledger_events_total",
    "Trajectory-ledger events appended, by node and event kind",
    labels=("node", "kind"),
)


def _leaf_array(leaf: Any) -> "np.ndarray":
    """A leaf as a host numpy array: torch tensors (bf16 through f32, which
    is exact) leave the device; anything numpy can read passes through."""
    import numpy as np
    import torch

    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.cpu().numpy()
    return np.asarray(leaf)


def _flatten_sorted(tree: Any) -> List[Any]:
    """``jax.tree.leaves`` of a nested mapping: keys sorted at every level."""
    out: List[Any] = []
    for key in sorted(tree):
        val = tree[key]
        out.extend(_flatten_sorted(val) if isinstance(val, Mapping) else [val])
    return out


def canonical_params_hash(params: Any) -> str:
    """Content hash of a parameter set, stable across backends (the JAX
    package's ``canonical_params_hash``, byte for byte).

    Leaves are taken in the JAX package's canonical order and layout:

    * a list / tuple: its leaves as given (e.g. ``ModelHandle.get_parameters()``);
    * a flat ``{port name: tensor}`` dict (a port model's ``params``), or
      ``{port name: numpy array}`` with every name dotted (a population
      engine's ``gather_params``): the flax leaf order with Dense kernels
      ``[in, out]`` (:func:`p2pfl_tpu_torch.models.convert.to_canonical`);
    * any other mapping (a flax-style nested tree): keys sorted at every
      level, as ``jax.tree.leaves`` takes them.

    Canonicalization rules (the reference's ``docs/components/parity.md``):
    float leaves are cast to little-endian float32, ``-0.0`` is normalized
    to ``+0.0`` and every NaN payload collapses to the one canonical quiet
    NaN; integer/bool leaves are cast to little-endian int64 / uint8; each
    leaf contributes its index, shape and dtype class. Returns
    ``"sha256:<hex>"``.
    """
    import numpy as np
    import torch

    if isinstance(params, (list, tuple)):
        leaves = list(params)
    elif isinstance(params, Mapping) and params and all(isinstance(v, torch.Tensor) for v in params.values()):
        from p2pfl_tpu_torch.models.convert import to_canonical

        leaves = to_canonical(params)
    elif (isinstance(params, Mapping) and params
          and all(isinstance(k, str) and "." in k and isinstance(v, np.ndarray) for k, v in params.items())):
        from p2pfl_tpu_torch.models.convert import to_canonical

        leaves = to_canonical({k: torch.from_numpy(v) for k, v in params.items()})
    else:
        leaves = _flatten_sorted(params)
    h = hashlib.sha256()
    h.update(f"pfl-ledger-hash-v1:{len(leaves)};".encode())
    for i, leaf in enumerate(leaves):
        a = _leaf_array(leaf)
        if np.issubdtype(a.dtype, np.floating):
            a = np.ascontiguousarray(a, dtype="<f4") + np.float32(0.0)
            a = np.where(np.isnan(a), np.float32(np.nan), a)
            kind = "f"
        elif np.issubdtype(a.dtype, np.bool_):
            a = np.ascontiguousarray(a, dtype="u1")
            kind = "b"
        else:
            a = np.ascontiguousarray(a, dtype="<i8")
            kind = "i"
        h.update(f"{i}:{kind}:{a.shape};".encode())
        h.update(a.tobytes(order="C"))
    return f"sha256:{h.hexdigest()}"


def _canonical_sort_key(ev: Dict[str, Any]):
    rnd = ev.get("round")
    return (
        rnd if isinstance(rnd, (int, float)) else -1,
        KIND_RANK.get(ev.get("kind"), 9),
        str(ev.get("kind", "")),
        str(ev.get("sender", ev.get("peer", ""))),
        json.dumps(
            {k: v for k, v in ev.items() if k != "seq"},
            sort_keys=True, separators=(",", ":"),
        ),
    )


class TrajectoryLedger:
    """One node's append-only event ring (bounded by LEDGER_CAPACITY)."""

    def __init__(self, node: str, run_id: str = "", campaign: str = "") -> None:
        self.node = node
        self.run_id = run_id
        #: campaign id (campaigns/engine.py) — scopes this ledger's dumps to
        #: one sampled campaign scenario; empty outside campaign runs.
        self.campaign = campaign
        self._lock = threading.Lock()
        self._events: deque = deque(maxlen=max(16, int(Settings.LEDGER_CAPACITY)))
        self._seq = 0
        self._dropped = 0
        #: last round/window opened — stamps events whose emitter doesn't
        #: know the round (membership transitions, admission rejections).
        self.current_round: Optional[int] = None
        #: dedup keys already emitted (admission rejections collapse to one
        #: trajectory fact per (round, sender, reason)).
        self._dedup: set = set()

    def emit(
        self,
        kind: str,
        round: Optional[int] = None,
        dedup_key: Optional[tuple] = None,
        **fields: Any,
    ) -> bool:
        """Append one event; returns False when deduped. ``round`` stays
        None when the emitter has no round context (membership transitions,
        pre-session chaos steps) — a timing-dependent guess here would
        break the byte-identical-across-runs guarantee the canonical dump
        makes. ``current_round`` (updated by round/window_open) is offered
        to emitters that WANT a best-effort stamp (wire admission)."""
        with self._lock:
            if dedup_key is not None:
                if dedup_key in self._dedup:
                    return False
                self._dedup.add(dedup_key)
            if kind in ("round_open", "window_open") and round is not None:
                self.current_round = int(round)
            ev: Dict[str, Any] = {
                "v": LEDGER_SCHEMA_VERSION,
                "seq": self._seq,
                "kind": kind,
                "round": int(round) if round is not None else None,
            }
            ev.update(fields)
            if len(self._events) == self._events.maxlen:
                self._dropped += 1
            self._events.append(ev)
            self._seq += 1
        _EVENTS.labels(self.node, kind).inc()
        return True

    # --- reading -------------------------------------------------------------

    def events(self) -> List[Dict[str, Any]]:
        with self._lock:
            return [dict(e) for e in self._events]

    def tail(self, n: int) -> List[Dict[str, Any]]:
        with self._lock:
            return [dict(e) for e in list(self._events)[-max(0, int(n)):]]

    def canonical_events(self) -> List[Dict[str, Any]]:
        """Events in canonical order (round, kind rank, sender, payload)
        with canonical sequence numbers — byte-stable across runs that
        produced the same event set."""
        evs = sorted(
            (
                {k: v for k, v in ev.items() if k not in NONCANONICAL_FIELDS}
                for ev in self.events()
            ),
            key=_canonical_sort_key,
        )
        out = []
        for i, ev in enumerate(evs):
            ev["seq"] = i
            out.append(ev)
        return out

    # --- dumping -------------------------------------------------------------

    def dump(self, path: str, canonical: bool = True) -> str:
        """Write the ledger as JSONL (header line + one event per line).
        Canonical mode (default) re-orders deterministically and re-numbers
        ``seq``; ``canonical=False`` keeps arrival order + live seq."""
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        header = {
            "ledger": "trajectory",
            "v": LEDGER_SCHEMA_VERSION,
            "node": self.node,
            "run_id": self.run_id,
            "canonical": bool(canonical),
            "dropped": self._dropped,
        }
        if self.campaign:
            # Present ONLY for campaign runs: pre-campaign dumps (and their
            # committed baselines) stay byte-identical.
            header["campaign"] = self.campaign
        evs = self.canonical_events() if canonical else self.events()
        # pid alone collides when two threads dump into one bundle dir
        tmp = f"{path}.tmp.{os.getpid()}.{threading.get_ident()}"
        with open(tmp, "w") as f:
            f.write(json.dumps(header, sort_keys=True, separators=(",", ":")) + "\n")
            for ev in evs:
                f.write(json.dumps(ev, sort_keys=True, separators=(",", ":")) + "\n")
        os.replace(tmp, path)
        return path


def _safe_name(node: str) -> str:
    return re.sub(r"[^A-Za-z0-9._-]+", "_", node)


class LedgerHub:
    """Process-wide per-node ledger registry (the REGISTRY/SKETCHES
    pattern): emission points address ledgers by node name, tests and the
    dump path enumerate them. Every method is a cheap no-op while
    ``Settings.LEDGER_ENABLED`` is off."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._ledgers: Dict[str, TrajectoryLedger] = {}
        self._run_id = ""
        self._campaign = ""

    @staticmethod
    def enabled() -> bool:
        return bool(Settings.LEDGER_ENABLED)

    @property
    def campaign(self) -> str:
        """The active campaign scope (empty outside campaign runs)."""
        with self._lock:
            return self._campaign

    @property
    def run_id(self) -> str:
        """The configured run id ("" until :meth:`configure`) — the ambient
        run context (telemetry/bundle.py) adopts a scenario-pinned id from
        here instead of minting over it."""
        with self._lock:
            return self._run_id

    def configure(self, run_id: str, campaign: Optional[str] = None) -> None:
        """Set the experiment-wide run id stamped into every ledger created
        (or already live) in this process — the parity benches derive it
        from the scenario seed so both backends' dumps carry the same id.
        ``campaign`` (campaigns/engine.py) additionally stamps the sampled
        campaign's id into dump headers; passing ``None`` leaves the current
        campaign scope untouched, ``""`` clears it."""
        with self._lock:
            self._run_id = str(run_id)
            if campaign is not None:
                self._campaign = str(campaign)
            for led in self._ledgers.values():
                led.run_id = self._run_id
                led.campaign = self._campaign

    def get(self, node: str) -> TrajectoryLedger:
        with self._lock:
            led = self._ledgers.get(node)
            if led is None:
                led = TrajectoryLedger(
                    node, run_id=self._run_id, campaign=self._campaign
                )
                self._ledgers[node] = led
            return led

    def peek(self, node: str) -> Optional[TrajectoryLedger]:
        with self._lock:
            return self._ledgers.get(node)

    def emit(self, node: str, kind: str, **fields: Any) -> bool:
        if not self.enabled():
            return False
        return self.get(node).emit(kind, **fields)

    def nodes(self) -> List[str]:
        with self._lock:
            return sorted(self._ledgers)

    def dump_all(self, directory: str, canonical: bool = True) -> List[str]:
        """Write ``ledger_<node>.jsonl`` per live ledger; returns paths."""
        paths = []
        for node in self.nodes():
            led = self.peek(node)
            if led is None:
                continue
            paths.append(
                led.dump(
                    os.path.join(directory, f"ledger_{_safe_name(node)}.jsonl"),
                    canonical=canonical,
                )
            )
        return paths

    def reset(self) -> None:
        # The campaign scope deliberately SURVIVES reset: one campaign spans
        # many scenario runs, each of which resets the hub between backends
        # (run_scenario_wire/fused). The engine clears it explicitly with
        # configure(run_id, campaign="") when the campaign ends.
        with self._lock:
            self._ledgers.clear()
            self._run_id = ""


#: process-wide hub every emission point writes through.
LEDGERS = LedgerHub()


__all__ = [
    "LEDGER_SCHEMA_VERSION",
    "KIND_RANK",
    "TRAJECTORY_KINDS",
    "TrajectoryLedger",
    "LedgerHub",
    "LEDGERS",
    "canonical_params_hash",
]
