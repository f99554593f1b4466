"""Wire-path admission control: screen inbound model frames before they
touch the aggregator or the local model.

The federation wire path used to accept any decodable frame: a Byzantine
peer could ship a wrong-shaped tree, NaN/Inf payloads, or an
arbitrarily-scaled update and it would flow straight into
``aggregator.add_model`` / ``apply_frame`` (production FL systems treat
inbound-update validation as a first-class plane — Papaya, arxiv
2111.04877; APPFL, arxiv 2409.11585). This module is the screening step
between ``decode_frame`` and those sinks, applied AFTER sparse-delta
reconstruction so a poisoned top-k frame is judged by the dense model it
reconstructs to and can never corrupt the round anchor or residuals.

Checks, in order (first failure wins; every rejection is counted into
``p2pfl_updates_rejected_total{node, reason}``):

* ``corrupt`` — the frame did not decode at all (counted by the command
  handlers via :meth:`AdmissionController.record`, not here);
* ``tree`` — leaf count differs from the local model spec;
* ``shape`` — some leaf's shape differs;
* ``dtype`` — some leaf's float/non-float class differs (exact-width
  mismatches within a class are admitted: the wire codecs legitimately
  deliver e.g. float32 for bfloat16 leaves and ``set_parameters`` casts);
* ``nonfinite`` — any NaN/Inf in a float leaf;
* ``norm`` — the update norm ``||recv - local||`` exceeds the adaptive
  bound: ``median(recently admitted norms) * Settings.ADMISSION_NORM_MULT``
  once enough history exists, else the local model's own norm (an "update"
  as large as the whole model is not an update — the same norm-bounding
  idea as the mesh path's ``clip_update_norm``, Sun et al. 2019, applied
  as an accept/reject gate at the wire boundary).

The norm bound applies to PARTIAL models only (the path where Byzantine
mass enters aggregation). Full-model adoption is screened structurally and
for finiteness but not by norm: a crashed-and-rejoined node must be able
to adopt an aggregate arbitrarily far from its stale weights (the
anchor-resync path), so distance-from-local is not a meaningful signal
there.

``num_samples`` arrives unauthenticated on the same frames;
:meth:`AdmissionController.clamp_num_samples` caps it at
``Settings.MAX_CLAIMED_SAMPLES`` so a single peer cannot dominate FedAvg's
sample weighting (the inflation attack GeometricMedian's unit weights
already neutralize — robust.py docstring).

The port's copy of ``p2pfl_tpu/comm/admission.py``: the screens run in
torch on the received leaves' device (on the card, the codec decodes there);
the masked-frame screen reads the privacy plane's host lattices.
"""

from __future__ import annotations

import logging
import threading
from collections import deque
from typing import Any, List, Optional, Sequence, Set, Tuple

import numpy as np
import torch

from p2pfl_tpu_torch.config import Settings
from p2pfl_tpu_torch.ops.compression import as_tensor
from p2pfl_tpu_torch.telemetry import REGISTRY

log = logging.getLogger("p2pfl_tpu_torch")

_REJECTED = REGISTRY.counter(
    "p2pfl_updates_rejected_total",
    "Inbound model-plane frames rejected by wire admission control, by "
    "reason and claimed sender (the observatory's suspect score sums the "
    "source attribution across the fleet's gossiped digests)",
    labels=("node", "reason", "source"),
)
_CLAMPED = REGISTRY.counter(
    "p2pfl_claimed_samples_clamped_total",
    "Wire-supplied num_samples claims clamped to MAX_CLAIMED_SAMPLES",
    labels=("node",),
)

#: Admitted-norm history entries required before the adaptive bound engages
#: (below this the bootstrap bound — the local model's own norm — applies).
MIN_NORM_HISTORY = 4

#: Init frames: reject when the received WEIGHT norm exceeds this multiple
#: of the local (fresh-init) weight norm. Both sides initialize the same
#: architecture, so honest inits sit near ratio 1; a x10-scaled init is ~10.
INIT_NORM_MULT = 4.0


def _is_floatlike(a: Any) -> bool:
    """Float class of a tensor or array (bfloat16 included)."""
    if isinstance(a, torch.Tensor):
        return a.is_floating_point()
    dt = np.asarray(a).dtype
    return np.issubdtype(dt, np.floating) or dt.name == "bfloat16" or dt.name.startswith("float8")


def _leaf(a: Any, device: torch.device) -> torch.Tensor:
    """A received leaf as a tensor; a tensor stays on its own device, host
    arrays come to ``device``."""
    return a if isinstance(a, torch.Tensor) else as_tensor(a, device=device)


def _float_sums(pairs: List[Tuple[torch.Tensor, torch.Tensor]]) -> Tuple[bool, float, float]:
    """``(all finite, sum ||recv - local||^2, sum ||local||^2)`` over the float
    leaf pairs, each leaf's sums taken in f32 on the received leaf's device
    (the local leaf moves there) and the three read back in one transfer."""
    if not pairs:
        return True, 0.0, 0.0
    rows = []
    for recv, mine in pairs:
        r32 = recv.float().reshape(-1)
        m32 = mine.to(device=r32.device, dtype=torch.float32).reshape(-1)
        d = r32 - m32
        rows.append(torch.stack([torch.isfinite(r32).all().float(), torch.dot(d, d), torch.dot(m32, m32)]).cpu())
    table = torch.stack(rows).double()
    finite = bool(table[:, 0].min() > 0)
    return finite, float(table[:, 1].sum()), float(table[:, 2].sum())


def _sq_norm(leaves: List[torch.Tensor]) -> float:
    """Sum of the leaves' squared L2 norms, each in f32 on its device."""
    if not leaves:
        return 0.0
    flat = [t.float().reshape(-1) for t in leaves]
    return float(torch.stack([torch.dot(f, f).cpu() for f in flat]).double().sum())


class AdmissionController:
    """Per-node screening state (held on :class:`~p2pfl_tpu_torch.node_state.
    NodeState` like the delta codec). Thread-safe: screening runs on
    transport threads."""

    def __init__(self, addr: str = "unknown-node") -> None:
        self._addr = addr
        self._lock = threading.Lock()
        self._norms: deque = deque(maxlen=Settings.ADMISSION_NORM_WINDOW)
        # (source, reason) pairs already warned about — repeats drop to
        # debug so a gossip loop re-shipping a rejected frame every 100ms
        # cannot flood the log.
        self._warned: Set[Tuple[str, str]] = set()
        # Optional flight recorder (set by Node): every rejection becomes a
        # postmortem event alongside the metric.
        self.recorder: Optional[Any] = None
        # Permissive mode: admit every structurally-decodable frame. The
        # campaign harness sets this on the ADAPTIVE ADVERSARY's own node —
        # an attacker does not defend itself, and if it screened inbound
        # honest frames against its own poisoned local model it would
        # reject the entire federation and diverge from the very state it
        # is trying to ride (population/scenarios.py run_scenario_wire).
        self.permissive = False

    # --- accounting ----------------------------------------------------------

    def record(self, reason: str, source: str = "?", cmd: str = "?") -> str:
        """Count (and log) one rejection; returns ``reason`` so handlers can
        ``return admission.record(...)``-style early-exit. The ``source``
        label is the frame's CLAIMED sender (unauthenticated, like
        everything else on this wire) — per-sender attribution feeds the
        observatory's suspect score via the gossiped digest."""
        _REJECTED.labels(self._addr, reason, source).inc()
        if self.recorder is not None:
            self.recorder.record("reject", reason=reason, source=source, cmd=cmd)
        # Trajectory ledger: one admission fact per (round, sender, reason) —
        # a gossip loop re-shipping the same bad frame every tick is ONE
        # trajectory event, however many times the screen fired (the metric
        # above keeps the raw count). Lazy import: admission must stay
        # importable before the telemetry package finishes wiring.
        from p2pfl_tpu_torch.telemetry.ledger import LEDGERS

        if LEDGERS.enabled():
            led = LEDGERS.get(self._addr)
            led.emit(
                "admission_rejected",
                round=led.current_round,  # best-effort: frames carry no round here
                sender=source,
                reason=reason,
                dedup_key=("admission", led.current_round, source, reason),
            )
        key = (source, reason)
        msg = "(%s) rejected %s frame from %s: reason=%s"
        if key in self._warned:
            log.debug(msg, self._addr, cmd, source, reason)
        else:
            self._warned.add(key)
            log.warning(msg, self._addr, cmd, source, reason)
        return reason

    def rejected_count(self, reason: Optional[str] = None) -> int:
        fam = REGISTRY.get("p2pfl_updates_rejected_total")
        if fam is None:
            return 0
        total = 0
        for labels, child in fam.samples():
            if labels.get("node") != self._addr:
                continue
            if reason is not None and labels.get("reason") != reason:
                continue
            total += int(child.value)
        return total

    # --- the screen -----------------------------------------------------------

    def screen(
        self,
        arrays: Sequence[Any],
        local_model: Any,
        *,
        source: str = "?",
        cmd: str = "?",
        check_norm: bool = True,
    ) -> Optional[str]:
        """Validate decoded ``arrays`` against ``local_model``'s spec.

        Returns ``None`` when the frame is admitted (and, with
        ``check_norm``, records its update norm into the adaptive-bound
        history), else the rejection reason (already counted/logged).
        """
        if not Settings.ADMISSION_ENABLED or self.permissive:
            return None
        local: List[torch.Tensor] = local_model.get_parameters()
        if len(arrays) != len(local):
            return self.record("tree", source, cmd)
        device = local[0].device if local else torch.device("cpu")
        received = [_leaf(recv, device) for recv in arrays]
        for recv, mine in zip(received, local):
            if tuple(recv.shape) != tuple(mine.shape):
                return self.record("shape", source, cmd)
            if _is_floatlike(recv) != _is_floatlike(mine):
                return self.record("dtype", source, cmd)
        # Finiteness + norm in one float32 pass over the float leaves.
        finite, sq_dist, sq_local = _float_sums([(r, m) for r, m in zip(received, local) if _is_floatlike(r)])
        if not finite:
            return self.record("nonfinite", source, cmd)
        if not check_norm:
            return None
        norm = float(np.sqrt(sq_dist))
        with self._lock:
            if len(self._norms) >= MIN_NORM_HISTORY:
                bound = float(np.median(self._norms)) * Settings.ADMISSION_NORM_MULT
            else:
                # Bootstrap: before history exists, an update at least as
                # large as the entire local model is rejected outright.
                bound = float(np.sqrt(sq_local))
            if norm > bound:
                pass  # reject outside the lock (record logs)
            else:
                self._norms.append(norm)
                return None
        log.debug(
            "(%s) update norm %.3f exceeds bound %.3f (history=%d)",
            self._addr, norm, bound, len(self._norms),
        )
        return self.record("norm", source, cmd)

    def screen_init(
        self,
        arrays: Sequence[Any],
        local_model: Any,
        *,
        source: str = "?",
    ) -> Optional[str]:
        """Screen an init-model frame: structure + finiteness, plus an
        init-scale sanity bound on the WEIGHT norm (not the update norm —
        there is no meaningful "update" before round 0). Both sides hold a
        fresh init of the same architecture, so ``||recv||`` should be
        comparable to ``||local||``; a scaled init (x10 weights from a
        Byzantine initiator) is ~10x out and rejected as ``init_norm``.
        Sign-preserving attacks (e.g. signflip) pass — a negated init is
        still a valid-scale init, which is exactly why init frames are the
        one place the protocol must trust the experiment operator."""
        reason = self.screen(
            arrays, local_model, source=source, cmd="init_model", check_norm=False
        )
        if reason is not None or not Settings.ADMISSION_ENABLED:
            return reason
        local = local_model.get_parameters()
        received = [_leaf(recv, local[0].device if local else torch.device("cpu")) for recv in arrays]
        sq_recv = _sq_norm([r for r in received if _is_floatlike(r)])
        sq_local = _sq_norm([m for m in local if _is_floatlike(m)])
        local_norm = float(np.sqrt(sq_local))
        if local_norm < 1e-6:  # zero-init local model: nothing to compare to
            return None
        if float(np.sqrt(sq_recv)) > INIT_NORM_MULT * local_norm:
            return self.record("init_norm", source, "init_model")
        return None

    # --- masked frames (privacy plane) ----------------------------------------

    def screen_masked(
        self,
        arrays: Sequence[np.ndarray],
        info: Any,
        *,
        committee: Sequence[str],
        contributors: Sequence[str],
        expected_ks: Sequence[int],
        source: str = "?",
        cmd: str = "partial_model",
    ) -> Optional[str]:
        """Screen a masked lattice frame (``p2pfl_tpu_torch/privacy/secagg.py``).

        A masked frame's VALUES are uniform ring elements by design, so the
        norm/finiteness screens are meaningless here — that is the
        admission-vs-secrecy tension, resolved the DisAgg/Papaya way:
        clipping-at-sender bounds what an honest masker can inject, the
        committee-side range check at finalize catches a dishonest one, and
        THIS screen validates everything structural a hostile frame
        controls (declared round/ring/committee geometry, per-tensor
        support sizes, ring dtype, membership of the claimed contributors)
        BEFORE the frame can enter the lattice sum. Every rejection is a
        counted ``masked_structure`` / ``masked_member`` — the same
        accounting surface as every other screen. The lattices are numpy
        vectors on the host.
        """
        if not Settings.ADMISSION_ENABLED:
            return None
        from p2pfl_tpu_torch.privacy.masking import ring_dtype

        if not isinstance(info, dict):
            return self.record("masked_structure", source, cmd)
        try:
            bits = int(info["bits"])
            declared_n = int(info["n"])
            int(info["round"])
        except (KeyError, TypeError, ValueError):
            return self.record("masked_structure", source, cmd)
        if bits != Settings.PRIVACY_RING_BITS or declared_n != len(set(committee)):
            return self.record("masked_structure", source, cmd)
        if not contributors or not set(contributors) <= set(committee):
            return self.record("masked_member", source, cmd)
        ks = [int(k) for k in expected_ks if int(k) > 0]
        if len(arrays) != len(ks):
            return self.record("masked_structure", source, cmd)
        dt = ring_dtype(bits)
        for a, k in zip(arrays, ks):
            a = np.asarray(a)
            if a.dtype != dt or a.shape != (k,):
                return self.record("masked_structure", source, cmd)
        return None

    # --- num_samples clamp ----------------------------------------------------

    def clamp_num_samples(self, claimed: int, source: str = "?") -> int:
        """Cap the unauthenticated wire claim at ``MAX_CLAIMED_SAMPLES``."""
        claimed = int(claimed)
        cap = Settings.MAX_CLAIMED_SAMPLES
        if claimed <= cap:
            return max(claimed, 0)
        _CLAMPED.labels(self._addr).inc()
        key = (source, "samples")
        if key not in self._warned:
            self._warned.add(key)
            log.warning(
                "(%s) %s claims %d samples — clamped to MAX_CLAIMED_SAMPLES=%d",
                self._addr, source, claimed, cap,
            )
        return cap

    def reset(self) -> None:
        with self._lock:
            self._norms.clear()
            self._warned.clear()
