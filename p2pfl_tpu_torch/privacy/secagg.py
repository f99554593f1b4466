"""Committee-based secure aggregation on the gossip wire (the port's copy of
``p2pfl_tpu/privacy/secagg.py``).

One masked round, end to end (sync scheduler; the async scheduler runs the
DP half of the plane only):

1. **Bootstrap** — every node broadcasts its session public key
   (``privacy_key``); :class:`~p2pfl_tpu_torch.privacy.masking.PairwiseMasker`
   derives pair secrets on demand.
2. **Encode** (:meth:`PrivacyPlane.mask_own`) — the trainer computes its
   round delta against the shared round anchor, adds the error-feedback
   residual, samples it on the round's SHARED rand-k support (public seed →
   zero index bytes on the wire), clamps each value to
   ``±PRIVACY_VALUE_RANGE`` (clipping-at-sender), quantizes onto the
   integer lattice, and adds its pairwise mask total. The EF residual
   absorbs clamp + lattice error element-exactly.
3. **Gossip** — masked frames ride the normal partial-model gossip
   (codec label ``masked``); lattice vectors ADD mod the ring, so partial
   aggregation, contributor dedup, coverage tracking and overlap drains all
   work unchanged (:class:`~p2pfl_tpu_torch.learning.aggregators.masked.
   MaskedFedAvg`).
4. **Screen** — the committee cannot norm-screen a masked frame (its values
   are uniform ring elements by design);
   :meth:`p2pfl_tpu_torch.comm.admission.AdmissionController.screen_masked`
   validates everything that IS checkable (ring dtype, per-tensor support
   sizes, declared round/committee) and the committee-side range check at
   finalize catches what is not.
5. **Finalize** (:meth:`PrivacyPlane.finalize`) — with every committee
   member present the pairwise masks have already cancelled in the merged
   sum; for each missing masker the survivors' revealed ROUND-SCOPED pair
   secrets (``privacy_repair`` — ``H(pair_secret, round)``, never the pair
   secret itself) reconstruct the uncancelled shares to subtract. The
   centered lattice sum is range-checked (``n * qmax`` — only a ring wrap,
   i.e. a hostile or unrepaired mask share, can exceed it), dequantized,
   averaged with UNIT weights (the committee mean; the unauthenticated
   ``num_samples`` claim cannot weight what it cannot inspect), and
   scattered onto the anchor.

Masked FedAvg is bit-exact with the identical pipeline run maskless: the
masks cancel in modular integer arithmetic, not to float epsilon.

Where the work runs: the full-size passes (the delta against the anchor,
the residual, non-finite zeroing, the gather at the support, the clamp and
the quantization in :meth:`~PrivacyPlane.mask_own`, and the scatter of the
committee mean onto the anchor in :meth:`~PrivacyPlane.finalize`) run in
torch on the plane's device, the node's; the supports, the mask streams,
the ring sums and the packing stay numpy on the host, as in the JAX
package, and only support-sized arrays cross between the two. Every float
step is the JAX package's f32 (or f64) operation in the same order, so a
node's lattice bytes and residual bits are the same on the card, on the CPU
and in the JAX package. The quantizer divides by the scale as a tensor:
CUDA turns a division by a host scalar into a multiplication by its
reciprocal, which can move a value across a rounding half-way point.
"""

from __future__ import annotations

import logging
import threading
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from p2pfl_tpu_torch.config import Settings
from p2pfl_tpu_torch.device import DeviceLike, resolve_device
from p2pfl_tpu_torch.models.model_handle import ModelHandle
from p2pfl_tpu_torch.ops.serialization import serialize_arrays
from p2pfl_tpu_torch.privacy.masking import (
    PairwiseMasker,
    center_ring,
    lattice_qmax,
    pack_ring,
    ring_dtype,
    round_secret,
    shared_support,
    signed_share,
    unpack_ring,
)
from p2pfl_tpu_torch.telemetry import REGISTRY

log = logging.getLogger("p2pfl_tpu_torch")

#: Frame-metadata key marking a masked lattice frame. The payload's arrays
#: are per-float-tensor lattice vectors over the round's shared support;
#: non-float leaves ship nothing (finalize carries the anchor's value).
MASKED_META_KEY = "__masked__"

#: additional_info key carried on in-process masked handles.
MASKED_INFO_KEY = "__masked__"

_MASKED_FRAMES = REGISTRY.counter(
    "p2pfl_privacy_masked_frames_total",
    "Masked lattice frames encoded for the wire",
    labels=("node",),
)
_MASKED_ROUNDS = REGISTRY.counter(
    "p2pfl_privacy_masked_rounds_total",
    "Masked-round finalizations by outcome (ok / unrepaired / range / "
    "structure)",
    labels=("node", "outcome"),
)
_REPAIRS = REGISTRY.counter(
    "p2pfl_privacy_repairs_total",
    "Mask-repair shares by role (tx = revealed own round-scoped pair "
    "secret for a dead masker, rx = stored a survivor's reveal, applied = "
    "subtracted at finalize)",
    labels=("node", "role"),
)

# Supports are a pure function of public state; a round's are derived by
# mask_own, by every received frame's screen and by finalize, so the last
# few geometries are kept (a full-width LM's take ~0.5 s of host time).
_SUPPORTS: Dict[tuple, List[Optional[np.ndarray]]] = {}
_SUPPORTS_LOCK = threading.Lock()
_SUPPORTS_KEEP = 4


def masked_info(handle: ModelHandle) -> Optional[Dict[str, Any]]:
    """The masked-lattice descriptor of an in-process handle, or ``None``
    for a plaintext model handle."""
    info = handle.additional_info.get(MASKED_INFO_KEY)
    return info if isinstance(info, dict) else None


def _host(a: Any) -> np.ndarray:
    """A leaf as a host numpy array (tensors are copied off their device)."""
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _is_float(a: Any) -> bool:
    if isinstance(a, torch.Tensor):
        return a.is_floating_point()
    return np.issubdtype(np.asarray(a).dtype, np.floating)


class PrivacyPlane:
    """Per-node secure-aggregation state (held on
    :class:`~p2pfl_tpu_torch.node_state.NodeState` like the delta codec and
    the admission controller). Thread-safe: encode runs on the stage thread,
    repairs and key learning on transport threads.

    Args:
        addr: the node's address.
        device: where the full-size passes run (the node's device; default
            ``"cuda"``, tests pass ``"cpu"``).
    """

    def __init__(self, addr: str, device: DeviceLike = "cuda") -> None:
        self.addr = addr
        self.device = resolve_device(device)
        self._lock = threading.RLock()
        self.masker = PairwiseMasker(addr)
        # Error-feedback residual, f32 flat per tensor on the plane's device
        # (None until the first masked encode; dropped when the model
        # structure changes).
        self._residual: Optional[List[torch.Tensor]] = None
        # (round, survivor, dead) -> ROUND-SCOPED secret revealed for
        # repair. First write wins: a later frame claiming the same pair
        # must not displace a stored reveal (a hostile overwrite would make
        # finalize subtract garbage and trip the range check).
        self._repairs: Dict[Tuple[int, str, str], bytes] = {}
        # rounds whose repairs we already broadcast per dead peer (dedup).
        self._repairs_sent: set = set()
        # round -> committee the masks were generated against (registered
        # by mask_own/finalize; validates repair claims). Bounded.
        self._committees: Dict[int, frozenset] = {}

    # --- key agreement (privacy_key command) ---------------------------------

    def key_payload(self) -> str:
        return self.masker.public_key_hex()

    def learn_key(self, peer: str, pubkey_hex: str) -> bool:
        with self._lock:
            return self.masker.learn_key(peer, pubkey_hex)

    def knows_keys(self, peers: Sequence[str]) -> bool:
        with self._lock:
            return all(self.masker.knows(p) for p in peers)

    def missing_keys(self, peers: Sequence[str]) -> List[str]:
        with self._lock:
            return [p for p in peers if not self.masker.knows(p)]

    # --- geometry ------------------------------------------------------------

    @staticmethod
    def lattice_params(committee_size: int) -> Tuple[int, int, float]:
        """(ring bits, qmax, scale) of a masked round for ``committee_size``
        members — a pure function of public configuration, so every member
        derives the same lattice."""
        bits = Settings.PRIVACY_RING_BITS
        if committee_size > Settings.PRIVACY_MAX_COMMITTEE:
            raise ValueError(
                f"masked committee of {committee_size} exceeds "
                f"PRIVACY_MAX_COMMITTEE={Settings.PRIVACY_MAX_COMMITTEE}"
            )
        qmax = lattice_qmax(bits, committee_size)
        scale = Settings.PRIVACY_VALUE_RANGE / qmax
        return bits, qmax, scale

    @staticmethod
    def supports(round: int, shapes: Sequence[tuple], floats: Sequence[bool]) -> List[Optional[np.ndarray]]:
        """Shared rand-k support per tensor (``None`` where ``floats`` says
        the leaf is not floating point: masked frames do not carry it)."""
        key = (int(round), tuple(tuple(int(d) for d in s) for s in shapes), tuple(bool(f) for f in floats),
               float(Settings.PRIVACY_MASK_RATIO))
        with _SUPPORTS_LOCK:
            hit = _SUPPORTS.get(key)
        if hit is not None:
            return list(hit)
        out: List[Optional[np.ndarray]] = []
        for i, (shape, is_float) in enumerate(zip(key[1], key[2])):
            size = int(np.prod(shape, dtype=np.int64)) if shape else 1
            if not is_float or size == 0:
                out.append(None)
                continue
            out.append(shared_support(round, i, size, Settings.PRIVACY_MASK_RATIO))
        with _SUPPORTS_LOCK:
            _SUPPORTS[key] = out
            while len(_SUPPORTS) > _SUPPORTS_KEEP:
                del _SUPPORTS[next(iter(_SUPPORTS))]
        return list(out)

    # --- encode --------------------------------------------------------------

    def mask_own(
        self,
        model: ModelHandle,
        anchor_leaves: Sequence[Any],
        round: int,
        committee: Sequence[str],
        *,
        mask: bool = True,
    ) -> ModelHandle:
        """Masked lattice handle of this node's round contribution.

        ``mask=False`` runs the IDENTICAL lattice pipeline with a zero mask
        — the bit-exactness comparator (and the fallback when a committee
        member's key is missing would poison the sum anyway; callers decide).
        Raises ``ValueError`` when a committee pubkey is missing with
        ``mask=True``.
        """
        committee = sorted(set(committee))
        self.note_committee(round, committee)
        bits, qmax, scale = self.lattice_params(len(committee))
        dt = ring_dtype(bits)
        dev = self.device
        leaves = model.get_parameters()
        anchors = [self._flat32(a, dev) for a in anchor_leaves]
        if len(leaves) != len(anchors):
            raise ValueError("model/anchor structure mismatch")
        value_range = Settings.PRIVACY_VALUE_RANGE
        with self._lock:
            if mask:
                missing = self.missing_keys([p for p in committee if p != self.addr])
                if missing:
                    raise ValueError(f"missing committee pubkeys: {missing}")
            if self._residual is not None and len(self._residual) != len(leaves):
                self._residual = None
            if self._residual is None:
                self._residual = [torch.zeros(a.numel(), dtype=torch.float32, device=dev) for a in anchors]
            shapes = [tuple(l.shape) for l in leaves]
            supports = self.supports(round, shapes, [_is_float(l) for l in leaves])
            scale_t = torch.tensor(scale, dtype=torch.float32, device=dev)
            qs: List[torch.Tensor] = []
            ks: List[int] = []
            for i, (leaf, anchor) in enumerate(zip(leaves, anchors)):
                idx = supports[i]
                if idx is None:
                    ks.append(0)
                    continue
                flat = self._flat32(leaf, dev)
                if self._residual[i].numel() != flat.numel():
                    self._residual[i] = torch.zeros(flat.numel(), dtype=torch.float32, device=dev)
                acc = (flat - anchor) + self._residual[i]
                # A diverged tensor must not launder NaNs through the
                # lattice: transmit zero, keep the finite residual parts.
                acc = torch.where(torch.isfinite(acc), acc, torch.zeros((), dtype=acc.dtype, device=dev))
                idx_t = torch.from_numpy(idx).to(dev)
                v = acc[idx_t]
                q = torch.clamp(torch.round(torch.clamp(v, -value_range, value_range) / scale_t), -qmax, qmax)
                # Element-exact error feedback: residual[idx] becomes
                # acc[idx] - q*scale, everything else keeps the full delta.
                resid = acc.clone()
                resid[idx_t] = v - q * scale_t
                self._residual[i] = resid
                qs.append(q.to(torch.int32))
                ks.append(int(idx.size))
            # One transfer of every tensor's lattice values to the host.
            host_q = torch.cat(qs).cpu().numpy().astype(np.int64) if qs else np.zeros(0, np.int64)
            lattices: List[np.ndarray] = []
            at = 0
            for i, k in enumerate(ks):
                if k == 0:
                    continue
                lat = (host_q[at:at + k] % (1 << bits)).astype(dt)
                at += k
                if mask:
                    lat = (lat + self.masker.total_mask(committee, round, i, k, bits)).astype(dt)
                lattices.append(lat)
            _MASKED_FRAMES.labels(self.addr).inc()
            return ModelHandle(
                params=lattices,
                contributors=[self.addr],
                num_samples=model.get_num_samples(),
                additional_info={
                    MASKED_INFO_KEY: {
                        "round": int(round),
                        "bits": int(bits),
                        "n": len(committee),
                        "ks": ks,
                    }
                },
            )

    @staticmethod
    def _flat32(a: Any, dev: torch.device) -> torch.Tensor:
        t = a if isinstance(a, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(a))
        return t.detach().to(device=dev, dtype=torch.float32).reshape(-1)

    def residual(self) -> Optional[List[torch.Tensor]]:
        """The error-feedback residual, one flat f32 tensor per leaf (None
        before the first masked encode)."""
        with self._lock:
            return None if self._residual is None else list(self._residual)

    # --- wire codec ----------------------------------------------------------

    @staticmethod
    def encode_frame(handle: ModelHandle, wire_ctx: str = "") -> bytes:
        """Serialize a masked lattice handle for the gossip wire: one
        bit-packed value plane per masked tensor (12-bit rings pack
        two-per-three-bytes — 1.5 B/value; the shared support ships no
        index bytes at all), lattice descriptor + federation metadata in
        the frame header."""
        info = masked_info(handle)
        if info is None:
            raise ValueError("not a masked handle")
        bits = int(info["bits"])
        planes = [pack_ring(_host(a), bits) for a in handle.get_parameters()]
        meta: Dict[str, Any] = {
            "contributors": list(handle.contributors),
            "num_samples": int(handle.get_num_samples()),
            MASKED_META_KEY: dict(info),
        }
        if wire_ctx:
            from p2pfl_tpu_torch.telemetry import tracing

            meta[tracing.TRACE_META_KEY] = wire_ctx
        return serialize_arrays(planes, meta)

    @staticmethod
    def parse_frame(arrays: Sequence[Any], meta: Dict[str, Any]) -> List[np.ndarray]:
        """Unpack a masked frame's value planes into in-memory lattice
        vectors. Raises ``ValueError`` on any geometry a hostile frame
        controls (unknown ring, plane/k disagreement, tensor count) —
        callers surface that as a counted ``corrupt`` rejection BEFORE any
        value can enter a lattice sum."""
        info = meta.get(MASKED_META_KEY)
        if not isinstance(info, dict):
            raise ValueError("not a masked frame")
        bits = int(info.get("bits", 0))
        if bits not in (12, 16, 32):
            raise ValueError(f"unknown masked ring width {bits}")
        ks = [int(k) for k in (info.get("ks") or []) if int(k) > 0]
        if len(arrays) != len(ks):
            raise ValueError("masked frame tensor count disagrees with ks")
        return [unpack_ring(_host(a), k, bits) for a, k in zip(arrays, ks)]

    @staticmethod
    def is_masked_frame(meta: Dict[str, Any]) -> bool:
        return isinstance(meta.get(MASKED_META_KEY), dict)

    @staticmethod
    def handle_from_frame(
        arrays: Sequence[np.ndarray],
        meta: Dict[str, Any],
        contributors: List[str],
        num_samples: int,
    ) -> ModelHandle:
        """In-process masked handle from an admission-screened wire frame."""
        return ModelHandle(
            params=[np.asarray(a) for a in arrays],
            contributors=contributors,
            num_samples=num_samples,
            additional_info={MASKED_INFO_KEY: dict(meta[MASKED_META_KEY])},
        )

    # --- repairs (masker dropout) --------------------------------------------

    def note_committee(self, round: int, committee: Sequence[str]) -> None:
        """Register the committee a masked round's masks were generated
        against (called by :meth:`mask_own` and :meth:`finalize`). Repair
        claims for the round are validated against it; bounded to the last
        few rounds so a long session cannot grow it."""
        with self._lock:
            self._committees[int(round)] = frozenset(committee)
            while len(self._committees) > 8:
                del self._committees[min(self._committees)]

    def repair_secrets_for(self, dead: str, round: int) -> Optional[str]:
        """Hex ROUND-SCOPED secret (``H(pair_secret, round)``) to reveal
        for ``dead`` — never the raw pair secret, which derives every
        round's mask streams and must not hit the wire (None when unknown
        or already revealed for this round)."""
        with self._lock:
            if not self.masker.knows(dead) or dead == self.addr:
                return None
            key = (int(round), dead)
            if key in self._repairs_sent:
                return None
            self._repairs_sent.add(key)
            sec = round_secret(self.masker.pair_secret(dead), round)
        _REPAIRS.labels(self.addr, "tx").inc()
        return sec.hex()

    def note_repair(self, round: int, survivor: str, dead: str, secret_hex: str) -> bool:
        """Store a survivor's revealed round-scoped secret (transport
        thread; ``survivor`` is the frame's transport source, so the claim
        is bound to the sender). First write wins per (round, survivor,
        dead), and both parties must be members of the round's registered
        committee — a peer outside it has no pair share in the sum and its
        'reveal' could only corrupt finalize. A round with no registered
        committee rejects every claim: any aggregator that will finalize
        round ``r`` ran :meth:`mask_own` (which registers) at round start,
        before a mid-round death can be detected, so the only frames this
        drops are ones nobody here could validate or use."""
        try:
            sec = bytes.fromhex(secret_hex)
        except (TypeError, ValueError):
            return False
        if len(sec) != 32 or survivor == dead:
            return False
        key = (int(round), survivor, dead)
        with self._lock:
            members = self._committees.get(key[0])
            if members is None or survivor not in members or dead not in members:
                return False
            if key in self._repairs:
                return False
            self._repairs[key] = sec
        _REPAIRS.labels(self.addr, "rx").inc()
        return True

    # --- finalize ------------------------------------------------------------

    def finalize(
        self,
        handle: ModelHandle,
        committee: Sequence[str],
        anchor_leaves: Sequence[Any],
        anchor_round: Optional[int] = None,
    ) -> Tuple[Optional[List[torch.Tensor]], str]:
        """Unmask the merged committee sum into model-shaped parameters
        (f32 tensors on the plane's device).

        ``anchor_round``, when given, must match the aggregate's declared
        round: the lattice deltas were computed against that round's anchor,
        and scattering them onto any other base would silently corrupt the
        mean (counted as ``structure``).

        Returns ``(params, "ok")`` or ``(None, reason)`` with ``reason`` in
        ``{"unrepaired", "range", "structure"}`` — the caller falls back to
        its own plaintext model and the outcome is counted either way.
        """
        info = masked_info(handle)
        if info is None:
            return None, self._outcome("structure")
        committee = sorted(set(committee))
        round = int(info.get("round", -1))
        bits = int(info.get("bits", 0))
        declared_n = int(info.get("n", 0))
        if bits != Settings.PRIVACY_RING_BITS or declared_n != len(committee):
            return None, self._outcome("structure")
        if anchor_round is not None and int(anchor_round) != round:
            log.warning(
                "(%s) masked round %s: anchor is for round %s — refusing to "
                "scatter onto the wrong base", self.addr, round, anchor_round,
            )
            return None, self._outcome("structure")
        self.note_committee(round, committee)
        try:
            _, qmax, scale = self.lattice_params(declared_n)
        except ValueError:
            return None, self._outcome("structure")
        dt = ring_dtype(bits)
        present = sorted(set(handle.contributors) & set(committee))
        missing = sorted(set(committee) - set(present))
        if not present:
            return None, self._outcome("structure")
        dev = self.device
        shapes = [tuple(a.shape) for a in anchor_leaves]
        # The anchors are taken as f32 leaves, every one a float tensor.
        supports = self.supports(round, shapes, [True] * len(shapes))
        lattices = [np.asarray(a) for a in handle.get_parameters()]
        masked_supports = [s for s in supports if s is not None]
        if len(lattices) != len(masked_supports) or any(
            l.dtype != dt or l.shape != (s.size,)
            for l, s in zip(lattices, masked_supports)
        ):
            return None, self._outcome("structure")
        # Subtract the uncancelled shares of every (present, missing) pair:
        # our own round-scoped pair secrets cover pairs involving us,
        # survivors' repair reveals (already round-scoped) cover the rest.
        # Any still-unknown secret aborts — an uncancelled mask share is
        # uniform ring noise, not an aggregate.
        corrections: List[Tuple[bytes, str, str]] = []
        with self._lock:
            for i_addr in present:
                for d_addr in missing:
                    if i_addr == self.addr:
                        sec = (
                            self.masker.pair_round_secret(d_addr, round)
                            if self.masker.knows(d_addr)
                            else None
                        )
                    else:
                        sec = self._repairs.get((round, i_addr, d_addr))
                    if sec is None:
                        log.warning(
                            "(%s) masked round %s: no repair share for pair "
                            "(%s, %s) — falling back to plaintext",
                            self.addr, round, i_addr, d_addr,
                        )
                        return None, self._outcome("unrepaired")
                    corrections.append((sec, i_addr, d_addr))
        # Host: unmask, range-check and dequantize every tensor's sum (the
        # JAX package's f64 arithmetic) before anything touches the anchor.
        n = len(present)
        bound = int(n * qmax * Settings.PRIVACY_RANGE_MULT)
        means: List[Optional[np.ndarray]] = []
        li = 0
        for i, idx in enumerate(supports):
            if idx is None:
                means.append(None)
                continue
            lat = lattices[li].copy()
            for sec, i_addr, d_addr in corrections:
                lat = (lat - signed_share(sec, i_addr, d_addr, i, idx.size, bits)).astype(dt)
            li += 1
            t = center_ring(lat, bits)
            # Committee-side range check: an honest sum of |q| <= qmax over
            # n members is bounded; beyond it a mask share failed to cancel
            # (hostile frame, wrong pair secret) — reject before the values
            # can touch the model or the next round's anchor.
            if t.size and int(np.abs(t).max()) > bound:
                log.warning(
                    "(%s) masked round %s: lattice sum out of range "
                    "(|t|max=%d > %d) — rejecting the masked aggregate",
                    self.addr, round, int(np.abs(t).max()), bound,
                )
                return None, self._outcome("range")
            means.append((t.astype(np.float64) * float(scale) / n).astype(np.float32))
        # Device: scatter each committee mean onto its anchor leaf.
        out: List[torch.Tensor] = []
        for anchor, idx, vbar in zip(anchor_leaves, supports, means):
            flat = self._flat32(anchor, dev).clone()
            if idx is not None:
                idx_t = torch.from_numpy(idx).to(dev)
                flat[idx_t] = flat[idx_t] + torch.from_numpy(vbar).to(dev)
            out.append(flat.reshape(tuple(anchor.shape)))
        if corrections:
            _REPAIRS.labels(self.addr, "applied").inc(len(corrections))
        from p2pfl_tpu_torch.telemetry.ledger import LEDGERS

        if LEDGERS.enabled():
            LEDGERS.get(self.addr).emit(
                "privacy_masked",
                round=round,
                dedup_key=("privacy_masked", round),
                members=present,
                repaired=missing,
            )
        return out, self._outcome("ok")

    def _outcome(self, outcome: str) -> str:
        _MASKED_ROUNDS.labels(self.addr, outcome).inc()
        return outcome

    # --- recovery journal ----------------------------------------------------

    def export_state(self) -> Dict[str, Any]:
        with self._lock:
            return {"masker": self.masker.export_state()}

    def import_state(self, st: Dict[str, Any]) -> None:
        masker = (st or {}).get("masker")
        if not masker:
            return
        with self._lock:
            try:
                self.masker = PairwiseMasker.import_state(self.addr, masker)
            except (KeyError, TypeError, ValueError):
                log.warning(
                    "(%s) journaled privacy key material unreadable — "
                    "minting a fresh session keypair", self.addr,
                )

    def reset(self) -> None:
        with self._lock:
            self._residual = None
            self._repairs.clear()
            self._repairs_sent.clear()
            self._committees.clear()


__all__ = [
    "MASKED_INFO_KEY",
    "MASKED_META_KEY",
    "PrivacyPlane",
    "masked_info",
]
