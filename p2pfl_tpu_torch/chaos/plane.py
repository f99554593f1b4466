"""Deterministic chaos/fault-injection plane.

Real-world FL treats device churn as the common case, not the exception
(Papaya, arxiv 2111.04877), but nothing in a clean in-process federation can
*reproduce* churn: every wait point quietly passes. This plane wraps the one
choke point both transports share — :meth:`CommunicationProtocol.send` — with
seeded, per-peer-pair fault rules:

* **drop** — the frame silently vanishes (sender believes it was delivered),
* **delay / jitter** — the sending thread stalls before the transport call
  (models a slow link; per-node ``set_slow`` models a straggling peer),
* **duplicate** — the frame is delivered twice (dedup/idempotency probes),
* **partition** — sends across declared groups fail like a dead link,
* **crash** — all sends to/from an address fail (an unreachable-but-alive
  node; for a *real* mid-round process death use :meth:`Node.crash`),
* **byzantine** — a peer turns adversarial on the MODEL plane: every
  weights frame it sends is corrupted at the send choke point
  (:meth:`set_byzantine`): ``signflip`` negates the float tensors,
  ``scaled`` multiplies them (default x10), ``nan`` replaces them with NaN
  garbage, and ``inflate`` blows up the unauthenticated ``num_samples``
  claim. Control frames (votes, heartbeats) stay honest — the adversary
  participates in the protocol while poisoning the learning, the standard
  model-poisoning threat model (Blanchard et al. 2017). Corruption is a
  pure function of the frame (no RNG draws), so it composes with the
  deterministic per-pair decision streams without desyncing them.

Determinism: every (src, dst) pair owns a ``random.Random`` seeded from
``(Settings.CHAOS_SEED, src, dst)``, and every probabilistic intercept draws
the same fixed number of uniforms regardless of which faults are enabled —
so the i-th send on a pair receives the same decision on every run with the
same seed and config. Scenario state (partitions/crashes/slow peers) is
plane-level and scoped by :meth:`reset` / :meth:`overridden`.

Configuration rides :class:`~p2pfl_tpu_torch.config.Settings` (``P2PFL_TPU_CHAOS_*``
env overrides, validated at config load like ``WIRE_COMPRESSION``), so
``Settings.overridden(CHAOS_DROP_RATE=...)`` and the plane's own scoped
:meth:`overridden` compose. Every injected fault is counted both in the
process-wide telemetry registry (``p2pfl_chaos_faults_total``) and in a
plane-local table (:meth:`fault_counts`) used for determinism assertions.
"""

from __future__ import annotations

import contextlib
import logging
import random
import threading
from dataclasses import dataclass
from dataclasses import replace as _dc_replace
from typing import (
    TYPE_CHECKING,
    Any,
    Dict,
    Iterator,
    List,
    Optional,
    Sequence,
    Set,
    Tuple,
)

from p2pfl_tpu_torch.config import Settings
from p2pfl_tpu_torch.telemetry import REGISTRY

if TYPE_CHECKING:  # pragma: no cover
    from p2pfl_tpu_torch.comm.envelope import Envelope

log = logging.getLogger("p2pfl_tpu_torch")

_FAULTS = REGISTRY.counter(
    "p2pfl_chaos_faults_total",
    "Faults injected into the transport send path, by sending node and kind",
    labels=("node", "fault"),
)


@dataclass(frozen=True)
class Decision:
    """What the send path must do with one outbound frame."""

    drop: bool = False
    #: fault name when the link is blocked ("partition" | "crash"); the send
    #: path raises a CommunicationError, engaging the normal retry/removal
    #: failure machinery exactly as a real dead link would.
    blocked: Optional[str] = None
    delay_s: float = 0.0
    #: extra deliveries on top of the real one.
    duplicates: int = 0


_CLEAN = Decision()

#: Supported Byzantine peer behaviors (model-plane frame corruption).
BYZANTINE_ATTACKS = ("signflip", "scaled", "nan", "inflate")

# --- adaptive adversary (campaign robustness family) --------------------------
#
# A static adversary keeps sending the same poison after admission starts
# rejecting it; a realistic one OBSERVES the rejection and adapts. The
# adaptive family climbs this ladder: full-parameter negation (crude, lands
# ~2x the local norm away — admission's bootstrap bound already rejects it),
# then a x10 blow-up (still far outside the admitted-norm envelope), and
# finally "norm riding": reflecting only the round's training delta
# (``old - delta``), which keeps the update's distance from honest peers
# inside the admitted-norm distribution while still pushing the aggregate
# the wrong way. The first two stages are expected to be rejected — they
# exist to model the probing an adversary does before finding the attack
# that slips through.
ADAPTIVE_LADDER = ("signflip", "scaled", "norm_ride")

#: Ladder stages the admission norm gate is expected to reject; the
#: adversary treats an attributed rejection while in one of these stages as
#: the signal to escalate. ``norm_ride`` is absent: once riding the norm
#: envelope there is nothing left to escalate to.
ADAPTIVE_REJECTED_STAGES = frozenset({"signflip", "scaled"})

#: Multiplier for the adaptive ``scaled`` stage (full-parameter blow-up).
ADAPTIVE_SCALE = 10.0


def adaptive_attack_schedule(
    rounds: int,
    ladder: Sequence[str] = ADAPTIVE_LADDER,
    patience: int = 1,
) -> Tuple[str, ...]:
    """The adaptive adversary's attack-per-round stream as a PURE function
    of ``(rounds, ladder, patience)`` — the replay oracle.

    Recurrence: the adversary opens every campaign at ``ladder[0]`` and
    escalates one rung after ``patience`` rounds in a rejected stage
    (stages in :data:`ADAPTIVE_REJECTED_STAGES` are rejected by
    construction — the admission norm gate rejects them whenever the
    federation has >=1 honest receiver, which every campaign scenario
    guarantees). The live :class:`AdaptiveAdversary` drives the same
    recurrence off the OBSERVED ``p2pfl_updates_rejected_total``
    attribution; this closed form is what tests and the campaign invariants
    compare its decision stream against, so a desync between "what the
    adversary saw" and "what the seed implies" is a caught failure, not a
    silent drift."""
    if patience < 1:
        raise ValueError(f"patience must be >= 1, got {patience}")
    if not ladder:
        raise ValueError("ladder must not be empty")
    stage, hits = 0, 0
    out = []
    for _ in range(max(0, int(rounds))):
        attack = ladder[stage]
        out.append(attack)
        if attack in ADAPTIVE_REJECTED_STAGES:
            hits += 1
            if hits >= patience and stage < len(ladder) - 1:
                stage += 1
                hits = 0
    return tuple(out)


def adaptive_poison(new_params, old_params, attack: str):
    """Apply one adaptive-ladder ``attack`` to a trained leaf pair, in torch
    on the leaf's own device (numpy leaves are read as CPU tensors); bit for
    bit the JAX package's ``adaptive_poison``.

    * ``signflip`` — full-parameter negation ``-new`` (NOT the delta
      reflection the frame-level chaos attack of the same name applies):
      distance ~2*||params|| from any honest peer, far outside the
      admission bound;
    * ``scaled`` — full-parameter blow-up ``new * ADAPTIVE_SCALE``;
    * ``norm_ride`` — delta reflection ``old - (new - old)``, delegated to
      :func:`p2pfl_tpu_torch.parallel.simulation.poison_delta`, the fused
      round's own leaf math.

    Pure, RNG-free, float32 like ``poison_delta`` — composes with the
    deterministic chaos decision streams without desyncing them."""
    import torch

    from p2pfl_tpu_torch.parallel.simulation import poison_delta

    new = torch.as_tensor(new_params)
    if attack == "signflip":
        return -new.float()
    if attack == "scaled":
        return new.float() * ADAPTIVE_SCALE
    if attack == "norm_ride":
        return poison_delta(new, torch.as_tensor(old_params), "norm_ride")
    raise ValueError(f"unknown adaptive attack {attack!r}")


@dataclass(frozen=True)
class RecoveryEvent:
    """One scheduled recovery-scenario step: at round/window ``when``,

    * ``crash`` — ``node`` dies abruptly (:meth:`Node.crash`),
    * ``restart`` — the same node is rebuilt from its journal
      (:meth:`Node.resume`) and re-enters as itself,
    * ``partition`` — the fleet splits into ``groups``
      (:meth:`ChaosPlane.partition`),
    * ``heal`` — the partition heals (:meth:`ChaosPlane.heal`).

    Executing an event is the caller's job; each executed event is reported
    via :meth:`ChaosPlane.recovery` so it lands in the deterministic fault
    table (``fault="recovery"``) like every other injected fault."""

    when: int
    kind: str  # "crash" | "restart" | "partition" | "heal"
    node: str = ""
    groups: Tuple[Tuple[str, ...], ...] = ()


#: Host-fault kinds the engine supervisor's injector can execute.
HOST_FAULT_KINDS = ("kill", "oom", "sigterm", "slow")


@dataclass(frozen=True)
class HostFaultEvent:
    """One scheduled host fault against a fused engine's chunk loop: at
    chunk boundary ``when``,

    * ``kill`` — the engine process "dies" (the supervisor closes and
      rebuilds the engine, then resumes from the last journal),
    * ``oom`` — the chunk launch raises an OOM ``RuntimeError`` AFTER the
      donated carry buffers are gone (the donation-failure shape),
    * ``sigterm`` — the preemption signal arrives (journal-now + restart),
    * ``slow`` — the host straggles; the supervisor takes a defensive
      extra journal but the chunk completes.

    Executing an event is the supervisor's job; each executed event is
    reported via :meth:`ChaosPlane.host_fault` so it lands in the
    deterministic fault table (``fault="host_fault"``) like every other
    injected fault."""

    when: int
    kind: str  # one of HOST_FAULT_KINDS


@dataclass(frozen=True)
class ChurnEvent:
    """One scheduled membership change: at round/window ``when``, ``node``
    performs ``kind`` ("leave" — abrupt death via :meth:`Node.crash`; or
    "join" — a cold node enters, in async mode via the full-model catch-up
    bootstrap)."""

    when: int
    kind: str  # "leave" | "join"
    node: str


@dataclass(frozen=True)
class _Byzantine:
    attack: str
    scale: float = 10.0
    inflate_factor: int = 1_000_000_000


def _bf16_round(x):
    """float32 values -> bf16 bits (uint16), rounded to nearest even; a NaN
    becomes the quiet NaN of its sign (0x7FC0 / 0xFFC0). ml_dtypes' float32
    -> bfloat16 cast, on bits, so corrupted frames are the JAX package's
    byte for byte (torch's cast differs on NaNs)."""
    import numpy as np

    x = np.ascontiguousarray(x, np.float32)
    u = x.view(np.uint32)
    rounded = ((u + np.uint32(0x7FFF) + ((u >> 16) & np.uint32(1))) >> 16).astype(np.uint16)
    nan = np.where((u >> 31) != 0, np.uint16(0xFFC0), np.uint16(0x7FC0))
    return np.where(np.isnan(x), nan, rounded)


def _bf16_attack(bits, byz: _Byzantine, negate_bits: bool = True):
    """A float attack on bf16 values given as their bits (uint16); returns
    the corrupted bits. ``negate_bits``: ``signflip`` flips the sign bit (a
    bf16 array's negation) instead of negating through float32 and rounding
    back (the coalesced value plane's way)."""
    import numpy as np

    if byz.attack == "nan":
        return np.full(bits.shape, 0x7FC0, np.uint16)
    if byz.attack == "signflip" and negate_bits:
        return bits ^ np.uint16(0x8000)
    vals = (bits.astype(np.uint32) << 16).view(np.float32)
    if byz.attack == "signflip":
        return _bf16_round(-vals)
    return _bf16_round(vals * np.float32(byz.scale))


class ChaosPlane:
    """Process-wide fault injector (one instance, :data:`CHAOS`, serves every
    in-process node — per-pair rules keep federations independent)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._rngs: Dict[Tuple[str, str], random.Random] = {}
        self._counts: Dict[str, int] = {}
        self._groups: Dict[str, int] = {}  # addr -> partition group id
        self._crashed: Set[str] = set()
        self._slow: Dict[str, float] = {}  # addr -> extra delay per send
        self._byzantine: Dict[str, _Byzantine] = {}  # addr -> attack config

    # --- activation ---------------------------------------------------------

    @property
    def active(self) -> bool:
        """True when any fault rule could fire. The send hot path checks this
        first, so a chaos-free federation pays two attribute reads."""
        return bool(
            Settings.CHAOS_ENABLED
            or self._groups
            or self._crashed
            or self._slow
            or self._byzantine
        )

    # --- scenario controls (plane-level state, not Settings) ----------------

    def partition(self, *groups: Sequence[str]) -> None:
        """Block sends between addresses in different ``groups``. Addresses
        in no group are unaffected."""
        with self._lock:
            self._groups = {a: i for i, g in enumerate(groups) for a in g}
        log.warning("chaos: network partitioned into %d groups", len(groups))

    def heal(self) -> None:
        with self._lock:
            self._groups = {}

    def crash(self, addr: str) -> None:
        """Make ``addr`` unreachable (all sends to/from it fail)."""
        with self._lock:
            self._crashed.add(addr)
        log.warning("chaos: %s marked crashed (unreachable)", addr)

    def restore(self, addr: str) -> None:
        with self._lock:
            self._crashed.discard(addr)

    def set_byzantine(
        self,
        addr: str,
        attack: str,
        *,
        scale: float = 10.0,
        inflate_factor: int = 1_000_000_000,
    ) -> None:
        """Turn ``addr`` into a model-poisoning adversary: every weights
        frame it sends is corrupted per ``attack`` (one of
        :data:`BYZANTINE_ATTACKS`). ``scale`` parameterizes the ``scaled``
        attack; ``inflate_factor`` the ``num_samples`` inflation."""
        if attack not in BYZANTINE_ATTACKS:
            raise ValueError(
                f"attack must be one of {BYZANTINE_ATTACKS}, got {attack!r}"
            )
        with self._lock:
            self._byzantine[addr] = _Byzantine(attack, float(scale), int(inflate_factor))
        from p2pfl_tpu_torch.telemetry.ledger import LEDGERS

        LEDGERS.emit(
            addr, "chaos_fault", fault="byzantine", peer=addr, attack=attack
        )
        log.warning("chaos: %s turned byzantine (attack=%s)", addr, attack)

    def clear_byzantine(self, addr: Optional[str] = None) -> None:
        with self._lock:
            if addr is None:
                self._byzantine.clear()
            else:
                self._byzantine.pop(addr, None)

    def byzantine_peers(self) -> Dict[str, str]:
        """{addr: attack} view of the current adversary set."""
        with self._lock:
            return {a: b.attack for a, b in self._byzantine.items()}

    def plan_churn(
        self,
        rounds: int,
        leave_pool: Sequence[str],
        join_pool: Sequence[str],
        *,
        seed: Optional[int] = None,
        leaves_per_round: int = 1,
        joins_per_round: int = 1,
        start: int = 1,
    ) -> Tuple["ChurnEvent", ...]:
        """Seeded per-round membership-churn trace (elastic-federation
        acceptance; reusable by sync benches to show what the barrier does
        under the same trace).

        Deterministic: the schedule is a pure function of ``(seed, pools,
        shape)`` — leave victims are drawn without replacement from
        ``leave_pool`` with a dedicated ``random.Random(f"{seed}|churn")``
        stream; joiners enter in ``join_pool`` order. Executing an event is
        the CALLER's job (crash the node / start + connect + join the new
        one); the caller reports each executed event via :meth:`churn` so it
        lands in ``p2pfl_chaos_faults_total{fault="churn"}`` and the
        determinism-assertion table like every other injected fault.
        """
        rng = random.Random(f"{seed if seed is not None else Settings.CHAOS_SEED}|churn")
        leavers = list(leave_pool)
        joiners = list(join_pool)
        events = []
        for r in range(max(1, start), rounds):
            for _ in range(leaves_per_round):
                if leavers:
                    victim = leavers.pop(rng.randrange(len(leavers)))
                    events.append(ChurnEvent(r, "leave", victim))
            for _ in range(joins_per_round):
                if joiners:
                    events.append(ChurnEvent(r, "join", joiners.pop(0)))
        return tuple(events)

    def plan_recovery(
        self,
        rounds: int,
        nodes: Sequence[str],
        *,
        seed: Optional[int] = None,
        crash_round: int = 1,
        restart_after: int = 1,
        partition_round: Optional[int] = None,
        heal_after: int = 2,
        groups: int = 2,
    ) -> Tuple["RecoveryEvent", ...]:
        """Seeded crash-restart + timed-partition scenario trace (the
        durable-recovery acceptance shape, à la :meth:`plan_churn`).

        Deterministic: a pure function of ``(seed, nodes, shape)`` — the
        crash victim is drawn with a dedicated
        ``random.Random(f"{seed}|recovery")`` stream, and the partition
        split is a seeded shuffle of ``nodes`` dealt round-robin into
        ``groups``. The caller executes each event (crash the node / resume
        it from its journal / partition / heal) and reports it via
        :meth:`recovery` so replays can assert identical event counts.
        """
        rng = random.Random(
            f"{seed if seed is not None else Settings.CHAOS_SEED}|recovery"
        )
        pool = list(nodes)
        events = []
        if crash_round is not None and 0 <= crash_round < rounds and pool:
            victim = pool[rng.randrange(len(pool))]
            events.append(RecoveryEvent(crash_round, "crash", victim))
            back = crash_round + max(1, restart_after)
            if back < rounds:
                events.append(RecoveryEvent(back, "restart", victim))
        if partition_round is not None and 0 <= partition_round < rounds and pool:
            shuffled = list(pool)
            rng.shuffle(shuffled)
            split: Tuple[Tuple[str, ...], ...] = tuple(
                tuple(shuffled[g::groups]) for g in range(max(2, groups))
            )
            events.append(RecoveryEvent(partition_round, "partition", groups=split))
            healed = partition_round + max(1, heal_after)
            events.append(RecoveryEvent(min(healed, rounds), "heal", groups=split))
        return tuple(sorted(events, key=lambda e: (e.when, e.kind, e.node)))

    def plan_masker_dropout(
        self,
        rounds: int,
        committee: Sequence[str],
        *,
        seed: Optional[int] = None,
        drop_round: int = 1,
    ) -> Tuple["RecoveryEvent", ...]:
        """Seeded masker-dropout trace (privacy-plane acceptance): one
        committee member, drawn with a dedicated
        ``random.Random(f"{seed}|masker")`` stream, crashes at
        ``drop_round`` MID-masked-round — after keys were exchanged, before
        its masked frame lands everywhere. The survivors must repair the
        uncancelled pairwise shares (``privacy_repair``) and the round's
        aggregate must stay correct. The caller executes the crash
        (:meth:`Node.crash`) and reports it via :meth:`recovery` so replays
        assert identical event counts, like every other scenario trace."""
        rng = random.Random(
            f"{seed if seed is not None else Settings.CHAOS_SEED}|masker"
        )
        pool = list(committee)
        if not pool or not 0 <= drop_round < rounds:
            return ()
        victim = pool[rng.randrange(len(pool))]
        return (RecoveryEvent(drop_round, "crash", victim),)

    def plan_host_faults(
        self,
        chunks: int,
        *,
        seed: Optional[int] = None,
        kinds: Sequence[str] = ("kill", "oom", "sigterm"),
        start: int = 1,
    ) -> Tuple["HostFaultEvent", ...]:
        """Seeded host-fault trace against a fused engine's chunk loop (the
        preemption-drill acceptance shape, à la :meth:`plan_recovery`).

        Deterministic: a pure function of ``(seed, chunks, kinds, start)``
        — fault chunk indices are drawn WITHOUT replacement from
        ``[start, chunks)`` with a dedicated
        ``random.Random(f"{seed}|hostfault")`` stream, one per requested
        kind in the order given, so replays derive the identical trace and
        soak gates can assert event-count identity. The supervisor executes
        each event at the chunk boundary and reports it via
        :meth:`host_fault`.
        """
        for k in kinds:
            if k not in HOST_FAULT_KINDS:
                raise ValueError(
                    f"host-fault kind must be one of {HOST_FAULT_KINDS}, got {k!r}"
                )
        rng = random.Random(
            f"{seed if seed is not None else Settings.CHAOS_SEED}|hostfault"
        )
        slots = list(range(max(0, start), max(0, int(chunks))))
        events = []
        for kind in kinds:
            if not slots:
                break
            when = slots.pop(rng.randrange(len(slots)))
            events.append(HostFaultEvent(when, kind))
        return tuple(sorted(events, key=lambda e: (e.when, e.kind)))

    def host_fault(self, label: str, kind: str) -> None:
        """Count one EXECUTED host-fault event (``kind`` is one of
        :data:`HOST_FAULT_KINDS` — recorded for the log line; the fault
        counter buckets them all under ``fault="host_fault"``)."""
        with self._lock:
            self._count(label, "host_fault")
        from p2pfl_tpu_torch.telemetry.ledger import LEDGERS

        LEDGERS.emit(label, "chaos_fault", fault="host_fault", peer=label, step=kind)
        log.warning("chaos: host fault %s on %s", kind, label)

    def recovery(self, label: str, kind: str) -> None:
        """Count one EXECUTED recovery-scenario event (``kind`` is "crash" |
        "restart" | "partition" | "heal" — recorded for the log line; the
        fault counter buckets them all under ``fault="recovery"``)."""
        with self._lock:
            self._count(label, "recovery")
        from p2pfl_tpu_torch.telemetry.ledger import LEDGERS

        # Scenario-level chaos steps are trajectory-shaping facts and enter
        # the ledger; per-frame link faults (drop/delay/duplicate) are
        # environment noise whose counts are run-dependent — metrics only.
        LEDGERS.emit(label, "chaos_fault", fault="recovery", peer=label, step=kind)
        log.warning("chaos: recovery event %s %s", kind, label)

    def adaptive_switch(
        self, addr: str, round: int, old_attack: str, new_attack: str,
        rejections: int,
    ) -> None:
        """Count one EXECUTED adaptive-adversary escalation (the attacker
        observed its own admission rejections and climbed the ladder).
        Scenario-shaping like :meth:`recovery`, so it enters both the fault
        table (``fault="adaptive_switch"``) and the ledger — chaos_fault
        events are environment facts parity_diff excludes, so the wire-only
        escalation record never breaks cross-backend alignment."""
        with self._lock:
            self._count(addr, "adaptive_switch")
        from p2pfl_tpu_torch.telemetry.ledger import LEDGERS

        LEDGERS.emit(
            addr, "chaos_fault", fault="adaptive_switch", peer=addr,
            round=int(round), step=f"{old_attack}->{new_attack}",
            rejections=int(rejections),
        )
        log.warning(
            "chaos: adaptive adversary %s escalated %s -> %s at round %d "
            "(%d attributed rejections)",
            addr, old_attack, new_attack, round, rejections,
        )

    def link_blocked(self, src: str, dst: str) -> Optional[str]:
        """State-only view of whether the ``src -> dst`` link is blocked
        ("crash" | "partition" | None). Used by the heal-detection probe:
        unlike :meth:`intercept` it draws NO randomness and counts nothing,
        so probing (whose cadence is wall-clock-dependent) can never desync
        the deterministic per-pair decision streams."""
        with self._lock:
            if src in self._crashed or dst in self._crashed:
                return "crash"
            gs, gd = self._groups.get(src), self._groups.get(dst)
            if gs is not None and gd is not None and gs != gd:
                return "partition"
        return None

    def churn(self, addr: str, kind: str) -> None:
        """Count one EXECUTED churn event (``kind`` is "join" | "leave" |
        "rejoin" — recorded for the log line; the fault counter buckets them
        all under ``fault="churn"``)."""
        with self._lock:
            self._count(addr, "churn")
        from p2pfl_tpu_torch.telemetry.ledger import LEDGERS

        LEDGERS.emit(addr, "chaos_fault", fault="churn", peer=addr, step=kind)
        log.warning("chaos: churn event %s %s", kind, addr)

    def set_slow(self, addr: str, extra_delay_s: float) -> None:
        """Straggler: every send involving ``addr`` stalls ``extra_delay_s``."""
        with self._lock:
            if extra_delay_s > 0:
                self._slow[addr] = float(extra_delay_s)
            else:
                self._slow.pop(addr, None)

    def reset(self) -> None:
        """Clear scenario state, per-pair RNG streams and local counts (the
        registry mirror persists; ``REGISTRY.reset()`` clears it)."""
        with self._lock:
            self._rngs.clear()
            self._counts.clear()
            self._groups = {}
            self._crashed.clear()
            self._slow.clear()
            self._byzantine.clear()

    # --- accounting ---------------------------------------------------------

    def _count(self, src: str, fault: str) -> None:
        # caller holds the lock
        self._counts[fault] = self._counts.get(fault, 0) + 1
        _FAULTS.labels(src, fault).inc()

    def fault_counts(self) -> Dict[str, int]:
        """Plane-local {fault: count} — the determinism-assertion surface:
        same seed + same intercept sequence => identical dict."""
        with self._lock:
            return dict(self._counts)

    # --- the intercept ------------------------------------------------------

    def intercept(self, src: str, dst: str) -> Decision:
        """Decide the fate of one outbound frame from ``src`` to ``dst``."""
        with self._lock:
            if src in self._crashed or dst in self._crashed:
                self._count(src, "crash")
                return Decision(blocked="crash")
            gs, gd = self._groups.get(src), self._groups.get(dst)
            if gs is not None and gd is not None and gs != gd:
                self._count(src, "partition")
                return Decision(blocked="partition")
            key = (src, dst)
            rng = self._rngs.get(key)
            if rng is None:
                rng = self._rngs[key] = random.Random(
                    f"{Settings.CHAOS_SEED}|{src}->{dst}"
                )
            # Fixed draw order/count regardless of which faults are enabled,
            # so per-pair decision streams stay aligned across configs with
            # the same seed (determinism is per (seed, pair, sequence index)).
            u_drop, u_dup, u_jit = rng.random(), rng.random(), rng.random()
            if u_drop < Settings.CHAOS_DROP_RATE:
                self._count(src, "drop")
                return Decision(drop=True)
            delay = (
                Settings.CHAOS_DELAY_S
                + Settings.CHAOS_DELAY_JITTER_S * u_jit
                + self._slow.get(src, 0.0)
                + self._slow.get(dst, 0.0)
            )
            duplicates = 1 if u_dup < Settings.CHAOS_DUPLICATE_RATE else 0
            if delay <= 0.0 and duplicates == 0:
                return _CLEAN
            if delay > 0.0:
                self._count(src, "delay")
            if duplicates:
                self._count(src, "duplicate")
            return Decision(delay_s=delay, duplicates=duplicates)

    # --- byzantine corruption (model plane) ---------------------------------

    def corrupt_weights(self, src: str, env: "Envelope") -> "Envelope":
        """Apply ``src``'s Byzantine behavior to an outbound weights
        envelope (identity when ``src`` is honest or the frame is control
        plane). Called by the shared send choke point
        (:meth:`CommunicationProtocol.send`); returns a NEW envelope, so
        broadcast fan-out reusing the original is unaffected.

        Deterministic: corruption is a pure function of (payload, attack),
        draws no randomness, and therefore never desyncs the per-pair
        decision streams. Every corrupted frame is counted as
        ``byzantine_<attack>`` in the fault table and the registry.
        """
        with self._lock:
            byz = self._byzantine.get(src)
        if byz is None or not env.is_weights:
            return env
        try:
            corrupted = self._corrupt(env, byz)
        except Exception:  # noqa: BLE001 — chaos must not take down the send path
            log.exception("chaos: byzantine corruption of a frame from %s failed", src)
            return env
        with self._lock:
            self._count(src, f"byzantine_{byz.attack}")
        return corrupted

    @staticmethod
    def _corrupt(env: "Envelope", byz: _Byzantine) -> "Envelope":
        import numpy as np
        import torch

        from p2pfl_tpu_torch.ops.serialization import deserialize_arrays, serialize_arrays

        if byz.attack == "inflate":
            # The num_samples claim rides the envelope, not the payload.
            return _dc_replace(
                env, num_samples=max(1, int(env.num_samples)) * byz.inflate_factor
            )

        def floatlike(a) -> bool:
            if isinstance(a, torch.Tensor):  # bf16 leaves decode as CPU tensors
                return a.is_floating_point()
            return np.issubdtype(a.dtype, np.floating)

        arrays, meta = deserialize_arrays(bytes(env.payload))
        # Quantized / coalesced sparse frames (comm/delta.py) carry their
        # float values as int grids + per-tensor scales or as raw byte
        # planes — a Byzantine sender attacks THOSE, not bare float arrays
        # (which such frames no longer contain). Still a pure function of
        # (payload, attack): no randomness, replay-deterministic.
        from p2pfl_tpu_torch.comm.delta import COALESCE_META_KEY
        from p2pfl_tpu_torch.ops.compression import CODEC_META_KEY

        spec = meta.get(CODEC_META_KEY) or []
        quantized = [
            s
            for s in spec
            if isinstance(s, dict) and s.get("values") in ("int8", "int4")
        ]
        for s in quantized:
            scale = float(s.get("scale", 1.0))
            if byz.attack == "signflip":
                s["scale"] = -scale  # negates every dequantized value
            elif byz.attack == "scaled":
                s["scale"] = scale * byz.scale
            else:  # "nan"
                s["scale"] = float("nan")
        co = meta.get(COALESCE_META_KEY)
        if co is not None:
            arrays = ChaosPlane._corrupt_value_plane(list(arrays), meta, spec, byz)
        out = []
        for a in arrays:
            if not isinstance(a, torch.Tensor):
                a = np.asarray(a)
            if not floatlike(a):
                out.append(a)  # sparse index tensors / byte planes stay intact
            elif isinstance(a, torch.Tensor):  # bf16: the attack on its bits
                bits = _bf16_attack(a.contiguous().view(torch.int16).numpy().view(np.uint16), byz)
                out.append(torch.from_numpy(bits.view(np.int16)).view(torch.bfloat16))
            elif byz.attack == "signflip":
                out.append(-a)
            elif byz.attack == "scaled":
                out.append((a.astype(np.float32) * byz.scale).astype(a.dtype))
            else:  # "nan"
                out.append(np.full_like(a, np.nan))
        return _dc_replace(env, payload=serialize_arrays(out, meta))

    @staticmethod
    def _corrupt_value_plane(arrays, meta, spec, byz):
        """Apply the float attacks to the bf16/float32 values inside a
        coalesced frame's shared value plane (quantized tensors were already
        attacked through their scales). Mutates ``meta`` in place and
        returns the array list with the rebuilt plane."""
        import numpy as np

        from p2pfl_tpu_torch.comm.delta import (
            COALESCE_META_KEY,
            _deflate_plane,
            _inflate_plane,
        )

        co = meta[COALESCE_META_KEY]
        raw_len = [int(x) for x in co["raw_len"]]
        deflate = [bool(x) for x in co["deflate"]]
        plane_bytes = np.asarray(arrays[-1]).tobytes()
        plane = bytearray(
            _inflate_plane(plane_bytes, raw_len[1]) if deflate[1] else plane_bytes
        )
        vo = 0
        for s in spec:
            if not (isinstance(s, dict) and s.get("codec") == "topk-c"):
                continue
            vb = int(s.get("val_bytes", 0))
            kind = s.get("values", "bf16")
            if kind == "bf16":
                bits = np.frombuffer(bytes(plane[vo : vo + vb]), np.uint16)
                plane[vo : vo + vb] = _bf16_attack(bits, byz, negate_bits=False).tobytes()
            elif kind == "float32":
                vals = np.frombuffer(bytes(plane[vo : vo + vb]), np.float32)
                if byz.attack == "signflip":
                    vals = -vals
                elif byz.attack == "scaled":
                    vals = vals * byz.scale
                else:  # "nan"
                    vals = np.full(vals.shape, np.nan, np.float32)
                plane[vo : vo + vb] = vals.astype(np.float32).tobytes()
            vo += vb
        packed, was_deflated = _deflate_plane(bytes(plane), 6 if deflate[1] else 0)
        co["deflate"][1] = was_deflated
        arrays[-1] = np.frombuffer(packed, np.uint8)
        return arrays

    # --- scoped configuration ----------------------------------------------

    @contextlib.contextmanager
    def overridden(
        self,
        *,
        enabled: bool = True,
        seed: Optional[int] = None,
        drop_rate: Optional[float] = None,
        delay_s: Optional[float] = None,
        delay_jitter_s: Optional[float] = None,
        duplicate_rate: Optional[float] = None,
    ) -> Iterator["ChaosPlane"]:
        """Scoped chaos config (tests/bench): overrides the CHAOS_* settings
        for the block and resets RNG streams + scenario state on both entry
        and exit, so every block starts from a deterministic clean slate."""
        kw: Dict[str, object] = {"CHAOS_ENABLED": enabled}
        for name, value in (
            ("CHAOS_SEED", seed),
            ("CHAOS_DROP_RATE", drop_rate),
            ("CHAOS_DELAY_S", delay_s),
            ("CHAOS_DELAY_JITTER_S", delay_jitter_s),
            ("CHAOS_DUPLICATE_RATE", duplicate_rate),
        ):
            if value is not None:
                kw[name] = value
        self.reset()
        try:
            with Settings.overridden(**kw):
                yield self
        finally:
            self.reset()


class AdaptiveAdversary:
    """Live runner of the adaptive attack ladder for one wire adversary.

    The adversary OBSERVES the federation's defense: honest receivers that
    reject its frames attribute the rejection to its address in
    ``p2pfl_updates_rejected_total{source=<addr>}`` (comm/admission.py), and
    this observer reads exactly that attribution — the adversary learns
    only what a real attacker gossiping into the mesh could learn from its
    peers' behavior. :meth:`attack_for_round` is called ONCE per round at
    fit time: if the attributed-rejection count grew since the last
    observation, the current (rejected) stage took a hit and the ladder
    escalates after ``patience`` hits, reported via
    :meth:`ChaosPlane.adaptive_switch`.

    Determinism: under the campaign guarantees (>=1 honest receiver, every
    round's poisoned frame gossips before the next round's fit — the
    aggregation barrier enforces this), every rejected-stage round produces
    >=1 attributed rejection, making the realized decision stream equal to
    the pure :func:`adaptive_attack_schedule` oracle. The ``stage <
    len(ladder) - 1`` cap in the recurrence means stale re-gossiped frames
    from an earlier round can never over-escalate past the terminal stage.
    ``decisions`` records the realized (round, attack, rejections) stream
    for the campaign invariant that asserts oracle equality."""

    def __init__(
        self,
        addr: str,
        ladder: Sequence[str] = ADAPTIVE_LADDER,
        patience: int = 1,
    ) -> None:
        if patience < 1:
            raise ValueError(f"patience must be >= 1, got {patience}")
        if not ladder:
            raise ValueError("ladder must not be empty")
        self.addr = addr
        self.ladder = tuple(ladder)
        self.patience = int(patience)
        self._stage = 0
        self._hits = 0
        #: counter baseline: the registry counter is process-wide, so start
        #: from its CURRENT value — rejections attributed to this address by
        #: an earlier scenario in the same process are not this campaign's.
        self._seen = self.rejections_attributed()
        self.decisions: List[Dict[str, Any]] = []

    def rejections_attributed(self) -> int:
        """Total admission rejections every honest node attributed to this
        adversary's address (sum over the ``source`` label across nodes and
        reasons — the raw per-frame count, which only needs to GROW to
        signal a hit, so gossip re-ship multiplicity is harmless)."""
        fam = REGISTRY.get("p2pfl_updates_rejected_total")
        if fam is None:
            return 0
        return int(
            sum(
                child.value
                for labels, child in fam.samples()
                if labels.get("source") == self.addr
            )
        )

    @property
    def current_attack(self) -> str:
        return self.ladder[self._stage]

    def attack_for_round(self, rnd: int) -> str:
        """The attack to apply this round; observes rejections FIRST, so an
        escalation triggered by round ``r-1``'s rejections lands at round
        ``r`` — the same stage stream :func:`adaptive_attack_schedule`
        produces."""
        total = self.rejections_attributed()
        if (
            self.current_attack in ADAPTIVE_REJECTED_STAGES
            and total > self._seen
        ):
            self._hits += 1
            if self._hits >= self.patience and self._stage < len(self.ladder) - 1:
                old = self.current_attack
                self._stage += 1
                self._hits = 0
                CHAOS.adaptive_switch(
                    self.addr, int(rnd), old, self.current_attack, total
                )
        self._seen = total
        attack = self.current_attack
        self.decisions.append(
            {"round": int(rnd), "attack": attack, "rejections": total}
        )
        return attack


#: The process-wide chaos plane the transport send path consults.
CHAOS = ChaosPlane()
