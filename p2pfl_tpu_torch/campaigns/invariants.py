"""Per-scenario-family invariant catalog and grading.

Every campaign scenario is graded right after its two backend runs. The
catalog (``FAMILY_INVARIANTS``) is data: the campaign doc renders it, and
the grader dispatches on it — a family fails its scenario iff at least
one :class:`Violation` is produced.

The invariants, and what each one catches:

* ``rounds_complete`` — the wire's stitched observer stream opened and
  hash-committed EVERY round, and so did the fused ledger: no silent
  stall, no dropped tail round.
* ``agg_wait_bounded`` — no ``wait_and_get_aggregation`` observation
  exceeded ``AGG_WAIT_BOUND_S``: stall-patience and death callbacks are
  actually bounding the barrier (a regression here shows up as one giant
  wait, not a missing round).
* ``parity_exact`` — the ledger parity differ reports OK and the
  per-round commit hashes are equal: the two backends executed the SAME
  trajectory, bit for bit, under this family's environment.
* ``masked_divergence`` (privacy family) — both backends committed every
  round AND the wire's masked hashes differ from the fused plaintext
  hashes: the negative control proving masking actually engaged (bit
  parity is impossible by design — ring quantization changes the
  arithmetic).
* ``privacy_engaged`` — the stitched stream carries ``privacy_masked``
  events.
* ``accuracy_floor`` — the fused final model (hash-certified equal to
  the wire's) clears the family's accuracy floor on the scenario's own
  data: the federation LEARNED, it did not just complete rounds.
* ``adaptive_oracle`` — the realized adaptive-adversary decision stream
  equals the pure seeded schedule oracle, and the chaos plane logged
  exactly the oracle's number of ``adaptive_switch`` escalations.
* ``rejection_attribution`` — honest nodes' norm rejections attribute to
  the REAL adversary and nobody else (the observatory's suspect score
  points at the right node).
* ``trace_deterministic`` (recovery family) — the composed
  crash-restart + partition-heal + masker-dropout chaos trace re-derives
  identically and is non-trivial (the lifecycle axes stay seeded pure
  functions).
* ``supervisor_recovered`` (host_fault family) — the seeded host-fault
  trace re-derives identically, and an
  :class:`~p2pfl_tpu_torch.population.supervisor.EngineSupervisor` driving a
  small fused engine THROUGH every planned kill/oom/sigterm completes
  all rounds with a final model bit-identical to a fault-free control —
  the journal + replay loop really is transparent to training.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

from p2pfl_tpu_torch.device import DeviceLike
from p2pfl_tpu_torch.telemetry import REGISTRY

#: One aggregation wait above this many seconds is a violation — campaign
#: scenarios run with CAMPAIGN_STALL_PATIENCE-bounded barriers, so a honest
#: wait is patience-plus-jitter, never half a minute.
AGG_WAIT_BOUND_S = 30.0

#: Per-family overrides of :data:`AGG_WAIT_BOUND_S`. The lossy-wire family
#: legitimately blocks for multiple gossip re-ship periods while a dropped
#: frame is re-sent — its bound is "the wire is lossy but alive", not the
#: clean-transport 30s (the 20-scenario campaign measured ~30-60s waits at
#: drop_rate 0.15 that still converged to bit parity).
AGG_WAIT_BOUNDS: Dict[str, float] = {
    "chaos_drop": 120.0,
}

#: Fused-final-model accuracy floors per family, on the scenario's own
#: training data (10-class synthetic MNIST, so chance is 0.1). The floors
#: separate "learned something" from chance with margin below the weakest
#: measured clean runs (two rounds of the tiny campaign MLP land in the
#: 0.2-0.5 band depending on seed); adversarial / heavily-skewed families
#: get looser floors.
ACCURACY_FLOORS: Dict[str, float] = {
    "baseline": 0.15,
    "chaos_drop": 0.15,
    "host_fault": 0.15,
    "byzantine": 0.12,
    "churn": 0.15,
    "tier_skew": 0.15,
    "noniid": 0.12,
    "privacy": 0.0,  # wire aggregate is masked; fused-only floor is moot
    "recovery": 0.15,
    "adaptive": 0.12,
}

FAMILY_INVARIANTS: Dict[str, Tuple[str, ...]] = {
    "baseline": (
        "rounds_complete", "agg_wait_bounded", "parity_exact",
        "accuracy_floor",
    ),
    "chaos_drop": (
        "rounds_complete", "agg_wait_bounded", "parity_exact",
        "accuracy_floor",
    ),
    "host_fault": (
        "rounds_complete", "agg_wait_bounded", "parity_exact",
        "accuracy_floor", "supervisor_recovered",
    ),
    "byzantine": (
        "rounds_complete", "agg_wait_bounded", "parity_exact",
        "accuracy_floor",
    ),
    "churn": (
        "rounds_complete", "agg_wait_bounded", "parity_exact",
        "accuracy_floor",
    ),
    "tier_skew": (
        "rounds_complete", "agg_wait_bounded", "parity_exact",
        "accuracy_floor",
    ),
    "noniid": (
        "rounds_complete", "agg_wait_bounded", "parity_exact",
        "accuracy_floor",
    ),
    "privacy": (
        "rounds_complete", "agg_wait_bounded", "masked_divergence",
        "privacy_engaged",
    ),
    "recovery": (
        "rounds_complete", "agg_wait_bounded", "parity_exact",
        "accuracy_floor", "trace_deterministic",
    ),
    "adaptive": (
        "rounds_complete", "agg_wait_bounded", "parity_exact",
        "accuracy_floor", "adaptive_oracle", "rejection_attribution",
    ),
}


@dataclass(frozen=True)
class Violation:
    """One graded invariant failure — the campaign's unit of finding."""

    family: str
    run_id: str
    invariant: str
    detail: str

    def render(self) -> str:
        return f"[{self.family}] {self.run_id}: {self.invariant} — {self.detail}"


def evaluate_final_params(scn: Any, final_params: Any) -> float:
    """Accuracy of the fused final global model over the scenario's own
    stacked data (both backends' finals are hash-certified equal, so one
    evaluation grades both). The template model's forward runs in torch on
    the final params' device (the host for numpy params)."""
    import torch

    x, y, _ = scn.data()
    device = next((v.device for v in final_params.values() if isinstance(v, torch.Tensor)), torch.device("cpu"))
    model = scn.template_model(device)
    params = {n: torch.as_tensor(v, device=device) for n, v in final_params.items()}
    with torch.no_grad():
        logits = model.apply(params, torch.as_tensor(x.reshape(-1, 28, 28), device=device))
    return float((logits.argmax(-1).cpu().numpy() == y.reshape(-1)).mean())


def _wire_hashes(wire: Dict[str, Any]) -> Dict[int, str]:
    return {
        e["round"]: e["hash"]
        for e in wire.get("stitched", ())
        if e.get("kind") == "aggregate_committed" and "hash" in e
    }


def _agg_wait_over(bound_s: float) -> int:
    """Observations above ``bound_s`` in the aggregation-wait histogram
    (scenario-scoped: the engine clears the family between scenarios)."""
    fam = REGISTRY.get("p2pfl_aggregation_wait_seconds")
    if fam is None:
        return 0
    over = 0
    for _labels, child in fam.samples():
        bounds, counts, _sum, _count = child.snapshot()
        for i, c in enumerate(counts):
            lower = bounds[i - 1] if i > 0 else 0.0
            if lower >= bound_s:
                over += c
    return over


def _norm_rejections_by_source(honest: List[str]) -> Dict[str, int]:
    """Honest nodes' norm-screen rejections, keyed by attributed source.
    Only honest receivers count: an adversarial node screening (or not)
    its own inbox is not part of the attribution contract."""
    fam = REGISTRY.get("p2pfl_updates_rejected_total")
    out: Dict[str, int] = {}
    if fam is None:
        return out
    honest_set = set(honest)
    for labels, child in fam.samples():
        if labels.get("node") not in honest_set:
            continue
        if labels.get("reason") != "norm":
            continue
        v = int(child.value)
        if v:
            out[labels.get("source", "?")] = out.get(labels.get("source", "?"), 0) + v
    return out


def _adaptive_switch_count(addr: str) -> int:
    fam = REGISTRY.get("p2pfl_chaos_faults_total")
    if fam is None:
        return 0
    total = 0
    for labels, child in fam.samples():
        if labels.get("node") == addr and labels.get("fault") == "adaptive_switch":
            total += int(child.value)
    return total


def _grade_recovery_trace(cs: Any, add: Any) -> None:
    """The composed lifecycle trace re-derives identically (pure seeded
    functions of the campaign draw) and is non-trivial."""
    from p2pfl_tpu_torch.chaos.plane import ChaosPlane

    scn, t = cs.scenario, cs.trace
    if t is None:
        add("trace_deterministic", "recovery scenario sampled without a trace")
        return
    names = scn.node_names

    def derive():
        plane = ChaosPlane()
        churn = plane.plan_churn(
            t["rounds"], names[1:], [f"joiner-{i}" for i in range(2)],
            seed=scn.seed, start=1,
        )
        recovery = plane.plan_recovery(
            t["rounds"], names, seed=scn.seed,
            crash_round=t["crash_round"], restart_after=t["restart_after"],
            partition_round=t["partition_round"], heal_after=t["heal_after"],
        )
        dropout = plane.plan_masker_dropout(
            t["rounds"], names, seed=scn.seed, drop_round=t["drop_round"],
        )
        return churn, recovery, dropout

    first, second = derive(), derive()
    if first != second:
        add("trace_deterministic", "composed chaos trace is not replay-stable")
        return
    churn, recovery, dropout = first
    if not churn or not recovery or not dropout:
        add(
            "trace_deterministic",
            f"composed trace degenerate: churn={len(churn)} "
            f"recovery={len(recovery)} dropout={len(dropout)}",
        )


def _grade_supervisor_recovered(cs: Any, add: Any, device: DeviceLike) -> None:
    """The seeded host-fault trace is replay-stable AND a supervised fused
    run on ``device`` heals through every planned fault to a final model
    bit-identical with a fault-free control (one restart per planned
    event)."""
    import tempfile

    from p2pfl_tpu_torch.chaos.plane import ChaosPlane
    from p2pfl_tpu_torch.management.checkpoint import FLCheckpointer
    from p2pfl_tpu_torch.population.engine import PopulationEngine
    from p2pfl_tpu_torch.population.supervisor import EngineSupervisor
    from p2pfl_tpu_torch.telemetry.ledger import canonical_params_hash

    scn, t = cs.scenario, cs.trace
    if t is None:
        add("supervisor_recovered", "host_fault scenario sampled without a trace")
        return
    rounds, kinds = int(t["rounds"]), tuple(t["kinds"])

    def derive():
        return ChaosPlane().plan_host_faults(rounds, seed=scn.seed, kinds=kinds)

    faults, second = derive(), derive()
    if faults != second:
        add("supervisor_recovered", "host-fault trace is not replay-stable")
        return
    if len(faults) != len(kinds):
        add(
            "supervisor_recovered",
            f"degenerate trace: {len(faults)} event(s) for kinds {kinds} "
            f"over {rounds} rounds",
        )
        return

    # The supervised arm runs a deliberately tiny fused engine: the graded
    # property is heal-to-bit-identity, not model quality.
    def factory(**kw: Any) -> PopulationEngine:
        args: Dict[str, Any] = dict(
            num_nodes=4, cohort_fraction=0.75, cohort_min=2, seed=scn.seed,
            samples_per_node=8, feature_dim=8, hidden=(8,), batch_size=4,
            device=device,
        )
        args.update(kw)
        return PopulationEngine(**args)

    control = factory()
    try:
        control.run(rounds)
        control_hash = canonical_params_hash(control.gather_params(0))
    finally:
        control.close()

    with tempfile.TemporaryDirectory(prefix="campaign-hostfault-") as tmp:
        with FLCheckpointer(tmp, max_to_keep=2) as ck:
            with EngineSupervisor(
                factory, ck, node=f"supervisor-{scn.run_id}",
                faults=faults, backoff_s=0.0,
            ) as sup:
                report = sup.run(rounds, chunk=1)
                supervised_hash = (
                    canonical_params_hash(sup.engine.gather_params(0))
                    if not report.parked else None
                )

    if report.parked:
        add(
            "supervisor_recovered",
            f"supervisor parked ({report.park_reason}) instead of healing",
        )
        return
    if report.completed != rounds:
        add(
            "supervisor_recovered",
            f"supervised run completed {report.completed}/{rounds} rounds",
        )
    executed = {ev.kind for ev in report.faults_executed}
    planned = {ev.kind for ev in faults}
    missing = sorted(planned - executed)
    if missing:
        add(
            "supervisor_recovered",
            f"planned fault kind(s) never injected: {missing}",
        )
    if supervised_hash != control_hash:
        add(
            "supervisor_recovered",
            "supervised final model diverged from fault-free control "
            f"({supervised_hash} != {control_hash})",
        )


def grade_scenario(
    cs: Any,
    wire: Dict[str, Any],
    fused: Dict[str, Any],
    parity_report: Optional[Dict[str, Any]],
    *,
    device: DeviceLike = "cuda",
) -> List[Violation]:
    """Grade one executed scenario against its family's invariant catalog.
    Reads the (scenario-scoped) metrics registry — call before the engine
    clears the scoped families for the next scenario. The host_fault
    family's supervised drill runs on ``device``."""
    scn = cs.scenario
    catalog = FAMILY_INVARIANTS[cs.family]
    violations: List[Violation] = []

    def add(invariant: str, detail: str) -> None:
        violations.append(Violation(cs.family, scn.run_id, invariant, detail))

    wh = _wire_hashes(wire)
    fh = {int(r): h for r, h in fused.get("hashes", {}).items()}
    rounds = set(range(scn.rounds))

    if "rounds_complete" in catalog:
        opened = {
            e["round"] for e in wire.get("stitched", ())
            if e.get("kind") == "round_open"
        }
        for label, got in (("opened", opened), ("wire", set(wh)), ("fused", set(fh))):
            missing = rounds - got
            if missing:
                add(
                    "rounds_complete",
                    f"{label} rounds missing {sorted(missing)} (silent stall "
                    f"or dropped tail)",
                )

    if "agg_wait_bounded" in catalog:
        bound = AGG_WAIT_BOUNDS.get(cs.family, AGG_WAIT_BOUND_S)
        over = _agg_wait_over(bound)
        if over:
            add(
                "agg_wait_bounded",
                f"{over} aggregation wait(s) exceeded {bound:g}s",
            )

    if "parity_exact" in catalog:
        status = (parity_report or {}).get("status")
        if status != "OK":
            add("parity_exact", f"parity differ status={status!r}")
        elif wh != fh:
            add("parity_exact", f"hash mismatch wire={wh} fused={fh}")

    if "masked_divergence" in catalog:
        common = set(wh) & set(fh)
        if not common:
            add("masked_divergence", "no common committed rounds to compare")
        elif any(wh[r] == fh[r] for r in common):
            add(
                "masked_divergence",
                "masked wire hash equals plaintext fused hash — masking "
                "did not engage",
            )

    if "privacy_engaged" in catalog:
        if not any(
            e.get("kind") == "privacy_masked" for e in wire.get("stitched", ())
        ):
            add("privacy_engaged", "no privacy_masked events in the stitched stream")

    if "accuracy_floor" in catalog and "final_params" in fused:
        floor = ACCURACY_FLOORS[cs.family]
        acc = evaluate_final_params(scn, fused["final_params"])
        if acc < floor:
            add("accuracy_floor", f"final accuracy {acc:.3f} < floor {floor:g}")

    if "adaptive_oracle" in catalog:
        oracle = list(scn.adaptive_schedule())
        realized = [d["attack"] for d in wire.get("adaptive", {}).get("decisions", ())]
        if realized != oracle:
            add("adaptive_oracle", f"decisions {realized} != oracle {oracle}")
        adv_addr = scn.node_names[scn.adaptive_adversary]
        expected_switches = sum(
            1 for a, b in zip(oracle, oracle[1:]) if a != b
        )
        got = _adaptive_switch_count(adv_addr)
        if got != expected_switches:
            add(
                "adaptive_oracle",
                f"{got} adaptive_switch event(s), oracle has {expected_switches}",
            )

    if "rejection_attribution" in catalog:
        adv_addr = scn.node_names[scn.adaptive_adversary]
        honest = [n for n in scn.node_names if n != adv_addr]
        by_source = _norm_rejections_by_source(honest)
        if not by_source.get(adv_addr):
            add(
                "rejection_attribution",
                "honest nodes recorded no norm rejection attributed to the "
                "adversary",
            )
        strays = sorted(set(by_source) - {adv_addr})
        if strays:
            add(
                "rejection_attribution",
                f"norm rejections attributed to non-adversaries: {strays}",
            )

    if "trace_deterministic" in catalog:
        _grade_recovery_trace(cs, add)

    if "supervisor_recovered" in catalog:
        _grade_supervisor_recovered(cs, add, device)

    return violations
