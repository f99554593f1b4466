"""Campaign execution: both backends per scenario, differ, grade, scope.

One :func:`run_campaign` call samples the seeded scenario list
(:mod:`p2pfl_tpu_torch.campaigns.matrix`), then for each scenario:

1. **scopes the telemetry** — clears the campaign-scoped counter families
   (``CAMPAIGN_SCOPED_FAMILIES``) so every scenario's chaos-fault /
   admission-rejection / aggregation-wait series start from zero (the
   adaptive adversary's ladder and the attribution invariant both read
   them), and stamps the campaign id into the trajectory-ledger scope so
   every dumped ledger header names its campaign;
2. **executes BOTH backends** — ``run_scenario_wire`` (real federation,
   in-memory transport) and ``run_scenario_fused`` (mesh engine);
3. **runs the ledger parity differ** (``scripts/parity_diff.py``) over
   the stitched wire stream vs the fused ledger;
4. **grades** the run against the family's invariant catalog
   (:mod:`p2pfl_tpu_torch.campaigns.invariants`).

The returned report is plain data: ``scripts/torch_campaign_check.py``
replays a committed baseline against it. Both backends run on ``device``
(``"cuda"`` unless the caller passes ``device="cpu"``).
"""

from __future__ import annotations

import importlib.util
import logging
import os
import time
from typing import Any, Callable, Dict, List, Optional

from p2pfl_tpu_torch.campaigns.invariants import grade_scenario
from p2pfl_tpu_torch.campaigns.matrix import campaign_id, sample_campaign
from p2pfl_tpu_torch.config import Settings
from p2pfl_tpu_torch.device import DeviceLike
from p2pfl_tpu_torch.telemetry import REGISTRY
from p2pfl_tpu_torch.telemetry.bundle import write_bundle

log = logging.getLogger("p2pfl_tpu_torch")

#: Metric families zeroed between campaign scenarios. Scenario-scoped
#: series only — process-lifetime series (ledger event totals, resource
#: gauges) keep accumulating across the campaign.
CAMPAIGN_SCOPED_FAMILIES = (
    "p2pfl_chaos_faults_total",
    "p2pfl_updates_rejected_total",
    "p2pfl_claimed_samples_clamped_total",
    "p2pfl_aggregation_wait_seconds",
    # host_fault grading drives a supervised engine through injected
    # faults — zero its series too so each scenario grades only itself.
    "p2pfl_supervisor_journals_total",
    "p2pfl_supervisor_restarts_total",
    "p2pfl_supervisor_retries_total",
    "p2pfl_supervisor_degrade_steps_total",
    "p2pfl_supervisor_parks_total",
)

_SCENARIOS = REGISTRY.counter(
    "p2pfl_campaign_scenarios_total",
    "Campaign scenarios executed, by family and grading verdict",
    labels=("family", "verdict"),
)

#: Families whose committed hashes are replay-stable and belong in the
#: campaign baseline. The privacy family is excluded: masked-round repair
#: fallbacks depend on key-exchange timing, so its hashes are not part of
#: the deterministic contract (its invariants are structural instead).
BASELINE_HASH_FAMILIES = frozenset(
    {
        "adaptive", "baseline", "chaos_drop", "host_fault", "byzantine",
        "churn", "tier_skew", "noniid", "recovery",
    }
)


def load_parity_differ() -> Any:
    """Import ``scripts/parity_diff.py`` by path (it is a stdlib-only
    script, not a package module)."""
    root = os.path.dirname(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    )
    path = os.path.join(root, "scripts", "parity_diff.py")
    spec = importlib.util.spec_from_file_location("p2pfl_tpu_torch_parity_diff", path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(f"parity differ not found at {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_campaign(
    seed: Optional[int] = None,
    n_scenarios: Optional[int] = None,
    *,
    ledger_dir: Optional[str] = None,
    differ: Optional[Any] = None,
    emit: Optional[Callable[[str], None]] = None,
    device: DeviceLike = "cuda",
) -> Dict[str, Any]:
    """Execute the seeded campaign and return its graded report. Both
    backends of every scenario run on ``device``."""
    from p2pfl_tpu_torch.telemetry.ledger import LEDGERS

    if seed is None:
        seed = Settings.CAMPAIGN_SEED
    if n_scenarios is None:
        n_scenarios = Settings.CAMPAIGN_SCENARIOS
    seed, n_scenarios = int(seed), int(n_scenarios)
    say = emit or (lambda msg: log.info("%s", msg))
    if differ is None:
        differ = load_parity_differ()
    cid = campaign_id(seed, n_scenarios)
    scenarios = sample_campaign(seed, n_scenarios)
    say(
        f"campaign {cid}: {len(scenarios)} scenarios across "
        f"{len({cs.family for cs in scenarios})} families"
    )
    results: List[Dict[str, Any]] = []
    violations_total = 0
    LEDGERS.configure("", campaign=cid)
    try:
        for cs in scenarios:
            scn = cs.scenario
            # Scenario scoping: zero the chaos/admission/wait series so
            # this scenario's grading (and its adaptive ladder, if any)
            # observes only its own run.
            REGISTRY.clear_families(CAMPAIGN_SCOPED_FAMILIES)
            t0 = time.monotonic()
            entry: Dict[str, Any] = {
                "family": cs.family,
                "index": cs.index,
                "run_id": scn.run_id,
                "seed": scn.seed,
                "key": cs.key,
            }
            scenario_ledger_dir = None
            if ledger_dir is not None:
                scenario_ledger_dir = os.path.join(
                    ledger_dir, f"{cs.family}-{cs.index}"
                )
                os.makedirs(scenario_ledger_dir, exist_ok=True)
            try:
                from p2pfl_tpu_torch.population.scenarios import (
                    run_scenario_fused,
                    run_scenario_wire,
                )

                wire = run_scenario_wire(scn, ledger_dir=scenario_ledger_dir, device=device)
                t_wire = time.monotonic()
                fused = run_scenario_fused(scn, ledger_dir=scenario_ledger_dir, device=device)
                entry.update(wire_seconds=round(t_wire - t0, 3), fused_seconds=round(time.monotonic() - t_wire, 3))
            except Exception as exc:  # noqa: BLE001 — campaign completeness
                entry.update(
                    verdict="error",
                    error=f"{type(exc).__name__}: {exc}",
                    seconds=round(time.monotonic() - t0, 3),
                )
                _SCENARIOS.labels(cs.family, "error").inc()
                entry["bundle"] = write_bundle(
                    "campaign_violation",
                    run_id=scn.run_id,
                    context=dict(entry),
                    error=exc,
                )
                results.append(entry)
                violations_total += 1
                say(f"  {cs.family}[{cs.index}] ERROR: {entry['error']}")
                continue
            report = differ.compare_ledgers(wire["stitched"], fused["events"])
            vs = grade_scenario(cs, wire, fused, report, device=device)
            violations_total += len(vs)
            wire_hashes = {
                int(e["round"]): e["hash"]
                for e in wire["stitched"]
                if e.get("kind") == "aggregate_committed" and "hash" in e
            }
            entry.update(
                verdict="ok" if not vs else "violated",
                parity_status=report.get("status"),
                parity_events=report.get("compared_events"),
                wire_hashes={str(r): h for r, h in sorted(wire_hashes.items())},
                fused_hashes={
                    str(r): h for r, h in sorted(fused.get("hashes", {}).items())
                },
                baseline_hashes=cs.family in BASELINE_HASH_FAMILIES,
                violations=[v.render() for v in vs],
                seconds=round(time.monotonic() - t0, 3),
            )
            if "adaptive" in wire:
                entry["adaptive"] = wire["adaptive"]
            _SCENARIOS.labels(cs.family, entry["verdict"]).inc()
            if vs:
                # An invariant violation is an incident: capture the
                # scenario's full evidence story under its pinned run id.
                entry["bundle"] = write_bundle(
                    "campaign_violation",
                    run_id=scn.run_id,
                    context=dict(entry),
                )
            results.append(entry)
            say(
                f"  {cs.family}[{cs.index}] {entry['verdict']} "
                f"(parity={entry['parity_status']}, "
                f"{entry['seconds']:.1f}s"
                + (f", {len(vs)} violation(s)" if vs else "")
                + ")"
            )
    finally:
        LEDGERS.configure("", campaign="")
    families: Dict[str, Dict[str, int]] = {}
    for entry in results:
        fam = families.setdefault(
            entry["family"],
            {"scenarios": 0, "ok": 0, "violations": 0, "seconds": 0.0},
        )
        fam["scenarios"] += 1
        if entry["verdict"] == "ok":
            fam["ok"] += 1
        fam["violations"] += len(entry.get("violations", ())) or (
            1 if entry["verdict"] == "error" else 0
        )
        fam["seconds"] = round(fam["seconds"] + entry.get("seconds", 0.0), 3)
    return {
        "campaign": cid,
        "seed": seed,
        "n_scenarios": n_scenarios,
        "families": families,
        "scenarios": results,
        "violations_total": violations_total,
        "ok": violations_total == 0,
    }
