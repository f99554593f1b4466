#!/usr/bin/env python
"""The port's doctor-check — seeded fault scenarios must diagnose to their
injected cause.

The gate for the PyTorch port's diagnosis plane (``python
scripts/torch_doctor_check.py``, host only, a few seconds): drives three
seeded 3-node fault scenarios plus a clean control through the port's
REAL telemetry planes (trajectory ledger, flight recorder, chaos plane,
observatory, metrics registry) — not mocks — captures an evidence bundle
for each, and asserts:

1. **attribution** — the top-1 diagnosis names the injected fault:
   straggler → ``straggler_gating``, signflip adversary →
   ``byzantine_active``, mid-round kill → ``churn_starved_cohort``;
2. **calibration** — the clean control produces ZERO findings (every
   rule demands an explicit anomaly signal, not just "telemetry exists");
3. **determinism** — running a scenario twice under its pinned run id
   yields replay-identical bundle manifests once the ``excluded``
   section (timestamps, volatile hashes) is stripped
   (:func:`~p2pfl_tpu_torch.telemetry.bundle.comparable_manifest`).

Exit 0 on success, 1 with a named failure otherwise.
"""

from __future__ import annotations

import json
import os
import shutil
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from p2pfl_tpu_torch.chaos.plane import CHAOS  # noqa: E402
from p2pfl_tpu_torch.config import Settings  # noqa: E402
from p2pfl_tpu_torch.telemetry import bundle  # noqa: E402
from p2pfl_tpu_torch.telemetry.digest import HealthDigest  # noqa: E402
from p2pfl_tpu_torch.telemetry.flight_recorder import (  # noqa: E402
    FlightRecorder,
    reset_live_recorders,
)
from p2pfl_tpu_torch.telemetry.ledger import LEDGERS  # noqa: E402
from p2pfl_tpu_torch.telemetry.metrics import REGISTRY  # noqa: E402
from p2pfl_tpu_torch.telemetry.observatory import Observatory  # noqa: E402

NODES = ("n0", "n1", "n2")


def _reset_world() -> None:
    """Start each scenario run from a zeroed process: same telemetry state
    both runs → same bundle manifest (the determinism assertion)."""
    REGISTRY.reset()
    LEDGERS.reset()
    CHAOS.reset()
    bundle.reset_run()
    reset_live_recorders()


def _digest(node: str, **kw) -> HealthDigest:
    d = HealthDigest(node=node, ts=time.time())
    for k, v in kw.items():
        setattr(d, k, v)
    return d


def _snapshot(obs: Observatory, workdir: str) -> None:
    obs.write_snapshot(os.path.join(workdir, "federation_snapshot.json"))


def scenario_straggler(workdir: str) -> None:
    """n2 runs 3 rounds behind at 1/20th the fleet step rate, and the
    aggregator hit its stall patience waiting for it."""
    obs = Observatory("n0")
    obs.ingest(_digest("n0", round=5, total_rounds=8, steps_per_s=100.0))
    obs.ingest(_digest("n1", round=5, total_rounds=8, steps_per_s=95.0))
    obs.ingest(_digest("n2", round=2, total_rounds=8, steps_per_s=5.0))
    REGISTRY.counter(
        "p2pfl_aggregation_stall_partials_total", labels=("node",)
    ).labels("n0").inc(2)
    _snapshot(obs, workdir)


def scenario_signflip(workdir: str) -> None:
    """A seeded signflip adversary: chaos marks the peer byzantine, the
    fleet's admission plane rejects its frames, digests attribute the
    rejections back to it."""
    CHAOS.set_byzantine("adv", "signflip")
    rejected = REGISTRY.counter(
        "p2pfl_updates_rejected_total", labels=("node", "reason", "source")
    )
    for r in (1, 2, 3):
        LEDGERS.emit(
            "n0", "admission_rejected", round=r, sender="adv",
            reason="norm_screen",
            dedup_key=("admission", r, "adv", "norm_screen"),
        )
        rejected.labels("n0", "norm_screen", "adv").inc()
    obs = Observatory("n0")
    obs.ingest(_digest("n0", round=3, total_rounds=8, steps_per_s=100.0,
                       rejected_by_source={"adv": 3.0}))
    obs.ingest(_digest("n1", round=3, total_rounds=8, steps_per_s=98.0))
    obs.ingest(_digest("n2", round=3, total_rounds=8, steps_per_s=102.0))
    obs.ingest(_digest("adv", round=3, total_rounds=8, steps_per_s=100.0))
    _snapshot(obs, workdir)


def scenario_kill(workdir: str):
    """n2 is killed mid-round: chaos blackholes its frames, the failure
    detector declares it lost (never recovered), aggregation drops its
    contribution from the expected set."""
    CHAOS.crash("n2")
    rec = FlightRecorder("n0")
    rec.record("peer_lost", peer="n2", missed=5.0)
    REGISTRY.counter(
        "p2pfl_chaos_faults_total", labels=("node", "fault")
    ).labels("n2", "crash").inc(3)
    REGISTRY.counter(
        "p2pfl_aggregation_dead_contributors_total", labels=("node",)
    ).labels("n0").inc()
    obs = Observatory("n0", recorder=rec)
    obs.ingest(_digest("n0", round=4, total_rounds=8, steps_per_s=100.0))
    obs.ingest(_digest("n1", round=4, total_rounds=8, steps_per_s=98.0))
    _snapshot(obs, workdir)
    # The live-recorder registry holds WEAK refs — keep the recorder alive
    # until write_bundle has collected its ring.
    return rec


def scenario_control(workdir: str) -> None:
    """Three healthy peers, nothing injected — must diagnose to nothing."""
    obs = Observatory("n0")
    obs.ingest(_digest("n0", round=3, total_rounds=8, steps_per_s=100.0))
    obs.ingest(_digest("n1", round=3, total_rounds=8, steps_per_s=98.0))
    obs.ingest(_digest("n2", round=3, total_rounds=8, steps_per_s=102.0))
    _snapshot(obs, workdir)


SCENARIOS = (
    # (name, builder, expected top-1 rule; None = expect zero findings)
    ("straggler", scenario_straggler, "straggler_gating"),
    ("signflip", scenario_signflip, "byzantine_active"),
    ("kill", scenario_kill, "churn_starved_cohort"),
    ("control", scenario_control, None),
)


def run_once(name, builder, root: str, attempt: int):
    """One seeded scenario pass: build the fault's telemetry story, bundle
    it, return (bundle_dir, incident_doc)."""
    workdir = os.path.join(root, f"{name}-{attempt}")
    os.makedirs(workdir, exist_ok=True)
    _reset_world()
    with Settings.overridden(RUN_ID=f"doctor-{name}"):
        keepalive = builder(workdir)  # noqa: F841 — weakly-registered recorders
        out = bundle.write_bundle(
            "doctor_check", directory=workdir, context={"scenario": name}
        )
        assert out, f"{name}: write_bundle produced nothing"
        with open(os.path.join(out, "incident.json")) as f:
            incident = json.load(f)
    return out, incident


def main() -> int:
    root = tempfile.mkdtemp(prefix="doctor_check_")
    t0 = time.time()
    failures = []
    try:
        for name, builder, expect in SCENARIOS:
            out1, inc1 = run_once(name, builder, root, 1)
            out2, _ = run_once(name, builder, root, 2)
            top = inc1.get("top")
            rules = [f["rule"] for f in inc1.get("findings", ())]
            if expect is None:
                ok = not rules
                verdict = "clean" if ok else f"UNEXPECTED findings {rules}"
            else:
                ok = top == expect
                verdict = f"top-1 {top}" + ("" if ok else f" (wanted {expect})")
            if not ok:
                failures.append(name)
            # Determinism: same scenario, same pinned run id, two fresh
            # processes-worth of state → identical comparable manifests.
            m1 = bundle.comparable_manifest(bundle.load_manifest(out1))
            m2 = bundle.comparable_manifest(bundle.load_manifest(out2))
            if m1 != m2:
                failures.append(f"{name}-manifest")
                verdict += "  MANIFEST DRIFT between identical runs"
            rid = inc1.get("run_id", "")
            if expect is not None and rid != f"doctor-{name}":
                failures.append(f"{name}-runid")
                verdict += f"  run_id {rid!r} not pinned"
            status = "ok" if name not in [f.split("-")[0] for f in failures] else "FAIL"
            print(f"  {name:<10} {status:<5} {verdict}  (findings: {rules or '-'})")
    finally:
        _reset_world()
        shutil.rmtree(root, ignore_errors=True)
    dt = time.time() - t0
    if failures:
        print(f"doctor-check FAILED ({', '.join(failures)}) in {dt:.1f}s")
        return 1
    print(f"doctor-check OK: 3 faults attributed + control clean, "
          f"manifests replay-identical ({dt:.1f}s)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
