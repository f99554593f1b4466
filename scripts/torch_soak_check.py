"""The port's soak-check — the supervisor's bit-exact-resume-under-fire gate.

A seeded 64-vnode population of the PyTorch port runs under the
:class:`~p2pfl_tpu_torch.population.supervisor.EngineSupervisor` with three
injected host faults (kill, OOM, SIGTERM) drawn from the chaos plane's
``plan_host_faults`` trace, ON BOTH fused engines:

1. **heal to bit-identity** — the supervised run completes every chunk
   and its final canonical params hash equals a fault-free control's
   (journal + rollback + seeded-stream replay is transparent to
   training);
2. **replay identity** — a second supervised run of the same seed
   produces the SAME timestamp-free event log (same journals, same
   faults, same restarts at the same cursors — event-count-identical
   and event-for-event identical);
3. **degrade ladder determinism** — a permanently failing engine walks
   chunks -> cohort halving -> park, twice, with identical event logs
   (the ladder is ledgered and replayable, mirroring quorum-park).

Exit 0 when every check passes on both engines; 1 with a reason
otherwise. The engines run on the card; ``--device cpu`` runs them on the
host::

    python scripts/torch_soak_check.py --device cpu
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

N_NODES = 64
CHUNKS = 5
SEED = 20260807
FAULT_KINDS = ("kill", "oom", "sigterm")

#: Tiny model shape: the gate grades healing semantics, not learning.
SHAPE = dict(
    samples_per_node=8, feature_dim=8, hidden=(8,), batch_size=4,
    cohort_fraction=0.25, cohort_min=4, seed=SEED,
)


def _fail(msg: str) -> int:
    print(f"FAIL: {msg}", file=sys.stderr)
    return 1


def _final_hash(engine) -> str:
    from p2pfl_tpu_torch.telemetry.ledger import canonical_params_hash

    if hasattr(engine, "global_params"):
        return canonical_params_hash(engine.global_params())
    return canonical_params_hash(engine.gather_params(0))


def _supervised(factory, faults, label):
    """One supervised run through ``faults``; returns (report, hash)."""
    from p2pfl_tpu_torch.management.checkpoint import FLCheckpointer
    from p2pfl_tpu_torch.population.supervisor import EngineSupervisor

    with tempfile.TemporaryDirectory(prefix=f"soak-{label}-") as tmp:
        with FLCheckpointer(tmp, max_to_keep=2) as ck:
            with EngineSupervisor(
                factory, ck, node=f"soak-{label}", faults=faults, backoff_s=0.0
            ) as sup:
                report = sup.run(CHUNKS, chunk=1)
                h = None if report.parked else _final_hash(sup.engine)
    return report, h


def _soak_engine(name: str, factory) -> int:
    from p2pfl_tpu_torch.chaos.plane import ChaosPlane

    t0 = time.monotonic()
    faults = ChaosPlane().plan_host_faults(CHUNKS, seed=SEED, kinds=FAULT_KINDS)
    if len(faults) != len(FAULT_KINDS):
        return _fail(f"{name}: degenerate fault trace {faults}")

    control = factory()
    try:
        control.run(CHUNKS)
        control_hash = _final_hash(control)
    finally:
        control.close()

    report, supervised_hash = _supervised(factory, faults, name)
    if report.parked:
        return _fail(f"{name}: supervisor parked ({report.park_reason})")
    if report.completed != CHUNKS:
        return _fail(f"{name}: completed {report.completed}/{CHUNKS} chunks")
    executed = {ev.kind for ev in report.faults_executed}
    if executed != set(FAULT_KINDS):
        return _fail(f"{name}: injected kinds {sorted(executed)} != {FAULT_KINDS}")
    if supervised_hash != control_hash:
        return _fail(
            f"{name}: supervised hash {supervised_hash} != control "
            f"{control_hash} — resume is not bit-exact"
        )

    replay, replay_hash = _supervised(factory, faults, f"{name}-replay")
    if len(replay.events) != len(report.events):
        return _fail(
            f"{name}: replay event count {len(replay.events)} != "
            f"{len(report.events)}"
        )
    if replay.events != report.events:
        return _fail(
            f"{name}: replay event log diverged\n  first  {report.events}\n"
            f"  replay {replay.events}"
        )
    if replay_hash != control_hash:
        return _fail(f"{name}: replay hash {replay_hash} != control")
    print(
        f"  {name}: healed {len(faults)} fault(s) "
        f"({'+'.join(sorted(executed))}), hash == control, "
        f"replay {len(replay.events)} events identical "
        f"[{time.monotonic() - t0:.1f}s]",
        file=sys.stderr,
    )
    return 0


def _degrade_ladder(device: str) -> int:
    """A permanently failing engine must walk the full ladder (chunks ->
    cohort -> park) identically on every replay."""
    from p2pfl_tpu_torch.management.checkpoint import FLCheckpointer
    from p2pfl_tpu_torch.population.engine import PopulationEngine
    from p2pfl_tpu_torch.population.supervisor import EngineSupervisor

    class FailingEngine(PopulationEngine):
        def run(self, *a, **kw):
            raise RuntimeError("soak: synthetic permanent chunk failure")

    def factory(**kw):
        args = dict(
            num_nodes=8, cohort_fraction=0.5, cohort_min=2,
            samples_per_node=8, feature_dim=8, hidden=(8,), batch_size=4,
            seed=SEED, device=device,
        )
        args.update(kw)
        return FailingEngine(**args)

    def one_run():
        with tempfile.TemporaryDirectory(prefix="soak-degrade-") as tmp:
            with FLCheckpointer(tmp, max_to_keep=2) as ck:
                with EngineSupervisor(
                    factory, ck, node="soak-degrade", max_retries=0,
                    backoff_s=0.0, degrade="cohort",
                ) as sup:
                    return sup.run(CHUNKS, chunk=4)

    first, second = one_run(), one_run()
    if not first.parked:
        return _fail("degrade: permanently failing engine did not park")
    actions = [a for a, _ in first.degrade_steps]
    if "chunks" not in actions or "cohort" not in actions:
        return _fail(f"degrade: ladder skipped a stage: {first.degrade_steps}")
    if first.events != second.events:
        return _fail(
            f"degrade: ladder replay diverged\n  first  {first.events}\n"
            f"  second {second.events}"
        )
    print(
        f"  degrade: ladder {actions} -> park, {len(first.events)} events, "
        "replay identical",
        file=sys.stderr,
    )
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="torch device of the engines (default: cuda)")
    device = ap.parse_args(argv).device
    from p2pfl_tpu_torch.config import Settings
    from p2pfl_tpu_torch.population.async_engine import AsyncPopulationEngine
    from p2pfl_tpu_torch.population.engine import PopulationEngine

    Settings.LOG_LEVEL = "ERROR"
    t0 = time.monotonic()
    print(
        f"soak-check: {N_NODES} vnodes, {CHUNKS} chunks, faults "
        f"{FAULT_KINDS} on both engines, on {device}...",
        file=sys.stderr,
    )

    def sync_factory(**kw):
        args = dict(num_nodes=N_NODES, device=device, **SHAPE)
        args.update(kw)
        return PopulationEngine(**args)

    def async_factory(**kw):
        args = dict(num_nodes=N_NODES, device=device, **SHAPE)
        args.update(kw)
        return AsyncPopulationEngine(**args)

    rc = _soak_engine("population", sync_factory)
    if rc:
        return rc
    rc = _soak_engine("async", async_factory)
    if rc:
        return rc
    rc = _degrade_ladder(device)
    if rc:
        return rc
    print(f"soak-check PASSED in {time.monotonic() - t0:.1f}s", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
