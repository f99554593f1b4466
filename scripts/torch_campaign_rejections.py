"""The adaptive adversary's decision stream across repeated runs of one
campaign scenario, in either package, on the CPU.

    python scripts/torch_campaign_rejections.py --package port --runs 3
    python scripts/torch_campaign_rejections.py --package jax --runs 3

Runs the committed campaign's first scenario (the adaptive family's first:
six MLP Nodes, one adaptive adversary) on the wire ``--runs`` times in one
process, its campaign-scoped metrics cleared before each run, and prints
each run's decisions: the attack of every round and the cumulative count of
the adversary's frames that honest nodes rejected when it chose it.

What it showed (both packages): the attack ladder is the same in every
run; the rejection counts are not. The adversary's rejected frames are
re-shipped by the gossip loop until the round closes, so the count before
its next fit follows the hosts' timing.
"""

from __future__ import annotations

import argparse
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--package", choices=("port", "jax"), default="port")
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--seed", type=int, default=20260806, help="campaign seed")
    args = ap.parse_args(argv)
    if args.package == "jax":
        os.environ.setdefault("JAX_PLATFORMS", "cpu")
        import jax

        jax.config.update("jax_platforms", "cpu")
        from p2pfl_tpu.campaigns import CAMPAIGN_SCOPED_FAMILIES, sample_campaign
        from p2pfl_tpu.population.scenarios import run_scenario_wire
        from p2pfl_tpu.telemetry import REGISTRY

        kw = {}
    else:
        from p2pfl_tpu_torch.campaigns import CAMPAIGN_SCOPED_FAMILIES, sample_campaign
        from p2pfl_tpu_torch.population.scenarios import run_scenario_wire
        from p2pfl_tpu_torch.telemetry import REGISTRY

        kw = {"device": "cpu"}
    cs = sample_campaign(args.seed, 1)[0]
    print(f"{args.package}: {cs.family}[{cs.index}] {cs.scenario.run_id}", flush=True)
    for run in range(args.runs):
        REGISTRY.clear_families(CAMPAIGN_SCOPED_FAMILIES)
        wire = run_scenario_wire(cs.scenario, **kw)
        decisions = wire["adaptive"]["decisions"]
        print(f"{args.package} run {run}: attacks {[d['attack'] for d in decisions]} "
              f"rejections {[d['rejections'] for d in decisions]}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
