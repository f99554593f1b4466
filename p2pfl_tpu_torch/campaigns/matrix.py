"""The campaign's declarative scenario space and its seeded sampler.

``AXES`` is the matrix as data: every environment axis the campaign can
vary and the levels it draws from. ``FAMILIES`` partitions the matrix
into gradeable scenario families — each family pins the axes that define
it and seeds the rest, so a family's invariant catalog
(:mod:`p2pfl_tpu_torch.campaigns.invariants`) knows exactly what it is grading.

``sample_campaign(seed, n)`` is a pure function: the same (seed, n)
always yields the same scenario list, byte for byte — that is what lets
``scripts/torch_campaign_check.py`` replay a committed baseline and what makes a
campaign finding reproducible from its two integers.

Family notes (the "why" behind the pinned axes):

* ``byzantine`` uses the delta-reflection attack only (``signflip`` in
  :func:`~p2pfl_tpu_torch.parallel.simulation.poison_delta` terms): a reflected
  update is honest-normed, so wire admission ADMITS it and both backends
  fold the same corrupted set — bit parity stays provable. Norm-tripping
  static attacks would make the wire fold n-1 while the fused mesh folds
  n; attacks that exploit the admission signal belong to the ADAPTIVE
  family, which replays the narrowed fold on the mesh via
  ``fold_schedule``.
* ``privacy`` runs the wire under masked secagg; fused execution stays
  plaintext, so the family is graded structurally plus the
  masked-vs-plain hash negative control instead of bit parity.
* ``recovery`` maps the crash-restart / partition-heal / masker-dropout
  axes: those lifecycles are seeded chaos-plane TRACES
  (``plan_recovery`` + ``plan_churn`` + ``plan_masker_dropout``) graded
  for deterministic replay alongside a clean both-backend run.
"""

from __future__ import annotations

import random
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

from p2pfl_tpu_torch.config import Settings
from p2pfl_tpu_torch.population.scenarios import PopulationScenario

#: The declarative campaign space. Keys are environment axes, values the
#: levels the family builders draw from (documentation-as-data: the
#: campaign doc renders this table, and tests assert every axis is
#: exercised by at least one family).
AXES: Dict[str, Tuple[Any, ...]] = {
    "chaos_drop_rate": (0.05, 0.1, 0.15),
    "byzantine_fraction": (0.2, 0.25),
    "byzantine_attack": ("signflip",),
    "cohort_fraction": (0.5, 0.75),
    "churn_rate": (0.1, 0.2),
    "privacy": (False, True),
    "crash_restart": (False, True),
    "partition_heal": (False, True),
    "speed_tiers": ((1.0, 2.0), (1.0, 1.5, 3.0)),
    "dirichlet_alpha": (0.1, 0.3, 1.0),
    "adaptive_patience": (1, 2),
    "host_fault_kinds": (
        ("kill", "oom", "sigterm"),
        ("oom", "kill"),
        ("sigterm", "oom"),
    ),
}

#: Scenario families, in round-robin sampling order. A campaign of
#: ``n >= len(FAMILIES)`` scenarios therefore always contains at least one
#: of each — including the headline ``adaptive`` family.
FAMILIES: Tuple[str, ...] = (
    "adaptive",
    "baseline",
    "chaos_drop",
    "host_fault",
    "byzantine",
    "churn",
    "tier_skew",
    "noniid",
    "privacy",
    "recovery",
)


@dataclass(frozen=True)
class CampaignScenario:
    """One sampled point: a family tag, the executable scenario, and (for
    the recovery family) the composed chaos-trace knobs graded at
    invariant time."""

    family: str
    index: int
    scenario: PopulationScenario
    trace: Optional[Dict[str, Any]] = field(default=None)

    @property
    def key(self) -> str:
        """Canonical distinctness key (two sampled scenarios must never
        collide on it — asserted by :func:`sample_campaign`)."""
        scn = self.scenario
        parts = [
            self.family,
            scn.run_id,
            f"drop{scn.drop_rate:g}",
            f"byz{sorted(scn.byzantine.items())}",
            f"churn{scn.churn_rate:g}",
            f"tiers{scn.speed_tiers}",
            f"alpha{scn.dirichlet_alpha}",
            f"priv{scn.privacy}",
        ]
        if self.trace is not None:
            parts.append(f"trace{sorted(self.trace.items())}")
        return "|".join(parts)


def campaign_id(seed: int, n_scenarios: int) -> str:
    """The campaign's ledger/artifact scope id."""
    return f"campaign-s{seed}-n{n_scenarios}"


def _rng(seed: int, family: str, index: int) -> random.Random:
    """A dedicated stream per (campaign seed, family, ordinal) — adding a
    family or reordering the rotation never perturbs another family's
    draws."""
    return random.Random(f"{seed}|{family}|{index}")


def _scenario_seed(rng: random.Random) -> int:
    return rng.randrange(1, 2**31 - 1)


def build_scenario(seed: int, family: str, index: int) -> CampaignScenario:
    """Materialize the ``index``-th scenario of ``family`` for campaign
    ``seed`` — a pure seeded function (no global state)."""
    rng = _rng(seed, family, index)
    sseed = _scenario_seed(rng)
    base: Dict[str, Any] = dict(
        seed=sseed, n_nodes=4, rounds=2, samples_per_node=32, batch_size=16
    )
    trace: Optional[Dict[str, Any]] = None
    if family == "baseline":
        base["n_nodes"] = rng.choice((4, 5))
    elif family == "chaos_drop":
        base["drop_rate"] = rng.choice(AXES["chaos_drop_rate"])
    elif family == "byzantine":
        base["n_nodes"] = rng.choice((4, 5))
        base["byzantine_fraction"] = rng.choice(AXES["byzantine_fraction"])
        base["byzantine_attack"] = rng.choice(AXES["byzantine_attack"])
    elif family == "churn":
        # Churn availability is a per-node seeded Bernoulli draw, so a
        # given (seed, n, fraction, churn_rate) combo can starve a round's
        # K-committee (the fused scan needs a static shape and raises).
        # Reroll DETERMINISTICALLY — the rng stream continues, so the
        # sampled scenario stays a pure function of (seed, family, index)
        # and a feasible draw is feasible forever.
        base["rounds"] = 3
        for _attempt in range(32):
            base["seed"] = sseed
            base["n_nodes"] = rng.choice((6, 8))
            base["cohort_fraction"] = rng.choice(AXES["cohort_fraction"])
            base["churn_rate"] = rng.choice(AXES["churn_rate"])
            scn = PopulationScenario(**base)
            try:
                scn.schedule(0)  # derive every round's committee up front
            except ValueError:
                sseed = _scenario_seed(rng)
                continue
            return CampaignScenario(family=family, index=index, scenario=scn)
        raise RuntimeError(
            f"no feasible churn scenario after 32 rerolls (campaign seed "
            f"{seed}, ordinal {index})"
        )
    elif family == "tier_skew":
        base["speed_tiers"] = rng.choice(AXES["speed_tiers"])
    elif family == "noniid":
        base["dirichlet_alpha"] = rng.choice(AXES["dirichlet_alpha"])
        base["n_nodes"] = rng.choice((4, 6))
    elif family == "privacy":
        base["privacy"] = True
    elif family == "host_fault":
        # Clean both-backend run + a seeded host-fault trace (kill / oom /
        # sigterm) graded by actually SUPERVISING a small fused run through
        # every planned fault and asserting bit-identity with a fault-free
        # control (invariants.py::_grade_supervisor_recovered). rounds stays
        # >= len(kinds) + 1 so plan_host_faults has a slot per kind.
        trace = {
            "rounds": rng.choice((4, 5)),
            "kinds": rng.choice(AXES["host_fault_kinds"]),
        }
    elif family == "recovery":
        # Clean both-backend run + the composed crash-restart /
        # partition-heal / masker-dropout trace graded for deterministic
        # replay (invariants.py::_grade_recovery).
        trace = {
            "rounds": rng.choice((6, 8)),
            "crash_round": rng.choice((1, 2)),
            "restart_after": rng.choice((1, 2)),
            "partition_round": rng.choice((2, 3)),
            "heal_after": rng.choice((1, 2)),
            "drop_round": rng.choice((1, 2)),
        }
    elif family == "adaptive":
        patience = rng.choice(AXES["adaptive_patience"])
        n = 6
        base.update(
            n_nodes=n,
            # Enough rounds for the ladder to reach its terminal admitted
            # stage: stages-1 escalations, each taking ``patience``
            # rejected rounds, plus >= 1 norm_ride round at the end.
            rounds=2 * patience + 1,
            adaptive_adversary=rng.randrange(1, n),
            adaptive_patience=patience,
        )
    else:
        raise ValueError(f"unknown campaign family {family!r}")
    return CampaignScenario(
        family=family,
        index=index,
        scenario=PopulationScenario(**base),
        trace=trace,
    )


def sample_campaign(
    seed: Optional[int] = None,
    n_scenarios: Optional[int] = None,
    families: Sequence[str] = FAMILIES,
) -> List[CampaignScenario]:
    """Sample the campaign: ``n_scenarios`` points, families rotated
    round-robin, every point seeded from ``seed`` alone. Raises if two
    sampled scenarios collide on their canonical key (the sampler must
    yield DISTINCT scenarios, an acceptance property of the harness)."""
    if seed is None:
        seed = Settings.CAMPAIGN_SEED
    if n_scenarios is None:
        n_scenarios = Settings.CAMPAIGN_SCENARIOS
    if n_scenarios < 1:
        raise ValueError(f"n_scenarios must be >= 1, got {n_scenarios}")
    out: List[CampaignScenario] = []
    per_family: Dict[str, int] = {}
    for i in range(int(n_scenarios)):
        family = families[i % len(families)]
        ordinal = per_family.get(family, 0)
        per_family[family] = ordinal + 1
        out.append(build_scenario(int(seed), family, ordinal))
    keys = [cs.key for cs in out]
    if len(set(keys)) != len(keys):
        dupes = sorted({k for k in keys if keys.count(k) > 1})
        raise RuntimeError(f"campaign sampler produced duplicate scenarios: {dupes}")
    return out
