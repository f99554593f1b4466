"""Adversarial campaign universe: seeded scenario-matrix harness.

A *campaign* treats :class:`~p2pfl_tpu_torch.population.scenarios.
PopulationScenario` as one point in a declarative space and samples a
seeded batch of points from the full matrix — chaos drop traces x
Byzantine fractions x churn/arrival profiles x privacy on/off x
crash-restart x partition-heal x device-tier skew x Dirichlet non-IID —
plus the headline ADAPTIVE adversary family (chaos/plane.py): an attacker
that observes its own admission rejections and climbs the
signflip -> scaled -> norm_ride ladder mid-campaign.

Every sampled scenario executes on BOTH backends (real wire + fused
mesh), runs under the ledger parity differ, and is graded against its
family's invariant catalog (:mod:`p2pfl_tpu_torch.campaigns.invariants`).
``scripts/torch_campaign_check.py`` replays the committed baseline
prefix (tests/torch_campaign_fixtures/) deterministically, on the card or
(``--device cpu``) on the host.
"""

from p2pfl_tpu_torch.campaigns.engine import (
    CAMPAIGN_SCOPED_FAMILIES,
    run_campaign,
)
from p2pfl_tpu_torch.campaigns.invariants import (
    FAMILY_INVARIANTS,
    Violation,
    evaluate_final_params,
    grade_scenario,
)
from p2pfl_tpu_torch.campaigns.matrix import (
    AXES,
    FAMILIES,
    CampaignScenario,
    build_scenario,
    campaign_id,
    sample_campaign,
)

__all__ = [
    "AXES",
    "CAMPAIGN_SCOPED_FAMILIES",
    "FAMILIES",
    "FAMILY_INVARIANTS",
    "CampaignScenario",
    "Violation",
    "build_scenario",
    "campaign_id",
    "evaluate_final_params",
    "grade_scenario",
    "run_campaign",
    "sample_campaign",
]
