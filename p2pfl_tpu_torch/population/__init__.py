"""Population-scale engine (counterpart of ``p2pfl_tpu/population/``): the
seeded cohort sampler, the sync population engine over one card and the
rule-driven spec trees of its stacked state.

The shared primitive is :mod:`p2pfl_tpu_torch.population.cohort`: an
order-independent hash sampler, equal to the JAX package's for the same
``(seed, round, names)``. :mod:`~p2pfl_tpu_torch.population.engine` drives a
``MeshSimulation`` population of up to 100k virtual nodes by committee
schedules drawn from it, and :mod:`~p2pfl_tpu_torch.population.sharding`
derives its spec tree. The async engine, its arrivals, the scenario engine
and the supervisor are not ported yet (``scenarios`` holds only the label
skew the engine's data reads).
"""

from p2pfl_tpu_torch.population.cohort import (
    CohortPlan,
    active_plan,
    clear_plan,
    cohort_for_round,
    committee_schedule,
    install_plan,
)
from p2pfl_tpu_torch.population.engine import PopulationEngine, population_data, vnode_names
from p2pfl_tpu_torch.population.sharding import (
    make_shard_and_gather_fns,
    match_partition_rules,
    population_partition_rules,
    tree_path_names,
)

__all__ = [
    "CohortPlan",
    "PopulationEngine",
    "active_plan",
    "clear_plan",
    "cohort_for_round",
    "committee_schedule",
    "install_plan",
    "make_shard_and_gather_fns",
    "match_partition_rules",
    "population_data",
    "population_partition_rules",
    "tree_path_names",
    "vnode_names",
]
