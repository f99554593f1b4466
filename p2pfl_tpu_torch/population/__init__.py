"""Population-scale engines (counterpart of ``p2pfl_tpu/population/``): the
seeded cohort sampler, the sync and async population engines over one card,
the scenario engine, the engine supervisor and the rule-driven spec trees
of the stacked state.

The shared primitive is :mod:`p2pfl_tpu_torch.population.cohort`: an
order-independent hash sampler, equal to the JAX package's for the same
``(seed, round, names)``. On it:

* :mod:`~p2pfl_tpu_torch.population.engine` drives a ``MeshSimulation``
  population of up to 100k virtual nodes by committee schedules, and
  :mod:`~p2pfl_tpu_torch.population.sharding` derives its spec tree;
* :mod:`~p2pfl_tpu_torch.population.arrivals` streams trace-driven arrival
  windows from the cohort stream, and
  :mod:`~p2pfl_tpu_torch.population.async_engine` runs those *windows*
  (FedBuff) instead of barrier rounds: staleness-weighted folds against a
  history ring of globals, bit-exact against the sync engine at zero lag
  and against the wire async buffer (:func:`wire_window_replay`);
* :mod:`~p2pfl_tpu_torch.population.scenarios` runs one seeded scenario
  (Dirichlet skew, cohorts, churn, speed tiers, Byzantine draws) on the
  wire and on the fused round, for ``scripts/parity_diff.py`` to align;
* :mod:`~p2pfl_tpu_torch.population.supervisor` drives either engine chunk
  by chunk with journaling, self-healing resume, a degrade ladder and
  seeded host-fault drills.
"""

from p2pfl_tpu_torch.population.arrivals import (
    AsyncWindowPlan,
    WindowSchedule,
    compile_window_schedule,
    trace_intensity,
)
from p2pfl_tpu_torch.population.async_engine import (
    AsyncPopulationEngine,
    AsyncRunResult,
    wire_window_replay,
)
from p2pfl_tpu_torch.population.cohort import (
    CohortPlan,
    active_plan,
    clear_plan,
    cohort_for_round,
    committee_schedule,
    install_plan,
)
from p2pfl_tpu_torch.population.engine import PopulationEngine, population_data, vnode_names
from p2pfl_tpu_torch.population.scenarios import PopulationScenario
from p2pfl_tpu_torch.population.sharding import (
    make_shard_and_gather_fns,
    match_partition_rules,
    population_partition_rules,
    tree_path_names,
)
from p2pfl_tpu_torch.population.supervisor import EngineSupervisor, SupervisorReport

__all__ = [
    "AsyncPopulationEngine",
    "AsyncRunResult",
    "AsyncWindowPlan",
    "CohortPlan",
    "EngineSupervisor",
    "PopulationEngine",
    "PopulationScenario",
    "SupervisorReport",
    "WindowSchedule",
    "active_plan",
    "clear_plan",
    "cohort_for_round",
    "committee_schedule",
    "compile_window_schedule",
    "install_plan",
    "make_shard_and_gather_fns",
    "match_partition_rules",
    "population_data",
    "population_partition_rules",
    "trace_intensity",
    "tree_path_names",
    "vnode_names",
    "wire_window_replay",
]
