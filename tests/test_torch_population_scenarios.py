"""The port's population scenario engine (``p2pfl_tpu_torch/population/
scenarios.py``) on the CPU: its host pieces (data, cohort schedules,
Byzantine draws, speed tiers, the adaptive ladder's oracle, the learners'
cohort slots) equal the JAX package's exactly, its validation refuses what
the JAX package's refuses, and one seeded Dirichlet scenario at a 50 %
cohort runs on the port's wire (real ``Node`` s, rotating-observer
stitching) and on the port's fused round with every round's aggregate
hash aligned by ``scripts/parity_diff.py``.
"""

import importlib.util
import os

import numpy as np
import pytest

from p2pfl_tpu.population.scenarios import PopulationLearner as JaxPopulationLearner
from p2pfl_tpu.population.scenarios import PopulationScenario as JaxPopulationScenario
from p2pfl_tpu_torch.population.scenarios import (
    PopulationLearner,
    PopulationScenario,
    run_scenario_fused,
    run_scenario_wire,
    stitch_observer_stream,
)

from test_torch_comm import port_transport  # noqa: F401  (reference test timings, transport teardown)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SPECS = [
    dict(seed=77, n_nodes=4, rounds=3, samples_per_node=16, batch_size=8, hidden=(8,), cohort_fraction=0.5,
         dirichlet_alpha=0.3),
    dict(seed=5, n_nodes=12, rounds=4, samples_per_node=8, batch_size=4, cohort_fraction=0.25, churn_rate=0.2,
         cohort_min=2, byzantine_fraction=0.25, byzantine_attack="scaled", speed_tiers=(1.0, 2.0, 5.0)),
    dict(seed=9, n_nodes=8, rounds=5, samples_per_node=8, batch_size=8, adaptive_adversary=3, adaptive_patience=2),
    dict(seed=3, n_nodes=6, rounds=2, samples_per_node=8, batch_size=8, privacy=True, straggler={2: 0.5}),
]


@pytest.mark.parametrize("spec", SPECS, ids=["dirichlet", "byzantine-churn-tiers", "adaptive", "privacy"])
def test_scenario_host_pieces_equal_the_jax_package(spec):
    scn, ref = PopulationScenario(**spec), JaxPopulationScenario(**spec)
    assert scn.run_id == ref.run_id and scn.cohort_k == ref.cohort_k and scn.node_names == ref.node_names
    assert scn.byzantine == ref.byzantine
    np.testing.assert_array_equal(scn.schedule(), ref.schedule())
    np.testing.assert_array_equal(scn.schedule(start_round=2), ref.schedule(start_round=2))
    a, b = scn.node_speed_array(), ref.node_speed_array()
    assert (a is None) == (b is None)
    if a is not None:
        np.testing.assert_array_equal(a, b)
    for x, y in zip(scn.data(), ref.data()):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)
    assert scn.adaptive_schedule() == ref.adaptive_schedule()
    assert [scn.plan().cohort(r, scn.node_names) for r in range(scn.rounds)] == [
        ref.plan().cohort(r, ref.node_names) for r in range(ref.rounds)]


def test_learners_take_the_jax_package_cohort_slots():
    scn, ref = PopulationScenario(**SPECS[1]), JaxPopulationScenario(**SPECS[1])
    x, y, w = scn.data()
    for i in range(scn.n_nodes):
        mine = PopulationLearner(None, None, scn.node_names[i], node_idx=i, scenario=scn,
                                 arrays=(x[i], y[i], w[i]), train_fn=lambda *a: None, device="cpu")
        theirs = JaxPopulationLearner(None, None, ref.node_names[i], node_idx=i, scenario=ref,
                                      arrays=(x[i], y[i], w[i]), train_fn=lambda *a: None)
        assert mine._slots == theirs._slots
        assert mine._attack == theirs._attack


@pytest.mark.parametrize("bad", [
    dict(cohort_fraction=0.0), dict(cohort_fraction=1.5), dict(privacy=True, byzantine_fraction=0.25),
    dict(adaptive_adversary=0), dict(adaptive_adversary=2, cohort_fraction=0.5),
    dict(adaptive_adversary=2, drop_rate=0.1), dict(adaptive_adversary=2, n_nodes=4),
    dict(adaptive_adversary=2, byzantine={1: "signflip"}), dict(adaptive_adversary=2, adaptive_patience=0),
    dict(samples_per_node=10, batch_size=4),
])
def test_scenario_validation_matches_the_jax_package(bad):
    spec = {"n_nodes": 8, "rounds": 2, "samples_per_node": 8, "batch_size": 8, **bad}
    with pytest.raises(ValueError) as mine:
        PopulationScenario(**spec)
    with pytest.raises(ValueError) as theirs:
        JaxPopulationScenario(**spec)
    assert str(mine.value) == str(theirs.value)


def test_stitch_observer_stream_rotates_the_first_cohort_member():
    scn = PopulationScenario(**SPECS[0])
    events = {name: [{"kind": "aggregate_committed", "round": r, "node": name} for r in range(scn.rounds)]
              for name in scn.node_names}
    stream = stitch_observer_stream(scn, events)
    assert [e["round"] for e in stream] == list(range(scn.rounds))
    assert [e["node"] for e in stream] == [scn.plan().cohort(r, scn.node_names)[0] for r in range(scn.rounds)]


def test_scenario_parity_under_cohort_sampling(tmp_path):
    """One seeded scenario (Dirichlet skew, 50 % cohort) on both of the
    port's backends: every node, member or not, commits the same bits each
    round on the wire; the rotating-observer stream aligns with the fused
    ledger and every round's aggregate hash is bit-exact."""
    spec = importlib.util.spec_from_file_location("parity_diff", os.path.join(ROOT, "scripts", "parity_diff.py"))
    parity_diff = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(parity_diff)
    scn = PopulationScenario(seed=77, n_nodes=4, rounds=2, samples_per_node=16, batch_size=8, hidden=(8,),
                             cohort_fraction=0.5, dirichlet_alpha=0.3)
    assert len({scn.plan().cohort(r, scn.node_names)[0] for r in range(scn.rounds)}) == 2  # the observer rotates
    wire = run_scenario_wire(scn, ledger_dir=str(tmp_path), timeout_s=120.0, device="cpu")
    ref = wire["hashes"][scn.node_names[0]]
    assert len(ref) == scn.rounds
    assert all(wire["hashes"][n] == ref for n in scn.node_names)
    fused = run_scenario_fused(scn, ledger_dir=str(tmp_path), device="cpu")
    report = parity_diff.compare_ledgers(wire["stitched"], fused["events"])
    assert report["status"] == "OK", report.get("first_divergence")
    assert report["hashes_compared"] == scn.rounds
    assert set(fused["final_params"]) == {"Dense_0.weight", "Dense_0.bias", "Dense_1.weight", "Dense_1.bias"}
