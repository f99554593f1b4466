"""The port's MeshSimulation population options against the JAX package's:
Byzantine members with robust aggregation rules, narrowed folds, the
canonical committee, filler padding, per-node initialization and node
speeds. Parity cases run tests/test_torch_classification.py's round (same
weights, partitions and committee schedule; f32 on both sides) and hold
test loss, accuracy and node 0's parameters within 1e-5.
"""

import numpy as np
import pytest
import torch

from p2pfl_tpu.ops import aggregation as jax_agg
from p2pfl_tpu.parallel.simulation import simulated_barrier_time as jax_simulated_barrier_time
from p2pfl_tpu_torch.ops import aggregation as agg
from p2pfl_tpu_torch.parallel.simulation import MeshSimulation, simulated_barrier_time
from test_torch_classification import NODES, SAMPLES, assert_matches, mlp_handles, mnist_partitions, run_pair

FULL = np.array([[0, 1, 2, 3], [3, 1, 0, 2]], np.int32)  # the whole population, twice
BYZ = np.array([0, 1, 0, 0], np.float32)  # node 1 poisons its update


@pytest.mark.parametrize(
    "attack,jax_rule,port_rule",
    [
        # Krum with f = 0 scores each member by its 2 nearest neighbours; at
        # f = 1 (1 neighbour) the two closest members tie up to f32 noise.
        ("signflip", lambda s, w: jax_agg.krum(s, w, 0)[0], lambda s, w: agg.krum(s, w, 0)[0]),
        ("norm_ride", lambda s, w: jax_agg.krum(s, w, 1, 2)[0], lambda s, w: agg.krum(s, w, 1, 2)[0]),
        ("scaled", lambda s, w: jax_agg.trimmed_mean(s, 1), lambda s, w: agg.trimmed_mean(s, 1)),
        ("scaled", lambda s, w: jax_agg.geometric_median(s, w), lambda s, w: agg.geometric_median(s, w)),
        ("signflip", lambda s, w: jax_agg.fedmedian(s), lambda s, w: agg.fedmedian(s)),
    ],
    ids=["signflip-krum", "norm_ride-multikrum", "scaled-trimmed-mean", "scaled-geomedian", "signflip-median"],
)
def test_byzantine_members_with_robust_rules_match_jax(attack, jax_rule, port_rule):
    common = dict(byzantine_mask=BYZ, byzantine_attack=attack)
    jsim, ref, sim, res = run_pair(FULL, common=common, jax_kwargs=dict(aggregate_fn=jax_rule),
                                   port_kwargs=dict(aggregate_fn=port_rule))
    assert_matches(jsim, ref, sim, res)


def test_byzantine_scaled_with_update_clip_matches_jax():
    common = dict(byzantine_mask=BYZ, byzantine_attack="scaled", clip_update_norm=0.05)
    assert_matches(*run_pair(FULL, common=common))


def test_fold_schedule_matches_jax():
    sched = np.array([[0, 1, 2], [1, 2, 3], [3, 0, 2]], np.int32)
    fold = np.array([[0, 2], [1, 2], [2, 0]], np.int32)
    jsim, ref, sim, res = run_pair(sched, run_kwargs=dict(fold_schedule=fold))
    assert_matches(jsim, ref, sim, res)
    # The unfolded members still train: their Adam state moved.
    assert sim.opt_stack.count.tolist() == [2, 2, 3, 2]


def test_canonical_committee_matches_jax_on_its_committees():
    _, ph = mlp_handles()
    _, pp = mnist_partitions()
    voted = MeshSimulation(ph, pp, train_set_size=3, batch_size=SAMPLES, seed=11, device="cpu",
                           canonical_committee=True).run(rounds=3, warmup=False).committees
    unsorted = MeshSimulation(ph, pp, train_set_size=3, batch_size=SAMPLES, seed=11,
                              device="cpu").run(rounds=3, warmup=False).committees
    np.testing.assert_array_equal(voted, np.sort(unsorted, axis=1))  # same set, index order
    jsim, ref, sim, res = run_pair(voted.astype(np.int32))
    assert_matches(jsim, ref, sim, res)


def test_pad_to_multiple_changes_nothing():
    jsim, ref, sim, res = run_pair(FULL[:, :2], port_kwargs=dict(pad_to_multiple=3))
    assert sim.num_nodes == 6 and sim.logical_num_nodes == NODES
    assert_matches(jsim, ref, sim, res)
    _, ph = mlp_handles()
    _, pp = mnist_partitions()
    runs = []
    for pad in (None, 3):
        s = MeshSimulation(ph, pp, train_set_size=2, batch_size=16, seed=2, device="cpu", pad_to_multiple=pad)
        runs.append((s.run(rounds=3, warmup=False), s))
    (a, sa), (b, sb) = runs
    np.testing.assert_array_equal(a.committees, b.committees)  # fillers are never elected
    assert a.test_loss == b.test_loss
    assert all(torch.equal(sa.params_stack[k], sb.params_stack[k][:NODES]) for k in sa.params_stack)
    assert not sb.sample_mask[NODES:].any()


def test_per_node_init_perturbs_each_node_from_a_seed():
    _, ph = mlp_handles()
    _, pp = mnist_partitions()
    sims = [MeshSimulation(ph, pp, seed=s, device="cpu", per_node_init=True) for s in (4, 4, 5)]
    for name, base in ph.params.items():
        delta = sims[0].params_stack[name] - base[None]
        assert torch.equal(sims[0].params_stack[name], sims[1].params_stack[name])
        assert not torch.equal(sims[0].params_stack[name], sims[2].params_stack[name])
        assert not torch.equal(delta[0], delta[1])  # each node its own draw
        if delta.numel() > 1000:
            assert abs(float(delta.std()) - 0.01) < 1e-3  # 0.01 N(0, 1)
    plain = MeshSimulation(ph, pp, seed=4, device="cpu")
    assert all(torch.equal(v[i], ph.params[k]) for k, v in plain.params_stack.items() for i in range(NODES))


def test_node_speed_is_kept_and_barrier_time_matches_jax():
    _, ph = mlp_handles()
    _, pp = mnist_partitions()
    speed = np.array([1.0, 5.0, 1.0, 2.5])
    sim = MeshSimulation(ph, pp, seed=1, device="cpu", train_set_size=2, batch_size=16, node_speed=speed)
    res = sim.run(rounds=4, warmup=False)
    np.testing.assert_array_equal(sim.node_speed, speed.astype(np.float32))
    for s in (speed, None):
        assert simulated_barrier_time(res.committees, s) == jax_simulated_barrier_time(res.committees, s)
    assert simulated_barrier_time(FULL, speed) == 10.0
    with pytest.raises(ValueError, match="rounds, k"):
        simulated_barrier_time(np.zeros(3, np.int32), speed)
