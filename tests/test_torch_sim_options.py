"""The port's MeshSimulation options against the JAX package's: the
signatures (and ``local_train_step``'s), the local-training options (SCAFFOLD, FedProx, DP-SGD's clip)
and the server optimizers, each on the same schedule and weights as
tests/test_torch_classification.py's round, within 1e-5 (f32 on both
sides). Two local epochs over one full batch each make FedProx's pull and
SCAFFOLD's drift correction act inside the round while the shuffle still
only reorders the rows of a mean.
"""

import inspect

import jax
import numpy as np
import optax
import pytest

from p2pfl_tpu.parallel.mesh import make_mesh
from p2pfl_tpu.parallel.simulation import MeshSimulation as JaxMeshSimulation
from p2pfl_tpu.parallel.simulation import local_train_step as jax_local_train_step
from p2pfl_tpu_torch.management.checkpoint import FLCheckpointer
from p2pfl_tpu_torch.models.convert import torch_to_flax
from p2pfl_tpu_torch.optim import sgd
from p2pfl_tpu_torch.parallel.simulation import MeshSimulation, local_train_step
from test_torch_classification import LR, SCHED, assert_matches, mlp_handles, mnist_partitions, run_pair

SCHED3 = np.array([[0, 2], [1, 2], [3, 0]], np.int32)


@pytest.mark.parametrize("method", ["__init__", "run"])
def test_signature_matches_jax(method):
    port = inspect.signature(getattr(MeshSimulation, method)).parameters
    ref = inspect.signature(getattr(JaxMeshSimulation, method)).parameters
    extra = ["device"] if method == "__init__" else []
    assert list(port) == [*ref, *extra]
    for name, p in ref.items():
        assert port[name].default == p.default, name
    if extra:
        assert port["device"].default == "cuda"
    assert port.get("task", None) is None or port["task"].default == "classification"


def test_local_train_step_signature_matches_jax():
    """``local_train_step`` takes the JAX package's arguments in its order,
    with its defaults (``lr`` among them, accepted and not read there
    either); the port renames ``key`` to ``gen`` (a torch generator: same
    inputs, not the same RNG) and adds only ``per_example`` last."""
    port = inspect.signature(local_train_step).parameters
    ref = inspect.signature(jax_local_train_step).parameters
    renamed = ["gen" if name == "key" else name for name in ref]
    assert list(port) == [*renamed, "per_example"]
    for (name, p), ported in zip(ref.items(), renamed):
        assert port[ported].kind == p.kind, name
        assert port[ported].default == p.default, name
    assert port["per_example"].kind == inspect.Parameter.KEYWORD_ONLY


@pytest.mark.parametrize(
    "common,epochs",
    [
        (dict(algorithm="scaffold"), 2),
        (dict(algorithm="scaffold", scaffold_global_lr=0.5), 1),
        (dict(fedprox_mu=0.1), 2),
        (dict(dp_clip_norm=0.5, dp_noise_multiplier=0.0), 1),
        (dict(dp_clip_norm=0.5, dp_noise_multiplier=0.0, fedprox_mu=0.1), 2),
    ],
    ids=["scaffold", "scaffold-global-lr", "fedprox", "dp-clip", "dp-clip-fedprox"],
)
def test_local_training_option_matches_jax(common, epochs):
    jsim, ref, sim, res = run_pair(SCHED3, common=common, run_kwargs=dict(epochs=epochs))
    assert_matches(jsim, ref, sim, res)
    if common.get("algorithm") == "scaffold":
        # The global control variate too: it holds round deltas over
        # steps * lr (1/500 or 1/1000 here), so it is compared in parameter
        # units, where the round's 1e-5 applies.
        unit = epochs * LR
        diffs = jax.tree.map(lambda a, b: unit * float(np.max(np.abs(a - np.asarray(b)))),
                             torch_to_flax(sim.c_global), jsim.c_global)
        assert max(jax.tree.leaves(diffs)) < 1e-5, diffs


@pytest.mark.parametrize("name", ["fedavgm", "fedadam", "fedyogi"])
def test_server_optimizer_matches_jax(name):
    jsim, ref, sim, res = run_pair(SCHED3, common=dict(server_optimizer=name, server_lr=0.1))
    assert_matches(jsim, ref, sim, res)


def test_server_optimizer_transformation_matches_jax():
    # sgd(1.0) on the pseudo-gradient reduces to plain FedAvg.
    jsim, ref, sim, res = run_pair(SCHED, jax_kwargs=dict(server_optimizer=optax.sgd(1.0)),
                                   port_kwargs=dict(server_optimizer=sgd(1.0)))
    assert_matches(jsim, ref, sim, res)
    _, plain = run_pair(SCHED)[2:]
    np.testing.assert_allclose(res.test_loss, plain.test_loss, atol=1e-6)


def test_clip_update_norm_matches_jax():
    jsim, ref, sim, res = run_pair(SCHED3, common=dict(clip_update_norm=0.01))
    assert_matches(jsim, ref, sim, res)


def test_eval_every_matches_jax():
    jsim, ref, sim, res = run_pair(SCHED3, run_kwargs=dict(eval_every=2))
    assert len(res.test_loss) == 2  # round index 1 (every 2nd) and the final round
    assert_matches(jsim, ref, sim, res)


def test_privacy_spent_matches_jax():
    jh, ph = mlp_handles()
    jp, pp = mnist_partitions()
    kw = dict(train_set_size=2, batch_size=16, dp_clip_norm=1.0, dp_noise_multiplier=0.8, seed=0)
    with pytest.warns(UserWarning):
        jsim = JaxMeshSimulation(jh, jp, mesh=make_mesh(devices=jax.devices()[:1]), **kw)
    with pytest.warns(UserWarning):
        sim = MeshSimulation(ph, pp, device="cpu", **kw)
    for s in (jsim, sim):
        s.run(rounds=1, warmup=False, committee_schedule=SCHED[:1])
    got, want = sim.privacy_spent(), jsim.privacy_spent()
    assert set(got) == set(want)
    for key in want:
        assert got[key] == want[key], key
    assert np.isfinite(got["epsilon"]) and got["epsilon"] > 0


@pytest.mark.parametrize(
    "kwargs,match",
    [
        (dict(algorithm="scaffold", optimizer=sgd(0.1)), "scaffold manages its own SGD"),
        (dict(algorithm="scaffold", aggregate_fn=lambda s, w: s), "scaffold defines its own aggregation"),
        (dict(algorithm="scaffold", per_node_init=True), "shared round-start"),
        (dict(algorithm="scaffold", server_optimizer="fedadam"), "server_optimizer composes"),
        (dict(algorithm="scaffold", clip_update_norm=1.0), "clip_update_norm composes"),
        (dict(server_optimizer="fedsgd"), "unknown server_optimizer"),
        (dict(server_optimizer="fedadam", per_node_init=True), "shared round-start"),
        (dict(dp_noise_multiplier=1.0), "requires dp_clip_norm"),
        (dict(clip_update_norm=-1.0), ">= 0"),
        (dict(algorithm="fedsgd"), "unknown algorithm"),
        (dict(byzantine_mask=np.zeros(4), byzantine_attack="noise"), "unknown byzantine_attack"),
        (dict(byzantine_mask=np.zeros(3)), "one flag per node"),
        (dict(node_speed=np.ones(3)), "one multiplier per node"),
        (dict(node_speed=np.array([1.0, 0.0, 1.0, 1.0])), "must be > 0"),
        (dict(pad_to_multiple=0), "pad_to_multiple must be >= 1"),
    ],
)
def test_bad_options_raise_as_in_jax(kwargs, match):
    _, ph = mlp_handles()
    _, pp = mnist_partitions()
    with pytest.raises(ValueError, match=match):
        MeshSimulation(ph, pp, device="cpu", seed=0, **kwargs)


def test_unported_options_raise_not_implemented(tmp_path):
    """Nothing here raises ``NotImplementedError`` any more: the checkpoint
    plane (``run(checkpointer=)``, ``save_to`` / ``load_from``) round-trips;
    ``profile_dir``, ``round_cost_analysis``, ``devobs_summary``,
    ``fleet_health`` and ``fleet_snapshot`` (ported with the profiler and
    the telemetry plane) run and return what the JAX package's do."""
    jh, ph = mlp_handles()
    jp, pp = mnist_partitions()
    kw = dict(seed=0, train_set_size=2, batch_size=SCHED.shape[1])
    sim = MeshSimulation(ph, pp, device="cpu", **kw)
    jsim = JaxMeshSimulation(jh, jp, mesh=make_mesh(devices=jax.devices()[:1]), **kw)
    with FLCheckpointer(str(tmp_path / "ck")) as ck:
        probe = MeshSimulation(ph, pp, device="cpu", **kw)
        probe.run(rounds=1, warmup=False, checkpointer=ck, committee_schedule=SCHED[:1])
        assert ck.all_steps() == [1] and probe.save_to(ck)
        assert MeshSimulation(ph, pp, device="cpu", **kw).load_from(ck) == 1
    res = sim.run(rounds=2, profile_dir=str(tmp_path / "trace"), committee_schedule=SCHED[:2])
    ref = jsim.run(rounds=2, committee_schedule=SCHED[:2])
    assert (tmp_path / "trace" / "mesh_round_chunk0" / "trace.json").is_file()
    cost, jcost = sim.round_cost_analysis(), jsim.round_cost_analysis()
    assert set(jcost) <= set(cost) and cost["flops_per_round"] > 0
    (extras, sketches), (jextras, jsketches) = sim.devobs_summary(), jsim.devobs_summary()
    assert set(extras) == set(jextras) and set(sketches) == set(jsketches)
    health, jhealth = sim.fleet_health(res), jsim.fleet_health(ref)
    assert set(health) == set(jhealth)
    np.testing.assert_array_equal(health["participation"], jhealth["participation"])
    assert sim.fleet_snapshot(res)["fleet"]["size"] == jsim.fleet_snapshot(ref)["fleet"]["size"] == 5


@pytest.mark.parametrize(
    "kwargs,match",
    [
        (dict(rounds=0), "rounds"),
        (dict(rounds=1, rounds_per_call=0), "rounds_per_call"),
        (dict(rounds=1, eval_every=0), "eval_every"),
        (dict(rounds=1, fold_schedule=np.zeros((1, 1))), "pass committee_schedule"),
        (dict(rounds=1, committee_schedule=SCHED[:1], fold_schedule=np.array([[2]])), "positions"),
        (dict(rounds=1, committee_schedule=SCHED[:1], fold_schedule=np.zeros((1, 3))), "fold_schedule has shape"),
    ],
)
def test_bad_run_arguments_raise(kwargs, match):
    _, ph = mlp_handles()
    _, pp = mnist_partitions()
    sim = MeshSimulation(ph, pp, device="cpu", seed=0, train_set_size=2)
    with pytest.raises(ValueError, match=match):
        sim.run(warmup=False, **kwargs)


def test_rounds_per_call_keeps_the_trajectory():
    _, ph = mlp_handles()
    _, pp = mnist_partitions()
    out = []
    for rpc in (1, 3):
        sim = MeshSimulation(ph, pp, device="cpu", seed=5, train_set_size=2, batch_size=16)
        a = sim.run(rounds=2, warmup=False, rounds_per_call=rpc)
        b = sim.run(rounds=1, warmup=False, rounds_per_call=rpc)  # round index 2 continues the key stream
        out.append((a, b))
    (a1, b1), (a3, b3) = out
    np.testing.assert_array_equal(a1.committees, a3.committees)
    np.testing.assert_array_equal(b1.committees, b3.committees)
    assert a1.test_loss == a3.test_loss and b1.test_loss == b3.test_loss
