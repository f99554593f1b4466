"""The port's devobs tripwires against the JAX package's MeshSimulation.

Both packages flag, in each round, a non-finite member loss or aggregate
("nonfinite") and a cohort loss above ``DEVOBS_LOSS_DIVERGE_MULT`` times the
chunk's best finite one ("loss_diverge"), read the flags once per chunk of
``rounds_per_call`` rounds and, under ``DEVOBS_TRIP_ACTION="abort"``, raise
``RuntimeError("devobs tripwire: <kind> at round <r> (chunk <c>); ...")``
with the population state parked at the end of the tripped chunk. Each case
runs both packages on one input and holds the port to the reference's kind,
round, chunk and ``completed_rounds``. The JAX side dumps its flight
recorder under ``artifacts/`` of the working directory, so the tests run in
their tmp dir.
"""

import re

import jax
import numpy as np
import pytest

from p2pfl_tpu.config import Settings as JaxSettings
from p2pfl_tpu.learning.dataset import RandomIIDPartitionStrategy as JaxRandomIID
from p2pfl_tpu.learning.dataset import synthetic_mnist as jax_synthetic_mnist
from p2pfl_tpu.parallel.mesh import make_mesh
from p2pfl_tpu.parallel.simulation import MeshSimulation as JaxMeshSimulation
from p2pfl_tpu_torch.config import Settings
from p2pfl_tpu_torch.learning.dataset import RandomIIDPartitionStrategy, synthetic_mnist
from p2pfl_tpu_torch.parallel.simulation import MeshSimulation, _first_trip
from test_torch_classification import mlp_handles

TRIP = re.compile(r"devobs tripwire: (\w+) at round (\d+) \(chunk (\d+)\); flight recorder dump: .*; "
                  r"state parked at round (\d+)")
# A diverging run: every member's update scaled 10x (the "scaled" Byzantine
# attack) at lr 0.1 takes round 1's cohort loss past 100 times round 0's,
# finite throughout.
DIVERGE = dict(batch_size=64, lr=0.1, byzantine_mask=np.ones(4, np.float32), byzantine_attack="scaled")
SCHED = np.array([[0, 1], [2, 3], [0, 2], [1, 3]], np.int32)


@pytest.fixture(autouse=True)
def _in_tmp(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)


def sims(**kw):
    """The JAX and port simulations of ROADMAP.md C2's input (the MLP, 256
    synthetic MNIST samples over 4 IID nodes, committee 2, batch 32, lr
    1e30: round 0's aggregate is NaN) from the same weights; ``kw``
    overrides its arguments."""
    jh, ph = mlp_handles()
    data = dict(n_train=256, n_test=64)
    args = {**dict(train_set_size=2, batch_size=32, lr=1e30, seed=0), **kw}
    jsim = JaxMeshSimulation(jh, jax_synthetic_mnist(**data).generate_partitions(4, JaxRandomIID),
                             mesh=make_mesh(devices=jax.devices()[:1]), **args)
    sim = MeshSimulation(ph, synthetic_mnist(**data).generate_partitions(4, RandomIIDPartitionStrategy),
                         device="cpu", **args)
    return jsim, sim


def trip_of(sim, **run_kw):
    """``(kind, round, chunk, parked round, completed_rounds)`` of the run's
    tripwire error."""
    with pytest.raises(RuntimeError, match="devobs tripwire") as err:
        sim.run(**run_kw)
    m = TRIP.search(str(err.value))
    assert m is not None, str(err.value)
    return m[1], int(m[2]), int(m[3]), int(m[4]), sim.completed_rounds


@pytest.mark.parametrize("rounds_per_call", [1, 2])
def test_nonfinite_round_aborts_as_in_jax(rounds_per_call):
    jsim, sim = sims()
    want = trip_of(jsim, rounds=2, rounds_per_call=rounds_per_call)
    got = trip_of(sim, rounds=2, rounds_per_call=rounds_per_call)
    assert got == want == ("nonfinite", 0, 0, rounds_per_call, rounds_per_call)


def test_diverging_loss_aborts_as_in_jax():
    jsim, sim = sims(**DIVERGE)
    run = dict(rounds=4, rounds_per_call=4, committee_schedule=SCHED)
    want = trip_of(jsim, **run)
    assert trip_of(sim, **run) == want == ("loss_diverge", 1, 0, 4, 4)


def test_one_round_chunks_never_diverge_and_agree_with_jax():
    # The divergence floor restarts each chunk: at one round a chunk the same
    # run completes on both sides, with the same losses.
    jsim, sim = sims(**DIVERGE)
    run = dict(rounds=4, rounds_per_call=1, committee_schedule=SCHED)
    ref, res = jsim.run(**run), sim.run(**run)
    np.testing.assert_allclose(res.test_loss, ref.test_loss, rtol=1e-5)
    assert max(res.test_loss) > 100 * 2.3  # the losses do diverge
    assert sim.completed_rounds == jsim.completed_rounds == 4


def test_disabled_tripwires_return_nan_as_in_jax():
    jsim, sim = sims()
    with JaxSettings.overridden(DEVOBS_ENABLED=False), Settings.overridden(DEVOBS_ENABLED=False):
        ref, res = jsim.run(rounds=2), sim.run(rounds=2)
    assert np.isnan(ref.test_loss).all() and np.isnan(res.test_loss).all()
    assert len(res.test_loss) == len(ref.test_loss) == 2
    assert sim.completed_rounds == jsim.completed_rounds == 2


def test_park_is_not_ported():
    _, sim = sims()
    with Settings.overridden(DEVOBS_TRIP_ACTION="park"):
        with pytest.raises(NotImplementedError, match="park.*nonfinite at round 0"):
            sim.run(rounds=2)
    assert sim.completed_rounds == 1


def test_settings_match_jax():
    for name in ("DEVOBS_ENABLED", "DEVOBS_TRIP_ACTION", "DEVOBS_LOSS_DIVERGE_MULT"):
        assert getattr(Settings, name) == getattr(JaxSettings, name)


def test_first_trip_prefers_the_earlier_round_then_nonfinite():
    flags = np.array([[False, False], [False, True], [True, True]])
    assert _first_trip(flags, 10, 3) == {"kind": "loss_diverge", "round": 11, "chunk": 3}
    assert _first_trip(flags[[0, 2]], 0, 0) == {"kind": "nonfinite", "round": 1, "chunk": 0}
    assert _first_trip(flags[:1], 0, 0) is None
