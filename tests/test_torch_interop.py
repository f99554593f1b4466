"""The port's interop learners (``p2pfl_tpu_torch/learning/interop/``) and
export strategies against the JAX package's on the CPU: the MLP weight
translators bit-equal, canonical (and native) frames byte-equal for the same
weights, the interop ``TorchLearner``'s fit within 1e-5 of the JAX
package's on the same module weights and batches (and its SCAFFOLD deltas),
the learner registry, a user's module federating with the port's zoo MLP
Node over canonical frames, the Keras bridge behind ``importorskip``, and
every export strategy's output equal to the JAX package's."""

import os

# The JAX package's interop module imports TensorFlow (and so does the port's
# Keras case): one intra-op and one inter-op thread, as the torch fits below
# get, so its ops do not take every core from the other test workers.
os.environ.setdefault("TF_NUM_INTRAOP_THREADS", "1")
os.environ.setdefault("TF_NUM_INTEROP_THREADS", "1")

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from p2pfl_tpu.learning import interop as ref  # noqa: E402
from p2pfl_tpu.learning.dataset import export_strategies as ref_export  # noqa: E402
from p2pfl_tpu.learning.dataset import synthetic_mnist as ref_mnist  # noqa: E402
from p2pfl_tpu_torch.exceptions import ModelNotMatchingError  # noqa: E402
from p2pfl_tpu_torch.learning import interop  # noqa: E402
from p2pfl_tpu_torch.learning.dataset import export_strategies as export  # noqa: E402
from p2pfl_tpu_torch.learning.dataset import synthetic_mnist  # noqa: E402
from p2pfl_tpu_torch.learning.learner import LearnerFactory  # noqa: E402
from p2pfl_tpu_torch.learning.learner import TorchLearner as ZooLearner  # noqa: E402

from test_torch_comm import _wait, port_transport  # noqa: E402,F401
from test_torch_node import one_intra_op_thread  # noqa: E402,F401


@pytest.fixture(autouse=True)
def _one_thread(one_intra_op_thread):  # noqa: F811
    """Every fit here takes one torch intra-op thread (see above)."""
    yield


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _state(seed=0, hidden=(24, 12)):
    rng = np.random.default_rng(seed)
    dims = (784, *hidden, 10)
    state = {}
    for i, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
        state[f"{1 + 2 * i}.weight"] = rng.standard_normal((b, a)).astype(np.float32)
        state[f"{1 + 2 * i}.bias"] = rng.standard_normal(b).astype(np.float32)
    return state


def test_mlp_translators_are_bit_equal_to_the_jax_packages():
    state = _state()
    got, want = interop.torch_state_dict_to_jax_mlp(state), ref.torch_state_dict_to_jax_mlp(state)
    assert sorted(got["params"]) == sorted(want["params"])
    for name in want["params"]:
        for leaf in ("kernel", "bias"):
            np.testing.assert_array_equal(_np(got["params"][name][leaf]), want["params"][name][leaf])
    back, ref_back = interop.jax_mlp_params_to_torch(want), ref.jax_mlp_params_to_torch(want)
    assert sorted(back) == sorted(ref_back) == sorted(state)
    for k in state:
        np.testing.assert_array_equal(_np(back[k]), ref_back[k])
        np.testing.assert_array_equal(_np(back[k]), state[k])
    wire, ref_wire = interop.torch_mlp_to_wire(state), ref.torch_mlp_to_wire(state)
    assert [a.shape for a in ref_wire] == [tuple(a.shape) for a in wire]
    for a, b in zip(wire, ref_wire):
        np.testing.assert_array_equal(_np(a), b)
    for k, v in interop.torch_mlp_from_wire(ref_wire).items():
        np.testing.assert_array_equal(_np(v), ref.torch_mlp_from_wire(ref_wire)[k])
    keras_weights = [state["1.weight"].T, state["1.bias"], state["3.weight"].T, state["3.bias"]]
    for a, b in zip(interop.keras_mlp_to_wire(keras_weights), ref.keras_mlp_to_wire(keras_weights)):
        np.testing.assert_array_equal(_np(a), b)
    jk, rk = interop.keras_weights_to_jax_mlp(keras_weights), ref.keras_weights_to_jax_mlp(keras_weights)
    for name in rk["params"]:
        for leaf in ("kernel", "bias"):
            np.testing.assert_array_equal(jk["params"][name][leaf], rk["params"][name][leaf])
    for a, b in zip(interop.jax_mlp_params_to_keras(rk), ref.jax_mlp_params_to_keras(rk)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("canonical", [True, False], ids=["canonical", "native"])
@pytest.mark.parametrize("compression", ["none", "int8", "bf16"])
def test_frames_are_byte_equal_to_the_jax_packages_for_the_same_weights(canonical, compression):
    got = interop.torch_mlp_model(seed=3, hidden_sizes=(32, 16), canonical=canonical, device="cpu")
    want = ref.torch_mlp_model(seed=3, hidden_sizes=(32, 16), canonical=canonical)
    for k, v in want.params.items():  # the same draw from torch.manual_seed(3)
        np.testing.assert_array_equal(_np(got.params[k]), v)
    for m in (got, want):
        m.set_contribution(["mem://t"], 77)
    assert bytes(got.encode_parameters(compression)) == bytes(want.encode_parameters(compression))
    # the JAX package's frame decodes into the port's handle, metadata included
    other = interop.torch_mlp_model(seed=9, hidden_sizes=(32, 16), canonical=canonical, device="cpu")
    other.set_parameters(bytes(want.encode_parameters()))
    assert other.contributors == ["mem://t"] and other.num_samples == 77
    for k, v in want.params.items():
        np.testing.assert_array_equal(_np(other.params[k]), v)
    with pytest.raises(ModelNotMatchingError):
        other.set_parameters([p[:1] for p in other.get_parameters()])


def test_canonical_handles_show_the_flax_layout_native_ones_their_own():
    can = interop.torch_mlp_model(seed=1, hidden_sizes=(8,), canonical=True, device="cpu")
    nat = interop.torch_mlp_model(seed=1, hidden_sizes=(8,), device="cpu")
    assert [tuple(p.shape) for p in can.get_parameters()] == [(8,), (784, 8), (10,), (8, 10)]
    assert [tuple(p.shape) for p in nat.get_parameters()] == [(8,), (8, 784), (10,), (10, 8)]
    copy = can.build_copy(params=[p * 2 for p in can.get_parameters()])
    assert copy.module is not can.module
    for a, b in zip(copy.get_parameters(), can.get_parameters()):
        assert torch.equal(a, 2 * b)
    x = torch.from_numpy(np.random.default_rng(0).random((4, 28, 28), dtype=np.float32))
    assert torch.allclose(can.apply(can.params, x), can.module(x))


def _pair(seed, lr=1e-3, batch=32, callbacks=None, hidden=(32, 16)):
    data_kw = dict(n_train=160, n_test=48)
    got = interop.TorchLearner(interop.torch_mlp_model(seed, hidden, device="cpu"), synthetic_mnist(**data_kw), "t0",
                               lr=lr, batch_size=batch, seed=seed, callbacks=callbacks, device="cpu")
    want = ref.TorchLearner(ref.torch_mlp_model(seed, hidden), ref_mnist(**data_kw), "t0", lr=lr, batch_size=batch,
                            seed=seed, callbacks=callbacks)
    return got, want


def test_interop_fit_matches_the_jax_packages_interop_fit():
    got, want = _pair(5)
    for learner in (got, want):
        learner.set_epochs(2)
    for _ in range(2):  # two fits: the second draws the next batch order
        g, w = got.fit(), want.fit()
        assert g.get_contributors() == w.get_contributors() == ["t0"] and g.num_samples == w.num_samples
        for k, v in w.params.items():
            np.testing.assert_allclose(_np(g.params[k]), v, atol=1e-5, rtol=0)
    gm, wm = got.evaluate(), want.evaluate()
    assert gm["test_acc"] == wm["test_acc"]
    assert abs(gm["test_loss"] - wm["test_loss"]) < 1e-5


def test_interop_scaffold_deltas_match_the_jax_packages():
    got, want = _pair(6, callbacks=["scaffold"])
    g, w = got.fit(), want.fit()
    gi, wi = g.get_info("scaffold"), w.get_info("scaffold")
    for key in ("delta_y_i", "delta_c_i"):
        assert len(gi[key]) == len(wi[key]) == len(w.params)
        for a, b in zip(gi[key], wi[key]):
            np.testing.assert_allclose(_np(a), b, atol=1e-5, rtol=0)
    canonical = interop.TorchLearner(interop.torch_mlp_model(canonical=True, device="cpu"),
                                     synthetic_mnist(n_train=64, n_test=16), callbacks=["scaffold"], device="cpu")
    with pytest.raises(ValueError, match="canonical"):
        canonical.fit()


def test_learner_registry_keeps_the_interop_and_zoo_torch_learners_apart():
    from p2pfl_tpu_torch.models.mlp import mlp_model

    assert LearnerFactory.create_learner(interop.torch_mlp_model(device="cpu")) is interop.TorchLearner
    assert LearnerFactory.create_learner(mlp_model(0, hidden_sizes=(8,), device="cpu")) is ZooLearner
    assert interop.TorchLearner is not ZooLearner
    if interop.KERAS_AVAILABLE:
        assert LearnerFactory._registry["tensorflow"] is interop.KerasLearner


def test_a_user_module_federates_with_the_zoo_mlp_node_over_canonical_frames():
    """A user's ``nn.Sequential`` in a canonical handle, trained by the
    interop learner, and the port's zoo MLP Node: two rounds on both, the
    final canonical parameters within 1e-5 (FedAvg over the same two
    models)."""
    from torch import nn

    from p2pfl_tpu_torch.config import Settings
    from p2pfl_tpu_torch.learning.aggregators import FedAvg
    from p2pfl_tpu_torch.learning.dataset import RandomIIDPartitionStrategy
    from p2pfl_tpu_torch.models.mlp import mlp_model
    from p2pfl_tpu_torch.node import Node

    Settings.RESOURCE_MONITOR_PERIOD = 0
    Settings.HEARTBEAT_TIMEOUT = 30.0  # no node dies here: a write-off could only be a starved beat
    torch.manual_seed(0)
    user = nn.Sequential(nn.Flatten(), nn.Linear(784, 32), nn.ReLU(), nn.Linear(32, 16), nn.ReLU(), nn.Linear(16, 10))
    handle = interop.TorchModelHandle(user, to_wire=interop.torch_mlp_to_wire, from_wire=interop.torch_mlp_from_wire,
                                      device="cpu")
    parts = synthetic_mnist(n_train=256, n_test=64).generate_partitions(2, RandomIIDPartitionStrategy)
    nodes = [Node(mlp_model(0, hidden_sizes=(32, 16), device="cpu"), parts[0], addr="mem://interop-zoo",
                  aggregator=FedAvg(), batch_size=32, device="cpu"),
             Node(handle, parts[1], addr="mem://interop-user", learner=interop.TorchLearner, aggregator=FedAvg(),
                  batch_size=32, device="cpu")]
    try:
        for nd in nodes:
            nd.start()
        nodes[1].connect(nodes[0].addr)
        assert _wait(lambda: all(len(nd.get_neighbors()) == 1 for nd in nodes), timeout=15.0)
        nodes[0].set_start_learning(rounds=2, epochs=1)
        assert _wait(lambda: all(not nd.learning_in_progress() and nd.learning_workflow is not None
                                 for nd in nodes), timeout=90.0)
        for nd in nodes:
            assert nd.learning_workflow.history.count("RoundFinishedStage") == 2, nd.learning_workflow.history
        zoo, mine = (nd.learner.get_model().get_parameters() for nd in nodes)
        for a, b in zip(zoo, mine):
            np.testing.assert_allclose(_np(a), _np(b), atol=1e-5, rtol=0)
        assert isinstance(nodes[1].learner.learner if hasattr(nodes[1].learner, "learner") else nodes[1].learner,
                          interop.TorchLearner)
    finally:
        for nd in nodes:
            nd.stop()


def test_keras_handles_translators_and_fit_match_the_jax_packages():
    pytest.importorskip("keras")
    got = interop.keras_mlp_model(seed=2, hidden_sizes=(16,), canonical=True)
    want = ref.keras_mlp_model(seed=2, hidden_sizes=(16,), canonical=True)
    for a, b in zip(got._native_leaves(), want.params):
        np.testing.assert_array_equal(_np(a), b)
    for m in (got, want):
        m.set_contribution(["mem://k"], 5)
    assert bytes(got.encode_parameters()) == bytes(want.encode_parameters())
    other = interop.keras_mlp_model(seed=4, hidden_sizes=(16,), canonical=True)
    other.set_parameters(bytes(want.encode_parameters()))
    for a, b in zip(other._native_leaves(), want.params):
        np.testing.assert_array_equal(_np(a), b)
    with pytest.raises(ModelNotMatchingError):
        other.set_parameters([p[:1] for p in other.get_parameters()])
    assert LearnerFactory.create_learner(got) is interop.KerasLearner
    data_kw = dict(n_train=96, n_test=32)
    lg = interop.KerasLearner(interop.keras_mlp_model(seed=2, hidden_sizes=(16,)), synthetic_mnist(**data_kw), "k0",
                              batch_size=32, seed=3, device="cpu")
    lw = ref.KerasLearner(ref.keras_mlp_model(seed=2, hidden_sizes=(16,)), ref_mnist(**data_kw), "k0",
                          batch_size=32, seed=3)
    g, w = lg.fit(), lw.fit()
    for a, b in zip(g._native_leaves(), w.params):
        np.testing.assert_allclose(_np(a), b, atol=1e-5, rtol=0)
    assert g.get_contributors() == ["k0"] and abs(lg.evaluate()["test_loss"] - lw.evaluate()["test_loss"]) < 1e-5
    with pytest.raises(ValueError, match="host"):
        interop.KerasLearner(got, synthetic_mnist(**data_kw), device="cuda")


@pytest.mark.parametrize("train,seed,kwargs", [(True, 0, {}), (True, (3, 1, 0), {"drop_remainder": True}),
                                               (False, 7, {})])
def test_export_strategies_equal_the_jax_packages(train, seed, kwargs):
    x = np.random.default_rng(1).random((37, 4, 3), dtype=np.float32)
    y = np.arange(37, dtype=np.int32) % 5
    common = dict(train=train, batch_size=8, seed=seed)
    for a, b in zip(export.NumpyExportStrategy.export(x, y, **common),
                    ref_export.NumpyExportStrategy.export(x, y, **common)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(export.BatchedArraysExportStrategy.export(x, y, **common, **kwargs),
                    ref_export.BatchedArraysExportStrategy.export(x, y, **common, **kwargs)):
        np.testing.assert_array_equal(a, b)
    got = list(export.TorchExportStrategy.export(x, y, **common))
    want = list(ref_export.TorchExportStrategy.export(x, y, **common))
    assert len(got) == len(want) == 5
    for (gx, gy), (wx, wy) in zip(got, want):
        assert torch.equal(gx, wx) and torch.equal(gy, wy) and gy.dtype == torch.int64
    assert issubclass(export.TensorFlowExportStrategy, export.ExportStrategy)


def test_tensorflow_export_equals_the_jax_packages():
    pytest.importorskip("tensorflow")
    x = np.random.default_rng(2).random((21, 3), dtype=np.float32)
    y = np.arange(21, dtype=np.int32) % 3
    for train in (True, False):
        got = list(export.TensorFlowExportStrategy.export(x, y, train=train, batch_size=4, seed=11))
        want = list(ref_export.TensorFlowExportStrategy.export(x, y, train=train, batch_size=4, seed=11))
        assert len(got) == len(want) == 6
        for (gx, gy), (wx, wy) in zip(got, want):
            np.testing.assert_array_equal(np.asarray(gx), np.asarray(wx))
            np.testing.assert_array_equal(np.asarray(gy), np.asarray(wy))
