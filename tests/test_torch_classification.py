"""The port's federated classification round against the JAX package's
MeshSimulation(task="classification").

Both sides build their models with f32 compute from the same flax weights
(carried across with ``models/convert.py``), read the same partitions (the
port's ``synthetic_mnist`` and partition strategies equal the JAX package's,
tests/test_torch_data.py) and take the same ``committee_schedule``. JAX
threefry keys and torch generators give different streams, so the batch is
all of a node's samples: a shuffle then only reorders the rows of one batch
whose loss is a mean. The JAX side runs on a one-device mesh so it pads no
filler nodes. Test loss and accuracy per round and node 0's parameters
must agree within 1e-5 (both sides are f32 and differ only in the order of
their sums).

``run_pair`` and ``assert_matches`` are shared with the option tests
(tests/test_torch_sim_options.py, tests/test_torch_sim_robust.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from p2pfl_tpu.learning.dataset import RandomIIDPartitionStrategy as JaxRandomIID
from p2pfl_tpu.learning.dataset import synthetic_mnist as jax_synthetic_mnist
from p2pfl_tpu.models.mlp import MLP as JaxMLP
from p2pfl_tpu.models.model_handle import ModelHandle as JaxModelHandle
from p2pfl_tpu.models.transformer import TransformerClassifier as JaxTransformerClassifier
from p2pfl_tpu.parallel.mesh import make_mesh
from p2pfl_tpu.parallel.simulation import MeshSimulation as JaxMeshSimulation
from p2pfl_tpu_torch.learning.dataset import RandomIIDPartitionStrategy, synthetic_mnist
from p2pfl_tpu_torch.models.convert import flax_to_torch, torch_to_flax
from p2pfl_tpu_torch.models.mlp import MLP, mlp_model
from p2pfl_tpu_torch.models.model_handle import ModelHandle
from p2pfl_tpu_torch.models.transformer import TransformerClassifier
from p2pfl_tpu_torch.parallel.simulation import MeshSimulation, SimulationResult

NODES, SAMPLES, LR = 4, 32, 1e-3
SCHED = np.array([[0, 2], [1, 2]], np.int32)  # node 2 trains twice


def mlp_handles(seed=0):
    """The JAX and port handles of one f32 MLP (hidden (16, 8))."""
    jm = JaxMLP(hidden_sizes=(16, 8), out_channels=10, compute_dtype=jnp.float32)
    params = jm.init(jax.random.key(seed), jnp.zeros((1, 28, 28)))
    with torch.device("meta"):
        pm = MLP(784, (16, 8), 10, torch.float32)
    return (JaxModelHandle(params=params, apply_fn=jm.apply, model_def=jm),
            ModelHandle(flax_to_torch(params, device="cpu"), pm))


def mnist_partitions(nodes=NODES):
    """The same ``SAMPLES``-per-node IID partitions from both packages."""
    kw = dict(n_train=SAMPLES * nodes, n_test=64)
    return (jax_synthetic_mnist(**kw).generate_partitions(nodes, JaxRandomIID),
            synthetic_mnist(**kw).generate_partitions(nodes, RandomIIDPartitionStrategy))


def run_pair(sched, *, nodes=NODES, handles=None, partitions=None, batch_size=SAMPLES, common=None,
             jax_kwargs=None, port_kwargs=None, run_kwargs=None):
    """Run both simulations on ``sched``; returns ``(jax_sim, jax_result,
    port_sim, port_result)``. ``common`` goes to both constructors,
    ``jax_kwargs`` / ``port_kwargs`` to one side each (callables such as
    ``aggregate_fn``), ``run_kwargs`` to both ``run`` calls."""
    jh, ph = handles or mlp_handles()
    jp, pp = partitions or mnist_partitions(nodes)
    kw = dict(train_set_size=sched.shape[1], batch_size=batch_size, lr=LR, seed=0, **(common or {}))
    run_kw = dict(rounds=len(sched), warmup=False, committee_schedule=sched, **(run_kwargs or {}))
    jsim = JaxMeshSimulation(jh, jp, mesh=make_mesh(devices=jax.devices()[:1]), **kw, **(jax_kwargs or {}))
    ref = jsim.run(**run_kw)
    sim = MeshSimulation(ph, pp, device="cpu", **kw, **(port_kwargs or {}))
    res = sim.run(**run_kw)
    return jsim, ref, sim, res


def node_params(jsim, sim, node=0):
    """Node ``node``'s parameters from both sides, as flax trees of numpy."""
    got = torch_to_flax({k: v[node] for k, v in sim.params_stack.items()})
    want = jax.tree.map(lambda a: np.asarray(a[node]), jsim.params_stack)
    return got, want


def assert_matches(jsim, ref, sim, res, atol=1e-5):
    np.testing.assert_array_equal(res.committees, np.asarray(ref.committees))
    assert len(res.test_loss) == len(ref.test_loss)
    np.testing.assert_allclose(res.test_loss, ref.test_loss, atol=atol)
    np.testing.assert_allclose(res.test_acc, ref.test_acc, atol=atol)
    got, want = node_params(jsim, sim)
    diffs = jax.tree.map(lambda a, b: float(np.max(np.abs(a - b))), got, want)
    assert max(jax.tree.leaves(diffs)) < atol, diffs


def test_mlp_classification_round_matches_jax():
    jsim, ref, sim, res = run_pair(SCHED)
    assert_matches(jsim, ref, sim, res)
    assert all(np.isfinite(res.test_loss)) and len(res.test_acc) == 2
    # Only committee members carry Adam state; diffusion gives every node
    # the aggregate.
    assert sim.opt_stack.count.tolist() == [1, 1, 2, 0] == np.asarray(jsim.opt_stack[0].count).tolist()
    first = {k: v[0] for k, v in sim.params_stack.items()}
    assert all(torch.equal(v[i], first[k]) for k, v in sim.params_stack.items() for i in range(NODES))


def test_mlp_classification_warmup_changes_nothing():
    _, ph = mlp_handles()
    _, pp = mnist_partitions()
    out = []
    for warmup in (False, True):
        sim = MeshSimulation(ph, pp, train_set_size=2, batch_size=SAMPLES, lr=LR, seed=0, device="cpu")
        out.append((sim.run(rounds=2, warmup=warmup, committee_schedule=SCHED), sim))
    (a, sa), (b, sb) = out
    assert a.test_loss == b.test_loss and a.test_acc == b.test_acc
    assert all(torch.equal(sa.params_stack[k], sb.params_stack[k]) for k in sa.params_stack)


def _token_data(nodes, per_node, seq, vocab, classes, seed=0):
    """Label-dependent tokens: class c draws its tokens from a band of the
    vocabulary, so the classifier has something to learn."""
    rng = np.random.default_rng(seed)
    y = rng.integers(0, classes, size=(nodes, per_node)).astype(np.int32)
    band = vocab // classes
    x = (y[..., None] * band + rng.integers(0, band, size=(nodes, per_node, seq))).astype(np.int32)
    yt = rng.integers(0, classes, size=8).astype(np.int32)
    xt = (yt[:, None] * band + rng.integers(0, band, size=(8, seq))).astype(np.int32)
    return (x, y, np.ones((nodes, per_node), np.float32)), (xt, yt)


def test_flash_classifier_round_matches_jax():
    seq, vocab, classes, per_node = 32, 32, 4, 4
    jm = JaxTransformerClassifier(num_classes=classes, vocab_size=vocab, num_layers=1, num_heads=2,
                                  embed_dim=64, attention_kind="flash", block_k=16,
                                  compute_dtype=jnp.float32)  # head size 32
    params = jm.init(jax.random.key(2), jnp.zeros((1, seq), jnp.int32))
    with torch.device("meta"):
        pm = TransformerClassifier(num_classes=classes, vocab_size=vocab, num_layers=1, num_heads=2,
                                   embed_dim=64, attention_kind="flash", compute_dtype=torch.float32,
                                   block_k=16)
    train, test = _token_data(NODES, per_node, seq, vocab, classes)
    handles = (JaxModelHandle(params=params, apply_fn=jm.apply, model_def=jm),
               ModelHandle(flax_to_torch(params, device="cpu"), pm))
    jsim, ref, sim, res = run_pair(SCHED[:1], handles=handles, partitions=(train, train),
                                   batch_size=per_node, common=dict(test_data=test))
    assert_matches(jsim, ref, sim, res)


def test_default_classification_run_votes_and_reports():
    parts = synthetic_mnist(n_train=256, n_test=64).generate_partitions(8, RandomIIDPartitionStrategy)
    sim = MeshSimulation(mlp_model(seed=0, hidden_sizes=(16, 8), device="cpu"), parts, batch_size=16,
                         seed=3, device="cpu")
    assert sim.task == "classification" and sim.train_set_size == 4  # Settings.TRAIN_SET_SIZE
    res = sim.run(rounds=3, epochs=1)
    assert isinstance(res, SimulationResult) and res.committees.shape == (3, 4)
    assert all(len(set(row)) == 4 for row in res.committees.tolist())
    assert len(res.test_acc) == 3 and all(np.isfinite(res.test_loss))
    summary = res.summary()
    assert summary["rounds"] == 3 and summary["final_test_acc"] == res.test_acc[-1]
    model = sim.final_model(5)
    assert all(torch.equal(model.params[k], sim.params_stack[k][5]) for k in model.params)
    assert set(sim.state_dict()) == {"params_stack", "opt_stack"}
    again = MeshSimulation(mlp_model(seed=0, hidden_sizes=(16, 8), device="cpu"), parts, batch_size=16,
                           seed=3, device="cpu").run(rounds=3, epochs=1)
    np.testing.assert_array_equal(again.committees, res.committees)  # seeded votes
    assert again.test_loss == res.test_loss
    sim.close()
    with pytest.raises(RuntimeError, match="closed"):
        sim.run(rounds=1)


def test_classification_test_labels_are_required():
    _, ph = mlp_handles()
    x = np.zeros((2, 4, 28, 28), np.float32)
    y = np.zeros((2, 4), np.int32)
    m = np.ones((2, 4), np.float32)
    with pytest.raises(ValueError, match="labels are required"):
        MeshSimulation(ph, (x, y, m), test_data=(x[0], None), device="cpu")
