"""The port's federated LM round against the JAX package's MeshSimulation.

The whole slice: 4 nodes, committee 2, 2 rounds, f32 compute, Adam lr 1e-3,
flash attention (Pallas in interpret mode on the JAX side, the plain
versions on the port's). JAX threefry keys and torch generators give
different streams, so both sides get the same ``committee_schedule`` and a
batch equal to the sequences per node: the shuffle then only reorders the
rows of one batch whose loss is a mean. The JAX side runs on a one-device
mesh so it pads no filler nodes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from p2pfl_tpu.models.model_handle import ModelHandle as JaxModelHandle
from p2pfl_tpu.models.transformer import TransformerLM as JaxTransformerLM
from p2pfl_tpu.ops.aggregation import fedavg as jax_fedavg
from p2pfl_tpu.parallel.mesh import make_mesh
from p2pfl_tpu.parallel.simulation import MeshSimulation as JaxMeshSimulation
from p2pfl_tpu_torch.models.convert import flax_to_torch, torch_to_flax
from p2pfl_tpu_torch.models.model_handle import ModelHandle
from p2pfl_tpu_torch.models.transformer import TransformerLM
from p2pfl_tpu_torch.ops.aggregation import fedavg
from p2pfl_tpu_torch.parallel.simulation import MeshSimulation, _generator, vote_committee

NODES, COMMITTEE, SEQS, SEQ, VOCAB = 4, 2, 4, 32, 64
LAYERS, HEADS, EMBED = 2, 2, 32
ROUNDS, LR = 2, 1e-3


def _data(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.integers(0, VOCAB, size=(NODES, SEQS, SEQ)).astype(np.int32)
    y = np.zeros((NODES, SEQS), np.int32)
    mask = np.ones((NODES, SEQS), np.float32)
    mask[3, -1] = 0.0  # one padded sequence: FedAvg weights differ across nodes
    xt = rng.integers(0, VOCAB, size=(4, SEQ)).astype(np.int32)
    return x, y, mask, xt


def test_lm_round_matches_jax_mesh_simulation():
    x, y, mask, xt = _data()
    sched = np.array([[0, 2], [1, 2]], np.int32)  # node 2 trains twice: Adam count 2
    module = JaxTransformerLM(
        vocab_size=VOCAB, num_layers=LAYERS, num_heads=HEADS, embed_dim=EMBED,
        attention_kind="flash", compute_dtype=jnp.float32,
    )
    params = module.init(jax.random.key(0), jnp.zeros((1, SEQ), jnp.int32))
    jsim = JaxMeshSimulation(
        JaxModelHandle(params=params, apply_fn=module.apply, model_def=module),
        (x, y, mask), test_data=(xt, None), train_set_size=COMMITTEE, batch_size=SEQS,
        lr=LR, seed=0, task="lm", mesh=make_mesh(devices=jax.devices()[:1]),
    )
    ref = jsim.run(rounds=ROUNDS, epochs=1, warmup=False, committee_schedule=sched)
    ref_node0 = jax.tree.map(lambda a: np.asarray(a[0]), jsim.params_stack)

    with torch.device("meta"):
        port_module = TransformerLM(
            vocab_size=VOCAB, num_layers=LAYERS, num_heads=HEADS, embed_dim=EMBED,
            attention_kind="flash", compute_dtype=torch.float32,
        )
    sim = MeshSimulation(
        ModelHandle(flax_to_torch(params, device="cpu"), port_module),
        (x, y, mask), test_data=(xt, None), train_set_size=COMMITTEE, batch_size=SEQS,
        lr=LR, seed=0, task="lm", device="cpu",
    )
    res = sim.run(rounds=ROUNDS, epochs=1, warmup=True, committee_schedule=sched)

    np.testing.assert_array_equal(res.committees, sched)
    # Both sides compute in f32 and differ only in the order of their sums.
    # Measured on the CPU: test loss within 9.5e-7 and node 0's params within
    # 8.3e-7 after 2 rounds; the bounds below leave ~10x room. No Adam sign
    # flip shows at this size: Adam divides by sqrt(nu) + 1e-8, so a gradient
    # element of ~1e-7 (f32 noise on a sum near 0) could move its weight by
    # ~lr either way, and a 2e-3 gap in one weight would be that, not a bug.
    np.testing.assert_allclose(res.test_loss, ref.test_loss, atol=1e-5)
    np.testing.assert_allclose(res.test_acc, ref.test_acc, atol=1e-6)
    got = torch_to_flax({k: v[0] for k, v in sim.params_stack.items()})
    diffs = jax.tree.map(lambda a, b: float(np.max(np.abs(a - b))), got, ref_node0)
    assert max(jax.tree.leaves(diffs)) < 1e-5, diffs
    # Only committee members carry Adam state: node 3 never trained.
    assert sim.opt_stack.count.tolist() == [1, 1, 2, 0]


def test_vote_committee_distinct_in_range_and_seeded():
    for n, k in ((8, 4), (5, 5), (100, 7)):
        a = vote_committee(_generator(7, 0, 0), n, k)
        b = vote_committee(_generator(7, 0, 0), n, k)
        assert torch.equal(a, b)
        assert a.shape == (k,)
        assert len(set(a.tolist())) == k
        assert 0 <= int(a.min()) and int(a.max()) < n
    picks = {tuple(vote_committee(_generator(7, r, 0), 16, 4).tolist()) for r in range(8)}
    assert len(picks) > 1
    with pytest.raises(ValueError):
        vote_committee(_generator(0), 4, 5)


def test_fedavg_matches_jax():
    rng = np.random.default_rng(4)
    stacked = {"a": rng.standard_normal((3, 5, 2)).astype(np.float32),
               "b": rng.standard_normal((3, 7)).astype(np.float32)}
    w = np.array([3.0, 1.0, 0.0], np.float32)
    ref = jax_fedavg(stacked, jnp.asarray(w))
    out = fedavg({k: torch.from_numpy(v) for k, v in stacked.items()}, torch.from_numpy(w))
    for k in stacked:
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]), atol=1e-6)
    bf = fedavg({"a": torch.from_numpy(stacked["a"]).bfloat16()}, torch.from_numpy(w))
    assert bf["a"].dtype == torch.bfloat16


def test_simulation_rejects_bad_inputs():
    x, y, mask, xt = _data()
    with torch.device("meta"):
        module = TransformerLM(vocab_size=VOCAB, num_layers=1, num_heads=HEADS, embed_dim=EMBED)
    from p2pfl_tpu_torch.models.transformer import init_params

    handle = ModelHandle(init_params(module, 0, "cpu"), module)
    with pytest.raises(ValueError, match="task"):
        MeshSimulation(handle, (x, y, mask), task="classification", device="cpu")
    sim = MeshSimulation(handle, (x, y, mask), test_data=(xt, None), train_set_size=2,
                         batch_size=SEQS, device="cpu", seed=1)
    with pytest.raises(ValueError, match="committee_schedule"):
        sim.run(rounds=1, committee_schedule=np.array([[0, NODES]]))
    with pytest.raises(ValueError, match="committee_schedule"):
        sim.run(rounds=2, committee_schedule=np.array([[0, 1]]))
