"""JAX references for ``tests/test_torch_expert_model_ranks.py``, computed
in a process of their own on the virtual 8-device CPU mesh (the settings of
``tests/conftest.py``), so that no JAX work a test left running in a pytest
worker competes with their collectives. Not collected by pytest.

    python tests/torch_expert_model_refs.py <dir>

Reads ``<dir>/init.pt`` (the JAX package's initial weights, as the port's
leaves) and writes ``<dir>/refs.pt``: for W = 2 and 4, ``shard_moe_params``
with the jitted apply and ``jax.grad`` on W devices, the ring MoE LM under
``shard_map``, ``MeshSimulation`` on ``make_mesh((1, W), ("nodes",
"model"))`` (FedAdam, the update-norm clip, Krum, the flash LM round) and
the leaves its ``stacked_spec`` splits, also for the CNN.
"""

import os
import sys

if __name__ == "__main__":  # before JAX loads, as tests/conftest.py sets it up
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()
    os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import optax  # noqa: E402
import torch  # noqa: E402
from jax.sharding import Mesh as JaxMesh  # noqa: E402

import torch_expert_model_worker as worker  # noqa: E402
from p2pfl_tpu.learning.dataset import RandomIIDPartitionStrategy as JaxRandomIID  # noqa: E402
from p2pfl_tpu.learning.dataset import synthetic_mnist as jax_synthetic_mnist  # noqa: E402
from p2pfl_tpu.models.cnn import CNN as JaxCNN  # noqa: E402
from p2pfl_tpu.models.mlp import MLP as JaxMLP  # noqa: E402
from p2pfl_tpu.models.model_handle import ModelHandle as JaxModelHandle  # noqa: E402
from p2pfl_tpu.models.moe import MoETransformerLM as JaxMoE  # noqa: E402
from p2pfl_tpu.models.moe import moe_lm_apply_with_aux as jax_moe_apply_with_aux  # noqa: E402
from p2pfl_tpu.models.moe import shard_moe_params as jax_shard_moe_params  # noqa: E402
from p2pfl_tpu.models.transformer import TransformerLM as JaxTransformerLM  # noqa: E402
from p2pfl_tpu.models.transformer import causal_lm_loss as jax_causal_lm_loss  # noqa: E402
from p2pfl_tpu.ops import aggregation as jax_agg  # noqa: E402
from p2pfl_tpu.parallel.mesh import make_mesh as jax_make_mesh  # noqa: E402
from p2pfl_tpu.parallel.sequence import make_sequence_parallel_train_step as jax_train_step  # noqa: E402
from p2pfl_tpu.parallel.sequence import sequence_parallel_apply as jax_sp_apply  # noqa: E402
from p2pfl_tpu.parallel.simulation import MeshSimulation as JaxMeshSimulation  # noqa: E402
from p2pfl_tpu_torch.models.cnn import CNN  # noqa: E402
from p2pfl_tpu_torch.models.convert import flax_path, flax_to_torch, torch_to_flax  # noqa: E402
from p2pfl_tpu_torch.parallel.tensor_parallel import split_dims  # noqa: E402

WORLDS = (2, 4)
#: The MLP arms held against the JAX package (the others against the one process).
JAX_ARMS = ("fedadam", "clip", "krum")


def _jax_moe_module(kind="blockwise", axis=None):
    return JaxMoE(vocab_size=worker.MOE_VOCAB, num_layers=worker.MOE_LAYERS, num_heads=worker.MOE_HEADS,
                  embed_dim=worker.MOE_EMBED, num_experts=worker.MOE_EXPERTS, attention_kind=kind, axis_name=axis,
                  block_k=16, compute_dtype=jnp.float32)


def _jax_mlp():
    jm = JaxMLP(hidden_sizes=worker.MLP_HIDDEN, out_channels=10, compute_dtype=jnp.float32)
    return jm, jm.init(jax.random.key(0), jnp.zeros((1, 28, 28)))


def _jax_lm():
    return JaxTransformerLM(vocab_size=worker.LM_VOCAB, num_layers=worker.LM_LAYERS, num_heads=worker.LM_HEADS,
                            embed_dim=worker.LM_EMBED, attention_kind="flash", block_k=worker.LM_BLOCK,
                            compute_dtype=jnp.float32)


def _torch(tree):
    return flax_to_torch(tree, device="cpu")


def _jax_moe(world, params):
    """``shard_moe_params`` on W devices, the jitted apply with its aux and
    ``jax.grad`` of loss + 0.01 aux: the first step's logits, aux and
    gradients, then ``worker.STEPS`` Adam steps."""
    apply = jax_moe_apply_with_aux(_jax_moe_module())
    sharded = jax_shard_moe_params(params, JaxMesh(np.array(jax.devices()[:world]), ("expert",)))
    toks = jnp.asarray(worker.moe_tokens())
    tx = optax.adam(worker.LR)

    def loss_fn(p):
        logits, aux = apply(p, toks)
        return jax_causal_lm_loss(logits, toks) + worker.MOE_AUX * aux, (logits, aux)

    @jax.jit
    def step(p, s):
        (loss, (logits, aux)), g = jax.value_and_grad(loss_fn, has_aux=True)(p)
        u, s = tx.update(g, s, p)
        return optax.apply_updates(p, u), s, loss, g, logits, aux

    p, s, losses = sharded, tx.init(sharded), []
    for i in range(worker.STEPS):
        p, s, loss, g, logits, aux = step(p, s)
        losses.append(float(loss))
        if i == 0:
            first = (np.asarray(logits), float(aux), _torch(g))
    return (*first, losses, _torch(p), str(sharded["params"]["block1"]["moe"]["wi"].sharding.spec))


def _jax_moe_seq(world, params):
    """The ring MoE LM under ``shard_map`` on W devices (each shard routes
    its own tokens): logits, then ``worker.STEPS`` train steps."""
    jm = _jax_moe_module("ring", "seq")
    mesh = JaxMesh(np.array(jax.devices()[:world]), ("seq",))
    toks = jnp.asarray(worker.moe_tokens(worker.MOE_RING_SEQ))
    logits = np.asarray(jax.jit(jax_sp_apply(jm.apply, mesh, "seq"))(params, toks))
    tx = optax.adam(worker.LR)
    step = jax_train_step(jm.apply, tx, mesh, "seq")
    p, s, losses = params, tx.init(params), []
    for _ in range(worker.STEPS):
        p, s, loss = step(p, s, toks)
        losses.append(float(loss))
    return logits, losses, _torch(p)


def _model_mesh(world):
    return jax_make_mesh((1, world), ("nodes", "model"), devices=jax.devices()[:world])


def _split_names(jsim):
    """The port names of the leaves ``stacked_spec`` put on ``"model"``."""
    specs = jax.tree_util.tree_flatten_with_path(jsim.params_stack)[0]
    out = set()
    for path, leaf in specs:
        keys = tuple(getattr(k, "key", str(k)) for k in path)[1:]  # drop "params"
        if tuple(leaf.sharding.spec)[-1:] == ("model",):
            out.add(next(n for n in _port_names(jsim) if flax_path(n)[0] == keys))
    return out


def _port_names(jsim):
    return list(_torch(jax.tree.map(lambda a: np.asarray(a[0]), jsim.params_stack)))


def _jax_sim(world, handle, data, test, kwargs, sched, task="classification"):
    """``MeshSimulation`` on ``make_mesh((1, W), ("nodes", "model"))``: test
    loss and accuracy per round, node 0's parameters and the split leaves."""
    batch = worker.SAMPLES if task == "classification" else worker.LM_SEQS
    jsim = JaxMeshSimulation(handle, data, test_data=test, train_set_size=len(sched[0]), batch_size=batch,
                             lr=worker.LR, seed=0, mesh=_model_mesh(world), task=task, **kwargs)
    split = _split_names(jsim)
    res = jsim.run(rounds=len(sched), epochs=1, warmup=False, committee_schedule=np.asarray(sched))
    node0 = _torch(jax.tree.map(lambda a: np.asarray(a[0]), jsim.params_stack))
    return res.test_loss, res.test_acc, node0, split


def _jax_sims(world, init):
    jm, _ = _jax_mlp()
    handle = JaxModelHandle(params=init["mlp"], apply_fn=jm.apply, model_def=jm)
    parts = jax_synthetic_mnist(n_train=worker.SAMPLES * worker.NODES, n_test=64).generate_partitions(
        worker.NODES, JaxRandomIID)
    arm_kwargs = {"fedadam": {"server_optimizer": "fedadam", "server_lr": worker.FEDADAM_LR},
                  "clip": {"clip_update_norm": worker.CLIP},
                  "krum": {"byzantine_mask": worker.MLP_ARMS["krum"][0]["byzantine_mask"],
                           "aggregate_fn": lambda s, w: jax_agg.krum(s, w, 0)[0]}}
    out = {arm: _jax_sim(world, handle, parts, None, arm_kwargs[arm], worker.MLP_ARMS[arm][2]) for arm in JAX_ARMS}
    lm = _jax_lm()
    x, y, mask, xt = worker.lm_data()
    out["lm"] = _jax_sim(world, JaxModelHandle(params=init["lm"], apply_fn=lm.apply, model_def=lm), (x, y, mask),
                         (xt, None), {"optimizer": optax.adam(worker.LR, eps=worker.LM_ADAM_EPS)}, worker.SCHED,
                         task="lm")
    return out


def _cnn_split(world):
    """The CNN (8 x 8 inputs): the leaves ``stacked_spec`` splits, from a JAX
    ``MeshSimulation`` built on ``(1, W)``, and the port's rule."""
    jm = JaxCNN(compute_dtype=jnp.float32)
    params = jm.init(jax.random.key(0), jnp.zeros((1, 8, 8, 1)))
    data = (np.zeros((4, 2, 8, 8, 1), np.float32), np.zeros((4, 2), np.int32), np.ones((4, 2), np.float32))
    jsim = JaxMeshSimulation(JaxModelHandle(params=params, apply_fn=jm.apply, model_def=jm), data,
                             test_data=(data[0][0], data[1][0]), train_set_size=2, batch_size=2, seed=0,
                             mesh=_model_mesh(world))
    with torch.device("meta"):
        module = CNN(1, (8, 8), 10, torch.float32)
    return _split_names(jsim), split_dims({k: v.shape for k, v in module.named_parameters()}, world)


def main(out_dir: str) -> int:
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_compilation_cache_dir", os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                                                ".jax_cache"))
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 2.0)
    init = {k: torch_to_flax(v) for k, v in torch.load(os.path.join(out_dir, "init.pt")).items()}
    refs = {}
    for world in WORLDS:
        refs["moe", world] = _jax_moe(world, init["moe"])
        refs["moe_seq", world] = _jax_moe_seq(world, init["moe"])
        refs["sims", world] = _jax_sims(world, init)
        refs["cnn_split", world] = _cnn_split(world)
    torch.save(refs, os.path.join(out_dir, "refs.pt"))
    print("REFS_DONE", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1]))
