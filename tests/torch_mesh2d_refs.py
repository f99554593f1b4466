"""JAX references for ``tests/test_torch_mesh2d_ranks.py``, computed in a
process of their own on the virtual 8-device CPU mesh (the settings of
``tests/conftest.py``), as ``tests/torch_expert_model_refs.py`` does. Not
collected by pytest.

    python tests/torch_mesh2d_refs.py <dir>

Reads ``<dir>/init.pt`` (the JAX package's initial weights, as the port's
leaves) and writes ``<dir>/refs.pt``: ``MeshSimulation`` on
``make_mesh((2, 2), ("nodes", "model"))`` (the f32 MLP with FedAdam, the
flash LM round: test losses and node 0's parameters), and the ring and
ring_flash LMs on a ``("batch", "seq")`` mesh of 2 x 2 devices with
``batch_axis="batch"`` (logits, loss, ``STEPS`` train steps; the Pallas
kernels interpreted).
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

import torch_mesh2d_worker as worker  # noqa: E402
from p2pfl_tpu.learning.dataset import RandomIIDPartitionStrategy as JaxRandomIID  # noqa: E402
from p2pfl_tpu.learning.dataset import synthetic_mnist as jax_synthetic_mnist  # noqa: E402
from p2pfl_tpu.models.mlp import MLP as JaxMLP  # noqa: E402
from p2pfl_tpu.models.model_handle import ModelHandle as JaxModelHandle  # noqa: E402
from p2pfl_tpu.models.transformer import TransformerLM as JaxTransformerLM  # noqa: E402
from p2pfl_tpu.parallel.mesh import make_mesh as jax_make_mesh  # noqa: E402
from p2pfl_tpu.parallel.sequence import make_sequence_parallel_train_step as jax_train_step  # noqa: E402
from p2pfl_tpu.parallel.sequence import sequence_parallel_apply as jax_sp_apply  # noqa: E402
from p2pfl_tpu.parallel.sequence import sequence_parallel_lm_loss as jax_sp_loss  # noqa: E402
from p2pfl_tpu.parallel.simulation import MeshSimulation as JaxMeshSimulation  # noqa: E402
from p2pfl_tpu_torch.models.convert import flax_to_torch, torch_to_flax  # noqa: E402


def jax_mlp():
    return JaxMLP(hidden_sizes=worker.MLP_HIDDEN, out_channels=10, compute_dtype=jnp.float32)


def jax_lm():
    return JaxTransformerLM(vocab_size=worker.LM_VOCAB, num_layers=worker.LM_LAYERS, num_heads=worker.LM_HEADS,
                            embed_dim=worker.LM_EMBED, attention_kind="flash", block_k=worker.LM_BLOCK,
                            compute_dtype=jnp.float32)


def jax_seq_lm(kind):
    return JaxTransformerLM(vocab_size=worker.SEQ_VOCAB, num_layers=worker.SEQ_LAYERS, num_heads=worker.SEQ_HEADS,
                            embed_dim=worker.SEQ_EMBED, attention_kind=kind, axis_name="seq",
                            block_k=worker.SEQ_BLOCK, compute_dtype=jnp.float32)


def _torch(tree):
    return flax_to_torch(tree, device="cpu")


def _sims(init):
    """``MeshSimulation`` on 2 x 2 ``nodes`` x ``model`` devices: each arm's
    test losses and node 0's parameters after the scheduled rounds."""
    mesh = jax_make_mesh((2, 2), ("nodes", "model"), devices=jax.devices()[:4])
    jm = jax_mlp()
    parts = jax_synthetic_mnist(n_train=worker.SAMPLES * worker.NODES, n_test=64).generate_partitions(
        worker.NODES, JaxRandomIID)
    lm = jax_lm()
    x, y, mask, xt = worker.lm_data()
    arms = {
        "mlp": (JaxModelHandle(params=init["mlp"], apply_fn=jm.apply, model_def=jm), parts, None,
                dict(batch_size=worker.SAMPLES, lr=worker.LR, optimizer=optax.sgd(worker.LR),
                     server_optimizer="fedadam", server_lr=worker.FEDADAM_LR)),
        "lm": (JaxModelHandle(params=init["lm"], apply_fn=lm.apply, model_def=lm), (x, y, mask), (xt, None),
               dict(batch_size=worker.LM_SEQS, lr=worker.LM_LR, task="lm",
                    optimizer=optax.adam(worker.LM_LR, eps=worker.LM_ADAM_EPS))),
    }
    out = {}
    for arm, (handle, data, test, kw) in arms.items():
        jsim = JaxMeshSimulation(handle, data, test_data=test, train_set_size=len(worker.SCHED[0]), seed=0,
                                 mesh=mesh, **kw)
        res = jsim.run(rounds=len(worker.SCHED), epochs=1, warmup=False,
                       committee_schedule=np.asarray(worker.SCHED))
        out[arm] = (res.test_loss, _torch(jax.tree.map(lambda a: np.asarray(a[0]), jsim.params_stack)))
    return out


def _seq(init):
    """The ring LMs with ``batch_axis="batch"`` on 2 x 2 ``batch`` x ``seq``
    devices: global logits and loss on the initial weights, then ``STEPS``
    Adam steps."""
    mesh = JaxMesh(np.array(jax.devices()[:4]).reshape(2, 2), ("batch", "seq"))
    toks = jnp.asarray(worker.seq_tokens())
    out = {}
    for kind in ("ring", "ring_flash"):
        jm = jax_seq_lm(kind)
        logits = np.asarray(jax.jit(jax_sp_apply(jm.apply, mesh, "seq", "batch"))(init["seq"], toks))
        loss = float(jax.jit(jax_sp_loss(jm.apply, mesh, "seq", "batch"))(init["seq"], toks))
        tx = optax.adam(worker.LM_LR)
        step = jax_train_step(jm.apply, tx, mesh, "seq", "batch")
        p, s, losses = init["seq"], tx.init(init["seq"]), []
        for _ in range(worker.STEPS):
            p, s, l = step(p, s, toks)
            losses.append(float(l))
        out[kind] = (logits, loss, losses, _torch(p))
    return out


def main(out_dir: str) -> int:
    jax.config.update("jax_platforms", "cpu")
    init = {k: torch_to_flax(v) for k, v in torch.load(os.path.join(out_dir, "init.pt")).items()}
    refs = {"sims": _sims(init), "seq": _seq(init)}
    torch.save(refs, os.path.join(out_dir, "refs.pt"))
    print("REFS_DONE", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1]))
