"""Worker for ``tests/test_torch_multirank.py``: one rank of a gloo world on
the CPU, started by :func:`p2pfl_tpu_torch.parallel.launch.launch` (not
collected by pytest). It imports only the port, never JAX.

    python tests/torch_multirank_worker.py <dir>

Each rank joins through ``initialize_multihost(coordinator, W, rank,
device="cpu")`` and runs, in order:

* ``mlp`` (W = 2 only): the counterpart of ``tests/multihost_worker.py``:
  the MLP ``MeshSimulation`` over ``synthetic_mnist(512, 128)``, 8 IID
  partitions, committee 4, batch 32, seed 1, one round; prints
  ``MULTIRANK_OK rank=<r> acc=<acc>``;
* ``collectives``: ``all_gather`` of mixed dtypes with a different row count
  on every rank (none on the last), ``broadcast_tree``, ``broadcast`` and
  ``all_reduce``, and ``make_shard_and_gather_fns`` over the rank mesh;
* ``refusals``: what a rank mesh does not run yet raises
  ``NotImplementedError`` naming its ROADMAP item, and a ``seq``,
  ``stage``, ``expert`` or ``model`` axis alone over the ranks builds, and
  so do both population engines and a population's sharded checkpoint
  (into a root every rank shares);
* every arm of :data:`ARMS`: the small f32 flash LM from ``<dir>/init.pt``
  for two scheduled rounds.

Rank r saves what it saw to ``<dir>/w<W>_r<r>.pt``. The test module imports
:data:`ARMS`, :func:`arm_data` and :func:`run_arm` to run the same arms in
one process.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch

NODES, SEQS, SEQ, VOCAB = 8, 4, 64, 128
LAYERS, HEADS, EMBED = 2, 2, 64
ROUNDS, LR = 2, 1e-3

#: name -> (logical nodes, committee schedule, MeshSimulation keywords). The
#: schedules put members on several ranks in round 0 (out of rank order) and
#: on fewer in round 1; "fillers" pads 6 nodes to 8 over four ranks. Local
#: training is SGD at ``lr`` (``"sgd": True``; each package's own): Adam's
#: first step divides a gradient by its own magnitude, so on the near-zero
#: gradients of this model it turns the two packages' f32 summation orders
#: into gaps above the 1e-5 bar (4.6e-5 in one weight, the same on one
#: JAX device as on eight).
ARMS = {
    "robust": (NODES, [[5, 0, 6, 2], [1, 3, 0, 2]],
               dict(sgd=True, lr=0.05, byzantine_mask=np.eye(NODES, dtype=np.float32)[1],
                    byzantine_attack="signflip", clip_update_norm=0.5, server_optimizer="fedadam", server_lr=1e-2)),
    "scaffold": (NODES, [[5, 0, 6, 2], [1, 3, 0, 2]], dict(algorithm="scaffold", lr=0.05)),
    "fillers": (6, [[4, 1, 3], [0, 2, 5]], dict(sgd=True, lr=0.05)),
}


def arm_data(nodes: int, seed: int = 0):
    """Seeded tokens ``[nodes, SEQS, SEQ]``, labels, masks (node 3's last
    sequence padded, so the FedAvg weights differ) and test tokens."""
    rng = np.random.default_rng(seed)
    x = rng.integers(0, VOCAB, size=(nodes, SEQS, SEQ)).astype(np.int32)
    y = np.zeros((nodes, SEQS), np.int32)
    mask = np.ones((nodes, SEQS), np.float32)
    mask[3, -1] = 0.0
    xt = rng.integers(0, VOCAB, size=(4, SEQ)).astype(np.int32)
    return x, y, mask, xt


def run_arm(name: str, init: dict, mesh=None) -> dict:
    """One arm on ``mesh`` (None: one process), on the CPU: node 0's final
    parameters, the whole population state (gathered over ranks), the test
    losses and the per-round members per rank and gathered bytes."""
    from p2pfl_tpu_torch.models.model_handle import ModelHandle
    from p2pfl_tpu_torch.models.transformer import TransformerLM
    from p2pfl_tpu_torch.optim import sgd
    from p2pfl_tpu_torch.parallel.simulation import MeshSimulation

    nodes, sched, kw = ARMS[name]
    x, y, mask, xt = arm_data(nodes)
    kw = {"lr": LR, **kw}
    if kw.pop("sgd", False):
        kw["optimizer"] = sgd(kw["lr"])
    with torch.device("meta"):
        module = TransformerLM(vocab_size=VOCAB, num_layers=LAYERS, num_heads=HEADS, embed_dim=EMBED,
                               attention_kind="flash", compute_dtype=torch.float32)
    sim = MeshSimulation(ModelHandle({k: v.clone() for k, v in init.items()}, module), (x, y, mask),
                         test_data=(xt, None), train_set_size=len(sched[0]), batch_size=SEQS, seed=0, task="lm",
                         mesh=mesh, device="cpu", **kw)
    res = sim.run(rounds=ROUNDS, epochs=1, warmup=True, committee_schedule=np.asarray(sched))
    state = sim.state_dict()
    return {
        "final": sim.final_model(0).params,
        "params_stack": {k: v[:nodes] for k, v in state["params_stack"].items()},
        "test_loss": res.test_loss,
        "committees": res.committees,
        "rank_members": sim.rank_members,
        "gather_bytes": sim.gather_bytes,
    }


def _mlp(mesh) -> float:
    from p2pfl_tpu_torch.learning.dataset import RandomIIDPartitionStrategy, synthetic_mnist
    from p2pfl_tpu_torch.models.mlp import mlp_model
    from p2pfl_tpu_torch.parallel.simulation import MeshSimulation

    parts = synthetic_mnist(n_train=512, n_test=128).generate_partitions(8, RandomIIDPartitionStrategy)
    sim = MeshSimulation(mlp_model(seed=0, device="cpu"), parts, train_set_size=4, batch_size=32, seed=1,
                         mesh=mesh, device="cpu")
    return sim.run(rounds=1, epochs=1, warmup=False).test_acc[-1]


def _collectives(mesh) -> dict:
    from p2pfl_tpu_torch.parallel import collectives
    from p2pfl_tpu_torch.parallel.mesh import PartitionSpec
    from p2pfl_tpu_torch.population.sharding import make_shard_and_gather_fns

    rank, world = mesh.rank, mesh.world
    n = world - 1 - rank  # rows this rank brings: world-1, ..., 0
    tree = {
        "f32": torch.arange(n * 6, dtype=torch.float32).reshape(n, 2, 3) + 100 * rank,
        "bf16": torch.full((n, 5), rank + 0.5, dtype=torch.bfloat16),
        "i64": torch.arange(n, dtype=torch.int64) + 1000 * rank,
        "bool": torch.full((n, 3), rank % 2 == 0),
    }
    gathered = collectives.all_gather(tree, [world - 1 - r for r in range(world)])
    src = world - 1
    bcast = collectives.broadcast_tree({"w": torch.full((3, 2), float(rank)), "c": torch.tensor(rank)}, src=src)
    summed = collectives.all_reduce(torch.tensor([float(rank + 1)]))
    top = collectives.all_reduce(torch.tensor([rank]), op="max")
    one = collectives.broadcast(torch.tensor([rank * 7]), src=src)
    shard, gather = make_shard_and_gather_fns({"pop": PartitionSpec("nodes"), "rep": PartitionSpec()}, mesh)
    population = np.arange(world * 2 * 3, dtype=np.float32).reshape(world * 2, 3)
    slab = shard["pop"](population)
    sharding = {"slab": slab, "whole": gather["pop"](slab), "replicated": gather["rep"](shard["rep"](population))}
    return {"gathered": gathered, "bcast": bcast, "sum": summed, "max": top, "one": one, "sharding": sharding}


def _refusals(mesh, init: dict) -> dict:
    """Each refusal's message, or None where nothing raised."""
    from p2pfl_tpu_torch.management.checkpoint import FLCheckpointer
    from p2pfl_tpu_torch.parallel.mesh import Mesh
    from p2pfl_tpu_torch.population import AsyncPopulationEngine, PopulationEngine

    world = mesh.world
    got = {}

    def note(key, fn):
        try:
            fn()
            got[key] = None
        except NotImplementedError as e:
            got[key] = str(e)

    for axes, key in (({"nodes": world, "model": 2}, "model"), ({"seq": world, "expert": 2}, "expert"),
                      ({"nodes": world, "seq": 2}, "nodes_seq"), ({"nodes": world, "stage": 2}, "nodes_stage"),
                      ({"batch": 2, "seq": world // 2}, "batch_seq"), ({"batch": world}, "batch"),
                      ({"seq": world}, "seq"), ({"stage": world, "model": 1}, "stage"),
                      ({"expert": world}, "expert_ranks"), ({"nodes": 1, "model": world}, "model_ranks")):
        note(key, lambda axes=axes: Mesh(axes, device="cpu", group=mesh.group))
    from p2pfl_tpu_torch.models.moe import moe_lm_model
    from p2pfl_tpu_torch.parallel.sequence import sequence_parallel_apply

    moe = moe_lm_model(0, 8, 16, 2, 2, 16, 2, "ring", "seq", device="cpu")
    seq = Mesh({"seq": world}, device="cpu", group=mesh.group)
    note("moe_seq", lambda: sequence_parallel_apply(moe.apply, seq)(moe.params, torch.zeros((1, 4), dtype=torch.long)))
    note("population_engine", lambda: PopulationEngine(16, mesh=mesh, device="cpu"))
    note("async_engine", lambda: AsyncPopulationEngine(16, mesh=mesh, device="cpu"))
    from p2pfl_tpu_torch.learning.dataset import RandomIIDPartitionStrategy, synthetic_mnist
    from p2pfl_tpu_torch.models.mlp import mlp_model
    from p2pfl_tpu_torch.parallel.simulation import MeshSimulation

    parts = synthetic_mnist(n_train=128, n_test=32).generate_partitions(4, RandomIIDPartitionStrategy)
    sim = MeshSimulation(mlp_model(seed=0, device="cpu"), parts, train_set_size=2, batch_size=32, seed=1,
                         mesh=mesh, device="cpu")
    ckpt = FLCheckpointer(os.path.join(sys.argv[1], f"ckpt_w{world}"))
    note("save_to", lambda: sim.save_to(ckpt))
    note("load_from", lambda: sim.load_from(ckpt))
    note("run_checkpointer", lambda: sim.run(rounds=1, warmup=False, checkpointer=ckpt))
    note("round_cost_analysis", lambda: sim.round_cost_analysis())
    # Over model ranks: the same refusals, and the MoE LM in the population.
    model = Mesh({"nodes": 1, "model": world}, device="cpu", group=mesh.group)
    split = MeshSimulation(mlp_model(seed=0, device="cpu"), parts, train_set_size=2, batch_size=32, seed=1,
                           mesh=model, device="cpu")
    note("model_save_to", lambda: split.save_to(FLCheckpointer(os.path.join(sys.argv[1], f"ckpt_w{world}_model"))))
    note("model_round_cost_analysis", lambda: split.round_cost_analysis())
    moe_lm = moe_lm_model(0, 8, 16, 2, 2, 16, 2, device="cpu")
    toks = np.zeros((4, 2, 8), np.int32)
    note("moe_model", lambda: MeshSimulation(moe_lm, (toks, np.zeros((4, 2), np.int32), np.ones((4, 2), np.float32)),
                                             test_data=(toks[0], None), train_set_size=2, batch_size=2, seed=1,
                                             task="lm", mesh=model, device="cpu"))
    return got


def main() -> int:
    torch.set_num_threads(1)
    out_dir = sys.argv[1]
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from p2pfl_tpu_torch.parallel.mesh import initialize_multihost, make_mesh, shutdown_multihost

    joined = initialize_multihost(f"127.0.0.1:{os.environ['MASTER_PORT']}", world, rank, device="cpu")
    assert joined == {"device": torch.device("cpu"), "backend": "gloo", "rank": rank, "world": world}, joined
    mesh = make_mesh(devices=["cpu"])
    assert mesh.ranked and mesh.shape == {"nodes": world, "model": 1} and mesh.process_count() == world
    saved = {"rank": rank, "world": world}
    if world == 2:
        acc = _mlp(mesh)
        saved["mlp_acc"] = acc
        print(f"MULTIRANK_OK rank={rank} acc={acc:.6f}", flush=True)
    saved["collectives"] = _collectives(mesh)
    init = torch.load(os.path.join(out_dir, "init.pt"))
    saved["refusals"] = _refusals(mesh, init)
    saved["arms"] = {name: run_arm(name, init, mesh) for name in ARMS}
    torch.save(saved, os.path.join(out_dir, f"w{world}_r{rank}.pt"))
    shutdown_multihost()
    print(f"WORKER_DONE rank={rank} world={world}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
