"""Worker for ``tests/test_torch_mesh2d_ranks.py``: one rank of a gloo world
on the CPU whose rank mesh has two axes, started by
:func:`p2pfl_tpu_torch.parallel.launch.launch` (not collected by pytest). It
imports only the port, never JAX.

    python tests/torch_mesh2d_worker.py <dir> w4|w2

Each rank joins through ``initialize_multihost(coordinator, W, rank,
device="cpu")`` on one CPU thread, on the weights carried from the JAX
package's initializers (``<dir>/init.pt``).

World ``w4`` (four ranks, the 2 x 2 layouts):

* ``meshes``: ``make_mesh((2, 2), ("nodes", "model"))`` and ``(("batch",
  "seq"))``: each rank's coordinates and the global ranks of its sub-group
  on each axis; a ``batch`` axis alone; the pairs no program of the JAX
  package runs (``nodes`` x ``seq``, ``nodes`` x ``stage``, ``seq`` x
  ``expert``), which raise;
* ``collectives``: a gather along ``nodes``, a broadcast from the second
  rank of each ``model`` sub-group, a ``ppermute`` along ``seq`` and the
  byte counters of each axis;
* ``sims``: ``MeshSimulation`` on ``nodes`` x ``model``: the f32 MLP with
  FedAdam (saving a sharded checkpoint after each round under
  ``<dir>/ckpt``) and the small f32 flash LM, two rounds of ``SCHED``; the
  MLP state restored from the checkpoint on the same mesh;
* ``seq``: the ring and ring_flash LMs on ``batch`` x ``seq``: logits of
  this rank's ``[B / 2, S / 2]`` tokens, ``STEPS`` train steps, the byte
  counters of each axis; a train step on that mesh without ``batch_axis``,
  which raises;
* ``cost``: ``round_cost_analysis`` of fresh MLP and LM populations;
* ``dryrun``: ``dryrun_multichip(4, "cpu")`` with its printed lines, then
  again with rank 0's budget 0 (every rank must skip after the core phase).

World ``w2`` (two ranks): the same populations on ``{"nodes": 1, "model":
2}``, the ``w4`` checkpoint restored on it and on two ``nodes`` ranks, and
the cost analysis on both. Rank r saves what it saw to
``<dir>/<world>_r<r>.pt``.
"""

from __future__ import annotations

import contextlib
import io
import os
import sys

import numpy as np
import torch

# The populations: an f32 MLP 784-16-8-10 over NODES nodes of SAMPLES
# samples (local SGD, FedAdam on the server), and the flash LM; one batch a
# node (the packages shuffle with different generators).
NODES, SAMPLES, MLP_HIDDEN, LR, FEDADAM_LR = 8, 32, (16, 8), 1e-2, 3e-3
# Round 0's committee on both slabs of 2 x 2 (rows 0-3 and 4-7), round 1's
# on the first slab alone (the second holds no member: an empty gather).
SCHED = ((0, 5, 2, 7), (1, 3, 0, 2))
LM_LAYERS, LM_HEADS, LM_EMBED, LM_SEQ, LM_VOCAB, LM_SEQS, LM_BLOCK = 2, 4, 64, 64, 64, 2, 64
# Adam's first step is g / (|g| + eps): at 1e-8 a gradient element within f32
# noise of 0 moves its weight by a visible part of lr (the ranks sum in
# another order than the JAX package).
LM_LR, LM_ADAM_EPS = 1e-3, 1e-3
# The batch x seq LMs: a batch of 2 over 2 batch ranks, 256 tokens over 2 seq ranks.
SEQ_LAYERS, SEQ_HEADS, SEQ_EMBED, SEQ_LEN, SEQ_VOCAB, SEQ_BATCH, SEQ_BLOCK, STEPS = 2, 4, 64, 256, 64, 2, 64, 2
# The cost analysis' populations: the committee size and a one-member twin.
COST_K = 4


def mlp_parts():
    from p2pfl_tpu_torch.learning.dataset import RandomIIDPartitionStrategy, synthetic_mnist

    return synthetic_mnist(n_train=SAMPLES * NODES, n_test=64).generate_partitions(NODES, RandomIIDPartitionStrategy)


def lm_data(seed: int = 0) -> tuple:
    """``(x, y, mask, x_test)`` of the LM round: NODES x LM_SEQS sequences."""
    rng = np.random.default_rng(seed)
    x = rng.integers(0, LM_VOCAB, size=(NODES, LM_SEQS, LM_SEQ)).astype(np.int32)
    xt = rng.integers(0, LM_VOCAB, size=(2, LM_SEQ)).astype(np.int32)
    return x, np.zeros((NODES, LM_SEQS), np.int32), np.ones((NODES, LM_SEQS), np.float32), xt


def seq_tokens(seed: int = 0) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, SEQ_VOCAB, size=(SEQ_BATCH, SEQ_LEN)).astype(np.int32)


def mlp_handle(init: dict):
    from p2pfl_tpu_torch.models.mlp import MLP
    from p2pfl_tpu_torch.models.model_handle import ModelHandle

    with torch.device("meta"):
        module = MLP(784, MLP_HIDDEN, 10, torch.float32)
    return ModelHandle({k: v.clone() for k, v in init.items()}, module)


def lm_handle(init: dict):
    from p2pfl_tpu_torch.models.model_handle import ModelHandle
    from p2pfl_tpu_torch.models.transformer import TransformerLM

    with torch.device("meta"):
        module = TransformerLM(LM_VOCAB, LM_LAYERS, LM_HEADS, LM_EMBED, "flash", torch.float32, None, LM_BLOCK)
    return ModelHandle({k: v.clone() for k, v in init.items()}, module)


def seq_handle(init: dict, kind: str):
    from p2pfl_tpu_torch.models.model_handle import ModelHandle
    from p2pfl_tpu_torch.models.transformer import TransformerLM

    with torch.device("meta"):
        module = TransformerLM(SEQ_VOCAB, SEQ_LAYERS, SEQ_HEADS, SEQ_EMBED, kind, torch.float32, "seq", SEQ_BLOCK)
    return ModelHandle({k: v.clone() for k, v in init.items()}, module)


def make_sim(arm: str, init: dict, mesh, train_set_size: int = len(SCHED[0])):
    """A fresh population of ``arm`` (``"mlp"`` or ``"lm"``) on ``mesh``."""
    from p2pfl_tpu_torch.optim import adam, sgd
    from p2pfl_tpu_torch.parallel.simulation import MeshSimulation

    if arm == "mlp":
        return MeshSimulation(mlp_handle(init["mlp"]), mlp_parts(), train_set_size=train_set_size,
                              batch_size=SAMPLES, lr=LR, seed=0, mesh=mesh, optimizer=sgd(LR),
                              server_optimizer="fedadam", server_lr=FEDADAM_LR, device="cpu")
    x, y, mask, xt = lm_data()
    return MeshSimulation(lm_handle(init["lm"]), (x, y, mask), test_data=(xt, None), train_set_size=train_set_size,
                          batch_size=LM_SEQS, lr=LM_LR, seed=0, task="lm", mesh=mesh,
                          optimizer=adam(LM_LR, eps=LM_ADAM_EPS), device="cpu")


def _copy(tree):
    from p2pfl_tpu_torch.optim import state_map

    return state_map(lambda t: t.detach().clone(), tree)


def _sims(mesh, init: dict, ckpt_root: str = None) -> dict:
    from p2pfl_tpu_torch.management.checkpoint import FLCheckpointer
    from p2pfl_tpu_torch.parallel import collectives

    out = {}
    for arm in ("mlp", "lm"):
        sim = make_sim(arm, init, mesh)
        collectives.reset_stats()
        ck = FLCheckpointer(ckpt_root) if arm == "mlp" and ckpt_root else None
        res = sim.run(rounds=len(SCHED), warmup=False, committee_schedule=np.asarray(SCHED), checkpointer=ck)
        stats = {axis: dict(v) for axis, v in collectives.AXIS_STATS.items()}
        if ck is not None:
            ck.wait()
        out[arm] = {"test_loss": res.test_loss, "final": _copy(sim.final_model(0).params),
                    "state": _copy(sim.state_dict()), "rank_members": sim.rank_members,
                    "local": {k: tuple(v.shape) for k, v in sim.params_stack.items()}, "stats": stats,
                    "dims": dict(sim._split.dims) if sim._split is not None else {}}
        sim.close()
    return out


def _restore(mesh, init: dict, root: str, step: int = None) -> dict:
    """The MLP population restored from ``root`` on ``mesh``: its whole state."""
    from p2pfl_tpu_torch.management.checkpoint import FLCheckpointer

    sim = make_sim("mlp", init, mesh)
    done = sim.load_from(FLCheckpointer(root), step)
    state = _copy(sim.state_dict())
    sim.close()
    return {"rounds": done, "state": state}


def _cost(mesh, init: dict) -> dict:
    out = {}
    for arm in ("mlp", "lm"):
        sim = make_sim(arm, init, mesh, COST_K)
        out[arm] = sim.round_cost_analysis()
        sim.close()
    return out


def _meshes(group) -> dict:
    import torch.distributed as dist
    from p2pfl_tpu_torch.parallel.mesh import Mesh, make_mesh

    got = {}
    for names in (("nodes", "model"), ("batch", "seq")):
        m = make_mesh((2, 2), names, devices=["cpu"])
        got[names] = {"rank_axes": m.rank_axes, "coords": [m.axis_rank(n) for n in names],
                      "groups": [dist.get_process_group_ranks(m.axis_process_group(n)) for n in names],
                      "slab": m.slab(8) if names[0] == "nodes" else None}
    batch = make_mesh((4,), ("batch",), devices=["cpu"])
    got["batch"] = {"rank_axes": batch.rank_axes, "coords": [batch.axis_rank("batch")]}
    refused = {}
    for axes in ({"nodes": 4, "seq": 2}, {"nodes": 4, "stage": 2}, {"seq": 2, "expert": 2}):
        try:
            Mesh(axes, device="cpu", group=group)
            refused[tuple(axes)] = None
        except NotImplementedError as e:
            refused[tuple(axes)] = str(e)
    got["refused"] = refused
    return got


def _collectives(mesh2d, seq2d) -> dict:
    from p2pfl_tpu_torch.parallel import collectives as c

    c.reset_stats()
    i, j = mesh2d.axis_rank("nodes"), mesh2d.axis_rank("model")
    nodes_g, model_g = mesh2d.axis_process_group("nodes"), mesh2d.axis_process_group("model")
    gathered = c.all_gather({"x": torch.full((i + 1, 3), float(10 * i + j))}, [1, 2], group=nodes_g)
    # src 1 of the model sub-group: global rank 2 i + 1.
    bcast = c.broadcast_tree({"w": torch.full((2,), float(mesh2d.rank))}, src=1, group=model_g)
    one = c.broadcast(torch.tensor([mesh2d.rank]), src=1, group=nodes_g)
    left = [(0, 1), (1, 0)]
    y = c.ppermute(torch.full((5,), float(seq2d.rank)), left, seq2d.axis_process_group("seq"))
    s = c.psum(torch.ones(3), seq2d.axis_process_group("batch"))
    return {"gathered": gathered["x"], "bcast": bcast["w"], "one": int(one.item()), "ppermute": y, "psum": s,
            "stats": {axis: dict(v) for axis, v in c.AXIS_STATS.items()}}


def _seq(mesh, init: dict) -> dict:
    from p2pfl_tpu_torch.optim import adam
    from p2pfl_tpu_torch.parallel import collectives
    from p2pfl_tpu_torch.parallel.sequence import (
        make_sequence_parallel_train_step,
        sequence_parallel_apply,
        sequence_parallel_lm_loss,
        shard_tokens,
    )

    out = {}
    toks = shard_tokens(seq_tokens(), mesh, "seq", "batch")
    for kind in ("ring", "ring_flash"):
        model = seq_handle(init["seq"], kind)
        with torch.no_grad():
            logits = sequence_parallel_apply(model.apply, mesh, "seq", "batch")(model.params, toks)
            loss = sequence_parallel_lm_loss(model.apply, mesh, "seq", "batch")(model.params, toks)
        opt = adam(LM_LR)
        step = make_sequence_parallel_train_step(model.apply, opt, mesh, "seq", "batch")
        params, state, losses = model.params, opt.init(model.params), []
        collectives.reset_stats()
        for _ in range(STEPS):
            params, state, l = step(params, state, toks)
            losses.append(float(l))
        out[kind] = {"tokens": toks.clone(), "logits": logits, "loss": float(loss), "losses": losses,
                     "params": _copy(params), "stats": {a: dict(v) for a, v in collectives.AXIS_STATS.items()}}
    try:  # the batch axis spans ranks but is not named: its rows would sum the same gradients twice
        make_sequence_parallel_train_step(model.apply, adam(LM_LR), mesh, "seq")
        out["unnamed_batch"] = None
    except ValueError as e:
        out["unnamed_batch"] = str(e)
    return out


def _dryrun(rank: int) -> dict:
    from p2pfl_tpu_torch.entry import dryrun_multichip

    out = {}
    for name, budget in (("full", "480"), ("skip", "0" if rank == 0 else "1e9")):
        os.environ["P2PFL_TPU_DRYRUN_BUDGET"] = budget
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            ran = dryrun_multichip(4, "cpu")
        out[name] = {"ran": ran, "printed": buf.getvalue()}
    return out


def main() -> int:
    torch.set_num_threads(1)
    out_dir, mode = sys.argv[1], sys.argv[2]
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from p2pfl_tpu_torch.parallel.mesh import initialize_multihost, make_mesh, shutdown_multihost

    joined = initialize_multihost(f"127.0.0.1:{os.environ['MASTER_PORT']}", world, rank, device="cpu")
    assert joined == {"device": torch.device("cpu"), "backend": "gloo", "rank": rank, "world": world}, joined
    init = torch.load(os.path.join(out_dir, "init.pt"))
    ckpt = os.path.join(out_dir, "ckpt")
    saved = {"rank": rank, "world": world}
    if mode == "w4":
        mesh2d = make_mesh((2, 2), ("nodes", "model"), devices=["cpu"])
        seq2d = make_mesh((2, 2), ("batch", "seq"), devices=["cpu"])
        saved["meshes"] = _meshes(mesh2d.group)
        saved["collectives"] = _collectives(mesh2d, seq2d)
        saved["sims"] = _sims(mesh2d, init, ckpt)
        saved["restore"] = {"2x2": _restore(mesh2d, init, ckpt)}
        saved["seq"] = _seq(seq2d, init)
        saved["cost"] = _cost(mesh2d, init)
        saved["dryrun"] = _dryrun(rank)
    else:
        model = make_mesh((1, 2), ("nodes", "model"), devices=["cpu"])
        nodes = make_mesh((2,), ("nodes",), devices=["cpu"])
        saved["sims"] = _sims(model, init)
        saved["restore"] = {"model": _restore(model, init, ckpt), "nodes": _restore(nodes, init, ckpt)}
        saved["cost"] = {"model": _cost(model, init), "nodes": _cost(nodes, init)}
    torch.save(saved, os.path.join(out_dir, f"{mode}_r{rank}.pt"))
    shutdown_multihost()
    print(f"WORKER_DONE rank={rank} world={world}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
