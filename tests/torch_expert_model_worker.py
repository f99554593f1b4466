"""Worker for ``tests/test_torch_expert_model_ranks.py``: one rank of a gloo
world on the CPU whose ``expert`` or ``model`` axis spans the ranks, started
by :func:`p2pfl_tpu_torch.parallel.launch.launch` (not collected by pytest).
It imports only the port, never JAX.

    python tests/torch_expert_model_worker.py <dir>

Each rank joins through ``initialize_multihost(coordinator, W, rank,
device="cpu")`` on one CPU thread and runs, on the weights carried from the
JAX package's initializers (``<dir>/init.pt``):

* ``collectives``: ``all_gather_dim`` on dims 0 and -1 (bf16 and f32), its
  gradient and its byte counter, and ``psum`` / ``sum_cotangent``'s;
* ``moe``: ``shard_moe_params`` on ``make_mesh((W,), ("expert",))``, the
  MoE LM's logits, aux and loss gradients on its local shards, then two
  Adam steps on loss + 0.01 aux;
* ``moe_seq``: the ring MoE LM over ``make_mesh((W,), ("seq",))``, each
  rank routing its own shard: logits and two
  ``make_sequence_parallel_train_step`` steps;
* ``conv``: ``conv_same`` (a 3 x 3 stride-2 convolution, padded (0, 1)) on
  a kernel split over ``model`` ranks, output and gradients;
* ``sims``: ``MeshSimulation`` on ``make_mesh((1, W), ("nodes", "model"))``:
  the MLP round with FedAdam, with the update-norm clip, with Krum, with
  the geometric median, with FedProx, with DP-SGD, with SCAFFOLD, with
  ``per_node_init`` and with the device observatory and a ledger; and the
  flash LM round. Each keeps this rank's local node 0, the gathered final
  model and state, the test losses and the bytes its exchanges moved.

Beside each ranked run it runs the one-process port on the same thread
count. Rank r saves what it saw to ``<dir>/w<W>_r<r>.pt``.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch

# The MoE LM (tests/test_moe.py's expert-parallel case at f32).
MOE_LAYERS, MOE_HEADS, MOE_EMBED, MOE_VOCAB, MOE_EXPERTS, MOE_SEQ, MOE_BATCH = 2, 2, 32, 32, 4, 16, 2
MOE_RING_SEQ, MOE_AUX, LR, STEPS = 64, 0.01, 1e-3, 2
# The MeshSimulation rounds: f32 MLPs, and the flash LM.
NODES, SAMPLES, MLP_HIDDEN = 4, 32, (16, 8)
SCHED = ((0, 2), (1, 2))  # node 2 trains twice
SCHED_ALL = ((0, 1, 2, 3), (3, 1, 0, 2))  # Krum scores each member by its 2 nearest of 4
LM_LAYERS, LM_HEADS, LM_EMBED, LM_SEQ, LM_VOCAB, LM_SEQS, LM_BLOCK = 2, 4, 64, 64, 64, 2, 64
FEDADAM_LR, CLIP, PROX, DP_CLIP, DP_NOISE, DP_LR = 3e-3, 0.05, 0.1, 1.0, 0.5, 0.1
# The LM's Adam eps. Adam's first step is g / (|g| + eps): at optax's 1e-8 a
# gradient element within f32 noise of 0 (the sums over ranks run in another
# order) moves its weight by a visible part of lr, on one element in ~10^4.
LM_ADAM_EPS = 1e-3
# The MLP arms: name -> (MeshSimulation kwargs, aggregate rule or None, committee schedule).
MLP_ARMS = {
    "fedadam": ({"server_optimizer": "fedadam", "server_lr": FEDADAM_LR}, None, SCHED),
    "clip": ({"clip_update_norm": CLIP}, None, SCHED),
    "krum": ({"byzantine_mask": np.array([0, 1, 0, 0], np.float32)}, "krum", SCHED_ALL),
    "geomed": ({}, "geomed", SCHED_ALL),
    "fedprox": ({"fedprox_mu": PROX}, None, SCHED),
    # SGD, for the reason of LM_ADAM_EPS.
    "dp": ({"dp_clip_norm": DP_CLIP, "dp_noise_multiplier": DP_NOISE, "optimizer": "sgd"}, None, SCHED),
    "scaffold": ({"algorithm": "scaffold"}, None, SCHED),
    "per_node_init": ({"per_node_init": True}, None, SCHED),
    "devobs": ({}, None, SCHED),
}


def moe_tokens(seq: int = MOE_SEQ) -> np.ndarray:
    """``tests/test_moe.py``'s tokens at ``seq``: ``arange % vocab``, shifted
    so the routes differ between the shards."""
    return ((np.arange(MOE_BATCH * seq).reshape(MOE_BATCH, seq) * 7 + 3) % MOE_VOCAB).astype(np.int32)


def lm_data(seed: int = 0) -> tuple:
    """``(x, y, mask, x_test)`` of the LM round: NODES x LM_SEQS sequences."""
    rng = np.random.default_rng(seed)
    x = rng.integers(0, LM_VOCAB, size=(NODES, LM_SEQS, LM_SEQ)).astype(np.int32)
    xt = rng.integers(0, LM_VOCAB, size=(2, LM_SEQ)).astype(np.int32)
    return x, np.zeros((NODES, LM_SEQS), np.int32), np.ones((NODES, LM_SEQS), np.float32), xt


def _moe_module(kind: str = "blockwise", axis: str = None):
    from p2pfl_tpu_torch.models.moe import MoETransformerLM

    with torch.device("meta"):
        return MoETransformerLM(MOE_VOCAB, MOE_LAYERS, MOE_HEADS, MOE_EMBED, MOE_EXPERTS, attention_kind=kind,
                                axis_name=axis, block_k=16, compute_dtype=torch.float32)


def _collectives(mesh) -> dict:
    from p2pfl_tpu_torch.parallel import collectives as c

    rank, world, group = mesh.rank, mesh.world, mesh.group
    c.reset_stats()
    x = torch.full((2, 3), float(rank + 1), requires_grad=True)
    y = c.all_gather_dim(x, -1, group)  # [2, 3 W]
    w = torch.arange(float(2 * 3 * world)).reshape(2, 3 * world)
    (gx,) = torch.autograd.grad((y * w).sum(), [x])
    bf = c.all_gather_dim(torch.full((1, 2), rank + 0.5, dtype=torch.bfloat16), 0, group)
    gather_bytes = c.STATS["gather_dim_bytes"]
    s = torch.full((3,), float(rank), requires_grad=True)
    t = c.sum_cotangent(s, group)
    (gs,) = torch.autograd.grad((t * (rank + 1)).sum(), [s])
    summed = c.psum(torch.ones(4), group)
    return {"y": y.detach(), "gx": gx, "bf": bf, "gather_bytes": gather_bytes, "gs": gs, "psum": summed,
            "sum_bytes": c.STATS["sum_bytes"], "route": c.p2p_route(torch.device("cpu"), group, "all_gather_dim")}


def _moe_step_fn(apply, mesh):
    from p2pfl_tpu_torch.models.transformer import causal_lm_loss
    from p2pfl_tpu_torch.optim import apply_updates

    def step(params, state, opt, tokens):
        leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
        with mesh.bind():
            logits, aux = apply(leaves, tokens)
            loss = causal_lm_loss(logits, tokens) + MOE_AUX * aux
            grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
        updates, state = opt.update(grads, state, params)
        return apply_updates(params, updates), state, float(loss.detach()), grads, logits.detach(), float(aux.detach())

    return step


def _moe(mesh, one, init: dict) -> dict:
    from p2pfl_tpu_torch.models.moe import moe_lm_apply_with_aux, shard_moe_params
    from p2pfl_tpu_torch.optim import adam
    from p2pfl_tpu_torch.parallel import collectives

    module = _moe_module()
    apply = moe_lm_apply_with_aux(module)
    tokens = torch.from_numpy(moe_tokens())
    runs = {}
    for name, m in (("ranks", mesh), ("one", one)):
        params = shard_moe_params(init, m)
        step = _moe_step_fn(apply, m)
        opt = adam(LR)
        state, losses = opt.init(params), []
        collectives.reset_stats()
        for i in range(STEPS):
            new, state, loss, grads, logits, aux = step(params, state, opt, tokens)
            if i == 0:
                first = {"logits": logits, "aux": aux, "grads": grads, "sum_bytes": collectives.STATS["sum_bytes"]}
            params = new
            losses.append(loss)
        runs[name] = {**first, "losses": losses, "params": params, "shapes": {k: tuple(v.shape) for k, v in
                                                                               params.items()}}
    return runs


def _moe_seq(mesh, init: dict) -> dict:
    from p2pfl_tpu_torch.models.model_handle import ModelHandle
    from p2pfl_tpu_torch.optim import adam
    from p2pfl_tpu_torch.parallel.sequence import (
        make_sequence_parallel_train_step,
        sequence_parallel_apply,
        shard_tokens,
    )

    model = ModelHandle({k: v.clone() for k, v in init.items()}, _moe_module("ring", "seq"))
    toks = moe_tokens(MOE_RING_SEQ)
    t = shard_tokens(toks, mesh)
    with torch.no_grad():
        logits = sequence_parallel_apply(model.apply, mesh)(model.params, t)
    opt = adam(LR)
    step = make_sequence_parallel_train_step(model.apply, opt, mesh, "seq")
    params, state, losses = model.params, opt.init(model.params), []
    for _ in range(STEPS):
        params, state, loss = step(params, state, t)
        losses.append(float(loss))
    return {"logits": logits, "losses": losses, "params": params}


def _conv(mesh, one) -> dict:
    """``conv_same`` of a 3 x 3 stride-2 convolution (flax pads (0, 1)) with a
    bias, its kernel split over the model ranks: output and gradients."""
    import torch.nn as nn
    from p2pfl_tpu_torch.models.cnn import conv_same
    from p2pfl_tpu_torch.parallel.tensor_parallel import ModelSplit

    g = torch.Generator().manual_seed(5)
    weight, bias = torch.randn(8, 4, 3, 3, generator=g), torch.randn(8, generator=g)
    x = torch.randn(2, 4, 8, 8, generator=g)
    cot = torch.randn(2, 8, 4, 4, generator=g)
    runs = {}
    for name, m in (("ranks", mesh), ("one", one)):
        conv, w = nn.Conv2d(4, 8, 3, 2), weight.clone()
        if m.ranked:  # this rank's output channels of the kernel; the bias whole
            w = ModelSplit({"Conv_0.weight": weight.shape}, m).local("Conv_0.weight", weight)
        conv.weight, conv.bias = nn.Parameter(w), nn.Parameter(bias.clone())
        xi = x.clone().requires_grad_(True)
        with m.bind():
            out = conv_same(xi, conv, torch.float32)
            grads = torch.autograd.grad(out, [xi, conv.weight, conv.bias], cot)
        runs[name] = {"out": out.detach(), "dx": grads[0], "dw": grads[1], "db": grads[2]}
    return runs


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


def _aggregate(rule):
    from p2pfl_tpu_torch.ops import aggregation as agg

    if rule == "krum":
        return lambda s, w: agg.krum(s, w, 0)[0]
    if rule == "geomed":
        return agg.geometric_median
    return None


def _sim_run(mesh, handle, data, test, kwargs, rule, sched=SCHED, task="classification", devobs=False) -> dict:
    from p2pfl_tpu_torch.config import Settings
    from p2pfl_tpu_torch.optim import adam, sgd
    from p2pfl_tpu_torch.parallel import collectives
    from p2pfl_tpu_torch.parallel.simulation import MeshSimulation
    from p2pfl_tpu_torch.telemetry.ledger import LEDGERS, canonical_params_hash
    from p2pfl_tpu_torch.telemetry.sketches import SKETCHES

    collectives.reset_stats()
    LEDGERS.reset()
    SKETCHES.reset()
    batch = SAMPLES if task == "classification" else LM_SEQS
    if isinstance(kwargs.get("optimizer"), str):
        kwargs = {**kwargs, "optimizer": sgd(DP_LR) if kwargs["optimizer"] == "sgd" else adam(LR, eps=LM_ADAM_EPS)}
    with Settings.overridden(DEVOBS_ENABLED=devobs):
        sim = MeshSimulation(handle, data, test_data=test, train_set_size=len(sched[0]), batch_size=batch, lr=LR,
                             seed=0, mesh=mesh, aggregate_fn=_aggregate(rule), task=task, device="cpu", **kwargs)
        if not mesh.ranked and kwargs.get("dp_clip_norm"):
            sim._per_example = "loop"  # the ranked run's per-example mode: a vmap sums in another order
        ledger = sim.attach_ledger() if devobs else None
        res = sim.run(rounds=len(sched), warmup=False, committee_schedule=np.asarray(sched))
    whole = sim.final_model(0).params
    state = sim.state_dict()
    out = {"test_loss": res.test_loss, "test_acc": res.test_acc, "whole": whole,
           "local0": {k: v[0].clone() for k, v in sim.params_stack.items()}, "hash": canonical_params_hash(whole),
           "state": state, "gather_dim_bytes": collectives.STATS["gather_dim_bytes"],
           "sum_bytes": collectives.STATS["sum_bytes"], "dims": dict(sim._split.dims) if sim._split else {}}
    if devobs:
        sk = SKETCHES.get("update_norm", "mesh-sim")
        out["update_norm"] = (sk.count, sk.sum) if sk is not None else None
        out["ledger_hashes"] = ([e["hash"] for e in ledger.events() if e.get("kind") == "aggregate_committed"
                                 and "hash" in e] if ledger is not None else None)
    sim.close()
    return out


def _sims(mesh, one, init: dict) -> dict:
    from p2pfl_tpu_torch.learning.dataset import RandomIIDPartitionStrategy, synthetic_mnist

    parts = synthetic_mnist(n_train=SAMPLES * NODES, n_test=64).generate_partitions(NODES,
                                                                                    RandomIIDPartitionStrategy)
    out = {}
    for arm, (kwargs, rule, sched) in MLP_ARMS.items():
        out[arm] = {name: _sim_run(m, mlp_handle(init["mlp"]), parts, None, kwargs, rule, sched, devobs=arm == "devobs")
                    for name, m in (("ranks", mesh), ("one", one))}
    x, y, mask, xt = lm_data()
    out["lm"] = {name: _sim_run(m, lm_handle(init["lm"]), (x, y, mask), (xt, None), {"optimizer": "adam"}, None,
                                task="lm")
                 for name, m in (("ranks", mesh), ("one", one))}
    return out


def main() -> int:
    torch.set_num_threads(1)
    out_dir = sys.argv[1]
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from p2pfl_tpu_torch.parallel.mesh import Mesh, initialize_multihost, make_mesh, shutdown_multihost

    joined = initialize_multihost(f"127.0.0.1:{os.environ['MASTER_PORT']}", world, rank, device="cpu")
    assert joined == {"device": torch.device("cpu"), "backend": "gloo", "rank": rank, "world": world}, joined
    expert = make_mesh((world,), ("expert",), devices=["cpu"])
    seq = make_mesh((world,), ("seq",), devices=["cpu"])
    model = make_mesh((1, world), ("nodes", "model"), devices=["cpu"])
    assert (expert.rank_axis, seq.rank_axis, model.rank_axis) == ("expert", "seq", "model"), (expert, seq, model)
    init = torch.load(os.path.join(out_dir, "init.pt"))
    one_expert, one_model = Mesh({"expert": world}, device="cpu"), Mesh({"nodes": 1, "model": world}, device="cpu")
    saved = {
        "rank": rank, "world": world,
        "collectives": _collectives(model),
        "moe": _moe(expert, one_expert, init["moe"]),
        "moe_seq": _moe_seq(seq, init["moe"]),
        "conv": _conv(model, one_model),
        "sims": _sims(model, one_model, init),
    }
    torch.save(saved, os.path.join(out_dir, f"w{world}_r{rank}.pt"))
    shutdown_multihost()
    print(f"WORKER_DONE rank={rank} world={world}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
