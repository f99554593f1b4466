"""Worker for ``tests/test_torch_seqstage_ranks.py``: one rank of a gloo world
on the CPU whose ``seq`` or ``stage`` axis spans the ranks, started by
:func:`p2pfl_tpu_torch.parallel.launch.launch` (not collected by pytest). It
imports only the port, never JAX.

    python tests/torch_seqstage_worker.py <dir>

Each rank joins through ``initialize_multihost(coordinator, W, rank,
device="cpu")`` on one CPU thread and runs, on ``make_mesh((W,), ("seq",))``
or ``(("stage",))``, each on the same inputs and weights (``<dir>/init.pt``,
carried from the JAX package's initializers):

* ``collectives``: ``ppermute`` (a ring and a partial permute, a tuple of
  two dtypes) with its gradient and byte counter, ``psum`` / ``pmean`` /
  ``replicate`` with theirs;
* ``ring``: ``ring_attention`` (blockwise and flash, causal and not) on this
  rank's shard, output and gradients;
* ``ring_lm``: the ring / ring_flash ``TransformerLM``'s logits, loss and
  two ``make_sequence_parallel_train_step`` steps;
* ``classifier``: the ring ``TransformerClassifier``'s logits;
* ``pipeline``: ``pipeline_apply``, its gradients and three
  ``make_pipeline_train_step`` steps on a tanh block;
* ``pipeline_lm``: ``make_pipelined_transformer_lm``'s logits, gradients and
  two Adam steps.

Beside each ranked run it runs the one-process port at the same axis size
(``Mesh({axis: W})``, virtual shards) on the same thread count, so the test
compares them bit for bit where they must be equal. Rank r saves what it saw
to ``<dir>/w<W>_r<r>.pt``.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch

LAYERS, HEADS, EMBED, SEQ, VOCAB, BATCH = 2, 4, 64, 256, 64, 2
PP_LAYERS, PP_BATCH, PP_SEQ, PP_MICRO = 4, 4, 64, 2  # four layers divide over 2 and 4 stages
CLASSES, BLOCK_K, LR, STEPS = 4, 64, 1e-3, 2
BLOCK_D, BLOCK_BATCH, BLOCK_STEPS = 16, 16, 3


def tokens(seed: int, batch: int = BATCH, seq: int = SEQ, vocab: int = VOCAB) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, vocab, size=(batch, seq)).astype(np.int32)


def qkvg(seed: int) -> list:
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((BATCH, SEQ, HEADS, EMBED // HEADS)).astype(np.float32) for _ in range(4)]


def block_stages(seed: int, n: int) -> list:
    rng = np.random.default_rng(seed)
    return [{"w": rng.normal(scale=0.5, size=(BLOCK_D, BLOCK_D)).astype(np.float32),
             "b": rng.normal(scale=0.1, size=(BLOCK_D,)).astype(np.float32)} for _ in range(n)]


def block_xy(seed: int) -> tuple:
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal((BLOCK_BATCH, BLOCK_D)).astype(np.float32) for _ in range(2))


def _block(p, x):
    return torch.tanh(x @ p["w"] + p["b"])


def _shard(a, mesh) -> torch.Tensor:
    """This rank's sequence shard of a global ``[B, S, ...]`` array."""
    return torch.from_numpy(np.ascontiguousarray(np.array_split(a, mesh.world, axis=1)[mesh.rank]))


def _collectives(mesh) -> dict:
    from p2pfl_tpu_torch.parallel import collectives as c

    rank, world, group = mesh.rank, mesh.world, mesh.group
    c.reset_stats()
    x = torch.full((3, 2), float(rank + 1), requires_grad=True)
    left = [(i, (i - 1) % world) for i in range(world)]
    y = c.ppermute(x, left, group)
    w = torch.arange(6.0).reshape(3, 2) + 10 * rank
    (gx,) = torch.autograd.grad((y * w).sum(), [x])
    ring_bytes = c.STATS["ppermute_bytes"]
    # A partial permute of a tuple: rank 0 to the last rank only; the others receive zeros.
    pair = (torch.full((4,), rank + 0.5), torch.arange(2, dtype=torch.int64) + 100 * rank)
    got = c.ppermute(pair, [(0, world - 1)], group)
    s = torch.tensor([float(rank + 1), 2.0], requires_grad=True)
    summed = c.psum(s, group)
    (gs,) = torch.autograd.grad((summed * torch.tensor([1.0, 3.0])).sum(), [s])
    mean = c.pmean(s, group)
    (gm,) = torch.autograd.grad(mean.sum(), [s])
    r = torch.full((2,), float(rank), requires_grad=True)
    rep = c.replicate(r, world - 1, group)
    (gr,) = torch.autograd.grad((rep * 2).sum(), [r])
    return {"y": y.detach(), "gx": gx, "ring_bytes": ring_bytes, "pair": got,
            "bytes": c.STATS["ppermute_bytes"], "psum": summed.detach(), "gpsum": gs, "pmean": mean.detach(),
            "gpmean": gm, "replicate": rep.detach(), "greplicate": gr, "route": c.p2p_route(torch.device("cpu"), group)}


def _ring(mesh, one) -> dict:
    from p2pfl_tpu_torch.ops.ring_attention import ring_attention

    q, k, v, g = qkvg(3)
    out = {}
    for impl in ("blockwise", "flash"):
        for causal in (True, False):
            runs = {}
            for name, m, arrays in (("ranks", mesh, [_shard(a, mesh) for a in (q, k, v, g)]),
                                    ("one", one, [torch.from_numpy(a) for a in (q, k, v, g)])):
                leaves = [t.clone().requires_grad_(True) for t in arrays[:3]]
                with m.bind():
                    o = ring_attention(*leaves, "seq", causal=causal, block_k=BLOCK_K, impl=impl)
                grads = torch.autograd.grad(o, leaves, arrays[3])
                runs[name] = (o.detach(), *grads)
            out[(impl, causal)] = runs
    return out


def _lm_module(kind, cls=False):
    from p2pfl_tpu_torch.models.transformer import TransformerClassifier, TransformerLM

    with torch.device("meta"):
        if cls:
            return TransformerClassifier(CLASSES, VOCAB, LAYERS, HEADS, EMBED, kind, torch.float32, "seq", BLOCK_K)
        return TransformerLM(VOCAB, LAYERS, HEADS, EMBED, kind, torch.float32, "seq", BLOCK_K)


def _ring_lm(mesh, one, init: dict) -> dict:
    from p2pfl_tpu_torch.models.model_handle import ModelHandle
    from p2pfl_tpu_torch.optim import adam
    from p2pfl_tpu_torch.parallel.sequence import (
        make_sequence_parallel_train_step,
        sequence_parallel_apply,
        sequence_parallel_lm_loss,
        shard_tokens,
    )

    toks = tokens(0)
    out = {}
    for kind in ("ring", "ring_flash"):
        model = ModelHandle({k: v.clone() for k, v in init.items()}, _lm_module(kind))
        runs = {}
        for name, m in (("ranks", mesh), ("one", one)):
            t = shard_tokens(toks, m)
            with torch.no_grad():
                logits = sequence_parallel_apply(model.apply, m)(model.params, t)
                loss = sequence_parallel_lm_loss(model.apply, m)(model.params, t)
            opt = adam(LR)
            step = make_sequence_parallel_train_step(model.apply, opt, m, "seq")
            params, state, losses = model.params, opt.init(model.params), []
            for _ in range(STEPS):
                params, state, l = step(params, state, t)
                losses.append(float(l))
            runs[name] = {"logits": logits, "loss": float(loss), "losses": losses, "params": params}
        out[kind] = runs
    return out


def _classifier(mesh, one, init: dict) -> dict:
    from p2pfl_tpu_torch.models.model_handle import ModelHandle
    from p2pfl_tpu_torch.parallel.sequence import sequence_parallel_apply, shard_tokens

    model = ModelHandle(init, _lm_module("ring", cls=True))
    toks = tokens(4)
    with torch.no_grad():
        return {name: sequence_parallel_apply(model.apply, m)(model.params, shard_tokens(toks, m))
                for name, m in (("ranks", mesh), ("one", one))}


def _pipeline(mesh, one) -> dict:
    from p2pfl_tpu_torch.optim import adam
    from p2pfl_tpu_torch.parallel import pipeline

    stages = [{k: torch.from_numpy(v) for k, v in s.items()} for s in block_stages(2, mesh.world)]
    x, y = (torch.from_numpy(a) for a in block_xy(3))
    runs = {}
    for name, m in (("ranks", mesh), ("one", one)):
        stacked = pipeline.stack_stage_params(stages, m)
        with torch.no_grad():
            fwd = pipeline.pipeline_apply(stacked, x, _block, m, PP_MICRO)
        leaves = {k: v.clone().requires_grad_(True) for k, v in stacked.items()}
        loss = torch.mean((pipeline.pipeline_apply(leaves, x, _block, m, PP_MICRO) - y) ** 2)
        grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
        opt = adam(1e-2)
        step = pipeline.make_pipeline_train_step(_block, lambda o, t: torch.mean((o - t) ** 2), opt, m, PP_MICRO)
        params, state, losses = stacked, opt.init(stacked), []
        for _ in range(BLOCK_STEPS):
            params, state, l = step(params, state, x, y)
            losses.append(float(l))
        runs[name] = {"out": fwd, "grads": grads, "params": params, "losses": losses}
    return runs


def _pipeline_lm(mesh, one, init: dict) -> dict:
    from p2pfl_tpu_torch.models.model_handle import ModelHandle
    from p2pfl_tpu_torch.models.transformer import TransformerLM, causal_lm_loss
    from p2pfl_tpu_torch.optim import adam, apply_updates
    from p2pfl_tpu_torch.parallel import collectives, pipeline

    with torch.device("meta"):
        module = TransformerLM(VOCAB, PP_LAYERS, HEADS, EMBED, "flash", torch.float32, None, BLOCK_K)
    model = ModelHandle(init, module)
    toks = torch.from_numpy(tokens(5, PP_BATCH, PP_SEQ))
    runs = {}
    for name, m in (("ranks", mesh), ("one", one)):
        pp, apply_fn = pipeline.make_pipelined_transformer_lm(model, m, PP_MICRO)
        collectives.reset_stats()
        with torch.no_grad():
            logits = apply_fn(pp, toks)
        params = pipeline._flatten(pp)
        opt = adam(LR)
        state, losses, first = opt.init(params), [], None
        for _ in range(STEPS):
            leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
            loss = causal_lm_loss(apply_fn(pipeline._unflatten(leaves), toks), toks)
            grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
            first = grads if first is None else first
            updates, state = opt.update(grads, state, params)
            params = apply_updates(params, updates)
            losses.append(float(loss))
        runs[name] = {"logits": logits, "grads": first, "params": params, "losses": losses,
                      "bytes": collectives.STATS["ppermute_bytes"]}
    return runs


def main() -> int:
    torch.set_num_threads(1)
    out_dir = sys.argv[1]
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from p2pfl_tpu_torch.parallel.mesh import Mesh, initialize_multihost, make_mesh, shutdown_multihost

    joined = initialize_multihost(f"127.0.0.1:{os.environ['MASTER_PORT']}", world, rank, device="cpu")
    assert joined == {"device": torch.device("cpu"), "backend": "gloo", "rank": rank, "world": world}, joined
    seq = make_mesh((world,), ("seq",), devices=["cpu"])
    stage = make_mesh((world,), ("stage",), devices=["cpu"])
    assert seq.rank_axis == "seq" and stage.rank_axis == "stage", (seq, stage)
    init = torch.load(os.path.join(out_dir, "init.pt"))
    one_seq, one_stage = Mesh({"seq": world}, device="cpu"), Mesh({"stage": world}, device="cpu")
    saved = {
        "rank": rank, "world": world,
        "collectives": _collectives(seq),
        "ring": _ring(seq, one_seq),
        "ring_lm": _ring_lm(seq, one_seq, init["lm"]),
        "classifier": _classifier(seq, one_seq, init["classifier"]),
        "pipeline": _pipeline(stage, one_stage),
        "pipeline_lm": _pipeline_lm(stage, one_stage, init["pipeline_lm"]),
    }
    torch.save(saved, os.path.join(out_dir, f"w{world}_r{rank}.pt"))
    shutdown_multihost()
    print(f"WORKER_DONE rank={rank} world={world}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
