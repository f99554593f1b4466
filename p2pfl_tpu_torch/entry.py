"""Entry points of the port (counterparts of ``__graft_entry__.py``):
``entry()``, a forward step of the flagship model (the MNIST MLP), and
``dryrun_multichip(n)``, one step of each parallel path with its mesh axes
collapsed onto the one card."""

from __future__ import annotations

import os
import time
from typing import Callable, Dict, Tuple

import numpy as np
import torch

from p2pfl_tpu_torch.device import DeviceLike, resolve_device
from p2pfl_tpu_torch.models.mlp import mlp_model


def entry(device: DeviceLike = None) -> Tuple[Callable, Tuple[Dict[str, torch.Tensor], torch.Tensor]]:
    """Return ``(forward, (params, x))``: ``forward(params, batch)`` runs
    ``mlp_model(seed=0)`` and ``x`` is a ``[64, 28, 28]`` f32 zero batch, both
    on ``device`` (default: the card; raises when none is visible)."""
    dev = resolve_device("cuda" if device is None else device)
    model = mlp_model(seed=0, device=dev)
    x = torch.as_tensor(np.zeros((64, 28, 28), np.float32), device=dev)

    def forward(params: Dict[str, torch.Tensor], batch: torch.Tensor) -> torch.Tensor:
        return model.apply(params, batch)

    return forward, (model.params, x)


def _expect(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"dryrun_multichip: {what}")


def dryrun_multichip(n_devices: int, device: DeviceLike = "cuda") -> None:
    """One step of each of the JAX package's parallel paths at tiny shapes,
    every mesh axis of ``n_devices`` virtual shards on the one ``device``:

    1. the MLP round with the FedAdam server optimizer over a ``nodes`` x
       ``model`` mesh (``model`` 2 when ``n_devices`` is even and >= 4);
    2. a ring-attention LM train step with the sequence cut into
       ``n_devices`` shards;
    3. the MoE LM forward with ``n_devices`` experts (``shard_moe_params``
       places nothing: the experts run one after another);
    4. the GPipe pipeline over ``min(4, n_devices)`` stages, equal to
       ``sequential_apply`` within 1e-5, and one pipelined train step;
    5. Krum under in-round model poisoning.

    Prints one ``... OK`` line a phase. As in the JAX package, the later
    phases are skipped once earlier ones used a share of the time budget
    (``P2PFL_TPU_DRYRUN_BUDGET`` seconds, default 480). It runs no flash
    kernel: like the JAX package's dryrun it uses ``blockwise`` attention
    (the MoE) and the blockwise ``ring``.
    """
    from p2pfl_tpu_torch.learning.dataset import RandomIIDPartitionStrategy, synthetic_mnist
    from p2pfl_tpu_torch.parallel.mesh import Mesh
    from p2pfl_tpu_torch.parallel.simulation import MeshSimulation

    t_start = time.monotonic()
    budget = float(os.environ.get("P2PFL_TPU_DRYRUN_BUDGET", "480"))
    dev = resolve_device(device)
    if int(n_devices) != n_devices or n_devices < 1:
        raise ValueError(f"n_devices must be a positive integer, got {n_devices!r}")

    tp = 2 if n_devices % 2 == 0 and n_devices >= 4 else 1
    mesh = Mesh({"nodes": n_devices // tp, "model": tp}, device=dev)
    num_nodes = max(2 * (n_devices // tp), 4)
    parts = synthetic_mnist(n_train=num_nodes * 64, n_test=64).generate_partitions(num_nodes, RandomIIDPartitionStrategy)
    sim = MeshSimulation(
        mlp_model(seed=0, device=dev), parts, train_set_size=min(4, num_nodes), batch_size=16, seed=0, mesh=mesh,
        server_optimizer="fedadam", server_lr=0.003, device=dev,
    )
    res = sim.run(rounds=1, epochs=1, warmup=False)
    _expect(res.rounds == 1 and np.isfinite(res.test_loss[-1]), "the core round's test loss is not finite")
    print(f"dryrun_multichip OK: mesh={dict(mesh.shape)} nodes={num_nodes} "
          f"acc={res.test_acc[-1]:.3f} (server_opt=fedadam)")

    if time.monotonic() - t_start > budget * 0.5:
        print("dryrun: core phase consumed >half the time budget; skipping sequence/expert-parallel phases")
        return

    from p2pfl_tpu_torch.models.transformer import transformer_lm_model
    from p2pfl_tpu_torch.optim import adam
    from p2pfl_tpu_torch.parallel.sequence import make_sequence_parallel_train_step, shard_tokens

    seq_mesh = Mesh({"seq": n_devices}, device=dev)
    seq_len = 16 * n_devices
    lm = transformer_lm_model(seed=0, seq_len=seq_len, vocab_size=64, num_layers=1, num_heads=2, embed_dim=32,
                              attention_kind="ring", axis_name="seq", device=dev)
    opt = adam(1e-3)
    step = make_sequence_parallel_train_step(lm.apply, opt, seq_mesh, "seq")
    toks = shard_tokens(np.arange(2 * seq_len, dtype=np.int32).reshape(2, seq_len) % 64, seq_mesh, "seq")
    _, _, loss = step(lm.params, opt.init(lm.params), toks)
    _expect(np.isfinite(float(loss)), "the ring step's loss is not finite")
    print(f"dryrun sequence-parallel OK: seq={seq_len} over {n_devices} shards loss={float(loss):.3f}")

    if time.monotonic() - t_start > budget * 0.75:
        print("dryrun: skipping expert-parallel phase (time budget)")
        return

    from p2pfl_tpu_torch.models.moe import moe_lm_model, shard_moe_params

    moe = moe_lm_model(seed=0, seq_len=32, vocab_size=64, num_layers=2, num_heads=2, embed_dim=32,
                       num_experts=n_devices, device=dev)
    sharded = shard_moe_params(moe.params, Mesh({"expert": n_devices}, device=dev))
    with torch.no_grad():
        logits = moe.apply(sharded, torch.as_tensor(np.arange(2 * 32).reshape(2, 32) % 64, device=dev))
    _expect(bool(torch.isfinite(logits).all()), "the MoE logits are not finite")
    print(f"dryrun expert-parallel OK: {n_devices} experts on one device")

    if time.monotonic() - t_start > budget * 0.85:
        print("dryrun: skipping pipeline-parallel phase (time budget)")
        return

    from p2pfl_tpu_torch.parallel.pipeline import (
        make_pipeline_train_step,
        pipeline_apply,
        sequential_apply,
        stack_stage_params,
    )

    pp = min(4, n_devices)
    pp_mesh = Mesh({"stage": pp}, device=dev)
    d = 16
    rng = np.random.default_rng(0)
    stages = [{"w": torch.as_tensor(rng.normal(scale=0.5, size=(d, d)), dtype=torch.float32),
               "b": torch.zeros(d)} for _ in range(pp)]

    def block_fn(p: Dict[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
        return torch.tanh(x @ p["w"] + p["b"])

    stacked = stack_stage_params(stages, pp_mesh)
    xb = torch.as_tensor(rng.normal(size=(8 * pp, d)), dtype=torch.float32, device=dev)
    piped = pipeline_apply(stacked, xb, block_fn, pp_mesh, n_microbatches=4)
    seq = sequential_apply(stacked, xb, block_fn, pp)
    torch.testing.assert_close(piped, seq, atol=1e-5, rtol=0)
    pp_opt = adam(1e-3)
    pp_step = make_pipeline_train_step(block_fn, lambda o, t: torch.mean((o - t) ** 2), pp_opt, pp_mesh, 4)
    _, _, pp_loss = pp_step(stacked, pp_opt.init(stacked), xb, torch.zeros_like(xb))
    _expect(np.isfinite(float(pp_loss)), "the pipelined step's loss is not finite")
    print(f"dryrun pipeline-parallel OK: {pp} stages, loss={float(pp_loss):.3f}")

    if time.monotonic() - t_start > budget * 0.92:
        print("dryrun: skipping robust-aggregation phase (time budget)")
        return

    from p2pfl_tpu_torch.ops import aggregation as agg_ops

    byz = np.zeros(num_nodes, np.float32)
    byz[:: max(num_nodes // 2, 1)] = 1.0  # a couple of attackers
    rob = MeshSimulation(
        mlp_model(seed=0, device=dev), parts, train_set_size=min(4, num_nodes), batch_size=16, seed=0, mesh=mesh,
        aggregate_fn=lambda s, w: agg_ops.krum(s, w, num_byzantine=1, num_selected=2)[0],
        byzantine_mask=byz, byzantine_attack="scaled", device=dev,
    )
    rob_res = rob.run(rounds=1, epochs=1, warmup=False)
    _expect(np.isfinite(rob_res.test_loss[-1]), "the robust round's test loss is not finite")
    print(f"dryrun robust-aggregation OK: krum over {int(byz.sum())} poisoned of {num_nodes} nodes, "
          f"acc={rob_res.test_acc[-1]:.3f}")
