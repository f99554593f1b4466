"""Sequence parallelism: run a model over a sequence cut into the shards of a
mesh axis (counterpart of ``p2pfl_tpu/parallel/sequence.py``).

The JAX package wraps the model in ``shard_map`` with the sequence axis
mapped, so each device runs every per-position op on its shard and only
attention (the ring) crosses shards. The port runs it two ways, by what the
``seq_axis`` of the mesh is:

* **Over ranks** (a mesh from :func:`~p2pfl_tpu_torch.parallel.mesh.
  make_mesh` in a joined group, its ``seq_axis`` spanning the W ranks): as
  the JAX package does. :func:`shard_tokens` gives each rank its ``[B, S /
  W]`` slice, the wrappers take and return local shards, and the loss
  shifts the targets across the shard boundary with a ``ppermute`` and
  sums its sum and count over the ranks (``psum``).
  :func:`make_sequence_parallel_train_step` sums the parameters' gradients
  over the ranks before the optimizer, so every rank takes the same step,
  and broadcasts rank 0's parameters on its first call.
* **On one process** (virtual shards): the wrappers run the model on the
  *global* ``[B, S]`` tokens with the mesh's axes bound
  (:meth:`~p2pfl_tpu_torch.parallel.mesh.Mesh.bind`): per-position ops do
  not care about shards, and ``ring_attention`` cuts its inputs into the
  axis' shards itself.

The loss keeps the JAX arithmetic: every shard scores its positions against
the next token (across shard boundaries), the global last position is
masked, and the mean is over ``B * (S - 1)`` tokens.

A ``batch_axis`` is validated (the mesh must have it and the batch must
divide by its size). Where it spans ranks too (``make_mesh((Nb, Ns),
("batch", "seq"))``, or a ranked ``batch`` axis beside a virtual
``seq``), each rank holds ``[B / Nb, S / Ns]`` tokens: the ring and the
shifted targets run in the ``seq`` axis' sub-group, the loss sums its sum
and count over ``seq`` and then over ``batch`` (as the JAX package's
``psum`` over both axes), and the train step sums the gradients over the
whole world, every rank holding the parameters whole (``P()``). On one
process the batch axis collapses: the batch is not split.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch

from p2pfl_tpu_torch.ops.ring_attention import ring_attention
from p2pfl_tpu_torch.optim import apply_updates
from p2pfl_tpu_torch.parallel import collectives
from p2pfl_tpu_torch.parallel.mesh import Mesh

Params = dict


def _check_tokens(tokens: torch.Tensor, mesh: Mesh, seq_axis: str, batch_axis: Optional[str],
                  local: bool = True) -> None:
    """``local``: over ranks the tokens are this rank's shard, whose length
    (and, over batch ranks, batch) need not divide by the axis."""
    if tokens.dim() != 2:
        raise ValueError(f"tokens must be [B, S], got shape {tuple(tokens.shape)}")
    n = mesh.check_axis(seq_axis)
    if not (local and mesh.spans(seq_axis)) and tokens.shape[1] % n:
        raise ValueError(f"sequence length {tokens.shape[1]} does not divide by the {seq_axis!r} axis size {n}")
    if (batch_axis is not None and not (local and mesh.spans(batch_axis))
            and tokens.shape[0] % mesh.check_axis(batch_axis)):
        raise ValueError(
            f"batch {tokens.shape[0]} does not divide by the {batch_axis!r} axis size "
            f"{mesh.shape[batch_axis]}"
        )


def _check_axes(mesh: Mesh, seq_axis: str, batch_axis: Optional[str]) -> None:
    mesh.check_axis(seq_axis)
    if batch_axis is not None:
        mesh.check_axis(batch_axis)
        if batch_axis == seq_axis:
            raise ValueError(f"batch_axis and seq_axis must differ, both are {seq_axis!r}")


def sequence_parallel_attention(
    mesh: Mesh, seq_axis: str = "seq", causal: bool = True, block_k: int = 512,
    impl: str = "blockwise",
) -> Callable:
    """Return ``f(q, k, v) -> out``: exact attention over ``[B, S, H, D]``
    inputs whose S is sharded over ``seq_axis`` (ring attention); over ranks
    ``q, k, v`` and ``out`` are this rank's shards."""
    _check_axes(mesh, seq_axis, None)

    def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        with mesh.bind():
            return ring_attention(q, k, v, seq_axis, causal=causal, block_k=block_k, impl=impl)

    return attention


def sequence_parallel_apply(
    model_apply: Callable, mesh: Mesh, seq_axis: str = "seq", batch_axis: Optional[str] = None,
) -> Callable:
    """Wrap ``model_apply(params, tokens) -> logits`` to run with the
    sequence sharded over ``seq_axis`` (over ranks: this rank's ``[B, S /
    W]`` tokens in, its logits out). The model must use a ring attention
    kind with ``axis_name=seq_axis``."""
    _check_axes(mesh, seq_axis, batch_axis)

    def apply(params: Params, tokens: torch.Tensor) -> torch.Tensor:
        _check_tokens(tokens, mesh, seq_axis, batch_axis)
        with mesh.bind():
            return model_apply(params, tokens)

    return apply


def sequence_parallel_lm_loss(
    model_apply: Callable, mesh: Mesh, seq_axis: str = "seq", batch_axis: Optional[str] = None,
) -> Callable:
    """Return ``loss_fn(params, tokens) -> scalar``: next-token cross entropy
    under sequence parallelism, the same value on every rank.

    Over ranks (``tokens`` this rank's shard) the targets roll left around
    the ring, as in the JAX package: each rank's end with the first token of
    its right neighbour, sent by ``ppermute``; the global last position is
    masked, and the masked sum and the count are summed over the ranks (the
    gradient rule is :func:`~p2pfl_tpu_torch.parallel.collectives.psum`'s).
    On one process that is ``tokens`` shifted by one, the last position's
    wrapped target masked."""
    apply = sequence_parallel_apply(model_apply, mesh, seq_axis, batch_axis)
    group = mesh.axis_process_group(seq_axis)
    batch_group = mesh.axis_process_group(batch_axis)

    def loss_fn(params: Params, tokens: torch.Tensor) -> torch.Tensor:
        logits = apply(params, tokens)  # [B, S, V] (over ranks: this rank's S / W)
        b, s = tokens.shape
        n, idx = (mesh.axis_ranks(seq_axis), mesh.axis_rank(seq_axis)) if group is not None else (1, 0)
        if group is not None:
            first_of_next = collectives.ppermute(tokens[:, :1].contiguous(), [(i, (i - 1) % n) for i in range(n)],
                                                 group)
            targets = torch.cat([tokens[:, 1:], first_of_next], dim=1).long()
        else:
            targets = torch.roll(tokens, -1, dims=1).long()
        logp = torch.log_softmax(logits.float(), dim=-1)
        nll = -torch.gather(logp, -1, targets[..., None])[..., 0]
        pos = idx * s + torch.arange(s, device=nll.device)
        mask = (pos < n * s - 1).float()[None, :]
        if group is None and batch_group is None:
            return (nll * mask).sum() / max(float(b * (s - 1)), 1.0)
        total = torch.stack([(nll * mask).sum(), b * mask.sum()])
        for g in (group, batch_group):  # over seq, then over batch
            if g is not None:
                total = collectives.psum(total, g)
        return total[0] / torch.clamp(total[1], min=1.0)

    return loss_fn


def make_sequence_parallel_train_step(
    model_apply: Callable, optimizer, mesh: Mesh, seq_axis: str = "seq",
    batch_axis: Optional[str] = None,
) -> Callable:
    """LM train step under sequence parallelism.

    Returns ``step(params, opt_state, tokens) -> (params, opt_state, loss)``
    (new params and state; the inputs are not modified). ``optimizer`` has
    optax's ``init`` / ``update(grads, state, params)``, e.g.
    :func:`p2pfl_tpu_torch.optim.adam`. Over ranks ``tokens`` is this rank's
    shard; the first call broadcasts rank 0's ``params``, and every step
    sums the gradients over every rank of the mesh (each holds its shard's
    part; over ``batch`` x ``seq`` both axes') before ``optimizer.update``,
    so every rank takes the same step.
    """
    loss_fn = sequence_parallel_lm_loss(model_apply, mesh, seq_axis, batch_axis)
    other = [a for a in mesh.rank_axes if a not in (seq_axis, batch_axis)]
    if other:  # its rows would hold the same gradients, summed twice over the world
        raise ValueError(f"the mesh spans the ranks along {other}: pass it as batch_axis, or use a mesh without it")
    group = mesh.group if mesh.rank_axes else None
    synced = group is None  # whether the ranks hold the same parameters yet

    def step(params: Params, opt_state, tokens: torch.Tensor) -> Tuple[Params, object, torch.Tensor]:
        nonlocal synced
        if not synced:
            params = collectives.broadcast_tree(params, src=0, group=group)
            synced = True
        leaves = {name: p.detach().requires_grad_(True) for name, p in params.items()}
        loss = loss_fn(leaves, tokens)
        grads = dict(zip(leaves, torch.autograd.grad(loss, tuple(leaves.values()))))
        if group is not None:
            grads = _sum_over_ranks(grads, group)
        updates, opt_state = optimizer.update(grads, opt_state, params)
        return apply_updates(params, updates), opt_state, loss.detach()

    return step


def _sum_over_ranks(grads: Params, group) -> Params:
    """Each gradient summed over the ranks of ``group``, as one ``all_reduce``
    of the leaves side by side (in their widest dtype, each cast back)."""
    flat = torch.cat([g.reshape(-1) for g in grads.values()])
    collectives.all_reduce(flat, group=group)
    parts = flat.split([g.numel() for g in grads.values()])
    return {name: part.view(g.shape).to(g.dtype) for (name, g), part in zip(grads.items(), parts)}


def shard_tokens(tokens, mesh: Mesh, seq_axis: str = "seq", batch_axis: Optional[str] = None) -> torch.Tensor:
    """Place a ``[B, S]`` token batch (numpy or torch) on the mesh's device,
    checking that S divides by the ``seq_axis`` size (and B by the
    ``batch_axis`` size). Over ranks each rank keeps its ``[B / Nb, S /
    Ns]`` slice: at ``seq`` coordinate ``j`` positions ``[j * S / Ns, (j +
    1) * S / Ns)``, at ``batch`` coordinate ``i`` rows ``[i * B / Nb, (i +
    1) * B / Nb)`` (``Nb`` 1 unless ``batch_axis`` spans ranks)."""
    t = tokens if isinstance(tokens, torch.Tensor) else torch.as_tensor(np.asarray(tokens))
    if t.dtype.is_floating_point or t.dtype == torch.bool:
        raise ValueError(f"tokens must be integers, got {t.dtype}")
    _check_axes(mesh, seq_axis, batch_axis)
    _check_tokens(t, mesh, seq_axis, batch_axis, local=False)
    if mesh.spans(batch_axis):
        t = t.chunk(mesh.axis_ranks(batch_axis), dim=0)[mesh.axis_rank(batch_axis)]
    if mesh.spans(seq_axis):
        t = t.chunk(mesh.axis_ranks(seq_axis), dim=1)[mesh.axis_rank(seq_axis)]
    return t.contiguous().to(mesh.device)
