"""Sequence parallelism on one card: run a model over a sequence cut into the
shards of a mesh axis (counterpart of ``p2pfl_tpu/parallel/sequence.py``).

The JAX package wraps the model in ``shard_map`` with the sequence axis
mapped, so each device runs every per-position op on its shard and only
attention (the ring) crosses shards. On one card the wrappers here run the
model on the *global* ``[B, S]`` tokens with the mesh's axes bound
(:meth:`~p2pfl_tpu_torch.parallel.mesh.Mesh.bind`): per-position ops do not
care about shards, and ``ring_attention`` cuts its inputs into the axis'
shards itself. The loss keeps the JAX arithmetic: every shard scores its
positions against the next token (across shard boundaries), the global last
position is masked, and the mean is over ``B * (S - 1)`` tokens.

A ``batch_axis`` is validated (the mesh must have it and the batch must
divide by its size) and otherwise collapses: on one card the batch is not
split.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch

from p2pfl_tpu_torch.ops.ring_attention import ring_attention
from p2pfl_tpu_torch.optim import apply_updates
from p2pfl_tpu_torch.parallel.mesh import Mesh

Params = dict


def _check_tokens(tokens: torch.Tensor, mesh: Mesh, seq_axis: str, batch_axis: Optional[str]) -> None:
    if tokens.dim() != 2:
        raise ValueError(f"tokens must be [B, S], got shape {tuple(tokens.shape)}")
    n = mesh.check_axis(seq_axis)
    if tokens.shape[1] % n:
        raise ValueError(f"sequence length {tokens.shape[1]} does not divide by the {seq_axis!r} axis size {n}")
    if batch_axis is not None and tokens.shape[0] % mesh.check_axis(batch_axis):
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
    inputs whose S is sharded over ``seq_axis`` (ring attention)."""
    _check_axes(mesh, seq_axis, None)

    def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        with mesh.bind():
            return ring_attention(q, k, v, seq_axis, causal=causal, block_k=block_k, impl=impl)

    return attention


def sequence_parallel_apply(
    model_apply: Callable, mesh: Mesh, seq_axis: str = "seq", batch_axis: Optional[str] = None,
) -> Callable:
    """Wrap ``model_apply(params, tokens) -> logits`` to run with the
    sequence sharded over ``seq_axis``. The model must use a ring attention
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
    under sequence parallelism (the JAX package rolls the targets left around
    the ring; globally that is ``tokens`` shifted by one, the last position's
    wrapped target masked)."""
    apply = sequence_parallel_apply(model_apply, mesh, seq_axis, batch_axis)

    def loss_fn(params: Params, tokens: torch.Tensor) -> torch.Tensor:
        logits = apply(params, tokens)  # [B, S, V]
        b, s = tokens.shape
        targets = torch.roll(tokens, -1, dims=1).long()
        logp = torch.log_softmax(logits.float(), dim=-1)
        nll = -torch.gather(logp, -1, targets[..., None])[..., 0]
        mask = (torch.arange(s, device=nll.device) < s - 1).float()[None, :]
        count = max(float(b * (s - 1)), 1.0)
        return (nll * mask).sum() / count

    return loss_fn


def make_sequence_parallel_train_step(
    model_apply: Callable, optimizer, mesh: Mesh, seq_axis: str = "seq",
    batch_axis: Optional[str] = None,
) -> Callable:
    """LM train step under sequence parallelism.

    Returns ``step(params, opt_state, tokens) -> (params, opt_state, loss)``
    (new params and state; the inputs are not modified). ``optimizer`` has
    optax's ``init`` / ``update(grads, state, params)``, e.g.
    :func:`p2pfl_tpu_torch.optim.adam`.
    """
    loss_fn = sequence_parallel_lm_loss(model_apply, mesh, seq_axis, batch_axis)

    def step(params: Params, opt_state, tokens: torch.Tensor) -> Tuple[Params, object, torch.Tensor]:
        leaves = {name: p.detach().requires_grad_(True) for name, p in params.items()}
        loss = loss_fn(leaves, tokens)
        grads = dict(zip(leaves, torch.autograd.grad(loss, tuple(leaves.values()))))
        updates, opt_state = optimizer.update(grads, opt_state, params)
        return apply_updates(params, updates), opt_state, loss.detach()

    return step


def shard_tokens(tokens, mesh: Mesh, seq_axis: str = "seq", batch_axis: Optional[str] = None) -> torch.Tensor:
    """Place a ``[B, S]`` token batch (numpy or torch) on the mesh's device,
    checking that S divides by the ``seq_axis`` size (and B by the
    ``batch_axis`` size)."""
    t = tokens if isinstance(tokens, torch.Tensor) else torch.as_tensor(np.asarray(tokens))
    if t.dtype.is_floating_point or t.dtype == torch.bool:
        raise ValueError(f"tokens must be integers, got {t.dtype}")
    _check_axes(mesh, seq_axis, batch_axis)
    _check_tokens(t, mesh, seq_axis, batch_axis)
    return t.to(mesh.device)
