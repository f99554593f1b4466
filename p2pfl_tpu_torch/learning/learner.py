"""The learner's math (counterpart of the loss and gradient functions of
``p2pfl_tpu/learning/learner.py``): the masked classification and LM
losses, FedProx's proximal term and its gradient, and DP-SGD's private
gradient.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch
from torch.func import grad_and_value, vmap

from p2pfl_tpu_torch.models.transformer import causal_lm_loss

Params = Dict[str, torch.Tensor]
BatchLoss = Callable[[Params, torch.Tensor, torch.Tensor, torch.Tensor], torch.Tensor]


def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Masked mean cross entropy in f32 (``mask`` zeroes padded rows)."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, labels[:, None].long())[:, 0]
    return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)


def masked_lm_loss(logits: torch.Tensor, tokens: torch.Tensor, seq_mask: torch.Tensor) -> torch.Tensor:
    """Next-token CE over ``logits [B, L, V]`` / ``tokens [B, L]`` with a
    per-sequence validity mask ``[B]`` (padded rows contribute zero)."""
    mask = seq_mask[:, None].expand(tokens.shape)
    return causal_lm_loss(logits, tokens, mask)


def fedprox_penalty(params: Params, anchor: Params, mu: float) -> torch.Tensor:
    """FedProx's proximal term ``mu/2 * ||w - w_anchor||^2`` in f32."""
    sq = sum(((p.float() - anchor[name].float()) ** 2).sum() for name, p in params.items())
    return 0.5 * mu * sq


def fedprox_grad(grads: Params, params: Params, anchor: Params, mu: float) -> Params:
    """``grads`` plus the proximal term's gradient ``mu * (w - w_anchor)``,
    added after DP's per-example clip so the regularizer is never clipped."""
    return {
        name: g + mu * (params[name].to(g.dtype) - anchor[name].to(g.dtype))
        for name, g in grads.items()
    }


def _per_example_vmap(batch_loss_fn: BatchLoss, params: Params, x, y) -> Tuple[torch.Tensor, Params]:
    """Per-example ``(losses [B], grads {name: [B, ...]})`` from one
    ``torch.func.vmap`` of ``grad`` over single-example batches."""

    def example_loss(p, xi, yi):
        return batch_loss_fn(p, xi[None], yi[None], torch.ones(1, device=xi.device))

    grads, losses = vmap(grad_and_value(example_loss), in_dims=(None, 0, 0))(params, x, y)
    return losses, grads


def _per_example_loop(batch_loss_fn: BatchLoss, params: Params, x, y) -> Tuple[torch.Tensor, Params]:
    """The same as :func:`_per_example_vmap`, one example at a time: for
    models whose ``autograd.Function`` (the flash kernels) has no vmap rule."""
    names = list(params)
    losses, per = [], {name: [] for name in names}
    for i in range(x.shape[0]):
        leaves = {name: p.detach().requires_grad_(True) for name, p in params.items()}
        with torch.enable_grad():
            loss = batch_loss_fn(leaves, x[i:i + 1], y[i:i + 1], torch.ones(1, device=x.device))
            gs = torch.autograd.grad(loss, [leaves[n] for n in names])
        losses.append(loss.detach())
        for name, g in zip(names, gs):
            per[name].append(g)
    return torch.stack(losses), {name: torch.stack(gs) for name, gs in per.items()}


def dp_grads(
    batch_loss_fn: BatchLoss,
    params: Params,
    x: torch.Tensor,
    y: torch.Tensor,
    w: torch.Tensor,
    gen: torch.Generator,
    clip_norm: float,
    noise_multiplier: float,
    per_example: str = "vmap",
) -> Tuple[torch.Tensor, Params]:
    """DP-SGD ``(loss, grads)``: per-example gradients clipped to global L2
    ``clip_norm``, their masked mean, plus Gaussian noise of std
    ``clip_norm * noise_multiplier / batch`` drawn from ``gen`` (one draw per
    parameter, in the dict's order; on the CPU, then moved to the
    parameters' device) — Abadi et al. 2016.

    ``per_example``: ``"vmap"`` (one ``torch.func.vmap`` over the batch) or
    ``"loop"`` (one backward per example, for the flash kernels); the same
    arithmetic. ``w`` is the ``[B]`` 0/1 validity mask. Returns the masked
    mean per-example loss and the private gradient.
    """
    per = {"vmap": _per_example_vmap, "loop": _per_example_loop}[per_example]
    losses, grads = per(batch_loss_fn, params, x, y)
    denom = torch.clamp(w.sum(), min=1.0)
    loss = (losses.float() * w).sum() / denom
    sq = sum(g.reshape(g.shape[0], -1).float().pow(2).sum(dim=1) for g in grads.values())
    norms = torch.sqrt(sq)  # [B] per-example global norm
    scale = torch.clamp(clip_norm / torch.clamp(norms, min=1e-12), max=1.0) * w
    noise_std = clip_norm * noise_multiplier / denom
    out = {}
    for name, g in grads.items():
        mean = torch.tensordot(scale, g.float(), dims=1) / denom
        if noise_multiplier > 0.0:
            noise = torch.randn(mean.shape, generator=gen, dtype=torch.float32).to(mean.device)
            mean = mean + noise_std * noise
        out[name] = mean.detach()
    return loss.detach(), out
