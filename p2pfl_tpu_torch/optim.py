"""Functional Adam with ``optax.adam``'s arithmetic, as functions
(:func:`adam_step`) and as an optax-style transformation (:func:`adam`).

The state is plain tensors (``mu``, ``nu``: one tensor per parameter;
``count``: int32), so the population can keep it stacked ``[N, ...]`` and
carry it between rounds, and a test can hold it against optax's state.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import torch

Params = Dict[str, torch.Tensor]
B1, B2, EPS = 0.9, 0.999, 1e-8  # optax.adam defaults (eps_root 0)


@dataclass
class AdamState:
    """``optax.ScaleByAdamState`` counterpart: first and second moments and
    the step count (a scalar, or ``[N]`` for a stacked population)."""

    mu: Params
    nu: Params
    count: torch.Tensor


def adam_init(params: Params, count_shape: tuple = ()) -> AdamState:
    return AdamState(
        mu={k: torch.zeros_like(v) for k, v in params.items()},
        nu={k: torch.zeros_like(v) for k, v in params.items()},
        count=torch.zeros(count_shape, dtype=torch.int32, device=next(iter(params.values())).device),
    )


@torch.no_grad()
def adam_updates(grads: Params, state: AdamState, lr: float) -> tuple[Params, AdamState]:
    """``optax.adam(lr).update``: the updates ``-lr u`` and the new state.

    Same order of operations as optax: ``mu = (1-b1) g + b1 mu``,
    ``nu = (1-b2) g^2 + b2 nu``, bias corrections ``1 - b**count`` computed
    in f32, ``u = mu_hat / (sqrt(nu_hat) + eps)``.
    """
    count = state.count + 1
    c = count.float()
    bc1 = 1.0 - torch.pow(torch.tensor(B1, dtype=torch.float32, device=c.device), c)
    bc2 = 1.0 - torch.pow(torch.tensor(B2, dtype=torch.float32, device=c.device), c)
    updates, mu, nu = {}, {}, {}
    for name, g in grads.items():
        mu[name] = (1 - B1) * g + B1 * state.mu[name]
        nu[name] = (1 - B2) * (g * g) + B2 * state.nu[name]
        u = (mu[name] / bc1.to(g.dtype)) / (torch.sqrt(nu[name] / bc2.to(g.dtype)) + EPS)
        updates[name] = (-lr) * u
    return updates, AdamState(mu=mu, nu=nu, count=count)


@torch.no_grad()
def apply_updates(params: Params, updates: Params) -> Params:
    """``optax.apply_updates``: ``p + u`` in f32, cast back to p's dtype."""
    return {name: (p + updates[name]).to(p.dtype) for name, p in params.items()}


def adam_step(params: Params, grads: Params, state: AdamState, lr: float) -> tuple[Params, AdamState]:
    """One ``optax.adam(lr)`` update; returns new params and state
    (``p + (-lr u)``)."""
    updates, state = adam_updates(grads, state, lr)
    return apply_updates(params, updates), state


@dataclass(frozen=True)
class Adam:
    """``optax.adam(lr)`` as an object with optax's ``GradientTransformation``
    methods: ``init(params)`` and ``update(grads, state, params)``."""

    lr: float

    def init(self, params: Params) -> AdamState:
        return adam_init(params)

    def update(self, grads: Params, state: AdamState, params: Params = None) -> tuple[Params, AdamState]:
        return adam_updates(grads, state, self.lr)


def adam(lr: float) -> Adam:
    """``optax.adam(lr)`` counterpart (b1 0.9, b2 0.999, eps 1e-8)."""
    return Adam(lr)
