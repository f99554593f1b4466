"""Functional Adam with ``optax.adam``'s arithmetic.

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
def adam_step(params: Params, grads: Params, state: AdamState, lr: float) -> tuple[Params, AdamState]:
    """One ``optax.adam(lr)`` update; returns new params and state.

    Same order of operations as optax: ``mu = (1-b1) g + b1 mu``,
    ``nu = (1-b2) g^2 + b2 nu``, bias corrections ``1 - b**count`` computed
    in f32, ``u = mu_hat / (sqrt(nu_hat) + eps)``, ``p - lr u``.
    """
    count = state.count + 1
    c = count.float()
    bc1 = 1.0 - torch.pow(torch.tensor(B1, dtype=torch.float32, device=c.device), c)
    bc2 = 1.0 - torch.pow(torch.tensor(B2, dtype=torch.float32, device=c.device), c)
    new_p, mu, nu = {}, {}, {}
    for name, p in params.items():
        g = grads[name]
        mu[name] = (1 - B1) * g + B1 * state.mu[name]
        nu[name] = (1 - B2) * (g * g) + B2 * state.nu[name]
        u = (mu[name] / bc1.to(g.dtype)) / (torch.sqrt(nu[name] / bc2.to(g.dtype)) + EPS)
        new_p[name] = (p + (-lr) * u).to(p.dtype)
    return new_p, AdamState(mu=mu, nu=nu, count=count)
