"""Functional optimizers with optax's arithmetic: Adam (:func:`adam`), SGD
with optional heavy-ball momentum (:func:`sgd`, ``optax.sgd``: ``trace``,
not Nesterov) and Yogi (:func:`yogi`, ``optax.yogi``: the sign update and a 1e-6 initial
accumulator).

Each optimizer has optax's ``GradientTransformation`` methods,
``init(params)`` and ``update(grads, state, params) -> (updates, state)``,
with the updates already scaled by ``-lr``; :func:`apply_updates` adds them.
The state is plain tensors in a dataclass, so a population can keep it
stacked ``[N, ...]`` (:func:`state_map` slices and writes it back) and a
test can hold it against optax's state.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional

import torch

Params = Dict[str, torch.Tensor]
B1, B2, EPS = 0.9, 0.999, 1e-8  # optax.adam defaults (eps_root 0)


@dataclass
class AdamState:
    """``optax.ScaleByAdamState`` counterpart (Adam and Yogi): first and
    second moments and the step count (a scalar, or ``[N]`` for a stacked
    population)."""

    mu: Params
    nu: Params
    count: torch.Tensor


@dataclass
class TraceState:
    """``optax.TraceState`` counterpart: the momentum trace, or ``None`` for
    SGD without momentum (optax keeps an empty state then)."""

    trace: Optional[Params]


def state_map(fn: Callable[..., Any], state: Any, *rest: Any) -> Any:
    """Apply ``fn`` to every tensor of an optimizer state (and the matching
    tensors of ``rest``, states of the same structure), keeping the
    structure: dataclasses, dicts and ``None`` leaves."""
    if state is None:
        return None
    if isinstance(state, torch.Tensor):
        return fn(state, *rest)
    if isinstance(state, dict):
        return {k: state_map(fn, v, *(r[k] for r in rest)) for k, v in state.items()}
    if dataclasses.is_dataclass(state):
        return type(state)(**{
            f.name: state_map(fn, getattr(state, f.name), *(getattr(r, f.name) for r in rest))
            for f in dataclasses.fields(state)
        })
    raise TypeError(f"unsupported optimizer state node {type(state).__name__}")


def _bias_correction(decay: float, count: torch.Tensor) -> torch.Tensor:
    """``1 - decay ** count`` in f32, as optax computes it."""
    return 1.0 - torch.pow(torch.tensor(decay, dtype=torch.float32, device=count.device), count.float())


def _zeros_count(params: Params) -> torch.Tensor:
    return torch.zeros((), dtype=torch.int32, device=next(iter(params.values())).device)


@torch.no_grad()
def _moment_updates(
    grads: Params, state: AdamState, lr: float, b1: float, b2: float, eps: float,
    second_moment: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
) -> tuple[Params, AdamState]:
    """The update loop Adam and Yogi share, in optax's order of operations:
    ``mu = (1-b1) g + b1 mu``, ``nu = second_moment(nu, g^2)``, bias
    corrections ``1 - b**count`` computed in f32, ``u = mu_hat /
    (sqrt(nu_hat) + eps)``; returns the updates ``-lr u`` and the new
    state."""
    count = state.count + 1
    bc1, bc2 = _bias_correction(b1, count), _bias_correction(b2, count)
    updates, mu, nu = {}, {}, {}
    for name, g in grads.items():
        mu[name] = (1 - b1) * g + b1 * state.mu[name]
        nu[name] = second_moment(state.nu[name], g * g)
        u = (mu[name] / bc1.to(g.dtype)) / (torch.sqrt(nu[name] / bc2.to(g.dtype)) + eps)
        updates[name] = (-lr) * u
    return updates, AdamState(mu=mu, nu=nu, count=count)


@torch.no_grad()
def apply_updates(params: Params, updates: Params) -> Params:
    """``optax.apply_updates``: ``p + u`` in f32, cast back to p's dtype."""
    return {name: (p + updates[name]).to(p.dtype) for name, p in params.items()}


@dataclass(frozen=True)
class Adam:
    """``optax.adam(lr, b1, b2, eps)``."""

    lr: float
    b1: float = B1
    b2: float = B2
    eps: float = EPS

    def init(self, params: Params) -> AdamState:
        return AdamState(mu={k: torch.zeros_like(v) for k, v in params.items()},
                         nu={k: torch.zeros_like(v) for k, v in params.items()}, count=_zeros_count(params))

    def update(self, grads: Params, state: AdamState, params: Params = None) -> tuple[Params, AdamState]:
        b2 = self.b2
        return _moment_updates(grads, state, self.lr, self.b1, b2, self.eps,
                               lambda v, g2: (1 - b2) * g2 + b2 * v)


@dataclass(frozen=True)
class Sgd:
    """``optax.sgd(lr, momentum)``: ``trace = g + momentum * trace`` (when
    ``momentum`` is set), then ``-lr * trace``."""

    lr: float
    momentum: Optional[float] = None

    def init(self, params: Params) -> TraceState:
        if self.momentum is None:
            return TraceState(trace=None)
        return TraceState(trace={k: torch.zeros_like(v) for k, v in params.items()})

    @torch.no_grad()
    def update(self, grads: Params, state: TraceState, params: Params = None) -> tuple[Params, TraceState]:
        if self.momentum is None:
            return {name: (-self.lr) * g for name, g in grads.items()}, state
        trace = {name: g + self.momentum * state.trace[name] for name, g in grads.items()}
        return {name: (-self.lr) * t for name, t in trace.items()}, TraceState(trace=trace)


@dataclass(frozen=True)
class Yogi:
    """``optax.yogi(lr, b1, b2, eps)``: Adam's first moment, the second
    moment ``v - (1-b2) sign(v - g^2) g^2``, both starting at 1e-6."""

    lr: float
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-3
    initial_accumulator_value: float = 1e-6

    def init(self, params: Params) -> AdamState:
        full = {k: torch.full_like(v, self.initial_accumulator_value) for k, v in params.items()}
        return AdamState(mu=full, nu={k: v.clone() for k, v in full.items()}, count=_zeros_count(params))

    def update(self, grads: Params, state: AdamState, params: Params = None) -> tuple[Params, AdamState]:
        b2 = self.b2
        return _moment_updates(grads, state, self.lr, self.b1, b2, self.eps,
                               lambda v, g2: v - (1 - b2) * torch.sign(v - g2) * g2)


def adam(lr: float, b1: float = B1, b2: float = B2, eps: float = EPS) -> Adam:
    """``optax.adam(lr, b1, b2, eps)`` counterpart."""
    return Adam(lr, b1, b2, eps)


def sgd(lr: float, momentum: Optional[float] = None) -> Sgd:
    """``optax.sgd(lr, momentum)`` counterpart (no Nesterov)."""
    return Sgd(lr, momentum)


def yogi(lr: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-3) -> Yogi:
    """``optax.yogi(lr, b1, b2, eps)`` counterpart."""
    return Yogi(lr, b1, b2, eps)
