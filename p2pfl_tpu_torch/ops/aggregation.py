"""Aggregation math over stacked parameters (counterpart of
``p2pfl_tpu/ops/aggregation.py``).

A stacked parameter set is a dict of tensors, each with a leading
``num_models`` axis. Every rule reduces in f32 and casts back to each leaf's
dtype, as in the JAX package; rules that flatten the stack (Krum, the
geometric median) concatenate the leaves in the dict's order.

Under a bound :class:`~p2pfl_tpu_torch.parallel.tensor_parallel.ModelSplit`
(a population whose kernels are split over ``model`` ranks) the stacked
leaves are this rank's slices: the elementwise rules need nothing more, and
Krum's distances and the geometric median's norms sum the split leaves'
part over the ranks (:func:`~p2pfl_tpu_torch.parallel.tensor_parallel.
whole_gram`, :func:`~p2pfl_tpu_torch.parallel.tensor_parallel.whole_sq_sum`).
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

from p2pfl_tpu_torch.parallel.tensor_parallel import active, whole_gram, whole_sq_sum

Params = Dict[str, torch.Tensor]


def tree_stack(trees: List[Params]) -> Params:
    """Stack a list of parameter dicts with the same names along a new axis 0."""
    return {name: torch.stack([t[name] for t in trees]) for name in trees[0]}


def tree_unstack(tree: Params, n: int) -> List[Params]:
    """Inverse of :func:`tree_stack`."""
    return [{name: x[i] for name, x in tree.items()} for i in range(n)]


def _bcast(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return w.to(x.device).reshape((-1,) + (1,) * (x.dim() - 1))


def fedavg(stacked: Params, weights: torch.Tensor) -> Params:
    """Sample-weighted mean over the model axis.

    The weights are normalized in f32, each leaf is averaged in f32 and cast
    back to its own dtype, as in the JAX package.
    """
    w = torch.as_tensor(weights, dtype=torch.float32)
    norm = w / torch.clamp(w.sum(), min=1e-12)
    return {name: (x.float() * _bcast(norm, x)).sum(dim=0).to(x.dtype) for name, x in stacked.items()}


def fedavg_masked(stacked: Params, weights: torch.Tensor, mask: torch.Tensor) -> Params:
    """FedAvg over the models where ``mask`` is nonzero (weights times mask)."""
    w = torch.as_tensor(weights, dtype=torch.float32)
    return fedavg(stacked, w * torch.as_tensor(mask, dtype=torch.float32, device=w.device))


def fedmedian(stacked: Params) -> Params:
    """Coordinate-wise median over the model axis; with an even count, the
    mean of the two middle values (``jnp.median``'s rule, not
    ``torch.median``'s lower one)."""
    out = {}
    for name, x in stacked.items():
        xs = torch.sort(x.float(), dim=0).values
        n = xs.shape[0]
        med = xs[n // 2] if n % 2 else 0.5 * (xs[n // 2 - 1] + xs[n // 2])
        out[name] = med.to(x.dtype)
    return out


def trimmed_mean(stacked: Params, trim: int) -> Params:
    """Coordinate-wise trimmed mean: drop the ``trim`` largest and smallest
    values per coordinate, then average (Yin et al. 2018)."""
    out = {}
    for name, x in stacked.items():
        n = x.shape[0]
        if trim < 0 or 2 * trim >= n:
            raise ValueError(f"trim {trim} leaves no model of {n}")
        xs = torch.sort(x.float(), dim=0).values
        out[name] = xs[trim:n - trim].mean(dim=0).to(x.dtype)
    return out


def _flatten_stack(stacked: Params) -> torch.Tensor:
    """``[num_models, total_params]`` f32 matrix from a stacked dict."""
    leaves = list(stacked.values())
    n = leaves[0].shape[0]
    return torch.cat([leaf.reshape(n, -1).float() for leaf in leaves], dim=1)


def _row_sums(cols: torch.Tensor, stacked: Params) -> torch.Tensor:
    """Row sums of ``cols`` (``[K, total]``, laid out as :func:`_flatten_stack`
    lays out ``stacked``) over whole models."""
    if active() is None:
        return cols.sum(dim=1)
    sizes = [math.prod(leaf.shape[1:]) for leaf in stacked.values()]
    return whole_sq_sum({name: c.sum(dim=1) for name, c in zip(stacked, torch.split(cols, sizes, dim=1))})


def krum_select(stacked: Params, num_byzantine: int, num_selected: int = 1) -> torch.Tensor:
    """(Multi-)Krum: indices ``[num_selected]`` of the models with the lowest
    sums of squared distances to their ``n - num_byzantine - 2`` nearest
    neighbours (Blanchard et al. 2017)."""
    sq, gram = whole_gram(stacked)
    n = sq.shape[0]
    d2 = sq[:, None] + sq[None, :] - 2.0 * gram
    d2 = d2 + torch.diag(torch.full((n,), math.inf, dtype=d2.dtype, device=d2.device))
    k = max(1, n - num_byzantine - 2)
    nearest = torch.topk(d2, k, dim=1, largest=False).values
    scores = nearest.sum(dim=1)
    return torch.sort(scores, stable=True).indices[:num_selected]  # lax.top_k's order: ties to the lower index


def krum(
    stacked: Params, weights: torch.Tensor, num_byzantine: int, num_selected: int = 1
) -> Tuple[Params, torch.Tensor]:
    """Multi-Krum: the sample-weighted mean of the selected models, and the
    selected indices."""
    idx = krum_select(stacked, num_byzantine, num_selected)
    sel = {name: x[idx] for name, x in stacked.items()}
    w = torch.as_tensor(weights, dtype=torch.float32).to(idx.device)
    return fedavg(sel, w[idx]), idx


def geometric_median(stacked: Params, weights: torch.Tensor, iters: int = 8, eps: float = 1e-6) -> Params:
    """Weighted geometric median over the model axis: ``iters`` Weiszfeld
    steps from the weighted mean (RFA, Pillutla et al. 2019)."""
    x = _flatten_stack(stacked)
    w = torch.as_tensor(weights, dtype=torch.float32).to(x.device)
    w = w / torch.clamp(w.sum(), min=1e-12)
    z = w @ x
    for _ in range(iters):
        d = torch.sqrt(torch.clamp(_row_sums((x - z) ** 2, stacked), min=eps * eps))
        beta = w / d
        z = (beta @ x) / torch.clamp(beta.sum(), min=1e-12)
    out, offset = {}, 0
    for name, leaf in stacked.items():
        size = math.prod(leaf.shape[1:])
        out[name] = z[offset:offset + size].reshape(leaf.shape[1:]).to(leaf.dtype)
        offset += size
    return out


def sparse_delta_apply(anchor_flat: torch.Tensor, idx: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """``anchor_flat`` plus a sparse delta, as a new f32 tensor: repeated
    indices add up (``anchor.at[idx].add(vals)``)."""
    return anchor_flat.float().index_add(0, idx.long(), vals.float())


def scaffold_update(
    global_params: Params,
    global_c: Params,
    delta_y_stack: Params,
    delta_c_stack: Params,
    global_lr: float,
    total_population: float,
) -> Tuple[Params, Params]:
    """SCAFFOLD server update (Karimireddy et al. 2020): the global model
    moves by ``global_lr`` times the mean client delta, the global control
    variate by ``K / N`` times the mean variate delta. Returns
    ``(new_global_params, new_global_c)``."""
    num_clients = next(iter(delta_y_stack.values())).shape[0]
    new_params = {
        name: (p.float() + global_lr * delta_y_stack[name].float().mean(dim=0)).to(p.dtype)
        for name, p in global_params.items()
    }
    frac = num_clients / max(float(total_population), 1.0)
    new_c = {
        name: (c.float() + frac * delta_c_stack[name].float().mean(dim=0)).to(c.dtype)
        for name, c in global_c.items()
    }
    return new_params, new_c
