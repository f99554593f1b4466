"""Aggregation math over stacked parameters (counterpart of
``p2pfl_tpu/ops/aggregation.py``).

A stacked parameter set is a dict of tensors, each with a leading
``num_models`` axis.
"""

from __future__ import annotations

from typing import Dict

import torch

Params = Dict[str, torch.Tensor]


def fedavg(stacked: Params, weights: torch.Tensor) -> Params:
    """Sample-weighted mean over the model axis.

    The weights are normalized in f32, each leaf is averaged in f32 and cast
    back to its own dtype, as in the JAX package.
    """
    w = torch.as_tensor(weights, dtype=torch.float32)
    norm = w / torch.clamp(w.sum(), min=1e-12)
    out = {}
    for name, x in stacked.items():
        wn = norm.to(x.device).reshape((-1,) + (1,) * (x.dim() - 1))
        out[name] = (x.float() * wn).sum(dim=0).to(x.dtype)
    return out
