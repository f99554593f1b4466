"""Entry point of the port (counterpart of ``__graft_entry__.entry``): a
forward step of the flagship model, the MNIST MLP."""

from __future__ import annotations

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
