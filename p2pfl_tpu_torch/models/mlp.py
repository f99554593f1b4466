"""MNIST-scale MLP (counterpart of ``p2pfl_tpu/models/mlp.py``): flatten,
Dense + relu per hidden size, then Dense to the logits.

The layers compute in ``Settings.COMPUTE_DTYPE`` (bf16 by default) with f32
parameters and f32 logits, as in the JAX package. The submodules are named
``Dense_0 .. Dense_n``, flax's names, so :mod:`p2pfl_tpu_torch.models.convert`
maps the flax tree as it is.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from p2pfl_tpu_torch.config import compute_dtype as settings_compute_dtype
from p2pfl_tpu_torch.device import DeviceLike
from p2pfl_tpu_torch.models.model_handle import ModelHandle
from p2pfl_tpu_torch.models.transformer import _linear, init_params


class MLP(nn.Module):
    """Flatten -> Dense stack -> logits ``[B, out_channels]`` (f32)."""

    def __init__(
        self, in_features: int, hidden_sizes: Sequence[int] = (256, 128), out_channels: int = 10,
        compute_dtype: torch.dtype = torch.bfloat16,
    ) -> None:
        super().__init__()
        self.compute_dtype = compute_dtype
        sizes = [in_features, *hidden_sizes, out_channels]
        self.num_layers = len(sizes) - 1
        for i in range(self.num_layers):
            self.add_module(f"Dense_{i}", nn.Linear(sizes[i], sizes[i + 1]))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.reshape(x.shape[0], -1)
        for i in range(self.num_layers):
            x = _linear(x, getattr(self, f"Dense_{i}"), self.compute_dtype)
            if i < self.num_layers - 1:
                x = F.relu(x)
        return x.float()


def mlp_model(
    seed: int = 0,
    input_shape: Tuple[int, ...] = (28, 28),
    hidden_sizes: Sequence[int] = (256, 128),
    out_channels: int = 10,
    device: DeviceLike = "cuda",
) -> ModelHandle:
    """An :class:`MLP` with random weights from ``seed`` (flax's default
    initializers, as :func:`~p2pfl_tpu_torch.models.transformer.init_params`
    draws them), computing in ``Settings.COMPUTE_DTYPE``, in a
    :class:`ModelHandle`; arguments in the JAX function's order."""
    with torch.device("meta"):
        module = MLP(math.prod(input_shape), tuple(hidden_sizes), out_channels, settings_compute_dtype())
    return ModelHandle(init_params(module, seed, device), module)
