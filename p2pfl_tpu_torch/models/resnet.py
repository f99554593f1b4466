"""ResNet-18 for CIFAR-10 (counterpart of ``p2pfl_tpu/models/resnet.py``).

CIFAR-style ResNet-18 (3 x 3 stem, no max-pool) with GroupNorm instead of
BatchNorm, as in the JAX package: BatchNorm's running statistics have no
well-defined federated average over non-IID clients, GroupNorm is stateless.

Inputs are NHWC, as the datasets give them; the network runs NCHW on a
permuted view. What it keeps of flax:

- convolutions pad flax's ``SAME`` (:func:`~p2pfl_tpu_torch.models.cnn.
  conv_same`): a 3 x 3 stride-2 convolution of an even side pads (0, 1);
  the 1 x 1 stride-2 shortcut pads nothing;
- ``GroupNorm`` has ``min(32, C)`` groups and eps 1e-6 (torch's default is
  1e-5), takes its statistics in at least f32 as ``E[x^2] - E[x]^2`` clamped
  at 0 (flax's fast variance), applies ``(x - mean) * (rsqrt(var + eps) *
  scale) + bias`` in that type and returns the compute dtype;
- the head is a global mean over H and W (in at least f32, cast back), then
  a Dense layer with f32 logits.

Layers compute in ``Settings.COMPUTE_DTYPE`` (bf16 by default) with f32
parameters. Submodules carry flax's names (``Conv_0``, ``GroupNorm_0``,
``BasicBlock_<n>``, ``Dense_0``) for :mod:`p2pfl_tpu_torch.models.convert`.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from p2pfl_tpu_torch.config import compute_dtype as settings_compute_dtype
from p2pfl_tpu_torch.device import DeviceLike
from p2pfl_tpu_torch.models.cnn import conv_same
from p2pfl_tpu_torch.models.model_handle import ModelHandle
from p2pfl_tpu_torch.models.transformer import _linear, init_params

GN_EPS = 1e-6  # flax nn.GroupNorm's default


def group_norm(x: torch.Tensor, gn: nn.GroupNorm, dtype: torch.dtype) -> torch.Tensor:
    """flax ``nn.GroupNorm(num_groups, dtype=...)`` on an NCHW tensor."""
    b, c = x.shape[:2]
    xf = x.to(torch.promote_types(x.dtype, torch.float32)).reshape(b, gn.num_groups, -1)
    mean = xf.mean(dim=-1, keepdim=True)
    var = torch.clamp((xf * xf).mean(dim=-1, keepdim=True) - mean * mean, min=0.0)
    mul = torch.rsqrt(var + GN_EPS).reshape(b, gn.num_groups, 1, 1).expand(b, gn.num_groups, c // gn.num_groups, 1)
    mul = mul.reshape(b, c, 1, 1) * gn.weight.reshape(1, c, 1, 1)
    centered = (xf - mean).reshape(x.shape)
    return (centered * mul + gn.bias.reshape(1, c, 1, 1)).to(dtype)


def _group_norm_layer(channels: int) -> nn.GroupNorm:
    return nn.GroupNorm(min(32, channels), channels, eps=GN_EPS)


class BasicBlock(nn.Module):
    """Two 3 x 3 convolutions with GroupNorm and a residual; a 1 x 1
    projection (with its GroupNorm) where the shape changes."""

    def __init__(
        self, in_channels: int, channels: int, strides: Tuple[int, int] = (1, 1),
        compute_dtype: torch.dtype = torch.bfloat16,
    ) -> None:
        super().__init__()
        self.compute_dtype = compute_dtype
        self.Conv_0 = nn.Conv2d(in_channels, channels, 3, strides, bias=False)
        self.GroupNorm_0 = _group_norm_layer(channels)
        self.Conv_1 = nn.Conv2d(channels, channels, 3, bias=False)
        self.GroupNorm_1 = _group_norm_layer(channels)
        self.project = tuple(strides) != (1, 1) or in_channels != channels
        if self.project:
            self.Conv_2 = nn.Conv2d(in_channels, channels, 1, strides, bias=False)
            self.GroupNorm_2 = _group_norm_layer(channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cd = self.compute_dtype
        y = F.relu(group_norm(conv_same(x, self.Conv_0, cd), self.GroupNorm_0, cd))
        y = group_norm(conv_same(y, self.Conv_1, cd), self.GroupNorm_1, cd)
        residual = group_norm(conv_same(x, self.Conv_2, cd), self.GroupNorm_2, cd) if self.project else x
        return F.relu(y + residual)


class ResNet18(nn.Module):
    """``[B, H, W, C]`` images -> ``[B, out_channels]`` logits (f32)."""

    def __init__(
        self, in_channels: int = 3, out_channels: int = 10, stage_sizes: Sequence[int] = (2, 2, 2, 2),
        compute_dtype: torch.dtype = torch.bfloat16,
    ) -> None:
        super().__init__()
        self.compute_dtype = compute_dtype
        self.Conv_0 = nn.Conv2d(in_channels, 64, 3, bias=False)
        self.GroupNorm_0 = _group_norm_layer(64)
        blocks, channels, c_in = 0, 64, 64
        for i, n in enumerate(stage_sizes):
            for b in range(n):
                strides = (2, 2) if i > 0 and b == 0 else (1, 1)
                self.add_module(f"BasicBlock_{blocks}", BasicBlock(c_in, channels, strides, compute_dtype))
                blocks, c_in = blocks + 1, channels
            channels *= 2
        self.num_blocks = blocks
        self.Dense_0 = nn.Linear(c_in, out_channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cd = self.compute_dtype
        x = x.to(cd).permute(0, 3, 1, 2)  # NHWC -> NCHW
        x = F.relu(group_norm(conv_same(x, self.Conv_0, cd), self.GroupNorm_0, cd))
        for i in range(self.num_blocks):
            x = getattr(self, f"BasicBlock_{i}")(x)
        x = x.to(torch.promote_types(cd, torch.float32)).mean(dim=(2, 3)).to(cd)
        return _linear(x, self.Dense_0, cd).float()


def resnet18_model(
    seed: int = 0,
    input_shape: Tuple[int, ...] = (32, 32, 3),
    out_channels: int = 10,
    device: DeviceLike = "cuda",
) -> ModelHandle:
    """A :class:`ResNet18` for ``input_shape`` ``(H, W, C)`` with random
    weights from ``seed``, computing in ``Settings.COMPUTE_DTYPE``, in a
    :class:`ModelHandle`; arguments in the JAX function's order."""
    with torch.device("meta"):
        module = ResNet18(input_shape[-1], out_channels, compute_dtype=settings_compute_dtype())
    return ModelHandle(init_params(module, seed, device), module)
