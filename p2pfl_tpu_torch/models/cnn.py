"""Small convnet for MNIST / FEMNIST (counterpart of
``p2pfl_tpu/models/cnn.py``): conv32, avg-pool, conv64, avg-pool, dense128,
logits.

Inputs are NHWC, as the datasets give them (``[B, H, W]`` gains a channel);
the convolutions run NCHW on a permuted view. The 3 x 3 convolutions pad
flax's ``SAME`` at stride 1 (one pixel each side), the 2 x 2 average pools
are ``VALID``, and the flatten before ``Dense_0`` runs in NHWC order (H, W,
C), so a flax ``Dense_0`` kernel's rows line up. Layers compute in
``Settings.COMPUTE_DTYPE`` (bf16 by default) with f32 parameters and f32
logits; the submodules carry flax's names (``Conv_0``, ``Conv_1``,
``Dense_0``, ``Dense_1``) for :mod:`p2pfl_tpu_torch.models.convert`.
Under a bound ``model`` axis over ranks a convolution whose kernel the rank
holds in part computes its output channels and gathers them
(:func:`~p2pfl_tpu_torch.parallel.tensor_parallel.column_conv`).
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from p2pfl_tpu_torch.config import compute_dtype as settings_compute_dtype
from p2pfl_tpu_torch.device import DeviceLike
from p2pfl_tpu_torch.models.model_handle import ModelHandle
from p2pfl_tpu_torch.models.transformer import _linear, init_params
from p2pfl_tpu_torch.parallel.tensor_parallel import column_conv, column_group


def conv_same(x: torch.Tensor, conv: nn.Conv2d, dtype: torch.dtype) -> torch.Tensor:
    """flax ``nn.Conv(padding="SAME", dtype=...)`` on an NCHW tensor: input,
    kernel and bias cast to ``dtype``; each spatial axis padded by
    ``max((ceil(n / s) - 1) * s + k - n, 0)``, the smaller half before, so a
    3 x 3 stride-2 convolution of an even side pads (0, 1), not (1, 1);
    column-parallel where the kernel is held in part."""
    pads = []
    for n, k, s in zip(x.shape[-2:], conv.kernel_size, conv.stride):
        total = max((-(-n // s) - 1) * s + k - n, 0)
        pads.append((total // 2, total - total // 2))
    (top, bottom), (left, right) = pads
    weight = conv.weight.to(dtype)
    bias = conv.bias.to(dtype) if conv.bias is not None else None
    x, padding = x.to(dtype), (top, left)
    if top != bottom or left != right:
        x, padding = F.pad(x, (left, right, top, bottom)), 0
    group = column_group(weight.shape[0], conv.out_channels, "a Conv kernel")
    if group is None:
        return F.conv2d(x, weight, bias, conv.stride, padding)
    return column_conv(x, weight, bias, conv.stride, padding, group)


class CNN(nn.Module):
    """conv32-pool-conv64-pool-dense128-logits: ``[B, H, W(, C)]`` -> ``[B,
    out_channels]`` (f32)."""

    def __init__(
        self, in_channels: int = 1, image_hw: Tuple[int, int] = (28, 28), out_channels: int = 10,
        compute_dtype: torch.dtype = torch.bfloat16,
    ) -> None:
        super().__init__()
        self.compute_dtype = compute_dtype
        self.Conv_0 = nn.Conv2d(in_channels, 32, 3)
        self.Conv_1 = nn.Conv2d(32, 64, 3)
        h, w = (d // 2 // 2 for d in image_hw)
        self.Dense_0 = nn.Linear(64 * h * w, 128)
        self.Dense_1 = nn.Linear(128, out_channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.dim() == 3:  # [B, H, W] -> [B, H, W, 1]
            x = x[..., None]
        cd = self.compute_dtype
        x = x.to(cd).permute(0, 3, 1, 2)  # NHWC -> NCHW
        x = F.avg_pool2d(F.relu(conv_same(x, self.Conv_0, cd)), 2)
        x = F.avg_pool2d(F.relu(conv_same(x, self.Conv_1, cd)), 2)
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)  # flatten in (H, W, C) order
        x = F.relu(_linear(x, self.Dense_0, cd))
        return _linear(x, self.Dense_1, cd).float()


def cnn_model(
    seed: int = 0,
    input_shape: Tuple[int, ...] = (28, 28, 1),
    out_channels: int = 10,
    device: DeviceLike = "cuda",
) -> ModelHandle:
    """A :class:`CNN` for ``input_shape`` (``(H, W)`` or ``(H, W, C)``) with
    random weights from ``seed``, computing in ``Settings.COMPUTE_DTYPE``, in
    a :class:`ModelHandle`; arguments in the JAX function's order."""
    channels = input_shape[2] if len(input_shape) == 3 else 1
    with torch.device("meta"):
        module = CNN(channels, tuple(input_shape[:2]), out_channels, settings_compute_dtype())
    return ModelHandle(init_params(module, seed, device), module)
