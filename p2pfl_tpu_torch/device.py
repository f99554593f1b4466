"""Device resolution for the port's entry points.

Entry points default to ``device="cuda"``. Asking for CUDA on a machine
without a card raises: the port never drops to the CPU on its own, so a
number measured on the CPU can never pass for one measured on the card.
Tests ask for the CPU explicitly.
"""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device]


def resolve_device(device: DeviceLike = "cuda") -> torch.device:
    """Return ``device`` as a :class:`torch.device`, checking it exists.

    Raises:
        RuntimeError: CUDA was asked for and no card is visible.
        ValueError: a device type the port does not run on.
    """
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(dev)!r} was requested but torch sees no CUDA "
                "device; pass device='cpu' to run the plain versions"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {str(dev)!r}: use 'cuda' or 'cpu'")
    return dev
