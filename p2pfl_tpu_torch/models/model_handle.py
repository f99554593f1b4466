"""A model = module + parameters + federation metadata (counterpart of
``p2pfl_tpu/models/model_handle.py``; no wire frames yet)."""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn as nn
from torch.func import functional_call

Params = Dict[str, torch.Tensor]


class ModelHandle:
    """Parameters as a flat ``{name: tensor}`` dict (the module's
    ``named_parameters`` names) plus the module that runs them.

    Args:
        params: the parameters, f32.
        module: the architecture; :meth:`apply` runs it on any parameter set
            with these names, so one module serves a whole population.
        num_samples: number of samples backing this model's training.
    """

    def __init__(self, params: Params, module: nn.Module, num_samples: int = 1) -> None:
        names = {n for n, _ in module.named_parameters()}
        if set(params) != names:
            raise ValueError(
                f"params do not match the module: missing {sorted(names - set(params))}, "
                f"unexpected {sorted(set(params) - names)}"
            )
        self.params = params
        self.module = module
        self.num_samples = int(num_samples)

    def apply(self, params: Params, x: torch.Tensor) -> torch.Tensor:
        """Run the module on ``x`` with ``params`` (``apply_fn`` counterpart)."""
        return functional_call(self.module, params, (x,))
