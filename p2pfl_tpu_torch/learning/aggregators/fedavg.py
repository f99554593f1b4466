"""FedAvg (McMahan et al. 2017) — sample-weighted mean (counterpart of
``p2pfl_tpu/learning/aggregators/fedavg.py``), through
:func:`p2pfl_tpu_torch.ops.aggregation.fedavg` on the models' device.
Supports partial aggregation.
"""

from __future__ import annotations

from typing import List

import torch

from p2pfl_tpu_torch.learning.aggregators.base import Aggregator
from p2pfl_tpu_torch.models.model_handle import ModelHandle
from p2pfl_tpu_torch.ops import aggregation as agg_ops


def sample_weights(models: List[ModelHandle]) -> torch.Tensor:
    """The models' sample counts as an f32 vector on their device."""
    return torch.tensor([m.get_num_samples() for m in models], dtype=torch.float32, device=models[0].device)


class FedAvg(Aggregator):
    partial_aggregation = True

    def aggregate(self, models: List[ModelHandle]) -> ModelHandle:
        if not models:
            raise ValueError("nothing to aggregate")
        stacked = agg_ops.tree_stack([m.params for m in models])
        out = agg_ops.fedavg(stacked, sample_weights(models))
        contributors, total = self._merge_metadata(models)
        return models[0].build_copy(params=out, contributors=contributors, num_samples=total)


class CanonicalFedAvg(FedAvg):
    """FedAvg with a run-independent float reduction order — the wire-side
    rule of the parity harness (:mod:`p2pfl_tpu_torch.parity`): partial
    merging is off (raw per-sender models) and the stack is sorted by
    contributor before the reduction, which is the node-index order the
    fused round reduces in under ``canonical_committee=True``, so the two
    backends' aggregates are bit-identical.
    """

    partial_aggregation = False

    def aggregate(self, models: List[ModelHandle]) -> ModelHandle:
        return super().aggregate(sorted(models, key=lambda m: sorted(m.contributors)))
