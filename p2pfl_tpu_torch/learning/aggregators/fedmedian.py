"""FedMedian (Yin et al. 2018) — coordinate-wise median (counterpart of
``p2pfl_tpu/learning/aggregators/fedmedian.py``). Median is non-linear, so
no partial aggregation."""

from __future__ import annotations

from typing import List

from p2pfl_tpu_torch.learning.aggregators.base import Aggregator
from p2pfl_tpu_torch.models.model_handle import ModelHandle
from p2pfl_tpu_torch.ops import aggregation as agg_ops


class FedMedian(Aggregator):
    partial_aggregation = False

    def aggregate(self, models: List[ModelHandle]) -> ModelHandle:
        if not models:
            raise ValueError("nothing to aggregate")
        out = agg_ops.fedmedian(agg_ops.tree_stack([m.params for m in models]))
        contributors, total = self._merge_metadata(models)
        return models[0].build_copy(params=out, contributors=contributors, num_samples=total)
