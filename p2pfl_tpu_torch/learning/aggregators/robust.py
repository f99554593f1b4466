"""Byzantine-robust aggregation rules (counterpart of
``p2pfl_tpu/learning/aggregators/robust.py``): coordinate-wise trimmed mean,
the geometric median (RFA) and (Multi-)Krum, none of which pre-merges
partial aggregates.
"""

from __future__ import annotations

from typing import List

import torch

from p2pfl_tpu_torch.learning.aggregators.base import Aggregator
from p2pfl_tpu_torch.learning.aggregators.fedavg import sample_weights
from p2pfl_tpu_torch.models.model_handle import ModelHandle
from p2pfl_tpu_torch.ops import aggregation as agg_ops


class TrimmedMean(Aggregator):
    """Coordinate-wise trimmed mean: robust to ``trim_ratio`` adversaries."""

    partial_aggregation = False

    def __init__(self, trim_ratio: float = 0.1) -> None:
        super().__init__()
        if not 0.0 <= trim_ratio < 0.5:
            raise ValueError("trim_ratio must be in [0, 0.5)")
        self.trim_ratio = trim_ratio

    def aggregate(self, models: List[ModelHandle]) -> ModelHandle:
        if not models:
            raise ValueError("nothing to aggregate")
        n = len(models)
        trim = min(int(n * self.trim_ratio), (n - 1) // 2)
        out = agg_ops.trimmed_mean(agg_ops.tree_stack([m.params for m in models]), trim=trim)
        contributors, total = self._merge_metadata(models)
        return models[0].build_copy(params=out, contributors=contributors, num_samples=total)


class GeometricMedian(Aggregator):
    """Geometric median via Weiszfeld iterations (RFA, Pillutla et al.
    2019). Contributions weigh UNIFORMLY, not by their self-reported
    ``num_samples``: a Byzantine peer claiming a huge count must not hold
    the weight the rule's breakdown point is stated in."""

    partial_aggregation = False

    def __init__(self, iters: int = 8) -> None:
        super().__init__()
        if iters < 1:
            raise ValueError("iters must be >= 1")
        self.iters = int(iters)

    def aggregate(self, models: List[ModelHandle]) -> ModelHandle:
        if not models:
            raise ValueError("nothing to aggregate")
        weights = torch.ones(len(models), dtype=torch.float32, device=models[0].device)
        out = agg_ops.geometric_median(agg_ops.tree_stack([m.params for m in models]), weights, iters=self.iters)
        contributors, total = self._merge_metadata(models)
        return models[0].build_copy(params=out, contributors=contributors, num_samples=total)


class Krum(Aggregator):
    """(Multi-)Krum (Blanchard et al. 2017): the model(s) closest to their
    peers, discarding up to ``num_byzantine`` outliers; only the selected
    models count as contributors."""

    partial_aggregation = False

    def __init__(self, num_byzantine: int = 1, num_selected: int = 1) -> None:
        super().__init__()
        self.num_byzantine = int(num_byzantine)
        self.num_selected = int(num_selected)

    def _select_count(self, n: int) -> int:
        return min(self.num_selected, n)

    def aggregate(self, models: List[ModelHandle]) -> ModelHandle:
        if not models:
            raise ValueError("nothing to aggregate")
        n = len(models)
        out, idx = agg_ops.krum(
            agg_ops.tree_stack([m.params for m in models]), sample_weights(models),
            num_byzantine=min(self.num_byzantine, n - 1), num_selected=self._select_count(n),
        )
        contributors, total = self._merge_metadata([models[i] for i in idx.tolist()])
        return models[0].build_copy(params=out, contributors=contributors, num_samples=total)


class MultiKrum(Krum):
    """Multi-Krum with the paper's selection size ``m = n - num_byzantine -
    2`` (or ``num_selected`` when given)."""

    def __init__(self, num_byzantine: int = 1, num_selected: int = 0) -> None:
        super().__init__(num_byzantine=num_byzantine, num_selected=num_selected)

    def _select_count(self, n: int) -> int:
        if self.num_selected > 0:
            return min(self.num_selected, n)
        return max(1, n - self.num_byzantine - 2)
