"""SCAFFOLD server-side aggregation (Karimireddy et al. 2020; counterpart of
``p2pfl_tpu/learning/aggregators/scaffold.py``): clients ship ``delta_y_i``
/ ``delta_c_i`` (canonical leaves) in ``additional_info["scaffold"]``; the
aggregator keeps the simulated global model and the global control variate
across rounds and hands ``global_c`` back in
``additional_info["scaffold_server"]``, through
:func:`p2pfl_tpu_torch.ops.aggregation.scaffold_update`.
"""

from __future__ import annotations

from typing import List, Optional

import torch

from p2pfl_tpu_torch.learning.aggregators.base import Aggregator
from p2pfl_tpu_torch.models.convert import from_canonical, to_canonical
from p2pfl_tpu_torch.models.model_handle import ModelHandle
from p2pfl_tpu_torch.ops import aggregation as agg_ops
from p2pfl_tpu_torch.ops.compression import as_tensor

Params = dict


class Scaffold(Aggregator):
    partial_aggregation = False

    def __init__(self, global_lr: float = 1.0, total_population: Optional[int] = None) -> None:
        super().__init__()
        self.global_lr = float(global_lr)
        self.total_population = total_population
        self._global_params: Optional[Params] = None
        self._global_c: Optional[Params] = None

    def get_required_callbacks(self) -> List[str]:
        return ["scaffold"]

    def _deltas(self, model: ModelHandle, template: Params) -> tuple:
        info = model.get_info("scaffold")
        if info is None or "delta_y_i" not in info:
            raise ValueError("scaffold aggregation requires models trained with the 'scaffold' learner callback")
        dev = next(iter(template.values())).device

        def params(leaves):
            return from_canonical(template, [as_tensor(a, device=dev, dtype=torch.float32) for a in leaves])

        return params(info["delta_y_i"]), params(info["delta_c_i"])

    def aggregate(self, models: List[ModelHandle]) -> ModelHandle:
        if not models:
            raise ValueError("nothing to aggregate")
        template = models[0].params
        if self._global_params is None:
            # Client params minus their deltas reconstruct the round start.
            dy0, _ = self._deltas(models[0], template)
            self._global_params = {n: p.float() - dy0[n] for n, p in template.items()}
        if self._global_c is None:
            self._global_c = {n: torch.zeros_like(p, dtype=torch.float32) for n, p in template.items()}
        deltas = [self._deltas(m, template) for m in models]
        population = float(self.total_population if self.total_population is not None else len(models))
        self._global_params, self._global_c = agg_ops.scaffold_update(
            self._global_params, self._global_c,
            agg_ops.tree_stack([d[0] for d in deltas]), agg_ops.tree_stack([d[1] for d in deltas]),
            self.global_lr, population,
        )
        contributors, total = self._merge_metadata(models)
        out = models[0].build_copy(
            params={n: g.to(template[n].dtype) for n, g in self._global_params.items()},
            contributors=contributors, num_samples=total,
        )
        out.add_info("scaffold_server", {"global_c": to_canonical(self._global_c)})
        out.additional_info.pop("scaffold", None)  # the per-round deltas are consumed
        return out

    def clear(self) -> None:  # keep global state across rounds
        super().clear()
