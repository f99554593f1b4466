"""Node-mode aggregators: round-scoped accumulators over the port's
aggregation math (counterpart of ``p2pfl_tpu/learning/aggregators/``).
``MaskedFedAvg`` waits for the privacy plane."""

from p2pfl_tpu_torch.learning.aggregators.async_buffer import (  # noqa: F401
    AsyncBufferedAggregator,
    staleness_discount,
    staleness_weight,
)
from p2pfl_tpu_torch.learning.aggregators.base import Aggregator  # noqa: F401
from p2pfl_tpu_torch.learning.aggregators.fedavg import CanonicalFedAvg, FedAvg  # noqa: F401
from p2pfl_tpu_torch.learning.aggregators.fedmedian import FedMedian  # noqa: F401
from p2pfl_tpu_torch.learning.aggregators.robust import (  # noqa: F401
    GeometricMedian,
    Krum,
    MultiKrum,
    TrimmedMean,
)
from p2pfl_tpu_torch.learning.aggregators.scaffold import Scaffold  # noqa: F401

__all__ = [
    "Aggregator", "AsyncBufferedAggregator", "CanonicalFedAvg", "FedAvg", "FedMedian",
    "GeometricMedian", "Krum", "MultiKrum", "TrimmedMean", "Scaffold", "staleness_discount",
    "staleness_weight",
]
