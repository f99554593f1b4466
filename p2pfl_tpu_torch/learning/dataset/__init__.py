"""Dataset wrapper and partition strategies (numpy only)."""

from p2pfl_tpu_torch.learning.dataset.dataset import FederatedDataset, synthetic_mnist  # noqa: F401
from p2pfl_tpu_torch.learning.dataset.partition import (  # noqa: F401
    DirichletPartitionStrategy,
    LabelSkewedPartitionStrategy,
    PartitionStrategy,
    PercentageBasedNonIIDPartitionStrategy,
    RandomIIDPartitionStrategy,
)
