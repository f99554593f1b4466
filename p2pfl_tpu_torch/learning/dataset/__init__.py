"""Dataset wrapper, partition strategies, export strategies and data
poisoning (numpy; torch and tensorflow only inside their export
strategies)."""

from p2pfl_tpu_torch.learning.dataset.dataset import (  # noqa: F401
    FederatedDataset,
    synthetic_cifar10,
    synthetic_mnist,
)
from p2pfl_tpu_torch.learning.dataset.export_strategies import (  # noqa: F401
    BatchedArraysExportStrategy,
    ExportStrategy,
    NumpyExportStrategy,
    TensorFlowExportStrategy,
    TorchExportStrategy,
)
from p2pfl_tpu_torch.learning.dataset.partition import (  # noqa: F401
    DirichletPartitionStrategy,
    LabelSkewedPartitionStrategy,
    PartitionStrategy,
    PercentageBasedNonIIDPartitionStrategy,
    RandomIIDPartitionStrategy,
)
from p2pfl_tpu_torch.learning.dataset.poison import (  # noqa: F401
    flip_labels,
    poison_partitions,
    select_poisoned,
)
