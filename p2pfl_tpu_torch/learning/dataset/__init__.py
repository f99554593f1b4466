"""Dataset wrapper, partition strategies, export strategies, data
poisoning and vision interop (numpy; Hugging Face ``datasets`` inside the
loaders, torch and tensorflow inside their export strategies, torchvision
inside ``load_torchvision``)."""

from p2pfl_tpu_torch.learning.dataset.dataset import (  # noqa: F401
    FederatedDataset,
    cifar10,
    mnist,
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
from p2pfl_tpu_torch.learning.dataset.vision import (  # noqa: F401
    from_vision_datasets,
    load_torchvision,
    vision_pairs_to_arrays,
)
