"""Vision dataset interop: torchvision-style datasets -> FederatedDataset.

Capability parity with the reference's torchvision bridge
(p2pfl/learning/frameworks/pytorch/utils/torchvision_to_datasets.py:41-79,
``create_huggingface_dataset_from_torchvision``): take a torchvision map- or
iterable-style dataset of ``(image, label)`` pairs and turn it into the
framework's federated dataset type, ready for partitioning and export
(counterpart of ``p2pfl_tpu/learning/dataset/vision.py``).

As in the JAX package, conversion lands directly in dense, contiguous
float32 arrays (the reference converts through an HF generator dataset,
row-at-a-time python objects) — the arrays the learners' batch stacks are
cut from — so there is no per-row overhead between the vision dataset and
the card.

torchvision itself is optional (it is not a dependency of the port); the
converter works with ANY object yielding ``(image, label)`` pairs, and
:func:`load_torchvision` gates the import with an actionable error pointing
at the zero-egress alternatives (``mnist()`` / ``synthetic_mnist()``).
"""

from __future__ import annotations

import warnings
from typing import Any, Iterable, Optional, Tuple

import numpy as np

from p2pfl_tpu_torch.learning.dataset.dataset import FederatedDataset

#: Dataset names the loader accepts without a warning — mirrors the
#: reference's SUPPORTED_DATASETS (torchvision_to_datasets.py:31-38).
SUPPORTED_DATASETS = (
    "CIFAR10",
    "CIFAR100",
    "MNIST",
    "FashionMNIST",
    "EMNIST",
    "QMNIST",
)


def vision_pairs_to_arrays(
    dataset: Iterable[Tuple[Any, Any]],
) -> Tuple[np.ndarray, np.ndarray]:
    """Materialize an ``(image, label)`` dataset as dense float32 arrays.

    Accepts PIL images, numpy arrays, or torch tensors; integer pixel data
    is rescaled to [0, 1] by its dtype max (255 for uint8). Labels may be
    ints or 0-d tensors.
    """
    # Fast path: torchvision map-style datasets store the whole split as
    # dense .data/.targets — rescale in one vectorized op instead of
    # round-tripping every row through __getitem__ (which builds a PIL
    # image per sample).
    data = getattr(dataset, "data", None)
    targets = getattr(dataset, "targets", None)
    has_transform = any(
        getattr(dataset, attr, None) is not None
        for attr in ("transform", "target_transform", "transforms")
    )
    if data is not None and targets is not None and not has_transform:
        x = _rescale(np.asarray(data))
        y = np.asarray(targets, dtype=np.int32).reshape(-1)
        if len(x) == 0:
            raise ValueError("vision dataset is empty")
        if len(x) != len(y):
            raise ValueError(f"data/targets length mismatch: {len(x)} vs {len(y)}")
        return x, y
    xs = []
    ys = []
    for image, label in dataset:
        xs.append(_rescale(np.asarray(image)))
        ys.append(int(label))
    if not xs:
        raise ValueError("vision dataset is empty")
    return np.stack(xs), np.asarray(ys, dtype=np.int32)


def _rescale(arr: np.ndarray) -> np.ndarray:
    """float32 in [0, 1]: integer pixel data is scaled by its dtype max."""
    if np.issubdtype(arr.dtype, np.integer):
        return arr.astype(np.float32) / float(np.iinfo(arr.dtype).max)
    return arr.astype(np.float32, copy=False)


def from_vision_datasets(
    train: Iterable[Tuple[Any, Any]],
    test: Optional[Iterable[Tuple[Any, Any]]] = None,
) -> FederatedDataset:
    """Build a :class:`FederatedDataset` from torchvision-style datasets."""
    x_train, y_train = vision_pairs_to_arrays(train)
    if test is not None:
        x_test, y_test = vision_pairs_to_arrays(test)
        return FederatedDataset.from_arrays(x_train, y_train, x_test, y_test)
    return FederatedDataset.from_arrays(x_train, y_train)


def load_torchvision(
    name: str,
    cache_dir: str,
    download: bool = True,
    with_test_split: bool = True,
    **dataset_kwargs: Any,
) -> FederatedDataset:
    """Load a named torchvision dataset as a :class:`FederatedDataset`.

    Mirrors the reference's name->class dispatch and its off-list warning
    (torchvision_to_datasets.py:62-67,132-138). Extra ``dataset_kwargs``
    are forwarded to the torchvision constructor (EMNIST, for example,
    requires ``split="byclass"``). Raises ``ImportError`` with the
    zero-egress alternatives when torchvision is not installed.
    """
    try:
        from torchvision import datasets as tv_datasets
    except ImportError as e:  # pragma: no cover - torchvision absent in CI image
        raise ImportError(
            "torchvision is not installed; use "
            "p2pfl_tpu_torch.learning.dataset.mnist() (HF hub with synthetic "
            "fallback) or synthetic_mnist() instead, or convert any "
            "(image, label) iterable with from_vision_datasets()"
        ) from e
    if name not in SUPPORTED_DATASETS:
        warnings.warn(
            f"torchvision dataset {name!r} is not on the supported list "
            f"{SUPPORTED_DATASETS}; it must follow the (image, label) "
            "map-style protocol with train=/download= constructor args",
            stacklevel=2,
        )
    dataset_cls = getattr(tv_datasets, name, None)
    if dataset_cls is None:
        raise ValueError(
            f"unknown torchvision dataset {name!r}; supported: {SUPPORTED_DATASETS}"
        )
    if name == "EMNIST":
        dataset_kwargs.setdefault("split", "byclass")
    train = dataset_cls(root=cache_dir, train=True, download=download, **dataset_kwargs)
    test = (
        dataset_cls(root=cache_dir, train=False, download=download, **dataset_kwargs)
        if with_test_split
        else None
    )
    return from_vision_datasets(train, test)
