"""Byzantine data poisoning for robustness experiments (counterpart of
``p2pfl_tpu/learning/dataset/poison.py``; numpy on the host, the same arrays
and node sets as the JAX package for the same arguments).

Label flipping is the data-side attack: a poisoned node trains on labels
``(y + offset) mod C``. Model poisoning (``MeshSimulation(byzantine_mask=...,
byzantine_attack=...)``) corrupts the update inside the round instead.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

from p2pfl_tpu_torch.learning.dataset.dataset import FederatedDataset


def flip_labels(dataset: FederatedDataset, num_classes: int, offset: int = 1) -> FederatedDataset:
    """A copy of ``dataset`` whose train labels are shifted by ``offset`` (mod
    ``num_classes``); the test split stays clean."""
    x, y = dataset.export_arrays(train=True)
    flipped = ((y.astype(np.int64) + offset) % num_classes).astype(y.dtype)
    try:
        xt, yt = dataset.export_arrays(train=False)
    except KeyError:
        xt = yt = None
    return FederatedDataset.from_arrays(x, flipped, xt, yt)


def select_poisoned(n: int, fraction: float, seed: int = 0) -> np.ndarray:
    """The Byzantine node set for a population of ``n``: ``round(fraction *
    n)`` distinct indices, sorted; shared by label flipping and model
    poisoning so both attack the same nodes."""
    if not 0.0 <= fraction < 1.0:
        raise ValueError(f"fraction must be in [0, 1), got {fraction}")
    k = int(round(fraction * n))
    rng = np.random.default_rng(seed)
    return np.sort(rng.choice(n, size=k, replace=False))


def poison_partitions(
    partitions: Sequence[FederatedDataset], fraction: float, num_classes: int, seed: int = 0, offset: int = 1,
) -> Tuple[List[FederatedDataset], np.ndarray]:
    """Label-flip a random ``fraction`` of the partitions: returns ``(new
    list, poisoned indices)``."""
    poisoned = select_poisoned(len(partitions), fraction, seed)
    out = list(partitions)
    for i in poisoned:
        out[i] = flip_labels(partitions[i], num_classes, offset)
    return out, poisoned
