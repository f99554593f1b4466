"""Federated dataset wrapper over numpy arrays (counterpart of
``p2pfl_tpu/learning/dataset/dataset.py``; numpy only).

:class:`FederatedDataset` holds a train split and an optional test split,
partitions the train split with a :mod:`.partition` strategy (every
partition shares the full test split) and exports dense ``(x, y)`` arrays,
which ``MeshSimulation`` stacks into its ``[N, S, ...]`` population, or a
framework-native dataset through an :mod:`.export_strategies` class.
:func:`synthetic_mnist` makes the same deterministic MNIST-shaped data as the
JAX package, so both run on equal inputs without downloads.

The Hugging Face, CSV, JSON, parquet, pandas and generator constructors are
not ported yet: they raise ``NotImplementedError``.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np

from p2pfl_tpu_torch.learning.dataset.partition import PartitionStrategy


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet; build the dataset with FederatedDataset.from_arrays"
    )


class _ArraySplit:
    """A split backed by dense numpy arrays."""

    def __init__(self, x: np.ndarray, y: np.ndarray) -> None:
        if len(x) != len(y):
            raise ValueError(f"x has {len(x)} rows but y has {len(y)}")
        self.x = x
        self.y = y

    def __len__(self) -> int:
        return len(self.y)

    def take(self, idx: np.ndarray) -> "_ArraySplit":
        return _ArraySplit(self.x[idx], self.y[idx])

    def train_test_split(self, test_size: float, seed: int) -> Tuple["_ArraySplit", "_ArraySplit"]:
        n = len(self.y)
        order = np.random.default_rng(seed).permutation(n)
        cut = int(n * (1 - test_size))
        return self.take(order[:cut]), self.take(order[cut:])


class FederatedDataset:
    """A train/test pair of array splits with partition and export helpers.

    Args:
        data: ``{train_split: split, test_split: split}`` (test optional) of
            :class:`_ArraySplit`; build one with :meth:`from_arrays`.
        x_key / y_key: column names for inputs and labels, kept as the JAX
            package keeps them (they name Hugging Face columns, which come
            with its loaders; array splits have no columns).
        train_split / test_split: the keys of the train and test splits.
    """

    def __init__(
        self,
        data: Dict[str, _ArraySplit],
        x_key: str = "image",
        y_key: str = "label",
        train_split: str = "train",
        test_split: str = "test",
    ) -> None:
        if not isinstance(data, dict):
            raise TypeError("FederatedDataset holds a dict of array splits (use from_arrays)")
        self._data = data
        self.x_key = x_key
        self.y_key = y_key
        self.train_split = train_split
        self.test_split = test_split

    # --- constructors ---------------------------------------------------------

    @classmethod
    def from_huggingface(cls, dataset_id: str, **kwargs) -> "FederatedDataset":
        raise _not_ported("FederatedDataset.from_huggingface")

    @classmethod
    def from_csv(cls, path: str, **kwargs) -> "FederatedDataset":
        raise _not_ported("FederatedDataset.from_csv")

    @classmethod
    def from_json(cls, path: str, **kwargs) -> "FederatedDataset":
        raise _not_ported("FederatedDataset.from_json")

    @classmethod
    def from_parquet(cls, path: str, **kwargs) -> "FederatedDataset":
        raise _not_ported("FederatedDataset.from_parquet")

    @classmethod
    def from_pandas(cls, df, **kwargs) -> "FederatedDataset":
        raise _not_ported("FederatedDataset.from_pandas")

    @classmethod
    def from_generator(cls, gen, **kwargs) -> "FederatedDataset":
        raise _not_ported("FederatedDataset.from_generator")

    @classmethod
    def from_arrays(
        cls,
        x_train: np.ndarray,
        y_train: np.ndarray,
        x_test: Optional[np.ndarray] = None,
        y_test: Optional[np.ndarray] = None,
        x_key: str = "x",
        y_key: str = "y",
    ) -> "FederatedDataset":
        """Build directly from numpy arrays."""
        d = {"train": _ArraySplit(np.asarray(x_train), np.asarray(y_train))}
        if x_test is not None:
            d["test"] = _ArraySplit(np.asarray(x_test), np.asarray(y_test))
        return cls(d, x_key=x_key, y_key=y_key)

    # --- splits ---------------------------------------------------------------

    def _split(self, train: bool) -> _ArraySplit:
        key = self.train_split if train else self.test_split
        if key not in self._data:
            raise KeyError("dataset has no test split — call generate_train_test_split first")
        return self._data[key]

    def generate_train_test_split(self, test_size: float = 0.2, seed: int = 0) -> None:
        """Split an unsplit dataset into train/test in place."""
        if "test" in self._data:
            raise TypeError("dataset is already split")
        a, b = self._data["train"].train_test_split(test_size, seed)
        self._data = {"train": a, "test": b}

    def get_num_samples(self, train: bool = True) -> int:
        return len(self._split(train))

    # --- partitioning ---------------------------------------------------------

    def generate_partitions(
        self,
        num_partitions: int,
        strategy: Union[PartitionStrategy, type],
        seed: int = 0,
        **kwargs,
    ) -> List["FederatedDataset"]:
        """Partition the train split; every partition shares the full test
        split (the standard FL evaluation protocol)."""
        train = self._split(True)
        index_lists = strategy.generate(train.y, num_partitions, seed=seed, **kwargs)
        test = self._data.get(self.test_split)  # the JAX package's _split(False), absent split as None
        out = []
        for idx in index_lists:
            d = {"train": train.take(idx)}
            if test is not None:
                d["test"] = test
            out.append(FederatedDataset(d, x_key=self.x_key, y_key=self.y_key, train_split="train",
                                        test_split="test"))
        return out

    # --- export ---------------------------------------------------------------

    def export_arrays(self, train: bool = True) -> Tuple[np.ndarray, np.ndarray]:
        """Dense ``(x, y)`` numpy arrays for the requested split."""
        split = self._split(train)
        return split.x, split.y

    def export_batches(
        self, batch_size: int, train: bool = True, seed: "int | Tuple[int, ...]" = 0,
        drop_remainder: bool = False,
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Fixed-shape shuffled batches ``(xb [steps, B, ...], yb [steps, B],
        wb [steps, B])`` as the JAX package's ``BatchedArraysExportStrategy``
        makes them (the same permutation for the same ``seed``, an int or a
        tuple fed to numpy's ``SeedSequence``); ``wb`` is a 0/1 mask over the
        zero padding of the final partial batch."""
        from p2pfl_tpu_torch.learning.dataset.export_strategies import BatchedArraysExportStrategy

        return self.export(BatchedArraysExportStrategy, train=train, batch_size=batch_size, seed=seed,
                           drop_remainder=drop_remainder)

    def export(self, strategy: type, train: bool = True, batch_size: int = 64,
               seed: "int | Tuple[int, ...]" = 0, **kwargs) -> Any:
        """Export the split through a framework-native strategy (reference
        ``P2PFLDataset.export``, p2pfl_dataset.py:224-248): ``strategy`` is
        an :class:`~p2pfl_tpu_torch.learning.dataset.export_strategies.
        ExportStrategy` subclass, e.g. ``TorchExportStrategy`` (a
        ``DataLoader``), ``TensorFlowExportStrategy`` (a ``tf.data.Dataset``)
        or ``BatchedArraysExportStrategy`` (the learners' batch stacks)."""
        x, y = self.export_arrays(train)
        return strategy.export(x, y, train=train, batch_size=batch_size, seed=seed, **kwargs)


def synthetic_mnist(
    n_train: int = 4096,
    n_test: int = 1024,
    num_classes: int = 10,
    seed: int = 42,
    noise: float = 0.35,
) -> FederatedDataset:
    """Deterministic MNIST-shaped dataset a small MLP can learn: a fixed
    random 28x28 template per class plus gaussian noise, clipped to [0, 1].
    The same arrays as the JAX package's ``synthetic_mnist`` for the same
    arguments."""
    rng = np.random.default_rng(seed)
    templates = rng.uniform(0.0, 1.0, size=(num_classes, 28, 28)).astype(np.float32)

    def make(n: int, rng: np.random.Generator) -> Tuple[np.ndarray, np.ndarray]:
        y = rng.integers(0, num_classes, size=n).astype(np.int32)
        x = templates[y] + rng.normal(0.0, noise, size=(n, 28, 28)).astype(np.float32)
        return np.clip(x, 0.0, 1.0), y

    x_train, y_train = make(n_train, np.random.default_rng(seed + 1))
    x_test, y_test = make(n_test, np.random.default_rng(seed + 2))
    return FederatedDataset.from_arrays(x_train, y_train, x_test, y_test)


def synthetic_cifar10(
    n_train: int = 8192,
    n_test: int = 1024,
    num_classes: int = 10,
    image_size: int = 32,
    seed: int = 42,
    noise: float = 0.25,
) -> FederatedDataset:
    """Deterministic CIFAR-shaped dataset ``[N, H, W, 3]`` a convnet can
    learn: a fixed low-frequency color template per class (a random 4 x 4
    grid upsampled to ``image_size``) plus gaussian noise, clipped to [0, 1].
    The same arrays as the JAX package's ``synthetic_cifar10`` for the same
    arguments."""
    rng = np.random.default_rng(seed)
    coarse = rng.uniform(0.0, 1.0, size=(num_classes, 4, 4, 3)).astype(np.float32)
    reps = -(-image_size // 4)
    templates = np.repeat(np.repeat(coarse, reps, axis=1), reps, axis=2)[:, :image_size, :image_size, :]

    def make(n: int, rng: np.random.Generator) -> Tuple[np.ndarray, np.ndarray]:
        y = rng.integers(0, num_classes, size=n).astype(np.int32)
        x = templates[y] + rng.normal(0.0, noise, size=(n, image_size, image_size, 3)).astype(np.float32)
        return np.clip(x, 0.0, 1.0), y

    x_train, y_train = make(n_train, np.random.default_rng(seed + 1))
    x_test, y_test = make(n_test, np.random.default_rng(seed + 2))
    return FederatedDataset.from_arrays(x_train, y_train, x_test, y_test)
