"""Federated dataset wrapper (counterpart of
``p2pfl_tpu/learning/dataset/dataset.py``; numpy, with Hugging Face
``datasets`` behind its loaders).

:class:`FederatedDataset` holds a train split and an optional test split,
partitions the train split with a :mod:`.partition` strategy (every
partition shares the full test split) and exports dense ``(x, y)`` arrays,
which ``MeshSimulation`` stacks into its ``[N, S, ...]`` population, or a
framework-native dataset through an :mod:`.export_strategies` class.
:func:`synthetic_mnist` makes the same deterministic MNIST-shaped data as the
JAX package, so both run on equal inputs without downloads.

The Hugging Face hub, CSV, JSON, parquet, pandas and generator constructors
build their splits through the ``datasets`` package, imported when one of
them is called (a machine without ``datasets`` or ``pandas`` still imports
this module and builds datasets from arrays). :func:`mnist` /
:func:`cifar10` try the hub first and fall back to the synthetic stand-ins.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import numpy as np

from p2pfl_tpu_torch.learning.dataset.partition import PartitionStrategy


def _hf() -> Any:
    """The Hugging Face ``datasets`` package, imported on first use."""
    import datasets

    return datasets


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
    """A train/test pair of splits with partition and export helpers.

    Args:
        data: ``{train_split: split, test_split: split}`` (test optional) of
            :class:`_ArraySplit` (build one with :meth:`from_arrays`) or of
            Hugging Face ``Dataset`` s (a ``DatasetDict``), or one HF
            ``Dataset``, split lazily.
        x_key / y_key: column names for inputs and labels in HF splits.
        train_split / test_split: the keys of the train and test splits.
    """

    def __init__(
        self,
        data: Any,
        x_key: str = "image",
        y_key: str = "label",
        train_split: str = "train",
        test_split: str = "test",
    ) -> None:
        self._data = data
        self.x_key = x_key
        self.y_key = y_key
        self.train_split = train_split
        self.test_split = test_split

    # --- constructors ---------------------------------------------------------

    @classmethod
    def from_huggingface(cls, dataset_id: str, **kwargs) -> "FederatedDataset":
        """``datasets.load_dataset(dataset_id)``: a hub id (fetched unless
        the hub is offline) or a local directory of data files."""
        return cls(_hf().load_dataset(dataset_id), **kwargs)

    @classmethod
    def from_csv(cls, path: str, **kwargs) -> "FederatedDataset":
        return cls(_hf().load_dataset("csv", data_files=path), **kwargs)

    @classmethod
    def from_json(cls, path: str, **kwargs) -> "FederatedDataset":
        return cls(_hf().load_dataset("json", data_files=path), **kwargs)

    @classmethod
    def from_parquet(cls, path: str, **kwargs) -> "FederatedDataset":
        return cls(_hf().load_dataset("parquet", data_files=path), **kwargs)

    @classmethod
    def from_pandas(cls, df: Any, **kwargs) -> "FederatedDataset":
        return cls(_hf().Dataset.from_pandas(df), **kwargs)

    @classmethod
    def from_generator(cls, gen: Callable, **kwargs) -> "FederatedDataset":
        return cls(_hf().Dataset.from_generator(gen), **kwargs)

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

    def _split(self, train: bool) -> Any:
        key = self.train_split if train else self.test_split
        if isinstance(self._data, dict):  # a DatasetDict is a dict too
            if key not in self._data:
                raise KeyError("dataset has no test split — call generate_train_test_split first")
            return self._data[key]
        if train:  # one HF Dataset, not split yet
            return self._data
        raise KeyError("dataset has no test split — call generate_train_test_split first")

    def generate_train_test_split(self, test_size: float = 0.2, seed: int = 0) -> None:
        """Split an unsplit dataset into train/test in place."""
        if not isinstance(self._data, dict):  # one HF Dataset
            self._data = self._data.train_test_split(test_size=test_size, seed=seed)
            return
        if "test" in self._data:
            raise TypeError("dataset is already split")
        train = self._data["train"]
        if isinstance(train, _ArraySplit):
            a, b = train.train_test_split(test_size, seed)
        else:  # HF Dataset: keyword args (its 2nd positional is train_size)
            dd = train.train_test_split(test_size=test_size, seed=seed)
            a, b = dd["train"], dd["test"]
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
        labels = train.y if isinstance(train, _ArraySplit) else np.asarray(train[self.y_key])
        index_lists = strategy.generate(labels, num_partitions, seed=seed, **kwargs)
        try:
            test = self._split(False)
        except KeyError:
            test = None
        out = []
        for idx in index_lists:
            d = {"train": train.take(idx) if isinstance(train, _ArraySplit) else train.select(idx)}
            if test is not None:
                d["test"] = test
            out.append(FederatedDataset(d, x_key=self.x_key, y_key=self.y_key, train_split="train",
                                        test_split="test"))
        return out

    # --- export ---------------------------------------------------------------

    def export_arrays(self, train: bool = True) -> Tuple[np.ndarray, np.ndarray]:
        """Dense ``(x, y)`` numpy arrays for the requested split (an HF
        split's ``x_key`` / ``y_key`` columns as float32 / int32, integer or
        0-255 pixels scaled to [0, 1])."""
        split = self._split(train)
        if isinstance(split, _ArraySplit):
            return split.x, split.y
        x = np.asarray(split[self.x_key], dtype=np.float32)
        y = np.asarray(split[self.y_key], dtype=np.int32)
        if x.dtype == np.uint8 or x.max() > 2.0:
            x = x.astype(np.float32) / 255.0
        return x, y

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


def cifar10(fallback_synthetic: bool = True) -> FederatedDataset:
    """Real CIFAR-10 from the HF hub if reachable, else the synthetic stand-in
    (any failure of the hub path, ``datasets`` missing included, falls back;
    ``fallback_synthetic=False`` re-raises it)."""
    try:
        return FederatedDataset.from_huggingface("uoft-cs/cifar10", y_key="label")
    except Exception:
        if not fallback_synthetic:
            raise
        return synthetic_cifar10()


def mnist(fallback_synthetic: bool = True) -> FederatedDataset:
    """Real MNIST from the HF hub if reachable, else the synthetic stand-in
    (any failure of the hub path, ``datasets`` missing included, falls back;
    ``fallback_synthetic=False`` re-raises it)."""
    try:
        return FederatedDataset.from_huggingface("ylecun/mnist")
    except Exception:
        if not fallback_synthetic:
            raise
        return synthetic_mnist()
