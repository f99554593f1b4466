"""Dataset partitioning strategies (a copy of
``p2pfl_tpu/learning/dataset/partition.py``; numpy only, so the index lists
equal the JAX package's exactly).

Every strategy maps a label vector to ``n`` lists of row indices; the dataset
wrapper turns those into per-node sub-datasets. All strategies are
deterministic given ``seed``.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np


class PartitionStrategy:
    """Interface: labels -> per-partition index lists."""

    @staticmethod
    def generate(labels: Sequence[int], n: int, seed: int = 0, **kwargs) -> List[np.ndarray]:
        raise NotImplementedError


class RandomIIDPartitionStrategy(PartitionStrategy):
    """Uniform shuffle + near-equal split (reference :60-105)."""

    @staticmethod
    def generate(labels: Sequence[int], n: int, seed: int = 0, **kwargs) -> List[np.ndarray]:
        rng = np.random.default_rng(seed)
        idx = rng.permutation(len(labels))
        return [np.sort(part) for part in np.array_split(idx, n)]


class LabelSkewedPartitionStrategy(PartitionStrategy):
    """Each partition draws from a limited set of classes.

    ``classes_per_partition`` classes are assigned round-robin over a shuffled
    class order; samples of each class are split evenly among the partitions
    that own the class. (The reference declares this strategy but raises
    NotImplementedError, :107-146.)
    """

    @staticmethod
    def generate(
        labels: Sequence[int],
        n: int,
        seed: int = 0,
        classes_per_partition: int = 2,
        **kwargs,
    ) -> List[np.ndarray]:
        labels = np.asarray(labels)
        rng = np.random.default_rng(seed)
        classes = np.unique(labels)
        class_pos = {c: i for i, c in enumerate(classes)}
        # Deal class slots from a shuffled round-robin deck so every partition
        # gets exactly `classes_per_partition` distinct-ish classes and class
        # ownership stays balanced across partitions.
        deck_len = n * classes_per_partition
        deck = np.tile(rng.permutation(classes), -(-deck_len // len(classes)))[:deck_len]
        owners: List[List[int]] = [[] for _ in classes]
        for p in range(n):
            for c in deck[p * classes_per_partition : (p + 1) * classes_per_partition]:
                owners[class_pos[c]].append(p)
        parts: List[List[int]] = [[] for _ in range(n)]
        for c in classes:
            own = owners[class_pos[c]]
            if not own:  # orphan class: give it to a random partition
                own = [int(rng.integers(n))]
            c_idx = rng.permutation(np.nonzero(labels == c)[0])
            for i, chunk in enumerate(np.array_split(c_idx, len(own))):
                parts[own[i]].extend(chunk.tolist())
        return [np.sort(np.asarray(p, dtype=np.int64)) for p in parts]


class DirichletPartitionStrategy(PartitionStrategy):
    """Per-class Dirichlet(alpha) proportions with min-size re-balancing.

    Semantics of reference :161-431: for each class, draw partition
    proportions ~ Dir(alpha); resample until every partition ends up with at
    least ``min_partition_size`` rows (bounded retries, then top up from the
    largest partitions).
    """

    @staticmethod
    def generate(
        labels: Sequence[int],
        n: int,
        seed: int = 0,
        alpha: float = 0.5,
        min_partition_size: int = 2,
        max_retries: int = 50,
        **kwargs,
    ) -> List[np.ndarray]:
        labels = np.asarray(labels)
        rng = np.random.default_rng(seed)
        classes = np.unique(labels)
        for _ in range(max_retries):
            parts: List[List[int]] = [[] for _ in range(n)]
            for c in classes:
                c_idx = rng.permutation(np.nonzero(labels == c)[0])
                props = rng.dirichlet(np.full(n, alpha))
                cuts = (np.cumsum(props) * len(c_idx)).astype(int)[:-1]
                for p, chunk in enumerate(np.split(c_idx, cuts)):
                    parts[p].extend(chunk.tolist())
            if min(len(p) for p in parts) >= min_partition_size:
                break
        else:
            # Top up starving partitions from the largest ones.
            sizes = [len(p) for p in parts]
            for p in range(n):
                while len(parts[p]) < min_partition_size:
                    donor = int(np.argmax([len(q) for q in parts]))
                    parts[p].append(parts[donor].pop())
        return [np.sort(np.asarray(p, dtype=np.int64)) for p in parts]


class PercentageBasedNonIIDPartitionStrategy(PartitionStrategy):
    """Each partition keeps ``percentage`` of its rows from one "home" class
    and fills the rest IID from all classes. (Empty stub in the reference,
    :433-436.)"""

    @staticmethod
    def generate(
        labels: Sequence[int],
        n: int,
        seed: int = 0,
        percentage: float = 0.8,
        **kwargs,
    ) -> List[np.ndarray]:
        labels = np.asarray(labels)
        rng = np.random.default_rng(seed)
        classes = np.unique(labels)
        total = len(labels)
        per_part = total // n
        home_budget = int(per_part * percentage)

        by_class = {c: list(rng.permutation(np.nonzero(labels == c)[0])) for c in classes}
        pool: List[int] = []
        parts: List[List[int]] = [[] for _ in range(n)]
        # Deal home classes round-robin; a partition keeps drawing home
        # classes until its home budget is met (a single class may be smaller
        # than the budget).
        home_order = list(rng.permutation(classes))
        next_home = 0
        for p in range(n):
            need = home_budget
            while need > 0 and any(by_class[c] for c in classes):
                home = home_order[next_home % len(home_order)]
                next_home += 1
                take = by_class[home][:need]
                by_class[home] = by_class[home][need:]
                parts[p].extend(int(i) for i in take)
                need -= len(take)
        for c in classes:  # leftover rows form the IID pool
            pool.extend(int(i) for i in by_class[c])
        pool = list(rng.permutation(pool))
        for p in range(n):
            need = per_part - len(parts[p])
            parts[p].extend(pool[:need])
            pool = pool[need:]
        return [np.sort(np.asarray(p, dtype=np.int64)) for p in parts]
