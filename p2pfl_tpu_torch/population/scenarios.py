"""The scenario partitioner's label skew (counterpart of the part of
``p2pfl_tpu/population/scenarios.py`` that :func:`~p2pfl_tpu_torch.population.
engine.population_data` reads; numpy on the host, so for the same generator
its counts equal the JAX package's draw for draw)."""

from __future__ import annotations

import numpy as np


def dirichlet_label_counts(rng: np.random.Generator, n: int, s: int, num_classes: int, alpha: float) -> np.ndarray:
    """Per-node class counts ``[n, num_classes]`` summing to ``s`` per row:
    proportions drawn from ``Dirichlet(alpha)``, quantized by largest
    remainder so every node holds exactly ``s`` samples (fixed counts keep
    the stacked shapes the same under any skew)."""
    props = rng.dirichlet(np.full(num_classes, float(alpha)), size=n)
    raw = props * s
    counts = np.floor(raw).astype(np.int64)
    short = s - counts.sum(axis=1)
    order = np.argsort(-(raw - counts), axis=1, kind="stable")
    for i in range(n):
        counts[i, order[i, : int(short[i])]] += 1
    return counts


__all__ = ["dirichlet_label_counts"]
