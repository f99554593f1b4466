"""Pluggable framework-native data export strategies (the port's copy of
``p2pfl_tpu/learning/dataset/export_strategies.py``).

Parity with the reference's export surface
(p2pfl/learning/dataset/p2pfl_dataset.py:224-248 ``export(strategy)``,
pytorch/lightning_dataset.py:29-69 ``PyTorchExportStrategy`` -> DataLoader,
tensorflow/keras_dataset.py:29-69 ``TensorFlowExportStrategy`` -> tf.data),
redesigned around dense arrays: every strategy receives the split as numpy
``(x, y)`` and returns whatever its framework trains from. The learners'
fixed-shape batch stacks are themselves a strategy
(:class:`BatchedArraysExportStrategy`), so the port's learners and the
interop learners pull batches through the same seam, with the same
permutations as the JAX package's for the same seed.

Strategies are stateless classes dispatched by
:meth:`FederatedDataset.export`; register new ones by subclassing
:class:`ExportStrategy` — nothing is looked up by name. ``tensorflow`` is
imported only by :class:`TensorFlowExportStrategy`'s export.
"""

from __future__ import annotations

import abc
from typing import Any

import numpy as np


class ExportStrategy(abc.ABC):
    """Interface: dense ``(x, y)`` arrays -> framework-native dataset."""

    @staticmethod
    @abc.abstractmethod
    def export(
        x: np.ndarray,
        y: np.ndarray,
        *,
        train: bool,
        batch_size: int,
        seed: Any,
        **kwargs: Any,
    ) -> Any: ...


class NumpyExportStrategy(ExportStrategy):
    """The identity export: ``(x, y)`` dense arrays."""

    @staticmethod
    def export(x, y, *, train, batch_size, seed, **kwargs):
        return x, y


class BatchedArraysExportStrategy(ExportStrategy):
    """Fixed-shape shuffled ``(xb [steps, B, ...], yb [steps, B], wb [steps,
    B])`` batch stacks (:meth:`FederatedDataset.export_batches` delegates
    here). ``seed`` is an int or a tuple of ints fed to numpy's
    ``SeedSequence``; ``wb`` is a 0/1 mask over the zero padding of the final
    partial batch (none with ``drop_remainder``)."""

    @staticmethod
    def export(x, y, *, train, batch_size, seed, drop_remainder=False, **kwargs):
        n = len(y)
        order = np.random.default_rng(seed).permutation(n)
        x, y = x[order], y[order]
        steps = n // batch_size if drop_remainder else -(-n // batch_size)
        pad = 0 if drop_remainder else steps * batch_size - n
        if pad:
            x = np.concatenate([x, np.zeros((pad, *x.shape[1:]), x.dtype)])
            y = np.concatenate([y, np.zeros((pad,), y.dtype)])
        w = np.ones((steps * batch_size,), np.float32)
        if pad:
            w[-pad:] = 0.0
        m = steps * batch_size  # drop_remainder: slice off the ragged tail
        return (x[:m].reshape(steps, batch_size, *x.shape[1:]), y[:m].reshape(steps, batch_size),
                w.reshape(steps, batch_size))


class TorchExportStrategy(ExportStrategy):
    """``torch.utils.data.DataLoader`` over a ``TensorDataset`` (reference
    pytorch/lightning_dataset.py:29-69 — without the Lightning wrapper).

    Shuffling uses a seeded generator so runs stay reproducible under a
    pinned learner seed; the final partial batch is kept (torch losses
    handle ragged batches natively, no padding mask needed).
    """

    @staticmethod
    def export(x, y, *, train, batch_size, seed, num_workers=0, **kwargs):
        import torch
        from torch.utils.data import DataLoader, TensorDataset

        ds = TensorDataset(
            torch.from_numpy(np.ascontiguousarray(x, dtype=np.float32)),
            torch.from_numpy(np.ascontiguousarray(y, dtype=np.int64)),
        )
        gen = torch.Generator()
        gen.manual_seed(int(np.random.SeedSequence(seed).generate_state(1)[0]))
        return DataLoader(ds, batch_size=batch_size, shuffle=train, generator=gen if train else None,
                          num_workers=num_workers)


class TensorFlowExportStrategy(ExportStrategy):
    """``tf.data.Dataset`` of ``(x, y)`` batches (reference
    tensorflow/keras_dataset.py:29-69).

    Shuffle buffer covers the whole split (partitions are small relative to
    host RAM); reshuffles each epoch iteration from the given seed.
    """

    @staticmethod
    def export(x, y, *, train, batch_size, seed, **kwargs):
        import tensorflow as tf

        ds = tf.data.Dataset.from_tensor_slices((np.asarray(x, np.float32), np.asarray(y, np.int32)))
        if train:
            ds = ds.shuffle(buffer_size=len(y), seed=int(np.random.SeedSequence(seed).generate_state(1)[0]),
                            reshuffle_each_iteration=True)
        return ds.batch(batch_size).prefetch(tf.data.AUTOTUNE)
