"""The port's host-side foundations against the JAX package's: ``config``,
the cohort sampler, the synthetic dataset, the partition strategies,
``_stack_partitions`` and the DP accountant. None of them touches a tensor,
so each output must equal the reference's exactly.
"""

import inspect
import math

import numpy as np
import pytest
import torch

from p2pfl_tpu import config as jax_config
from p2pfl_tpu.learning import privacy as jax_privacy
from p2pfl_tpu.learning.dataset import dataset as jax_dataset
from p2pfl_tpu.learning.dataset import partition as jax_partition
from p2pfl_tpu.parallel.simulation import _stack_partitions as jax_stack_partitions
from p2pfl_tpu.population import cohort as jax_cohort
from p2pfl_tpu_torch import config
from p2pfl_tpu_torch.learning import privacy
from p2pfl_tpu_torch.learning.dataset import dataset, partition
from p2pfl_tpu_torch.parallel.simulation import _stack_partitions
from p2pfl_tpu_torch.population import cohort

STRATEGIES = [
    ("RandomIIDPartitionStrategy", {}),
    ("LabelSkewedPartitionStrategy", {"classes_per_partition": 3}),
    ("DirichletPartitionStrategy", {"alpha": 0.3, "min_partition_size": 5}),
    ("PercentageBasedNonIIDPartitionStrategy", {"percentage": 0.6}),
]


@pytest.mark.parametrize("method", ["__init__", "from_arrays"])
def test_federated_dataset_signature_matches_jax(method):
    """``FederatedDataset(data, x_key, y_key, train_split, test_split)`` and
    ``from_arrays(..., x_key, y_key)`` take the JAX package's arguments in
    its order, with its defaults, and keep them as it does."""
    port = inspect.signature(getattr(dataset.FederatedDataset, method)).parameters
    ref = inspect.signature(getattr(jax_dataset.FederatedDataset, method)).parameters
    assert list(port) == list(ref)
    for name, p in ref.items():
        assert port[name].kind == p.kind and port[name].default == p.default, name
    x, y = np.zeros((4, 2), np.float32), np.arange(4)
    kw = dict(x_key="img", y_key="lab")
    got = dataset.FederatedDataset.from_arrays(x, y, x, y, **kw)
    want = jax_dataset.FederatedDataset.from_arrays(x, y, x, y, **kw)
    split = dict(train_split="tr", test_split="te")
    for a, b in ((got, want), (dataset.FederatedDataset({"tr": got._split(True)}, **kw, **split),
                               jax_dataset.FederatedDataset({"tr": want._split(True)}, **kw, **split))):
        for attr in ("x_key", "y_key", "train_split", "test_split"):
            assert getattr(a, attr) == getattr(b, attr), attr
        assert a.get_num_samples() == b.get_num_samples() == 4
        parts = a.generate_partitions(2, partition.RandomIIDPartitionStrategy)
        assert [(p.x_key, p.y_key, p.train_split, p.test_split) for p in parts] == [("img", "lab", "train", "test")] * 2


def test_settings_match_jax_defaults_and_env(monkeypatch):
    for name in ("TRAIN_SET_SIZE", "COMPUTE_DTYPE"):
        assert getattr(config.Settings, name) == getattr(jax_config.Settings, name)
    for name, raw, default in (("TRAIN_SET_SIZE", "7", 4), ("COMPUTE_DTYPE", "float32", "bfloat16"),
                               ("X", "yes", False), ("Y", "0.5", 1.0)):
        monkeypatch.setenv(f"P2PFL_TPU_{name}", raw)
        got = config._env_override(name, default)
        assert got == jax_config._env_override(name, default) and type(got) is type(default)
    monkeypatch.setenv("P2PFL_TPU_TRAIN_SET_SIZE", "four")
    with pytest.raises(ValueError):
        config._env_override("TRAIN_SET_SIZE", 4)
    with config.Settings.overridden(COMPUTE_DTYPE="float32"):
        import torch

        assert config.compute_dtype() == torch.float32
    assert config.Settings.COMPUTE_DTYPE == "bfloat16"
    with pytest.raises(AttributeError):
        with config.Settings.overridden(NO_SUCH=1):
            pass
    with config.Settings.overridden(COMPUTE_DTYPE="no_dtype"), pytest.raises(ValueError):
        config.compute_dtype()


@pytest.mark.parametrize("churn", [0.0, 0.2])
def test_committee_schedule_equals_jax(churn):
    names = [f"vnode/{i:05d}" for i in range(40)]
    args = dict(seed=11, fraction=0.1, min_size=2, churn_rate=churn)
    got = cohort.committee_schedule(cohort.CohortPlan(**args), names, rounds=12, start_round=3)
    ref = jax_cohort.committee_schedule(jax_cohort.CohortPlan(**args), names, rounds=12, start_round=3)
    assert got.dtype == ref.dtype == np.int32
    np.testing.assert_array_equal(got, ref)
    assert (np.diff(got, axis=1) > 0).all()  # index-sorted rows


def test_cohort_primitives_equal_jax():
    for seed, r, name in ((0, 0, "a"), (7, 123, "vnode/00042"), (2**31 - 1, 9, "x:y")):
        assert cohort.cohort_score(seed, r, name) == jax_cohort.cohort_score(seed, r, name)
        for rate in (0.0, 0.3, 1.0):
            assert cohort.availability_down(seed, r, name, rate) == jax_cohort.availability_down(seed, r, name, rate)
    for n, f, m in ((10, 0.25, 1), (3, 0.0, 2), (100, 0.5, 1), (5, 2.0, 1)):
        assert cohort.cohort_size(n, f, m) == jax_cohort.cohort_size(n, f, m)
    names = [f"n{i}" for i in range(25)]
    plan, jplan = cohort.CohortPlan(3, 0.3, churn_rate=0.4), jax_cohort.CohortPlan(3, 0.3, churn_rate=0.4)
    for r in range(6):
        assert plan.cohort(r, names) == jplan.cohort(r, names)
    with pytest.raises(ValueError, match="churn left"):
        cohort.committee_schedule(cohort.CohortPlan(1, 0.5, churn_rate=0.9), names, rounds=5)


def test_synthetic_mnist_equals_jax():
    got = dataset.synthetic_mnist(n_train=300, n_test=50, seed=5)
    ref = jax_dataset.synthetic_mnist(n_train=300, n_test=50, seed=5)
    for train in (True, False):
        for a, b in zip(got.export_arrays(train), ref.export_arrays(train)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    assert got.get_num_samples(True) == 300 and got.get_num_samples(False) == 50


@pytest.mark.parametrize("name,kwargs", STRATEGIES, ids=[s[0] for s in STRATEGIES])
def test_partition_index_lists_equal_jax(name, kwargs):
    labels = np.random.default_rng(2).integers(0, 10, size=500)
    got = getattr(partition, name).generate(labels, 7, seed=3, **kwargs)
    ref = getattr(jax_partition, name).generate(labels, 7, seed=3, **kwargs)
    assert len(got) == len(ref) == 7
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, b)


def test_partitions_and_stack_equal_jax():
    got_parts = dataset.synthetic_mnist(n_train=203, n_test=20).generate_partitions(
        5, partition.DirichletPartitionStrategy, seed=1, alpha=0.5)
    ref_parts = jax_dataset.synthetic_mnist(n_train=203, n_test=20).generate_partitions(
        5, jax_partition.DirichletPartitionStrategy, seed=1, alpha=0.5)
    for g, r in zip(got_parts, ref_parts):
        for train in (True, False):
            for a, b in zip(g.export_arrays(train), r.export_arrays(train)):
                np.testing.assert_array_equal(a, b)
    for a, b in zip(_stack_partitions(got_parts), jax_stack_partitions(ref_parts)):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


def test_train_test_split_equals_jax_and_unported_loaders_raise():
    x = np.arange(40, dtype=np.float32).reshape(20, 2)
    y = np.arange(20, dtype=np.int32)
    got = dataset.FederatedDataset.from_arrays(x, y)
    ref = jax_dataset.FederatedDataset.from_arrays(x, y)
    got.generate_train_test_split(0.25, seed=4)
    ref.generate_train_test_split(0.25, seed=4)
    for train in (True, False):
        for a, b in zip(got.export_arrays(train), ref.export_arrays(train)):
            np.testing.assert_array_equal(a, b)
    with pytest.raises(TypeError):
        got.generate_train_test_split()
    with pytest.raises(KeyError):
        dataset.FederatedDataset.from_arrays(x, y).export_arrays(train=False)
    # export_batches is ported (the learner's batches): the same permutation,
    # padding and mask as the JAX package's BatchedArraysExportStrategy.
    for train, seed, drop in ((True, (3, 1, 0), False), (False, 0, False), (True, 7, True)):
        for a, b in zip(got.export_batches(4, train, seed, drop), ref.export_batches(4, train, seed, drop)):
            np.testing.assert_array_equal(a, b)
    # The file loaders are ported (tests/test_torch_dataset_loaders.py): a
    # missing local file fails as in the JAX package.
    for loader, path in (("from_csv", "missing.csv"), ("from_parquet", "missing.parquet")):
        with pytest.raises(FileNotFoundError):
            getattr(jax_dataset.FederatedDataset, loader)(path)
        with pytest.raises(FileNotFoundError):
            getattr(dataset.FederatedDataset, loader)(path)
    # export is ported with the export strategies: a class that is not a
    # strategy fails as in the JAX package.
    with pytest.raises(AttributeError, match="export"):
        ref.export(object)
    with pytest.raises(AttributeError, match="export"):
        got.export(object)


def test_export_through_each_strategy_equals_jax():
    from p2pfl_tpu.learning.dataset import BatchedArraysExportStrategy as JaxBatched
    from p2pfl_tpu.learning.dataset import NumpyExportStrategy as JaxNumpy
    from p2pfl_tpu.learning.dataset import TorchExportStrategy as JaxTorch
    from p2pfl_tpu_torch.learning.dataset import (BatchedArraysExportStrategy, NumpyExportStrategy,
                                                  TorchExportStrategy)

    got = dataset.synthetic_mnist(n_train=50, n_test=20)
    ref = jax_dataset.synthetic_mnist(n_train=50, n_test=20)
    for train in (True, False):
        for mine, theirs, kw in ((NumpyExportStrategy, JaxNumpy, {}),
                                 (BatchedArraysExportStrategy, JaxBatched, {"drop_remainder": train})):
            for a, b in zip(got.export(mine, train, 16, (2, 0, 1), **kw),
                            ref.export(theirs, train, 16, (2, 0, 1), **kw)):
                np.testing.assert_array_equal(a, b)
        batches = list(zip(got.export(TorchExportStrategy, train, 16, 5), ref.export(JaxTorch, train, 16, 5)))
        assert len(batches) == (4 if train else 2)
        for (gx, gy), (rx, ry) in batches:
            assert torch.equal(gx, rx) and torch.equal(gy, ry)


def test_privacy_accountant_equals_jax():
    for sigma, steps, delta in ((0.5, 30, 1e-5), (1.1, 1, 1e-3), (0.0, 5, 1e-5), (2.0, 0, 1e-5)):
        assert privacy.gaussian_rdp_epsilon(sigma, steps, delta) == jax_privacy.gaussian_rdp_epsilon(
            sigma, steps, delta)
    for nonprivate in (0, 3):
        assert privacy.dp_sgd_privacy_spent(0.7, 1.0, 100, 1e-5, nonprivate) == jax_privacy.dp_sgd_privacy_spent(
            0.7, 1.0, 100, 1e-5, nonprivate)
    assert math.isinf(privacy.dp_sgd_privacy_spent(0.7, 1.0, 100, nonprivate_steps=1)["epsilon"])
    with pytest.raises(ValueError):
        privacy.gaussian_rdp_epsilon(1.0, 5, 1.5)
    assert privacy.resolve_seed(9) == jax_privacy.resolve_seed(9) == 9
    with pytest.warns(UserWarning, match="pinned seed"):
        privacy.resolve_seed(9, dp_noise_multiplier=0.5)
    assert 0 <= privacy.resolve_seed(None) < 2**31
