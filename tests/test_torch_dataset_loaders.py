"""The port's dataset loaders and vision interop against the JAX package's,
on the CPU and offline.

Each ``FederatedDataset.from_*`` loader reads the same small local files
(CSV, JSON, parquet), pandas frame or generator that the JAX package's
reads, both through the local ``datasets`` package, and the two give equal
``export_arrays`` before and after a seeded train/test split, and equal
partitions. ``from_huggingface`` reads a local directory of data files.
The hub is offline and every cache lies under the test's ``tmp_path``:
``datasets`` and ``huggingface_hub`` read their settings when imported, so
the in-process tests patch those module constants (and rebuild the hub's
HTTP sessions, which then refuse every request), and ``mnist()`` /
``cifar10()``, whose first step is the hub, run in a fresh interpreter
started with the offline settings in its environment. The vision
converter runs on plain ``(image, label)`` pairs (torchvision is not
installed).
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from p2pfl_tpu.learning.dataset import dataset as jax_dataset
from p2pfl_tpu.learning.dataset import vision as jax_vision
from p2pfl_tpu.learning.dataset.partition import RandomIIDPartitionStrategy as JaxIID
from p2pfl_tpu_torch.learning.dataset import dataset, vision
from p2pfl_tpu_torch.learning.dataset.partition import RandomIIDPartitionStrategy

from test_torch_comm import ROOT

ROWS = 24


@pytest.fixture
def offline_hub(monkeypatch, tmp_path):
    """The Hugging Face hub offline and the datasets cache under
    ``tmp_path`` for this test."""
    import datasets
    from huggingface_hub import constants
    from huggingface_hub.utils import reset_sessions

    cache = tmp_path / "hf"
    for key, value in {"HF_HUB_OFFLINE": "1", "HF_DATASETS_OFFLINE": "1", "HF_HOME": str(cache),
                       "HF_DATASETS_CACHE": str(cache / "datasets")}.items():
        monkeypatch.setenv(key, value)
    monkeypatch.setattr(constants, "HF_HUB_OFFLINE", True)
    monkeypatch.setattr(datasets.config, "HF_HUB_OFFLINE", True)
    monkeypatch.setattr(datasets.config, "HF_DATASETS_OFFLINE", True)
    monkeypatch.setattr(datasets.config, "HF_DATASETS_CACHE", cache / "datasets")
    reset_sessions()
    yield cache
    reset_sessions()


def _rows(seed=5):
    rng = np.random.default_rng(seed)
    feats = rng.uniform(0.0, 1.0, size=(ROWS, 4)).round(6)
    labels = rng.integers(0, 10, size=ROWS)
    return feats, labels


def _write(kind, tmp_path):
    """The same rows as a file of ``kind`` (scalar ``x`` in CSV, a list of
    four in JSON and parquet)."""
    import pandas as pd

    feats, labels = _rows()
    if kind == "csv":
        path = tmp_path / "rows.csv"
        pd.DataFrame({"x": feats[:, 0], "label": labels}).to_csv(path, index=False)
    elif kind == "json":
        path = tmp_path / "rows.jsonl"
        path.write_text("".join(json.dumps({"x": list(f), "label": int(y)}) + "\n" for f, y in zip(feats, labels)))
    else:
        path = tmp_path / "rows.parquet"
        pd.DataFrame({"x": list(feats), "label": labels}).to_parquet(path)
    return str(path)


def _generator():
    feats, labels = _rows()
    for f, y in zip(feats, labels):
        yield {"x": [float(v) for v in f], "label": int(y)}


def _build(pkg, loader, arg):
    return getattr(pkg.FederatedDataset, loader)(arg, x_key="x", y_key="label")


def _assert_same(got, ref, train=True):
    for a, b in zip(got.export_arrays(train), ref.export_arrays(train)):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("loader", ["from_csv", "from_json", "from_parquet", "from_pandas", "from_generator"])
def test_each_loader_exports_the_jax_packages_arrays(loader, offline_hub, tmp_path):
    import pandas as pd

    feats, labels = _rows()
    if loader == "from_pandas":
        arg = pd.DataFrame({"x": list(feats), "label": labels})
    elif loader == "from_generator":
        arg = _generator
    else:
        arg = _write(loader[len("from_"):], tmp_path)
    got, ref = _build(dataset, loader, arg), _build(jax_dataset, loader, arg)
    assert got.get_num_samples() == ref.get_num_samples() == ROWS
    _assert_same(got, ref)
    got.generate_train_test_split(0.25, seed=3)
    ref.generate_train_test_split(0.25, seed=3)
    for train in (True, False):
        _assert_same(got, ref, train)
    for mine, theirs in zip(got.generate_partitions(3, RandomIIDPartitionStrategy, seed=2),
                            ref.generate_partitions(3, JaxIID, seed=2)):
        for train in (True, False):
            _assert_same(mine, theirs, train)


def test_from_huggingface_reads_a_local_directory(offline_hub, tmp_path):
    import pandas as pd

    feats, labels = _rows()
    root = tmp_path / "local_dataset"
    root.mkdir()
    pd.DataFrame({"x": feats[:18, 1], "label": labels[:18]}).to_csv(root / "train.csv", index=False)
    pd.DataFrame({"x": feats[18:, 1], "label": labels[18:]}).to_csv(root / "test.csv", index=False)
    got, ref = _build(dataset, "from_huggingface", str(root)), _build(jax_dataset, "from_huggingface", str(root))
    assert (got.get_num_samples(True), got.get_num_samples(False)) == (18, 6)
    for train in (True, False):
        _assert_same(got, ref, train)
    xb, yb, wb = got.export_batches(4, train=True, seed=1)
    for a, b in zip((xb, yb, wb), ref.export_batches(4, train=True, seed=1)):
        np.testing.assert_array_equal(a, b)
    # the datasets cache went under tmp_path
    assert any((offline_hub / "datasets").iterdir())


_HUB_SCRIPT = r"""
import json, sys
import numpy as np
from p2pfl_tpu.learning.dataset import dataset as ref
from p2pfl_tpu_torch.learning.dataset import dataset as port

out = {}
for name, synth in (("mnist", "synthetic_mnist"), ("cifar10", "synthetic_cifar10")):
    got, want, synthetic = getattr(port, name)(), getattr(ref, name)(), getattr(port, synth)()
    out[name] = all(
        np.array_equal(a, b) and np.array_equal(a, c)
        for train in (True, False)
        for a, b, c in zip(got.export_arrays(train), want.export_arrays(train), synthetic.export_arrays(train)))
    errors = []
    for pkg in (port, ref):
        try:
            getattr(pkg, name)(fallback_synthetic=False)
            errors.append(None)
        except Exception as exc:
            errors.append(type(exc).__name__)
    out[name + "_errors"] = errors
print(json.dumps(out))
"""


def test_mnist_and_cifar10_fall_back_to_the_synthetic_arrays_when_the_hub_is_unreachable(tmp_path):
    """In an interpreter whose environment turns the hub offline before
    ``datasets`` is imported: ``mnist()`` / ``cifar10()`` return the
    synthetic stand-ins, equal to the JAX package's, and with
    ``fallback_synthetic=False`` the hub's error propagates, of the same
    type in both packages."""
    env = {**os.environ, "HF_HUB_OFFLINE": "1", "HF_DATASETS_OFFLINE": "1", "HF_HOME": str(tmp_path / "hf"),
           "HF_DATASETS_CACHE": str(tmp_path / "hf" / "datasets"), "JAX_PLATFORMS": "cpu",
           "PYTHONPATH": os.pathsep.join([str(ROOT), os.environ.get("PYTHONPATH", "")])}
    run = subprocess.run([sys.executable, "-c", _HUB_SCRIPT], cwd=tmp_path, env=env, capture_output=True,
                         text=True, timeout=240)
    assert run.returncode == 0, run.stdout[-2000:] + run.stderr[-3000:]
    out = json.loads(run.stdout.strip().splitlines()[-1])
    assert out["mnist"] and out["cifar10"], out
    for name in ("mnist", "cifar10"):
        port_error, ref_error = out[name + "_errors"]
        assert port_error is not None and port_error == ref_error, out


def test_loaders_import_datasets_only_when_called():
    """On a machine without ``datasets`` or ``pandas`` the port's dataset
    modules import, a loader raises ImportError (which ``mnist()`` /
    ``cifar10()`` turn into the fallback)."""
    code = ("import sys; sys.modules['datasets'] = None; sys.modules['pandas'] = None\n"
            "import p2pfl_tpu_torch.learning.dataset as d\n"
            "assert d.mnist().get_num_samples() == d.synthetic_mnist().get_num_samples()\n"
            "try:\n    d.FederatedDataset.from_csv('rows.csv')\nexcept ImportError:\n    print('gated')\n")
    run = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert run.returncode == 0 and run.stdout.strip() == "gated", run.stdout + run.stderr[-2000:]


# --- vision interop ----------------------------------------------------------------------


class _Pairs:
    """A torchvision-like map-style dataset of (uint8 image, label) pairs,
    without the dense ``.data`` / ``.targets`` attributes."""

    def __init__(self, n, seed=0, dtype=np.uint8):
        rng = np.random.default_rng(seed)
        self.images = rng.integers(0, np.iinfo(dtype).max, size=(n, 28, 28)).astype(dtype)
        self.labels = rng.integers(0, 10, size=n)

    def __iter__(self):
        return iter(zip(self.images, self.labels))


def test_vision_pairs_to_arrays_equals_jax_on_uint8_and_int_pairs():
    for dtype in (np.uint8, np.uint16):
        got = vision.vision_pairs_to_arrays(_Pairs(12, dtype=dtype))
        ref = jax_vision.vision_pairs_to_arrays(_Pairs(12, dtype=dtype))
        for a, b in zip(got, ref):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
        assert got[0].dtype == np.float32 and 0.0 <= got[0].min() and got[0].max() <= 1.0

    class DenseStyle:  # torchvision-like: whole split as .data/.targets
        data = np.arange(4 * 28 * 28, dtype=np.uint16).reshape(4, 28, 28)
        targets = [0, 1, 2, 3]

        def __iter__(self):  # the fast path must win
            raise AssertionError("fast path not taken")

    for a, b in zip(vision.vision_pairs_to_arrays(DenseStyle()), jax_vision.vision_pairs_to_arrays(DenseStyle())):
        np.testing.assert_array_equal(a, b)


def test_vision_transforms_and_empty_input_follow_jax():
    class WithTransform:
        data = np.zeros((2, 4, 4), dtype=np.uint8)
        targets = [0, 1]
        transform = staticmethod(lambda img: np.asarray(img) + 1.0)

        def __iter__(self):
            for img, t in zip(self.data, self.targets):
                yield self.transform(img), t

    got, ref = vision.vision_pairs_to_arrays(WithTransform()), jax_vision.vision_pairs_to_arrays(WithTransform())
    assert got[0].min() == 1.0  # the transform ran: the per-item path was taken
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, b)

    class Empty:
        data = np.zeros((0, 4, 4), dtype=np.uint8)
        targets = []

        def __iter__(self):
            return iter(())

    for mod in (vision, jax_vision):
        with pytest.raises(ValueError, match="empty"):
            mod.vision_pairs_to_arrays(Empty())
        with pytest.raises(ValueError, match="empty"):
            mod.vision_pairs_to_arrays([])


def test_from_vision_datasets_equals_jax_and_partitions():
    got = vision.from_vision_datasets(_Pairs(32), _Pairs(8, seed=1))
    ref = jax_vision.from_vision_datasets(_Pairs(32), _Pairs(8, seed=1))
    for train in (True, False):
        _assert_same(got, ref, train)
    assert vision.from_vision_datasets(_Pairs(8)).get_num_samples() == 8
    parts = got.generate_partitions(4, RandomIIDPartitionStrategy, seed=0)
    for mine, theirs in zip(parts, ref.generate_partitions(4, JaxIID, seed=0)):
        for a, b in zip(mine.export_batches(4), theirs.export_batches(4)):
            np.testing.assert_array_equal(a, b)
    assert vision.SUPPORTED_DATASETS == jax_vision.SUPPORTED_DATASETS


def test_load_torchvision_gated(tmp_path):
    from p2pfl_tpu_torch.learning.dataset import load_torchvision

    try:
        import torchvision  # noqa: F401
    except ImportError:
        with pytest.raises(ImportError, match="synthetic_mnist"):
            load_torchvision("MNIST", cache_dir=str(tmp_path))
    else:  # torchvision present: only the no-download path, never a fetch
        with pytest.raises(RuntimeError):
            load_torchvision("MNIST", cache_dir=str(tmp_path), download=False)
