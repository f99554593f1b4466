"""Import hygiene of the port: every module of ``p2pfl_tpu_torch``, every
``scripts/torch_*_check.py`` / ``scripts/torch_analyze.py``, and the rank
workers ``tests/torch_multirank_worker.py``,
``tests/torch_seqstage_worker.py``, ``tests/torch_expert_model_worker.py``
and ``tests/torch_sharded_worker.py`` import
with JAX, flax, optax, ml_dtypes, msgpack and the JAX package blocked (the
card's machine has none of them), and Hugging Face ``datasets`` and pandas
too (the dataset loaders import them when called), in a fresh
interpreter."""

import subprocess
import sys
from pathlib import Path

BLOCKED = ("jax", "jaxlib", "flax", "optax", "ml_dtypes", "msgpack", "p2pfl_tpu", "datasets", "pandas")

SCRIPT = f"""
import importlib, pkgutil, sys
for name in {BLOCKED!r}:
    sys.modules[name] = None  # any import of it (or a submodule) raises ImportError
import p2pfl_tpu_torch
names = ["p2pfl_tpu_torch"] + [m.name for m in pkgutil.walk_packages(p2pfl_tpu_torch.__path__, "p2pfl_tpu_torch.")]
assert {{"p2pfl_tpu_torch.management.checkpoint", "p2pfl_tpu_torch.population.engine",
         "p2pfl_tpu_torch.population.sharding", "p2pfl_tpu_torch.population.scenarios",
         "p2pfl_tpu_torch.population.arrivals", "p2pfl_tpu_torch.population.async_engine",
         "p2pfl_tpu_torch.population.supervisor", "p2pfl_tpu_torch.config",
         "p2pfl_tpu_torch.population", "p2pfl_tpu_torch.campaigns", "p2pfl_tpu_torch.campaigns.matrix",
         "p2pfl_tpu_torch.campaigns.invariants", "p2pfl_tpu_torch.campaigns.engine",
         "p2pfl_tpu_torch.analysis", "p2pfl_tpu_torch.analysis.core", "p2pfl_tpu_torch.analysis.checkers",
         "p2pfl_tpu_torch.analysis.baseline", "p2pfl_tpu_torch.analysis.runtime",
         "p2pfl_tpu_torch.learning.dataset.vision", "p2pfl_tpu_torch.parallel.collectives",
         "p2pfl_tpu_torch.parallel.launch", "p2pfl_tpu_torch.parallel.mesh", "p2pfl_tpu_torch.parallel.pipeline",
         "p2pfl_tpu_torch.parallel.sequence", "p2pfl_tpu_torch.ops.ring_attention",
         "p2pfl_tpu_torch.parallel.tensor_parallel", "p2pfl_tpu_torch.parallel.simulation",
         "p2pfl_tpu_torch.models.moe", "p2pfl_tpu_torch.models.transformer", "p2pfl_tpu_torch.models.cnn",
         "p2pfl_tpu_torch.models.mlp", "p2pfl_tpu_torch.models.resnet", "p2pfl_tpu_torch.ops.aggregation",
         "p2pfl_tpu_torch.learning.learner"}} <= set(names), names
for name in names:
    importlib.import_module(name)
import glob, importlib.util
scripts = sorted(glob.glob("scripts/torch_*_check.py")) + ["scripts/torch_analyze.py"]
scripts += ["tests/torch_multirank_worker.py", "tests/torch_seqstage_worker.py",
            "tests/torch_expert_model_worker.py", "tests/torch_sharded_worker.py"]
assert len(scripts) == 9, scripts
for path in scripts:
    spec = importlib.util.spec_from_file_location("script_" + path.split("/")[-1][:-3], path)
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
names += scripts
leaked = sorted(n for n in sys.modules if sys.modules[n] is not None and n.split(".")[0] in {BLOCKED!r})
assert not leaked, leaked
print(len(names))
"""


def test_every_port_module_imports_without_jax_or_the_jax_package():
    root = Path(__file__).resolve().parents[1]
    out = subprocess.run([sys.executable, "-c", SCRIPT], cwd=root, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert int(out.stdout.strip().splitlines()[-1]) >= 30  # every module was walked
