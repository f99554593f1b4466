"""Import hygiene of the port: every module of ``p2pfl_tpu_torch`` imports
with JAX, flax, optax, ml_dtypes, msgpack and the JAX package blocked (the
card's machine has none of them), in a fresh interpreter."""

import subprocess
import sys
from pathlib import Path

BLOCKED = ("jax", "jaxlib", "flax", "optax", "ml_dtypes", "msgpack", "p2pfl_tpu")

SCRIPT = f"""
import importlib, pkgutil, sys
for name in {BLOCKED!r}:
    sys.modules[name] = None  # any import of it (or a submodule) raises ImportError
import p2pfl_tpu_torch
names = ["p2pfl_tpu_torch"] + [m.name for m in pkgutil.walk_packages(p2pfl_tpu_torch.__path__, "p2pfl_tpu_torch.")]
for name in names:
    importlib.import_module(name)
leaked = sorted(n for n in sys.modules if sys.modules[n] is not None and n.split(".")[0] in {BLOCKED!r})
assert not leaked, leaked
print(len(names))
"""


def test_every_port_module_imports_without_jax_or_the_jax_package():
    root = Path(__file__).resolve().parents[1]
    out = subprocess.run([sys.executable, "-c", SCRIPT], cwd=root, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert int(out.stdout.strip().splitlines()[-1]) >= 30  # every module was walked
