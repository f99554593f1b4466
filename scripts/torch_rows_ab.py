#!/usr/bin/env python3
"""Time the port's kernel rows 1-5 (head size 64) of two checkouts on one card, in turns.

    python3 scripts/torch_rows_ab.py BASE

``BASE`` is another checkout of the repository (for example the parent
commit unpacked with ``git archive`` under ``build/``; it needs
``chip_smoke.py`` and ``p2pfl_tpu_torch/``). Each checkout builds its own
kernels into its own ``build/`` and runs its ``chip_smoke.py`` kernel and
carry phases (every row held to its plain version, then timed with CUDA
events) in a subprocess, in the order BASE, this tree, this tree, BASE, so
that drift shows. Prints each run's row times and, last, one JSON object
``{"runs": [{"tree": ..., "ms": {row: ms}}, ...]}``. Runs on the card only.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

CHILD = """
import json, sys
sys.path.insert(0, {root!r})
import torch
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
import chip_smoke as cs
rows = cs.phase_kernels()
rows.update(cs.phase_carry())
ms = {{name: r["ms"] for name, r in rows.items()}}
ms["flash_carry_diagonal"] = rows["flash_carry"]["ms_diagonal"]
print("ROWS " + json.dumps(ms))
"""


def run(tree: Path) -> dict:
    out = subprocess.run([sys.executable, "-c", CHILD.format(root=str(tree.resolve()))], cwd=tree,
                         capture_output=True, text=True, timeout=900)
    if out.returncode != 0:
        raise RuntimeError(f"{tree}: exit {out.returncode}\n{out.stdout[-3000:]}\n{out.stderr[-3000:]}")
    line = next(l for l in out.stdout.splitlines() if l.startswith("ROWS "))
    return json.loads(line[5:])


def main() -> int:
    if len(sys.argv) != 2:
        print(__doc__.strip().splitlines()[2].strip(), file=sys.stderr)
        return 2
    base = Path(sys.argv[1])
    runs = []
    for label, tree in (("BASE", base), ("tree", ROOT), ("tree", ROOT), ("BASE", base)):
        ms = run(tree)
        runs.append({"tree": label, "ms": ms})
        print(f"{label}: " + ", ".join(f"{k} {v:.4f}" for k, v in ms.items()))
    print(json.dumps({"runs": runs}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
