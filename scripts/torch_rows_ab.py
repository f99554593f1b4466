#!/usr/bin/env python3
"""Time the port's kernel rows of two checkouts on one card, in turns.

    python3 scripts/torch_rows_ab.py BASE

``BASE`` is another checkout of the repository (for example the parent
commit unpacked with ``git archive`` under ``build/``; it needs
``chip_smoke.py`` and ``p2pfl_tpu_torch/``). Each checkout builds its own
kernels into its own ``build/`` and runs, in a subprocess, its
``chip_smoke.py`` kernel and carry phases (rows 1-5 at head size 64), then
its ``narrow_rows`` in bf16 at [8, 1024, 16, 32], [8, 1024, 32, 16], [8,
1024, 8, 48], [8, 1024, 4, 128], [8, 1024, 2, 256], [8, 1024, 1, 512] and [8,
1024, 1, 1024] (the eval forward at batch 16; and the carry's past fold of
one ring chunk [2, 1024, H, D]), and rows 1-4 at the flash
classifier's and the longcontext example's own shapes (its
``phase_kernels_classifier`` and ``phase_kernels_longcontext``): every row
held to its plain version, then timed with CUDA events, and the source of
the bf16 kernel each row runs there (its ``row_source``). Then the
federated LM at width 512 over 1 head (D 512, 4 layers) and at width 1024
over 1 head (D 1024, 1 layer), one round after a warm-up round each, as
``chip_smoke.py``'s wide and chunked paths drive them: ``lm_d<D>`` is that
round's s/round; and the ring trainer (8192 tokens in 8 shards, batch 2) at
width 512 over 4, 2 and 1 heads (D 128, 256, 512; 4 layers) and at width
1024 over 1 head (D 1024, 1 layer): ``ring_d<D>`` is the mean s/step of two
steps after a warm-up step (host clock, ending in
``torch.cuda.synchronize()``; the rows are device times). The order is BASE,
this tree, this tree, BASE, so that drift shows. Prints each run's numbers
and sources and, last, one JSON object ``{"runs": [{"tree": ..., "ms":
{row: ms}, "sources": {row: source}}, ...]}``. Runs on the card only.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

CHILD = """
import json, sys, time
sys.path.insert(0, {root!r})
import numpy as np
import torch
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
import chip_smoke as cs
rows = cs.phase_kernels()
rows.update(cs.phase_carry())
gen = torch.Generator().manual_seed(16)
for d, heads in ((32, 16), (16, 32), (48, 8), (128, 4), (256, 2), (512, 1), (1024, 1)):
    rows.update(cs.narrow_rows("ab", f"_d{{d}}", d, heads, cs.BATCH, cs.EVAL_SEQS, cs.SEQ_LEN,
                               (torch.bfloat16,), True, gen))
rows.update(cs.phase_kernels_classifier())
rows.update(cs.phase_kernels_longcontext())
ms = {{name: r["ms"] for name, r in rows.items()}}
ms["flash_carry_diagonal"] = rows["flash_carry"]["ms_diagonal"]
dims = {{"": 64, "_d32": 32, "_d16": 16, "_d48": 48, "_d128": 128, "_d256": 256, "_d512": 512, "_d1024": 1024,
         cs.CLS_SUFFIX: 32, cs.LC_SUFFIX: 16}}
sources = {{name + sfx: cs.row_source(name, d, src) for name, (_, _, src) in {{**cs.KERNEL_ROWS, **cs.RING_KERNEL_ROWS}}.items()
           for sfx, d in dims.items() if name + sfx in ms}}
print("SOURCES " + json.dumps(sources))
from p2pfl_tpu_torch.models.transformer import transformer_lm_model
from p2pfl_tpu_torch.parallel.simulation import MeshSimulation
for d, layers in ((512, cs.LAYERS), (1024, cs.CHUNKED_LAYERS)):
    model = transformer_lm_model(seed=0, vocab_size=cs.VOCAB, num_layers=layers, num_heads=1, embed_dim=d,
                                 attention_kind="flash", device="cuda")
    train, xt = cs.lm_data(6)
    sim = MeshSimulation(model, train, test_data=(xt, None), train_set_size=cs.COMMITTEE, batch_size=cs.BATCH,
                         lr=cs.LR, seed=1, task="lm", device="cuda")
    ms[f"lm_d{{d}}"] = sim.run(rounds=1, epochs=1, warmup=True).seconds_per_round
    del sim, model
from p2pfl_tpu_torch.optim import adam
from p2pfl_tpu_torch.parallel.mesh import Mesh
from p2pfl_tpu_torch.parallel.sequence import make_sequence_parallel_train_step, shard_tokens
rng = np.random.default_rng(8)
x = ((rng.integers(0, cs.VOCAB, size=(cs.RING_BATCH, 1)) + np.arange(cs.RING_SEQ)) % cs.VOCAB).astype(np.int32)
mesh = Mesh({{"seq": cs.RING_SHARDS}}, device="cuda")
tokens = shard_tokens(x, mesh)
for d, heads, layers in ((128, 4, cs.LAYERS), (256, 2, cs.LAYERS), (512, 1, cs.LAYERS), (1024, 1, cs.CHUNKED_LAYERS)):
    model = transformer_lm_model(0, cs.RING_SEQ, cs.VOCAB, layers, heads, d * heads, "ring_flash", "seq",
                                 device="cuda")
    opt = adam(cs.LR)
    step = make_sequence_parallel_train_step(model.apply, opt, mesh, "seq")
    params, state = model.params, opt.init(model.params)
    params, state, loss = step(params, state, tokens)  # warm-up
    torch.cuda.synchronize()
    t0 = time.monotonic()
    for _ in range(2):
        params, state, loss = step(params, state, tokens)
    torch.cuda.synchronize()
    ms[f"ring_d{{d}}"] = (time.monotonic() - t0) / 2
    del model, params, state, step
print("ROWS " + json.dumps(ms))
"""


def run(tree: Path) -> tuple:
    """``({row: ms}, {row: source})`` of one run of ``tree``."""
    out = subprocess.run([sys.executable, "-c", CHILD.format(root=str(tree.resolve()))], cwd=tree,
                         capture_output=True, text=True, timeout=900)
    if out.returncode != 0:
        raise RuntimeError(f"{tree}: exit {out.returncode}\n{out.stdout[-3000:]}\n{out.stderr[-3000:]}")
    found = {key: json.loads(l[len(key) + 1:]) for l in out.stdout.splitlines()
             for key in ("ROWS", "SOURCES") if l.startswith(key + " ")}
    return found["ROWS"], found["SOURCES"]


def main() -> int:
    if len(sys.argv) != 2:
        print(__doc__.strip().splitlines()[2].strip(), file=sys.stderr)
        return 2
    base = Path(sys.argv[1])
    runs = []
    for label, tree in (("BASE", base), ("tree", ROOT), ("tree", ROOT), ("BASE", base)):
        ms, sources = run(tree)
        runs.append({"tree": label, "ms": ms, "sources": sources})
        print(f"{label}: " + ", ".join(f"{k} {v:.4f}" for k, v in ms.items()))
        print(f"{label} sources: " + ", ".join(f"{k} {Path(v).name}" for k, v in sources.items()))
    print(json.dumps({"runs": runs}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
