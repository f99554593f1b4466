#!/usr/bin/env python3
"""Split one bf16 carry fold's device time between the CUDA kernels it runs.

    python3 scripts/torch_carry_breakdown.py [BASE]

For this tree and, when given, another checkout ``BASE`` first (for example
the parent commit unpacked with ``git archive`` under ``build/``; it needs
``chip_smoke.py`` and ``p2pfl_tpu_torch/``): a past fold of one ring chunk
[2, 1024, H, D] bf16 into the carry of shard 7 of 8 (as ``chip_smoke.py``
times it) at D 32 / 16 / 48 (H 16 / 32 / 8), called 20 times under
``torch.profiler`` after a warm-up, each in a fresh process (on the card,
the later profiler sessions of a long process were seen to record no
kernel) that builds that checkout's kernels into its own ``build/``. Prints,
per tree and D, the CUDA kernels one call runs and each one's device time
per call in us (a wrapper's pad and slice copies and the carry kernel),
their sum, and the call's time by CUDA events (``chip_smoke.time_ms``,
after the profiled calls); last, one JSON object ``{"runs": [{"tree": ...,
"D": ..., "kernels": {name: us}, "per_call": n, "ms": ms}, ...]}``. Runs on
the card only.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CALLS = 20
SHAPES = ((32, 16), (16, 32), (48, 8))  # (D, H): the width 512 of the ring LM

CHILD = """
import json, sys
sys.path.insert(0, {root!r})
import torch
from torch.profiler import ProfilerActivity, profile
import chip_smoke as cs
from p2pfl_tpu_torch.ops import _kernels
from p2pfl_tpu_torch.ops import attention as att
gen = torch.Generator().manual_seed(17)
q, k, v, kp, vp = (torch.randn((2, 1024, {h}, {d}), generator=gen).to("cuda", torch.bfloat16) for _ in range(5))
off = 7 * 1024
diag = _kernels.flash_carry(att.init_carry(q.shape, q.device), q, k, v, off, off, True)
call = lambda: _kernels.flash_carry(diag, q, kp, vp, off, 0, True)
call()
torch.cuda.synchronize()
with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
    for _ in range({calls}):
        call()
    torch.cuda.synchronize()
found = cs.cuda_kernels(prof)
kernels = {{}}
for us, name in found:
    kernels[name] = kernels.get(name, 0.0) + us / {calls}
print("FOLD " + json.dumps({{"kernels": kernels, "per_call": len(found) / {calls}, "ms": cs.time_ms(call, 20)}}))
"""


def run(tree: Path, d: int, h: int) -> dict:
    code = CHILD.format(root=str(tree.resolve()), d=d, h=h, calls=CALLS)
    out = subprocess.run([sys.executable, "-c", code], cwd=tree, capture_output=True, text=True, timeout=900)
    if out.returncode != 0:
        raise RuntimeError(f"{tree} D={d}: exit {out.returncode}\n{out.stdout[-3000:]}\n{out.stderr[-3000:]}")
    line = next(l for l in out.stdout.splitlines() if l.startswith("FOLD "))
    return json.loads(line[len("FOLD "):])


def main() -> int:
    import chip_smoke

    print(f"card: {chip_smoke.nvidia_smi()}")
    trees = ([("BASE", Path(sys.argv[1]))] if len(sys.argv) > 1 else []) + [("tree", ROOT)]
    runs = []
    for label, tree in trees:
        for d, h in SHAPES:
            fold = run(tree, d, h)
            runs.append({"tree": label, "D": d, **fold})
            total = sum(fold["kernels"].values())
            print(f"{label} D={d} [2, 1024, {h}, {d}] past fold: {fold['per_call']:g} CUDA kernels a call, "
                  f"{total:.2f} us of kernels a call (profiler), {fold['ms']:.4f} ms a call (CUDA events)")
            for name, us in sorted(fold["kernels"].items(), key=lambda kv: -kv[1]):
                print(f"    {us:9.2f} us  {name[:150]}")
    print(json.dumps({"runs": runs}))
    return 0


if __name__ == "__main__":
    sys.path.insert(0, str(ROOT))
    sys.exit(main())
