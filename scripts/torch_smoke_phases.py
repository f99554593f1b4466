"""Run some of ``chip_smoke.py``'s phases on the card, after its build.

    python3 scripts/torch_smoke_phases.py recovery population asyncpop

Each argument names a ``phase_<name>`` of ``chip_smoke.py`` that takes the
card's name (``nvidia-smi``'s name and power limit) as its only argument;
``phase_env`` (the kernels' build) runs first. Exits 1 when a phase fails.
"""

from __future__ import annotations

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(names: list) -> int:
    import torch

    import chip_smoke as cs

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cs.time_phases()
    t0 = time.monotonic()
    try:
        card = cs.phase_env()
        for name in names:
            getattr(cs, f"phase_{name}")(card)
    except Exception as e:  # noqa: BLE001 - any failed phase fails the run
        import traceback

        traceback.print_exc()
        print(f"torch_smoke_phases: FAILED: {type(e).__name__}: {e}", file=sys.stderr)
        return 1
    print(f"[phases] {' '.join(names)} done in {time.monotonic() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
