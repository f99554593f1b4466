#!/usr/bin/env python3
"""Where an async population window's time goes, on one card.

    python3 scripts/torch_asyncpop_breakdown.py [NODES] [WINDOWS]

Builds the engine of ``chip_smoke.py``'s async throughput arm (NODES
virtual nodes, default 100,000; cohort 0.01; speed tiers (1, 1, 1, 2, 5);
seed 42; the ledger attached) and runs one warm-up window. Then four runs
of WINDOWS windows each (default 3), the device observatory on, off, off,
on, with no tracing: each run's seconds a window and a folded member, and
the schedule's host time. Last, one window traced by the engine's own
device trace window (``run``'s ``profile_dir``): the host time of each of
the window's ``record_function`` ranges
(:data:`p2pfl_tpu_torch.population.async_engine.TRACE_RANGES`), the rest of
the traced span, the kernels' device time over the span and their
launches. The profiler's per-op cost inflates the traced window's host
times, the op-heavy parts most. Prints one line a run and, last, one JSON
object. Runs on the card only.
"""

from __future__ import annotations

import json
import shutil
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def trace_split(trace_file: Path, ranges: tuple) -> dict:
    """From one Chrome trace: the host's traced span (first host event's
    start to the last one's end), the seconds of each named host range in
    it, and the CUDA kernels' seconds and count."""
    events = json.loads(trace_file.read_text()).get("traceEvents", [])
    spent = {name: 0.0 for name in ranges}
    kernel_us, launches = 0.0, 0
    first, last = float("inf"), float("-inf")
    for ev in events:
        if ev.get("ph") != "X":
            continue
        cat = str(ev.get("cat", ""))
        ts, dur = float(ev.get("ts", 0.0)), float(ev.get("dur", 0.0))
        if cat == "kernel":
            kernel_us += dur
            launches += 1
        elif not cat.startswith("gpu_"):
            first, last = min(first, ts), max(last, ts + dur)
            if ev.get("name") in spent:
                spent[ev["name"]] += dur / 1e6
    return {"span_s": max(0.0, last - first) / 1e6, "ranges_s": spent, "device_busy_s": kernel_us / 1e6,
            "kernel_launches": launches}


def main(argv: list) -> int:
    import torch

    import chip_smoke as cs
    from p2pfl_tpu_torch.config import Settings
    from p2pfl_tpu_torch.population import AsyncPopulationEngine
    from p2pfl_tpu_torch.population.async_engine import TRACE_RANGES

    if not torch.cuda.is_available():
        print("torch_asyncpop_breakdown: no CUDA device visible", file=sys.stderr)
        return 1
    nodes = int(argv[0]) if argv else cs.POP_NODES
    windows = int(argv[1]) if len(argv) > 1 else 3
    card = cs.nvidia_smi()
    eng = AsyncPopulationEngine(nodes, cohort_fraction=cs.POP_COHORT, seed=cs.POP_SEED, speed_tiers=cs.ASYNC_TIERS,
                                device="cuda")
    eng.attach_ledger(run_id=f"asyncpop-breakdown-n{nodes}")
    eng.run(1, profile_dir="")  # warm-up: allocator growth, library set-up
    out = {"runs": []}
    for devobs in (True, False, False, True):
        with Settings.overridden(DEVOBS_ENABLED=devobs):
            sched_t = time.monotonic()
            eng.schedule(windows)
            sched_s = time.monotonic() - sched_t
            res = eng.run(windows, eval_every=windows, profile_dir="")
        members = int(res.fills.sum())
        row = {"devobs": devobs, "s_per_window": res.seconds_per_window,
               "ms_per_member": 1e3 * res.seconds_total / max(1, members), "members_per_window": members / windows,
               "schedule_s_per_window": sched_s / windows}
        out["runs"].append(row)
        print(f"[breakdown] n={nodes}, devobs {'on' if devobs else 'off'}, {windows} windows: "
              + ", ".join(f"{k} {v}" for k, v in row.items() if k != "devobs") + f" [{card}]")
    tmp = Path(tempfile.mkdtemp(prefix="asyncpop_trace_"))
    try:
        with Settings.overridden(DEVOBS_ENABLED=True, DEVOBS_PROFILE_CHUNKS=1):
            res = eng.run(1, profile_dir=str(tmp))
        split = trace_split(tmp / "asyncpop_window_chunk0" / "trace.json", TRACE_RANGES)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    spent, span_s = split["ranges_s"], split["span_s"]
    traced = {"span_s": span_s, "folded": int(res.fills.sum()),
              **{k.split("/")[1] + "_s": v for k, v in spent.items()},
              "other_s": span_s - sum(spent.values()), "device_busy_s": split["device_busy_s"],
              "busy_share": split["device_busy_s"] / span_s, "kernel_launches": split["kernel_launches"]}
    out["traced_window"] = traced
    print("[breakdown] one traced window: " + ", ".join(f"{k} {v}" for k, v in traced.items()) + f" [{card}]")
    eng.close()
    print(card)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
