#!/usr/bin/env python
"""Static correctness analysis CLI for the PyTorch port.

Runs the port's C1-C5 checkers (p2pfl_tpu_torch/analysis/checkers.py) over its
package tree and reconciles findings against the committed suppression
baseline.

Exit codes: 0 clean | 1 new finding | 2 stale suppression | 3 usage error.

Examples:

    python scripts/torch_analyze.py --baseline analysis_baseline_torch.json
    python scripts/torch_analyze.py --checks C1,C2         # subset, no baseline
    python scripts/torch_analyze.py --baseline analysis_baseline_torch.json \
        --write-baseline  # refresh (reasons to be filled in by hand)
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from p2pfl_tpu_torch.analysis import (  # noqa: E402
    ALL_CHECKERS,
    Baseline,
    compare,
    run_checkers,
)
from p2pfl_tpu_torch.analysis.baseline import Suppression  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument(
        "--root",
        default=str(Path(__file__).resolve().parent.parent),
        help="repo root (default: this repo)",
    )
    ap.add_argument(
        "--subdirs",
        default="p2pfl_tpu_torch",
        help="comma-separated subtrees to scan (default: p2pfl_tpu_torch)",
    )
    ap.add_argument("--baseline", default=None, help="suppression baseline JSON")
    ap.add_argument(
        "--checks",
        default=None,
        help=f"comma-separated subset of {','.join(sorted(ALL_CHECKERS))}",
    )
    ap.add_argument(
        "--write-baseline",
        action="store_true",
        help="write current findings to --baseline (reason: TODO) and exit 0",
    )
    ap.add_argument("--json", action="store_true", help="machine-readable output")
    args = ap.parse_args(argv)

    checks = None
    if args.checks:
        checks = [c.strip().upper() for c in args.checks.split(",") if c.strip()]
        unknown = [c for c in checks if c not in ALL_CHECKERS]
        if unknown:
            print(f"unknown checks: {unknown}", file=sys.stderr)
            return 3

    root = Path(args.root).resolve()
    subdirs = [s.strip() for s in args.subdirs.split(",") if s.strip()]
    findings = run_checkers(root, subdirs, checks)

    if args.write_baseline:
        if not args.baseline:
            print("--write-baseline requires --baseline", file=sys.stderr)
            return 3
        bl = Baseline(
            [Suppression(f.checker, f.key, "TODO: justify or fix") for f in findings]
        )
        bl.save(Path(args.baseline))
        print(f"wrote {len(findings)} suppressions to {args.baseline}")
        return 0

    baseline = Baseline()
    if args.baseline:
        try:
            baseline = Baseline.load(Path(args.baseline))
        except FileNotFoundError:
            print(f"baseline {args.baseline} not found", file=sys.stderr)
            return 3
        except ValueError as exc:
            print(f"bad baseline: {exc}", file=sys.stderr)
            return 3

    new, suppressed, stale = compare(findings, baseline)

    if args.json:
        print(
            json.dumps(
                {
                    "new": [f.__dict__ for f in new],
                    "suppressed": [f.__dict__ for f in suppressed],
                    "stale": [s.to_json() for s in stale],
                },
                indent=2,
            )
        )
    else:
        for f in new:
            print(f"NEW  {f.render()}")
        for f in suppressed:
            print(f"SUPP {f.render()}")
        for s in stale:
            print(f"STALE suppression {s.key} ({s.reason})")
        print(
            f"-- {len(new)} new, {len(suppressed)} suppressed, "
            f"{len(stale)} stale (checks: {','.join(checks or sorted(ALL_CHECKERS))})"
        )

    if new:
        return 1
    if stale:
        return 2
    return 0


if __name__ == "__main__":
    sys.exit(main())
