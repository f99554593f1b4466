"""Suppression baseline for the static checkers.

The committed ``analysis_baseline_torch.json`` is the ONLY sanctioned way to ship
a known finding: every entry must carry a written reason, the CLI fails on
entries that no longer match anything (stale suppressions rot into lies),
and the acceptance bar keeps the file small — a baseline that grows is a
tree getting worse.

Exit-code contract (scripts/torch_analyze.py):

* ``0`` — no new findings, no stale suppressions
* ``1`` — at least one NEW finding (not in the baseline)
* ``2`` — at least one STALE suppression (baseline entry matching nothing)
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Sequence, Tuple

from p2pfl_tpu_torch.analysis.core import Finding

BASELINE_VERSION = 1


@dataclass
class Suppression:
    checker: str
    key: str
    reason: str

    def to_json(self) -> Dict[str, str]:
        return {"checker": self.checker, "key": self.key, "reason": self.reason}


@dataclass
class Baseline:
    suppressions: List[Suppression] = field(default_factory=list)

    @classmethod
    def load(cls, path: Path) -> "Baseline":
        doc = json.loads(path.read_text())
        if doc.get("version") != BASELINE_VERSION:
            raise ValueError(
                f"baseline version {doc.get('version')!r} != {BASELINE_VERSION}"
            )
        sups = []
        for e in doc.get("suppressions", []):
            if not e.get("reason", "").strip():
                raise ValueError(
                    f"baseline entry {e.get('key')!r} has no reason — every "
                    "suppression must say WHY the finding is safe"
                )
            try:
                sups.append(Suppression(e["checker"], e["key"], e["reason"]))
            except KeyError as exc:
                raise ValueError(
                    f"baseline entry {e!r} is missing required field {exc}"
                ) from exc
        return cls(sups)

    def save(self, path: Path) -> None:
        doc = {
            "version": BASELINE_VERSION,
            "suppressions": [s.to_json() for s in self.suppressions],
        }
        path.write_text(json.dumps(doc, indent=2, sort_keys=True) + "\n")


def compare(
    findings: Sequence[Finding], baseline: Baseline
) -> Tuple[List[Finding], List[Finding], List[Suppression]]:
    """(new findings, suppressed findings, stale suppressions)."""
    by_key = {s.key: s for s in baseline.suppressions}
    new: List[Finding] = []
    suppressed: List[Finding] = []
    matched: set = set()
    for f in findings:
        if f.key in by_key:
            suppressed.append(f)
            matched.add(f.key)
        else:
            new.append(f)
    stale = [s for s in baseline.suppressions if s.key not in matched]
    return new, suppressed, stale
