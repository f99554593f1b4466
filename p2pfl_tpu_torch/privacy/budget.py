"""Per-node privacy-budget ledger (the port's copy of
``p2pfl_tpu/privacy/budget.py``).

Wires the RDP accountant (:mod:`p2pfl_tpu_torch.learning.privacy` — conservative
Gaussian-mechanism composition, no subsampling-amplification claim) into a
process-wide per-node ledger the rest of the federation can see:

* the learner reports every fit's DP-SGD step count (and any NON-private
  steps, which void the guarantee — epsilon must read ``inf``, never 0);
* the ledger exposes the cumulative ``(epsilon, delta)`` spend through the
  ``p2pfl_privacy_epsilon`` gauge, the health digest (``dp_epsilon`` field,
  absent-tolerated like every digest field), the observatory snapshot, and
  the observatory's EPS column — a node's remaining budget is a fleet-visible
  operational fact, not a local print statement.

Epsilon conventions: ``-1`` in wire/serialized forms means "no DP claim"
(infinite epsilon or no DP steps at all) because JSON cannot carry ``inf``;
in-process the ledger reports the honest float (``math.inf`` included).
"""

from __future__ import annotations

import math
import threading
from typing import Any, Dict, Optional

from p2pfl_tpu_torch.config import Settings
from p2pfl_tpu_torch.learning.privacy import dp_sgd_privacy_spent
from p2pfl_tpu_torch.telemetry import REGISTRY

_EPSILON = REGISTRY.gauge(
    "p2pfl_privacy_epsilon",
    "Cumulative (epsilon, PRIVACY_DELTA)-DP spend of this node's training "
    "(conservative Gaussian RDP composition; -1 = no valid DP claim — "
    "noise off or non-private steps taken)",
    labels=("node",),
)
_DP_STEPS = REGISTRY.counter(
    "p2pfl_privacy_dp_steps_total",
    "Training steps taken under the DP-SGD mechanism",
    labels=("node",),
)


class PrivacyBudgetLedger:
    """Process-wide {node -> cumulative DP accounting}. Thread-safe; one
    instance (:data:`BUDGETS`) serves every in-process node."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._acct: Dict[str, Dict[str, Any]] = {}

    def record(
        self,
        node: str,
        *,
        clip_norm: float,
        noise_multiplier: float,
        dp_steps: int = 0,
        nonprivate_steps: int = 0,
    ) -> None:
        """Fold one fit's step counts into ``node``'s ledger entry and
        refresh the gauge. Mixing sigma/clip across fits keeps the WEAKEST
        configuration (smallest sigma, largest clip) — the conservative
        direction for a composed bound."""
        with self._lock:
            a = self._acct.setdefault(
                node,
                {
                    "clip_norm": 0.0,
                    "noise_multiplier": math.inf,
                    "dp_steps": 0,
                    "nonprivate_steps": 0,
                },
            )
            if dp_steps > 0:
                a["clip_norm"] = max(a["clip_norm"], float(clip_norm))
                a["noise_multiplier"] = min(
                    a["noise_multiplier"], float(noise_multiplier)
                )
                a["dp_steps"] += int(dp_steps)
            a["nonprivate_steps"] += int(nonprivate_steps)
            spent = self._spent_locked(node)
        if dp_steps > 0:
            _DP_STEPS.labels(node).inc(dp_steps)
        _EPSILON.labels(node).set(wire_epsilon(spent["epsilon"]))

    def _spent_locked(self, node: str) -> Dict[str, Any]:
        a = self._acct.get(node)
        if a is None or (a["dp_steps"] == 0 and a["nonprivate_steps"] == 0):
            return dp_sgd_privacy_spent(0.0, 0.0, 0, Settings.PRIVACY_DELTA)
        sigma = a["noise_multiplier"]
        return dp_sgd_privacy_spent(
            0.0 if math.isinf(sigma) else sigma,
            a["clip_norm"],
            a["dp_steps"],
            Settings.PRIVACY_DELTA,
            nonprivate_steps=a["nonprivate_steps"],
        )

    def spent(self, node: str) -> Dict[str, Any]:
        """Cumulative accountant summary for ``node`` (epsilon may be 0 —
        nothing released — or ``inf`` — guarantee voided)."""
        with self._lock:
            return self._spent_locked(node)

    def epsilon(self, node: str) -> float:
        return float(self.spent(node)["epsilon"])

    def reset(self, node: Optional[str] = None) -> None:
        with self._lock:
            if node is None:
                self._acct.clear()
            else:
                self._acct.pop(node, None)


def wire_epsilon(eps: float) -> float:
    """JSON/metric-safe epsilon: ``-1`` encodes "no valid DP claim"
    (``inf``) and "no DP steps" (0 with no mechanism) both round-trip."""
    if eps is None or math.isinf(eps) or math.isnan(eps):
        return -1.0
    return float(eps)


#: The process-wide privacy-budget ledger.
BUDGETS = PrivacyBudgetLedger()

__all__ = ["BUDGETS", "PrivacyBudgetLedger", "wire_epsilon"]
