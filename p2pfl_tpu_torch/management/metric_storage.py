"""Two-level metric storage.

Parity with reference management/metric_storage.py:30-251:
* local (step-wise) metrics: exp -> round -> node -> metric -> [(step, value)]
* global (round-wise) metrics: exp -> node -> metric -> [(round, value)]
Both lock-guarded.

The port's copy of ``p2pfl_tpu/management/metric_storage.py``.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Tuple

LocalMetrics = Dict[str, Dict[int, Dict[str, Dict[str, List[Tuple[int, float]]]]]]
GlobalMetrics = Dict[str, Dict[str, Dict[str, List[Tuple[int, float]]]]]


class LocalMetricStorage:
    """exp -> round -> node -> metric -> [(step, value)]"""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._store: LocalMetrics = {}

    def add(self, exp: str, round: int, node: str, metric: str, value: float, step: int = 0) -> None:
        with self._lock:
            self._store.setdefault(exp, {}).setdefault(round, {}).setdefault(node, {}).setdefault(
                metric, []
            ).append((step, float(value)))

    def get_all(self) -> LocalMetrics:
        with self._lock:
            return {
                e: {r: {n: {m: list(v) for m, v in ms.items()} for n, ms in ns.items()} for r, ns in rs.items()}
                for e, rs in self._store.items()
            }

    def get(self, exp: str) -> Dict:
        return self.get_all().get(exp, {})


class GlobalMetricStorage:
    """exp -> node -> metric -> [(round, value)]"""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._store: GlobalMetrics = {}

    def add(self, exp: str, node: str, metric: str, value: float, round: int) -> None:
        with self._lock:
            self._store.setdefault(exp, {}).setdefault(node, {}).setdefault(metric, []).append(
                (round, float(value))
            )

    def get_all(self) -> GlobalMetrics:
        with self._lock:
            return {
                e: {n: {m: list(v) for m, v in ms.items()} for n, ms in ns.items()}
                for e, ns in self._store.items()
            }

    def get(self, exp: str) -> Dict:
        return self.get_all().get(exp, {})
