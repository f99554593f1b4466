"""Process-wide metrics registry: labeled counters, gauges, histograms (a
framework-free copy of ``p2pfl_tpu/telemetry/metrics.py``).

Design constraints (the reason this exists instead of pulling in
prometheus_client, which the image doesn't ship):

* **lock-cheap hot path** — gossip ticks, heartbeats and per-frame byte
  accounting increment counters from several threads at once. A child
  (one metric + one label combination) is a slotted object holding a
  plain ``threading.Lock`` and a float; ``inc()`` is acquire/add/release,
  a fraction of a microsecond in CPython. Hot callers resolve
  ``metric.labels(...)`` once and keep the child reference.
* **process-wide** — one registry serves every in-process node (the
  in-memory federation runs many nodes per process), so per-node series
  carry a ``node`` label rather than per-node registries.
* **reset for harnesses** — ``REGISTRY.reset()`` clears *values* but keeps
  the families registered, so module-level metric handles stay valid
  across bench/test runs.

Exposition (Prometheus text format, JSON snapshot) lives in
:mod:`p2pfl_tpu_torch.telemetry.export`.
"""

from __future__ import annotations

import bisect
import threading
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

LabelValues = Tuple[str, ...]

#: Default histogram buckets: spans µs-scale hot-path costs through the
#: multi-minute aggregation timeouts seen in real federations (seconds).
DEFAULT_BUCKETS: Tuple[float, ...] = (
    0.001, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
    1.0, 2.5, 5.0, 10.0, 30.0, 60.0, 120.0, 300.0,
)


class _CounterChild:
    """One (metric, label-values) series. Hot-path object."""

    __slots__ = ("_lock", "_value")

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError("counters only go up; use a Gauge")
        with self._lock:
            self._value += amount

    @property
    def value(self) -> float:
        with self._lock:
            return self._value

    def _reset(self) -> None:
        with self._lock:
            self._value = 0.0


class _GaugeChild:
    __slots__ = ("_lock", "_value")

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._value = 0.0

    def set(self, value: float) -> None:
        with self._lock:
            self._value = float(value)

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self._value += amount

    def dec(self, amount: float = 1.0) -> None:
        with self._lock:
            self._value -= amount

    @property
    def value(self) -> float:
        with self._lock:
            return self._value

    def _reset(self) -> None:
        with self._lock:
            self._value = 0.0


class _HistogramChild:
    __slots__ = ("_lock", "_bounds", "_counts", "_sum", "_count")

    def __init__(self, bounds: Sequence[float]) -> None:
        self._lock = threading.Lock()
        self._bounds = tuple(bounds)
        self._counts = [0] * (len(bounds) + 1)  # +1 for +Inf
        self._sum = 0.0
        self._count = 0

    def observe(self, value: float) -> None:
        i = bisect.bisect_left(self._bounds, value)
        with self._lock:
            self._counts[i] += 1
            self._sum += value
            self._count += 1

    def snapshot(self) -> Tuple[Tuple[float, ...], List[int], float, int]:
        """(bounds, per-bucket counts, sum, count) — counts are NON-cumulative."""
        with self._lock:
            return self._bounds, list(self._counts), self._sum, self._count

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    @property
    def sum(self) -> float:
        with self._lock:
            return self._sum

    def _reset(self) -> None:
        with self._lock:
            self._counts = [0] * (len(self._bounds) + 1)
            self._sum = 0.0
            self._count = 0


class _MetricFamily:
    """Base: owns the children table keyed by label-value tuples."""

    kind = "untyped"
    _child_cls: type = _CounterChild

    def __init__(self, name: str, help: str, labelnames: Sequence[str]) -> None:
        _validate_name(name)
        for ln in labelnames:
            _validate_name(ln)
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self._children: Dict[LabelValues, object] = {}
        self._lock = threading.Lock()
        if not self.labelnames:
            # Label-less metric: materialize the single child eagerly so
            # bare .inc()/.set()/.observe() on the family works.
            self._children[()] = self._new_child()

    def _new_child(self):
        return self._child_cls()

    def labels(self, *values: object, **kv: object) -> object:
        if kv:
            if values:
                raise ValueError("pass label values positionally OR by name")
            try:
                values = tuple(str(kv[ln]) for ln in self.labelnames)
            except KeyError as exc:
                raise ValueError(f"missing label {exc} for {self.name}") from exc
        else:
            values = tuple(str(v) for v in values)
        if len(values) != len(self.labelnames):
            raise ValueError(
                f"{self.name} expects labels {self.labelnames}, got {values}"
            )
        # Fast path: plain dict read (safe under the GIL); slow path locked.
        child = self._children.get(values)
        if child is None:
            with self._lock:
                child = self._children.setdefault(values, self._new_child())
        return child

    def samples(self) -> Iterable[Tuple[Dict[str, str], object]]:
        """(labels-dict, child) pairs — a consistent point-in-time copy of
        the children table (values are read per-child by the exporter)."""
        with self._lock:
            items = list(self._children.items())
        for values, child in items:
            yield dict(zip(self.labelnames, values)), child

    def clear(self) -> None:
        """Reset all children's values (the family stays registered)."""
        with self._lock:
            items = list(self._children.values())
        for child in items:
            child._reset()  # type: ignore[attr-defined]

    # --- label-less convenience --------------------------------------------

    def _solo(self):
        if self.labelnames:
            raise ValueError(f"{self.name} has labels {self.labelnames}; use .labels()")
        return self._children[()]


class Counter(_MetricFamily):
    kind = "counter"
    _child_cls = _CounterChild

    def inc(self, amount: float = 1.0) -> None:
        self._solo().inc(amount)

    @property
    def value(self) -> float:
        return self._solo().value


class Gauge(_MetricFamily):
    kind = "gauge"
    _child_cls = _GaugeChild

    def set(self, value: float) -> None:
        self._solo().set(value)

    def inc(self, amount: float = 1.0) -> None:
        self._solo().inc(amount)

    def dec(self, amount: float = 1.0) -> None:
        self._solo().dec(amount)

    @property
    def value(self) -> float:
        return self._solo().value


class Histogram(_MetricFamily):
    kind = "histogram"
    _child_cls = _HistogramChild

    def __init__(
        self,
        name: str,
        help: str,
        labelnames: Sequence[str] = (),
        buckets: Sequence[float] = DEFAULT_BUCKETS,
    ) -> None:
        bounds = tuple(sorted(float(b) for b in buckets))
        if not bounds:
            raise ValueError("histogram needs at least one bucket bound")
        self.buckets = bounds
        super().__init__(name, help, labelnames)

    def _new_child(self) -> _HistogramChild:
        return _HistogramChild(self.buckets)

    def observe(self, value: float) -> None:
        self._solo().observe(value)


def _validate_name(name: str) -> None:
    if not name or not (name[0].isalpha() or name[0] == "_"):
        raise ValueError(f"invalid metric/label name {name!r}")
    for ch in name:
        if not (ch.isalnum() or ch in "_:"):
            raise ValueError(f"invalid metric/label name {name!r}")


class MetricsRegistry:
    """Get-or-create home for metric families.

    ``counter/gauge/histogram`` are idempotent by name (the common pattern is
    a module-level handle), but re-registering a name with a different kind
    or label set raises — silent divergence between two call sites would
    corrupt the series.
    """

    def __init__(self) -> None:
        self._metrics: Dict[str, _MetricFamily] = {}
        self._lock = threading.Lock()

    def _get_or_create(self, cls, name: str, help: str, labels: Sequence[str], **kw):
        with self._lock:
            existing = self._metrics.get(name)
            if existing is not None:
                if not isinstance(existing, cls) or existing.labelnames != tuple(labels):
                    raise ValueError(
                        f"metric {name!r} already registered as {existing.kind} "
                        f"with labels {existing.labelnames}"
                    )
                return existing
            fam = cls(name, help, labels, **kw)
            self._metrics[name] = fam
            return fam

    def counter(self, name: str, help: str = "", labels: Sequence[str] = ()) -> Counter:
        return self._get_or_create(Counter, name, help, labels)

    def gauge(self, name: str, help: str = "", labels: Sequence[str] = ()) -> Gauge:
        return self._get_or_create(Gauge, name, help, labels)

    def histogram(
        self,
        name: str,
        help: str = "",
        labels: Sequence[str] = (),
        buckets: Sequence[float] = DEFAULT_BUCKETS,
    ) -> Histogram:
        return self._get_or_create(Histogram, name, help, labels, buckets=buckets)

    def get(self, name: str) -> Optional[_MetricFamily]:
        with self._lock:
            return self._metrics.get(name)

    def collect(self) -> List[_MetricFamily]:
        with self._lock:
            return [self._metrics[k] for k in sorted(self._metrics)]

    def reset(self) -> None:
        """Zero every series but keep families registered — module-level
        handles survive (bench/tests call this between runs)."""
        for fam in self.collect():
            fam.clear()

    def clear_families(self, names: Sequence[str]) -> None:
        """Zero ONLY the named families (unknown names are fine — the
        family may simply not have instrumented yet this process). The
        campaign engine's scenario scoping: back-to-back scenarios in one
        process must each start their chaos-fault / admission-rejection /
        agg-wait counters from zero or replay-count assertions (and the
        adaptive adversary's rejection observations) would see the previous
        scenario's tail, while unrelated process-lifetime series (ledger
        event totals, resource gauges) keep accumulating."""
        for name in names:
            fam = self.get(name)
            if fam is not None:
                fam.clear()


#: The process-wide registry every subsystem instruments into.
REGISTRY = MetricsRegistry()
