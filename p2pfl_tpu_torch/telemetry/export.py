"""Export surfaces for the metrics registry (the port's framework-free copy of
``p2pfl_tpu/telemetry/export.py``, its imports rerouted to ``p2pfl_tpu_torch``).

* :func:`render_prometheus` — Prometheus text exposition format 0.0.4
  (``# HELP`` / ``# TYPE`` headers, escaped labels, cumulative histogram
  buckets with ``le`` plus ``_sum``/``_count``), scrapeable as-is. Every
  histogram family additionally exposes a ``<name>_quantile`` gauge family
  with ``quantile="0.5|0.9|0.99"`` labels (estimated by linear
  interpolation inside the covering bucket), and the process-wide sketch
  registry exposes ``p2pfl_sketch_<metric>`` gauge families in the same
  quantile-label form — dashboards read p50/p90/p99 directly instead of
  re-deriving them from bucket counts.
* :func:`snapshot` — JSON-able dict of every family and series, the shape
  ``bench.py --telemetry`` embeds into its BENCH json and the
  ``make telemetry-check`` gate asserts against.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Sequence, Tuple

from p2pfl_tpu_torch.telemetry.metrics import Histogram, MetricsRegistry, REGISTRY

#: The quantiles exposed for histograms and sketches (Prometheus summary-
#: style ``quantile`` label values).
EXPORT_QUANTILES: Tuple[float, ...] = (0.5, 0.9, 0.99)


def _escape_label(value: str) -> str:
    return value.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _escape_help(value: str) -> str:
    return value.replace("\\", "\\\\").replace("\n", "\\n")


def _fmt_labels(labels: Dict[str, str], extra: Optional[Dict[str, str]] = None) -> str:
    merged = dict(labels)
    if extra:
        merged.update(extra)
    if not merged:
        return ""
    inner = ",".join(f'{k}="{_escape_label(v)}"' for k, v in merged.items())
    return "{" + inner + "}"


def _fmt_value(v: float) -> str:
    if math.isnan(v):
        return "NaN"
    if math.isinf(v):
        return "+Inf" if v > 0 else "-Inf"
    if v == int(v) and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


def hist_quantile(
    bounds: Sequence[float], counts: Sequence[int], q: float
) -> float:
    """Estimate the ``q``-quantile from non-cumulative histogram buckets
    (linear interpolation inside the covering bucket; values in the +Inf
    bucket report the highest finite bound). NaN when empty."""
    total = sum(counts)
    if total <= 0:
        return float("nan")
    rank = min(1.0, max(0.0, q)) * total
    cum = 0.0
    lower = 0.0
    for b, c in zip(bounds, counts):
        if cum + c >= rank and c > 0:
            frac = (rank - cum) / c
            return lower + frac * (b - lower)
        cum += c
        lower = b
    return float(bounds[-1])  # +Inf bucket: clamp to the last finite bound


def _quantile_lines(
    name: str, rows: List[Tuple[Dict[str, str], Dict[float, float]]]
) -> List[str]:
    """Summary-style quantile gauge family lines (skips empty series)."""
    out: List[str] = []
    emitted_header = False
    for labels, quantiles in rows:
        for q, v in quantiles.items():
            if math.isnan(v):
                continue
            if not emitted_header:
                out.append(f"# TYPE {name} gauge")
                emitted_header = True
            lbl = _fmt_labels(labels, {"quantile": _fmt_value(q)})
            out.append(f"{name}{lbl} {_fmt_value(v)}")
    return out


def render_prometheus(registry: MetricsRegistry = REGISTRY) -> str:
    """Render every family in ``registry`` as Prometheus exposition text,
    followed by derived ``<name>_quantile`` families for histograms and
    ``p2pfl_sketch_<metric>`` families for the sketch registry."""
    out = []
    quantile_rows: List[Tuple[str, List[Tuple[Dict[str, str], Dict[float, float]]]]] = []
    for fam in registry.collect():
        if fam.help:
            out.append(f"# HELP {fam.name} {_escape_help(fam.help)}")
        out.append(f"# TYPE {fam.name} {fam.kind}")
        if isinstance(fam, Histogram):
            fam_rows: List[Tuple[Dict[str, str], Dict[float, float]]] = []
            for labels, child in fam.samples():
                bounds, counts, total, count = child.snapshot()
                cum = 0
                for b, c in zip(bounds, counts):
                    cum += c
                    le = _fmt_labels(labels, {"le": _fmt_value(b)})
                    out.append(f"{fam.name}_bucket{le} {cum}")
                cum += counts[-1]
                le = _fmt_labels(labels, {"le": "+Inf"})
                out.append(f"{fam.name}_bucket{le} {cum}")
                out.append(f"{fam.name}_sum{_fmt_labels(labels)} {_fmt_value(total)}")
                out.append(f"{fam.name}_count{_fmt_labels(labels)} {count}")
                fam_rows.append(
                    (
                        labels,
                        {
                            q: hist_quantile(bounds, counts, q)
                            for q in EXPORT_QUANTILES
                        },
                    )
                )
            quantile_rows.append((f"{fam.name}_quantile", fam_rows))
        else:
            for labels, child in fam.samples():
                out.append(f"{fam.name}{_fmt_labels(labels)} {_fmt_value(child.value)}")
    for name, rows in quantile_rows:
        out.extend(_quantile_lines(name, rows))
    # Sketch registry quantiles (only when the default registry is asked —
    # the sketch registry is process-global like it).
    if registry is REGISTRY:
        from p2pfl_tpu_torch.telemetry.sketches import SKETCHES

        by_metric: Dict[str, List[Tuple[Dict[str, str], Dict[float, float]]]] = {}
        for metric, node in SKETCHES.names():
            sk = SKETCHES.get(metric, node)
            if sk is None or sk.count <= 0:
                continue
            safe = "".join(
                ch if (ch.isalnum() or ch in "_:") else "_" for ch in metric
            ) or "_"
            by_metric.setdefault(safe, []).append(
                ({"node": node}, {q: sk.quantile(q) for q in EXPORT_QUANTILES})
            )
        for metric in sorted(by_metric):
            out.extend(
                _quantile_lines(f"p2pfl_sketch_{metric}", by_metric[metric])
            )
    return "\n".join(out) + "\n"


def snapshot(registry: MetricsRegistry = REGISTRY) -> Dict[str, Any]:
    """JSON-able snapshot: family name -> {type, help, samples: [...]}.

    Counter/gauge samples are ``{"labels": {...}, "value": v}``; histogram
    samples carry ``buckets`` (upper-bound -> non-cumulative count), ``sum``
    and ``count``.
    """
    snap: Dict[str, Any] = {}
    for fam in registry.collect():
        samples = []
        if isinstance(fam, Histogram):
            for labels, child in fam.samples():
                bounds, counts, total, count = child.snapshot()
                samples.append(
                    {
                        "labels": labels,
                        "buckets": {
                            **{_fmt_value(b): c for b, c in zip(bounds, counts)},
                            "+Inf": counts[-1],
                        },
                        "sum": total,
                        "count": count,
                        "quantiles": {
                            f"p{int(round(q * 100))}": hist_quantile(bounds, counts, q)
                            for q in EXPORT_QUANTILES
                        }
                        if count
                        else {},
                    }
                )
        else:
            for labels, child in fam.samples():
                samples.append({"labels": labels, "value": child.value})
        snap[fam.name] = {"type": fam.kind, "help": fam.help, "samples": samples}
    return snap


__all__ = ["EXPORT_QUANTILES", "hist_quantile", "render_prometheus", "snapshot"]
