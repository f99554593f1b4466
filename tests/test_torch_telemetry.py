"""The port's metrics exposition and round tracing against the JAX
package's (the host cases of tests/test_telemetry.py).

Both telemetry planes are framework-free, so each case runs the same
operations through the reference's modules and the port's and holds the
port's output to the reference's: the Prometheus text and the JSON snapshot
byte for byte, the span trees and the Chrome trace up to their random ids
and clock readings, the wire context exactly. Cases that need the
transport (the in-memory protocol, gRPC envelopes, the gossiper) wait for
it.
"""

import json
import re
import threading
import time

import numpy as np
import pytest

from p2pfl_tpu.telemetry import TRACER as REF_TRACER
from p2pfl_tpu.telemetry import export as ref_export
from p2pfl_tpu.telemetry import metrics as ref_metrics
from p2pfl_tpu.telemetry import tracing as ref_tracing
from p2pfl_tpu_torch.telemetry import REGISTRY, TRACER
from p2pfl_tpu_torch.telemetry import export, metrics, tracing


@pytest.fixture(autouse=True)
def _reset_tracers():
    TRACER.reset()
    REF_TRACER.reset()
    yield
    TRACER.reset()
    REF_TRACER.reset()


def _fill(m):
    """The reference test's exposition registry, built through module ``m``
    (either package's ``telemetry.metrics``)."""
    reg = m.MetricsRegistry()
    c = reg.counter("fed_bytes_total", "payload bytes", labels=("node", "cmd"))
    c.labels("n1", "full_model").inc(1024)
    g = reg.gauge("fed_depth", "queue depth", labels=("node",))
    g.labels('we"ird\\n1').set(2)
    h = reg.histogram("fed_wait_seconds", "wait", labels=("node",), buckets=(0.5, 5.0))
    h.labels("n1").observe(0.1)
    h.labels("n1").observe(60.0)
    esc = reg.counter("esc_total", "help with \\ and newline\nhere", labels=("who",))
    esc.labels('evil"name\\with\nnewline').inc()
    reg.gauge("weird_gauge").set(float("nan"))
    reg.counter("s_total", "c", labels=("node",)).labels("n1").inc(3)
    reg.histogram("s_seconds", "h", buckets=(1.0,)).observe(0.5)
    return reg


# --- registry ---------------------------------------------------------------


def test_counter_thread_safety_under_concurrent_increments():
    reg = metrics.MetricsRegistry()
    child = reg.counter("t_bytes_total", "b", labels=("node",)).labels("n1")
    threads, per_thread = 8, 5_000
    barrier = threading.Barrier(threads)

    def worker():
        barrier.wait()
        for _ in range(per_thread):
            child.inc()

    ts = [threading.Thread(target=worker) for _ in range(threads)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    assert child.value == threads * per_thread


def test_histogram_concurrent_observes_conserve_count():
    reg = metrics.MetricsRegistry()
    child = reg.histogram("t_wait_seconds", "w", labels=("node",), buckets=(0.1, 1.0)).labels("n1")

    def worker():
        for i in range(2_000):
            child.observe(0.05 if i % 2 else 5.0)

    ts = [threading.Thread(target=worker) for _ in range(4)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    _, counts, _, count = child.snapshot()
    assert count == sum(counts) == 8_000 and counts[0] == counts[-1] == 4_000


def test_registry_kind_checks_and_reset_match_jax():
    for m in (ref_metrics, metrics):
        reg = m.MetricsRegistry()
        a = reg.counter("t_same_total", "b", labels=("x",))
        assert reg.counter("t_same_total", "b", labels=("x",)) is a
        with pytest.raises(ValueError):
            reg.gauge("t_same_total", "b", labels=("x",))
        with pytest.raises(ValueError):
            reg.counter("t_same_total", "b", labels=("y",))
        with pytest.raises(ValueError):
            a.labels("1").inc(-1)
        a.labels("1").inc(5)
        reg.reset()
        a.labels("1").inc()
        assert reg.get("t_same_total").labels("1").value == 1


# --- exposition -------------------------------------------------------------


def test_prometheus_text_equals_jax():
    text = export.render_prometheus(_fill(metrics))
    assert text == ref_export.render_prometheus(_fill(ref_metrics))
    assert 'fed_bytes_total{node="n1",cmd="full_model"} 1024' in text
    assert 'fed_depth{node="we\\"ird\\\\n1"} 2' in text
    assert 'fed_wait_seconds_bucket{node="n1",le="+Inf"} 2' in text
    assert re.search(r'fed_wait_seconds_sum\{node="n1"\} 60\.1', text)
    assert 'esc_total{who="evil\\"name\\\\with\\nnewline"} 1' in text
    assert "weird_gauge NaN" in text
    for line in text.strip().splitlines():
        if not line.startswith("#"):
            assert re.match(r'^[a-zA-Z_:][a-zA-Z0-9_:]*(\{.*\})? \S+$', line), line


def test_snapshot_equals_jax():
    text = json.dumps(export.snapshot(_fill(metrics)), sort_keys=True)
    assert text == json.dumps(ref_export.snapshot(_fill(ref_metrics)), sort_keys=True)
    snap = json.loads(text)
    assert snap["s_total"]["samples"][0] == {"labels": {"node": "n1"}, "value": 3}
    assert snap["s_seconds"]["samples"][0]["buckets"]["1"] == 1


def test_histogram_quantile_equals_jax():
    for bounds, counts, q in (((1.0, 2.0, 4.0), (0, 2, 2), 0.5), ((0.5, 5.0), (3, 1, 2), 0.9), ((1.0,), (0,), 0.5)):
        got, want = export.hist_quantile(bounds, counts, q), ref_export.hist_quantile(bounds, counts, q)
        assert got == want or (np.isnan(got) and np.isnan(want))


# --- tracing ----------------------------------------------------------------


def _span_shape(tracer):
    """Span names, nodes, args and parent links (by position), without ids
    and clock readings."""
    spans = tracer.spans()
    pos = {s.span_id: i for i, s in enumerate(spans)}
    return [(s.name, s.node, s.args, pos.get(s.parent_id), s.trace_id == spans[0].trace_id) for s in spans]


def _nested(tr_mod, tracer):
    with tracer.span("experiment", node="mem://a", round=0) as ctx:
        with tracer.span("TrainStage", node="mem://a", round=0, skipped=None):
            pass
        with tracer.span("recv", node="mem://b", trace_id=ctx.trace_id):
            pass
    with tracer.recv_span("ignored", node="mem://b", wire=""):
        pass
    with tracer.recv_span("recv:probe", node="mem://b", wire="deadbeef:cafe"):
        assert tr_mod.current_trace_id() == "deadbeef"
    return ctx


def test_span_tree_equals_jax():
    ctx = _nested(tracing, TRACER)
    _nested(ref_tracing, REF_TRACER)
    assert _span_shape(TRACER) == _span_shape(REF_TRACER)
    inner = TRACER.spans()[0]
    assert inner.name == "TrainStage" and inner.trace_id == ctx.trace_id and "skipped" not in inner.args
    assert TRACER.spans()[-1].trace_id == "deadbeef" and TRACER.spans()[-1].parent_id == "cafe"


def test_wire_context_equals_jax():
    for wire in ("", "garbage", "aaaa:bbbb", ":x", "x:", "a:b:c"):
        got, want = tracing.parse_wire(wire), ref_tracing.parse_wire(wire)
        assert (got is None) == (want is None)
        if got is not None:
            assert (got.trace_id, got.span_id, got.wire()) == (want.trace_id, want.span_id, want.wire())
    assert tracing.WIRE_ARG_PREFIX == ref_tracing.WIRE_ARG_PREFIX
    assert tracing.TRACE_META_KEY == ref_tracing.TRACE_META_KEY
    with tracing.attach_wire("deadbeef:cafe") as ctx:
        assert tracing.current_trace_id() == "deadbeef" and tracing.current_wire() == "deadbeef:cafe"
        assert tracing.current_context() == ctx
    assert tracing.current_context() is None and tracing.current_wire() == ""
    assert len(tracing.new_id()) == len(ref_tracing.new_id()) == 16


def test_chrome_trace_equals_jax():
    def shape(trace):
        keys = ("trace_id", "span_id", "parent_id")
        return [
            {k: v for k, v in e.items() if k not in ("ts", "dur", "tid")}
            | ({"args": {k: v for k, v in e["args"].items() if k not in keys}} if "args" in e else {})
            for e in trace["traceEvents"]
        ]

    for tracer in (TRACER, REF_TRACER):
        with tracer.span("experiment", node="mem://a", round=0):
            with tracer.span("TrainStage", node="mem://a", round=0):
                time.sleep(0.002)
            with tracer.span("fit", node="mem://b", round=3):
                pass
    got, want = TRACER.export_chrome_trace(), REF_TRACER.export_chrome_trace()
    assert shape(got) == shape(want)
    assert set(got["metadata"]) == set(want["metadata"]) and got["displayTimeUnit"] == "ms"
    spans = [e for e in got["traceEvents"] if e["ph"] == "X"]
    assert all(isinstance(e["pid"], int) and isinstance(e["tid"], int) for e in spans)
    assert [e["ts"] for e in spans] == sorted(e["ts"] for e in spans)
    assert max(e["dur"] for e in spans) >= 2_000  # microseconds
    assert abs(spans[0]["ts"] / 1e6 + got["metadata"]["wall_epoch_s"] - time.time()) < 5.0
    json.dumps(got)


def test_tracer_bound_drops_oldest_and_counts():
    dropped = REGISTRY.get("p2pfl_trace_spans_dropped_total")
    before = dropped.value
    tr = tracing.Tracer(max_spans=4)
    for i in range(10):
        with tr.span(f"s{i}", node="n"):
            pass
    assert [s.name for s in tr.spans()] == ["s6", "s7", "s8", "s9"]
    assert tr.dropped == 6 and dropped.value - before == 6
    from p2pfl_tpu_torch.config import Settings

    with Settings.overridden(TRACE_MAX_SPANS=1234):
        assert tracing.Tracer()._spans.maxlen == 1234


def test_pflt_frame_carries_the_span_context_to_jax():
    """A port frame built inside a port span carries the span's wire context
    in the PFLT header, where the JAX package's decoder reads it; outside a
    span the slot stays empty, as before."""
    import torch

    from p2pfl_tpu.ops.serialization import deserialize_arrays
    from p2pfl_tpu_torch.models.model_handle import encode_wire_frame

    leaves = [torch.ones(3)]
    with TRACER.span("s", node="n") as ctx:
        blob = encode_wire_frame(leaves, ["n"], 1, {})
    _, meta = deserialize_arrays(bytes(blob))
    assert meta[tracing.TRACE_META_KEY] == ctx.wire()
    _, meta = deserialize_arrays(bytes(encode_wire_frame(leaves, ["n"], 1, {})))
    assert meta.get(tracing.TRACE_META_KEY, "") == ""
