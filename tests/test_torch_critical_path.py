"""The port's critical-path analysis against the JAX package's (the cases of
tests/test_critical_path.py that need no ``Node`` or protocol).

``critical_path.py`` is a framework-free copy: each synthetic span DAG, and
each pair of traces exported by the port's tracers, goes through both
packages' analyzers, and the port's paths, shares, overlap and window
reports must equal the reference's, besides the reference test's own
assertions.
"""

import json
import time
from dataclasses import asdict

import pytest

from p2pfl_tpu.telemetry import critical_path as ref_cp
from p2pfl_tpu_torch.telemetry import REGISTRY, critical_path, tracing
from p2pfl_tpu_torch.telemetry.flight_recorder import FlightRecorder
from p2pfl_tpu_torch.telemetry.tracing import Tracer


def _segs(mod, rows):
    return [mod.Seg(name=name, node=node, start_s=start, end_s=end, span_id=span_id or f"{node}-{name}-{start}",
                    parent_id=parent_id, trace_id="t", round=rnd)
            for name, node, start, end, span_id, parent_id, rnd in rows]


def _row(name, node, start, end, span_id="", parent_id="", rnd=0):
    return (name, node, start, end, span_id, parent_id, rnd)


STRAGGLER = [
    _row("fit", "A", 0.0, 1.0, span_id="a-fit"),
    _row("diffuse:partial_model", "A", 1.0, 1.3, span_id="a-diff"),
    _row("aggregation_wait", "A", 1.3, 5.5, span_id="a-wait"),
    _row("fit", "B", 0.0, 5.0, span_id="b-fit"),
    _row("diffuse:partial_model", "B", 5.0, 5.45, span_id="b-diff"),
    _row("recv:partial_model", "A", 5.4, 5.41, span_id="a-recv", parent_id="b-diff"),
]
DAGS = {
    "straggler": STRAGGLER,
    "no_arrival": [_row("fit", "A", 0.0, 1.0, span_id="a-fit"),
                   _row("aggregation_wait", "A", 1.0, 4.0, span_id="a-wait")],
    "ack_cycle": [_row("fit", "A", 0.0, 3.0, span_id="a-fit"),
                  _row("diffuse:full_model", "A", 3.0, 4.0, span_id="a-diff"),
                  _row("recv:full_model", "B", 3.2, 3.21, span_id="b-recv", parent_id="a-diff"),
                  _row("recv:models_ready", "A", 3.9, 3.91, span_id="a-ack", parent_id="b-recv")],
    "two_rounds": STRAGGLER + [_row("fit", "A", 10.0, 11.0, span_id="a-fit-1", rnd=1),
                               _row("fit", "B", 10.0, 15.0, span_id="b-fit-1", rnd=1)],
    "serialized": [_row("fit", "A", 0.0, 2.0), _row("diffuse:partial_model", "A", 2.0, 3.0)],
    "overlapped": [_row("fit", "A", 0.0, 2.0), _row("diffuse:partial_model", "A", 1.0, 2.0),
                   _row("fit", "B", 0.0, 1.0), _row("diffuse:partial_model", "B", 1.5, 2.5)],
}


def _analysis(mod, rows):
    an = mod.CriticalPathAnalyzer(_segs(mod, rows), slack_s=0.5)
    return an, {
        "rounds": an.rounds(),
        "paths": {r: asdict(an.round_path(r)) for r in an.rounds()},
        "shares": {r: an.stage_shares(r) for r in an.rounds()},
        "overlap": an.overlap_report(),
        "report": an.report(),
    }


@pytest.mark.parametrize("dag", sorted(DAGS))
def test_analysis_equals_jax(dag):
    an, got = _analysis(critical_path, DAGS[dag])
    _, want = _analysis(ref_cp, DAGS[dag])
    assert json.dumps(got, sort_keys=True, default=str) == json.dumps(want, sort_keys=True, default=str)
    path = an.round_path(0)
    if dag == "straggler":
        assert path.gating_node == "B" and path.attributed_by_node["B"] == pytest.approx(5.4, abs=0.5)
        assert {"fit", "aggregation_wait"} <= {h.name for h in path.hops} and 0.5 < path.coverage <= 1.01
        assert an.stage_shares(0)["by_stage_s"]["fit"] == pytest.approx(6.0)
    elif dag == "no_arrival":
        assert [h.name for h in path.hops] == ["fit", "aggregation_wait"]
        assert sum(h.attributed_s for h in path.hops) == pytest.approx(4.0, abs=0.01)
    elif dag == "ack_cycle":
        assert path.gating_node == "A" and any(h.name == "fit" for h in path.hops)
    elif dag == "two_rounds":
        rep = an.report()
        assert rep["top_gating_node"] == "B" and rep["gating_node_counts"]["B"] == 2
    elif dag == "serialized":
        assert got["overlap"]["train_diffuse_overlap_fraction"] == 0.0
        assert got["overlap"]["serialized_diffuse_s"] == pytest.approx(1.0)
    else:
        assert got["overlap"]["train_diffuse_overlap_fraction"] == pytest.approx(0.5)
        assert got["overlap"]["diffuse_under_any_fit_fraction"] == pytest.approx(0.75)


def _two_process_docs(offset_s: float):
    """A sender tracer ("process" A) and a receiver tracer (B) of the port,
    linked through the wire context and exported separately; B's wall
    anchor shifted by ``offset_s`` (NTP skew)."""
    t_a, t_b = Tracer(max_spans=64), Tracer(max_spans=64)
    with t_a.span("fit", node="procA", round=0):
        time.sleep(0.05)
    with t_b.span("aggregation_wait", node="procB", round=0):
        with t_a.span("diffuse:partial_model", node="procA", round=0) as ctx:
            wire = ctx.wire()
            time.sleep(0.01)
        with tracing.attach_wire(wire):
            with t_b.span("recv:partial_model", node="procB", round=0):
                time.sleep(0.005)
        time.sleep(0.005)
    doc_a, doc_b = t_a.export_chrome_trace(), t_b.export_chrome_trace()
    doc_a["metadata"]["node"], doc_b["metadata"]["node"] = "procA", "procB"
    doc_b["metadata"]["wall_epoch_s"] += offset_s
    return doc_a, doc_b


@pytest.mark.parametrize("offset", [0.0, 5.0])
def test_two_process_merge_of_port_traces_equals_jax(offset):
    doc_a, doc_b = _two_process_docs(offset)
    if offset:
        doc_a["metadata"]["peer_clock_skew_s"] = {"procB": -offset}
    runs = {}
    for mod in (critical_path, ref_cp):
        merged = mod.CriticalPathAnalyzer.from_chrome_traces([doc_a, doc_b], slack_s=0.5)
        raw = mod.CriticalPathAnalyzer.from_chrome_traces([doc_a, doc_b], auto_skew=False, slack_s=0.5)
        explicit = mod.CriticalPathAnalyzer.from_chrome_traces(
            [doc_a, doc_b], skew_s={"procB": -offset}, slack_s=0.5)
        runs[mod] = [asdict(a.round_path(0)) for a in (merged, raw, explicit)] + [merged.nodes()]
    assert json.dumps(runs[critical_path], default=str) == json.dumps(runs[ref_cp], default=str)
    merged, raw, explicit, nodes = runs[critical_path]
    assert set(nodes) == {"procA", "procB"}
    assert merged["gating_node"] == explicit["gating_node"] == "procA" and merged["wall_s"] < 2.0
    if offset:
        assert raw["wall_s"] > 4.0  # uncorrected, the skew inflates the round


def test_skew_from_registry_reads_reference_rows():
    g = REGISTRY.gauge("p2pfl_heartbeat_clock_skew_seconds",
                       "Receiver wall-clock minus the sender-stamped beat timestamp", labels=("node", "peer"))
    g.labels("mem://ref", "mem://peer1").set(0.25)
    g.labels("mem://ref", "mem://peer2").set(-1.5)
    g.labels("mem://other", "mem://peer1").set(99.0)
    assert critical_path.skew_from_registry("mem://ref") == {"mem://peer1": 0.25, "mem://peer2": -1.5}


def test_analyzer_reads_the_port_tracer():
    t = Tracer(max_spans=64)
    with t.span("fit", node="mem://n0", round=2):
        time.sleep(0.01)
    with t.span("diffuse:partial_model", node="mem://n1", round=2):
        pass
    got = critical_path.CriticalPathAnalyzer.from_tracer(t)
    want = ref_cp.CriticalPathAnalyzer.from_chrome_traces([t.export_chrome_trace()])
    assert got.rounds() == want.rounds() == [2] and set(got.nodes()) == {"mem://n0", "mem://n1"}
    assert got.round_path(2).gating_node == want.round_path(2).gating_node
    doc = t.export_chrome_trace()
    doc2 = t.export_chrome_trace()
    for d in (doc, doc2):
        d["metadata"].pop("wall_epoch_s"), d["metadata"].pop("exported_at_s")
    assert json.dumps(doc) == json.dumps(doc2)


def test_flight_recorder_maps_mono_to_wall_at_read_time(tmp_path):
    rec = FlightRecorder("mem://clock-test", capacity=8)
    rec.record("tick", i=1)
    ev = rec.events()[0]
    assert abs(ev["t"] - time.time()) < 5.0 and abs(ev["t_mono"] - time.monotonic()) < 5.0
    with open(rec.dump("test", directory=str(tmp_path))) as f:
        doc = json.load(f)
    assert {"dumped_at", "dumped_at_mono", "mono_to_wall_epoch"} <= set(doc)
    assert doc["events"][0]["t"] == pytest.approx(doc["events"][0]["t_mono"] + doc["mono_to_wall_epoch"], abs=1.0)
