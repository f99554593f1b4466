"""The port's sketches, health digests, observatory and flight recorder
against the JAX package's (tests/test_observatory.py and
tests/test_fleetobs.py).

The modules are framework-free copies, so each case feeds the same inputs
to both packages and holds the port to the reference: sketch and digest
wire payloads byte for byte, quantiles, scores and snapshot documents
equal (up to wall-clock stamps), and the reference test's own assertions
on the port's side. Cases that need the transport (heartbeat piggyback,
gRPC mapping, admission) wait for it.
"""

from __future__ import annotations

import json
import math
import random
import time

import numpy as np
import pytest

from p2pfl_tpu.config import Settings as RefSettings
from p2pfl_tpu.telemetry import REGISTRY as REF_REGISTRY
from p2pfl_tpu.telemetry import digest as ref_digest
from p2pfl_tpu.telemetry import export as ref_export
from p2pfl_tpu.telemetry import observatory as ref_observatory
from p2pfl_tpu.telemetry import sketches as ref_sketches
from p2pfl_tpu.telemetry.critical_path import CriticalPathAnalyzer as RefAnalyzer
from p2pfl_tpu.telemetry.critical_path import Seg as RefSeg
from p2pfl_tpu_torch.config import Settings
from p2pfl_tpu_torch.telemetry import REGISTRY
from p2pfl_tpu_torch.telemetry import digest, export, observatory, sketches
from p2pfl_tpu_torch.telemetry.critical_path import CriticalPathAnalyzer, Seg
from p2pfl_tpu_torch.telemetry.flight_recorder import FlightRecorder

PKGS = {"ref": (ref_sketches, ref_digest, ref_observatory), "port": (sketches, digest, observatory)}


@pytest.fixture(autouse=True)
def _clean_sketches():
    for mod in (sketches, ref_sketches):
        mod.SKETCHES.reset()
    yield
    for mod in (sketches, ref_sketches):
        mod.SKETCHES.reset()


def _streams():
    rng = random.Random(7)
    return {
        "constant": [3.14] * 500,
        "bimodal_extreme": [1e-6] * 300 + [1e6] * 300,
        "lognormal": [rng.lognormvariate(0.0, 2.0) for _ in range(2000)],
        "with_zeros_and_negatives": ([0.0] * 50 + [-rng.lognormvariate(0.0, 1.0) for _ in range(200)]
                                     + [rng.lognormvariate(0.0, 1.0) for _ in range(200)]),
        "heavy_duplicates": [float(rng.choice([1, 1, 1, 2, 50])) for _ in range(1000)],
    }


def _exact_quantile(values, q):
    """Nearest-rank (floor) — the sketch walk's convention."""
    s = sorted(values)
    return s[int(q * (len(s) - 1))]


# --- quantile sketch and distinct estimator -------------------------------------


@pytest.mark.parametrize("max_bins", [1024, 32])
def test_sketch_wire_and_quantiles_equal_jax(max_bins):
    """Every stream through both packages' sketches: identical wire payloads
    and quantiles; without collapse each quantile within the relative error
    of the exact one, with it within the tracked (degraded) error."""
    for name, stream in _streams().items():
        a = sketches.QuantileSketch(rel_err=0.02, max_bins=max_bins)
        b = ref_sketches.QuantileSketch(rel_err=0.02, max_bins=max_bins)
        for v in stream:
            a.add(v)
            b.add(v)
        assert json.dumps(a.to_wire()) == json.dumps(b.to_wire()), name
        assert json.dumps(a.to_wire(max_bins=16)) == json.dumps(b.to_wire(max_bins=16)), name
        assert len(a._bins) <= max_bins and a.rel_err == b.rel_err
        for q in (0.1, 0.5, 0.9, 0.99):
            assert a.quantile(q) == b.quantile(q)
            exact, est = _exact_quantile(stream, q), a.quantile(q)
            if abs(exact) < 1e-9:
                assert abs(est) < 1e-9, (name, q, est)
            elif max_bins == 1024 or exact > 0:
                assert abs(est - exact) / abs(exact) <= a.rel_err + 1e-9, (name, q, exact, est)


def test_sketch_merge_add_many_and_device_fold_equal_jax():
    rng = random.Random(11)
    streams = [[rng.lognormvariate(0.0, 1.5) for _ in range(200)] for _ in range(3)]
    out = {}
    for key, (sk_mod, _, _) in PKGS.items():
        a, b, c = (sk_mod.QuantileSketch(rel_err=0.02) for _ in range(3))
        for sk, vals in zip((a, b, c), streams):
            sk.add_many(np.asarray(vals))
        left, right = a.merge(b).merge(c), a.merge(b.merge(c))
        assert [left.quantile(q) for q in (0.25, 0.5, 0.9)] == [right.quantile(q) for q in (0.25, 0.5, 0.9)]
        assert left.count == 600
        dev = sk_mod.QuantileSketch(rel_err=0.02)
        gamma, lo, nbins = sk_mod.device_bucket_spec(0.02)
        counts = np.zeros(nbins, np.int64)
        counts[[3, 100, 400]] = [2, 5, 1]
        dev.fold_device_buckets(gamma, lo, counts, zeros=2.0, vsum=12.5, vmin=1e-6, vmax=50.0)
        out[key] = (left.to_wire(), dev.to_wire(), sk_mod.device_bucket_spec(0.02), sk_mod.device_bucket_spec(0.05))
    assert json.dumps(out["port"]) == json.dumps(out["ref"])


def test_sketch_hostile_payloads_decode_to_none():
    for garbage in (None, "x", 42, [], {"v": 99}, {"v": 1, "b": "nope"}, {"v": 1, "b": [[0, "NaN"]]},
                    {"v": 1, "c": 1, "b": [[0, 1e9]]}, {"v": 1, "c": float("inf"), "b": []}):
        assert sketches.QuantileSketch.from_wire(garbage) is None, garbage
        assert ref_sketches.QuantileSketch.from_wire(garbage) is None, garbage
    for garbage in (None, 7, "!!!notb64!!!", "QUJD", ""):
        assert sketches.DistinctEstimator.from_wire(garbage) is None, garbage


def test_distinct_estimator_equals_jax():
    ests = {}
    for key, (sk_mod, _, _) in PKGS.items():
        a, b = sk_mod.DistinctEstimator(), sk_mod.DistinctEstimator()
        for i in range(2000):
            a.add(f"node-{i}")
        for i in range(1500, 2500):
            b.add(f"node-{i}")
        ests[key] = (a.to_wire(), a.merge(b).to_wire(), a.estimate(), a.merge(a).estimate())
    assert ests["port"] == ests["ref"]
    assert abs(ests["port"][2] - 2000) / 2000 < 0.25 and ests["port"][3] == ests["port"][2]
    back = sketches.DistinctEstimator.from_wire(ests["port"][0])
    assert back is not None and back.estimate() == ests["port"][2]


def test_device_bucket_spec_follows_settings():
    with Settings.overridden(SKETCH_REL_ERR=0.05), RefSettings.overridden(SKETCH_REL_ERR=0.05):
        assert sketches.device_bucket_spec() == ref_sketches.device_bucket_spec()


# --- digests ----------------------------------------------------------------------


def _v2_digest(dg, sk_mod, node="mem://peer", lags=(0, 0, 1, 2), ts=1234.5):
    sk = sk_mod.QuantileSketch(rel_err=0.02)
    for lag in lags:
        sk.add(float(lag))
    est = sk_mod.DistinctEstimator()
    est.add("a")
    est.add("b")
    return dg.HealthDigest(
        node=node, ts=ts, round=3, stage="AsyncWindowStage", mode="async", steps_per_s=25.0,
        sketches={"staleness": sk.to_wire(), "__distinct__": est.to_wire()},
    )


def _full_digest(dg):
    return dg.HealthDigest(
        node="mem://node-7", ts=123.5, round=3, total_rounds=10, stage="TrainStage", steps_per_s=42.5,
        jit_compile_s=1.25, tx_bytes=1e6, rx_bytes=2e6, queue_depth=4, agg_waits=3, agg_wait_s=7.5,
        contributors=5, rejections={"norm": 2.0, "nonfinite": 1.0}, rejected_by_source={"mem://node-2": 3.0},
        faults_seen=9.0, mem_bytes=1 << 20,
    )


def test_digest_wire_bytes_equal_jax():
    for make in (_full_digest, lambda dg: _v2_digest(dg, sketches if dg is digest else ref_sketches)):
        payload = make(digest).encode()
        assert payload == make(ref_digest).encode()
        back = digest.decode(payload)
        assert back == make(digest)
        assert ref_digest.decode(payload) == make(ref_digest)  # a JAX node reads the port's beat
    back = digest.decode(_v2_digest(digest, sketches).encode())
    assert back.version == digest.DIGEST_VERSION == ref_digest.DIGEST_VERSION
    assert back.sketch("staleness").count == 4
    assert back.sketch("staleness").quantile(0.9) == pytest.approx(1.0, rel=0.05)
    assert back.distinct().estimate() == pytest.approx(2.0, abs=0.5)


def test_digest_decode_tolerance_equals_jax():
    future = json.dumps({"v": 99, "node": "mem://future", "round": 5, "stage": "WarpStage",
                         "steps_per_s": "not-a-number", "frobnication_index": {"deeply": ["nested"]},
                         "rejections": {"norm": 1, "bad": "x"}})
    raw = json.loads(_v2_digest(digest, sketches).encode())
    raw["sk"] = {"staleness": "not-a-dict", "__distinct__": 42}
    v1 = digest.HealthDigest(node="mem://old", ts=1.0, round=2)
    v1.version, v1.sketches = 1, {}
    payloads = ["", "not json{", json.dumps([1, 2, 3]), json.dumps({"no_node": True}),
                json.dumps({"node": "n", "stage": "x" * digest.MAX_DIGEST_BYTES}), future, json.dumps(raw),
                v1.encode()]
    for p in payloads:
        got, want = digest.decode(p), ref_digest.decode(p)
        assert (got is None) == (want is None), p[:40]
        if got is not None:
            assert got.encode() == want.encode()
    dig = digest.decode(future)
    assert (dig.version, dig.round, dig.steps_per_s, dig.rejections) == (99, 5, 0.0, {"norm": 1.0})
    assert '"sk"' not in v1.encode() and digest.decode(v1.encode()).sketches == {}
    assert digest.decode(json.dumps(raw)).sketch("staleness") is None


def test_collect_reads_registry_sketches_and_state():
    addr = "obs-collect-node"
    for reg, sk_mod in ((REGISTRY, sketches), (REF_REGISTRY, ref_sketches)):
        reg.gauge("p2pfl_learner_steps_per_second", "", labels=("node",)).labels(addr).set(17.0)
        reg.counter("p2pfl_updates_rejected_total", "", labels=("node", "reason", "source")).labels(
            addr, "norm", "evil-peer").inc(3)
        sk_mod.SKETCHES.observe("step_time", addr, 0.02)
        sk_mod.SKETCHES.observe("staleness", addr, 1.0)
        sk_mod.SKETCHES.distinct_add(addr, "mem://peer")

    class _State:
        round = 2
        total_rounds = 5
        current_stage = "TrainStage"

    dig = digest.collect(addr, _State())
    assert (dig.round, dig.total_rounds, dig.stage, dig.steps_per_s) == (2, 5, "TrainStage", 17.0)
    assert dig.rejected_by_source == {"evil-peer": 3.0} and dig.rejections.get("norm") == 3.0
    assert dig.version == 2 and dig.sketch("staleness").count == 1 and dig.distinct() is not None
    assert dig.sketches == ref_digest.collect(addr, _State()).sketches
    assert len(dig.encode()) <= digest.MAX_DIGEST_BYTES


# --- observatory ----------------------------------------------------------------


def _ingest_all(obs_mod, dg, observer, rows):
    obs = obs_mod.Observatory(observer)
    now = time.time()
    for node, kw in rows:
        obs.ingest(dg.HealthDigest(node=node, **{"ts": now, **kw}))
    return obs


SCENARIOS = {
    "round_lag": ("obs-a", [("obs-a", dict(round=5, steps_per_s=10.0)), ("peer-fast", dict(round=5, steps_per_s=10.0)),
                            ("peer-slow", dict(round=3, steps_per_s=10.0))], "straggler", "peer-slow"),
    "step_time": ("obs-b", [("obs-b", dict(round=1, steps_per_s=100.0)), ("peer-1", dict(round=1, steps_per_s=95.0)),
                            ("peer-crawl", dict(round=1, steps_per_s=2.0))], "straggler", "peer-crawl"),
    "suspect": ("obs-c", [("obs-c", dict(round=1, rejected_by_source={"peer-evil": 4.0})),
                          ("peer-1", dict(round=1, rejected_by_source={"peer-evil": 2.0})),
                          ("peer-evil", dict(round=1))], "suspect", "peer-evil"),
}


def _timeless(scores):
    """Scores without the digests' ages (wall-clock readings)."""
    return {peer: {k: v for k, v in row.items() if k != "age_s"} for peer, row in scores.items()}


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_observatory_scores_equal_jax(scenario):
    observer, rows, metric, top = SCENARIOS[scenario]
    obs = _ingest_all(observatory, digest, observer, rows)
    ref = _ingest_all(ref_observatory, ref_digest, observer, rows)
    assert _timeless(obs.scores()) == _timeless(ref.scores())
    assert obs.top(metric) == ref.top(metric) == top
    if scenario == "suspect":
        assert obs.scores()["peer-evil"]["suspect"] == 6.0 and obs.top("straggler") is None
    if scenario == "round_lag":
        fam = REGISTRY.get("p2pfl_fed_straggler_score")
        vals = {lbl["peer"]: c.value for lbl, c in fam.samples() if lbl["node"] == observer}
        assert vals.get("peer-slow", 0.0) >= 2.0


def test_observatory_snapshot_ingest_order_and_forget_equal_jax():
    docs = []
    for obs_mod, dg, sk_mod in ((observatory, digest, sketches), (ref_observatory, ref_digest, ref_sketches)):
        obs = obs_mod.Observatory("obs-d")
        changes = [obs.ingest(dg.HealthDigest(node="p", round=r, ts=ts)) for r, ts in ((1, 10.0), (1, 11.0),
                                                                                      (2, 12.0), (1, 5.0))]
        assert changes == [True, False, True, False] and obs.scores()["p"]["round"] == 2.0
        obs.ingest(_v2_digest(dg, sk_mod, node="peer-1", lags=(0, 0, 0, 0, 0, 0, 0, 0, 3, 3), ts=time.time()))
        dig = _v2_digest(dg, sk_mod, node="peer-2", ts=time.time())
        obs.ingest(dig)
        once = obs.fleet_quantiles()
        obs.ingest(dig)  # gossip redelivery: latest-per-peer, not accumulation
        assert obs.fleet_quantiles() == once
        snap = obs.snapshot()
        assert snap["peers"]["peer-1"]["staleness_p90"] == pytest.approx(3.0, rel=0.05)
        json.dumps(snap)
        obs.forget("peer-1")
        assert "peer-1" not in obs.scores()
        docs.append(snap)
    port, ref = docs
    assert observatory.snapshot_shape_diff(port, ref) == [] and observatory.snapshot_shape_diff(ref, port) == []
    assert set(port["peers"]) == set(ref["peers"])
    assert port["fleet"]["quantiles"] == ref["fleet"]["quantiles"]


def test_observatory_ttl_eviction_and_overflow_equal_jax():
    out = {}
    for key, (sk_mod, dg, obs_mod) in PKGS.items():
        settings = Settings if key == "port" else RefSettings
        with settings.overridden(OBS_PEER_TTL=5.0, OBS_MAX_TRACKED=8):
            obs = obs_mod.Observatory(f"mem://obs-{key}")
            obs.ingest(_v2_digest(dg, sk_mod, node="mem://dead", ts=time.time()))
            with obs._lock:
                d, seen = obs._peers["mem://dead"]
                obs._peers["mem://dead"] = (d, seen - 10.0)
            obs._last_evict = 0.0
            obs.ingest(_v2_digest(dg, sk_mod, node="mem://alive", ts=time.time()))
            evicted = "mem://dead" not in obs.scores()
            events = [e["event"] for e in obs.snapshot()["membership_events"]]
            for i in range(40):
                obs.ingest(_v2_digest(dg, sk_mod, node=f"mem://p{i:03d}", lags=(1,), ts=time.time()))
            m1 = obs.estimated_memory_bytes()
            for i in range(40, 80):
                obs.ingest(_v2_digest(dg, sk_mod, node=f"mem://p{i:03d}", lags=(1,), ts=time.time()))
            snap = obs.snapshot()
            out[key] = (evicted, "evict" in events, len(obs.scores()), snap["fleet"]["overflow_peers"],
                        snap["fleet"]["size"], obs.fleet_quantiles()["staleness"]["count"],
                        obs.estimated_memory_bytes() < m1 * 1.5)
    assert out["port"] == out["ref"]
    assert out["port"][:3] == (True, True, 8) and out["port"][-1]


def test_population_snapshot_equals_jax():
    n = 200
    rng = np.random.default_rng(0)
    lag, step = np.zeros(n), np.full(n, 0.01) + rng.normal(0, 1e-4, n)
    seeded = [7, 50, 199]
    lag[seeded], step[seeded] = 3.0, 0.05
    names = [f"vnode/{i:05d}" for i in range(n)]
    metrics = {"round_lag": lag, "step_time": step, "round": np.full(n, 5.0)}
    snap = observatory.population_snapshot("mesh-sim", names, metrics, top_n=5)
    ref = ref_observatory.population_snapshot("mesh-sim", names, metrics, top_n=5)
    assert observatory.snapshot_shape_diff(snap, ref) == [] and observatory.snapshot_shape_diff(ref, snap) == []
    assert set(snap["peers"]) == set(ref["peers"]) and snap["top_straggler"] == ref["top_straggler"]
    assert snap["fleet"]["quantiles"] == ref["fleet"]["quantiles"]
    assert {names[i] for i in seeded} <= set(snap["peers"]) and len(snap["peers"]) == 5 + 1
    assert snap["virtual"] is True and snap["fleet"]["overflow_peers"] == n - 5
    assert snap["fleet"]["quantiles"]["round_lag"]["p99"] == pytest.approx(3.0, rel=0.1)
    with pytest.raises(ValueError):
        observatory.population_snapshot("x", ["a", "b"], {"round_lag": np.zeros(3)})


# --- prometheus quantile families ----------------------------------------------


def test_prometheus_quantile_families_equal_jax():
    texts = []
    for reg, exp, sk_mod in ((REGISTRY, export, sketches), (REF_REGISTRY, ref_export, ref_sketches)):
        reg.reset()
        h = reg.histogram("t_fleetobs_demo_seconds", "demo", labels=("node",))
        for v in (0.01, 0.02, 0.3, 1.2, 4.0):
            h.labels("n1").observe(v)
        reg.histogram("t_fleetobs_empty_seconds", "empty", labels=("node",)).labels("a")
        sk_mod.SKETCHES.observe("step_time", 'no"de\\with\nnasties', 0.5)
        text = exp.render_prometheus(reg)
        texts.append([line for line in text.splitlines() if "t_fleetobs" in line or "p2pfl_sketch" in line])
    port, ref = texts
    assert port == ref
    text = "\n".join(port)
    assert '# TYPE t_fleetobs_demo_seconds_quantile gauge' in text
    assert 't_fleetobs_demo_seconds_quantile{node="n1",quantile="0.9"}' in text
    assert "t_fleetobs_empty_seconds_quantile" not in text
    assert 'node="no\\"de\\\\with\\nnasties"' in text and 'quantile="0.5"' in text
    assert export.hist_quantile((1.0, 2.0, 4.0), (0, 2, 2), 0.5) == pytest.approx(2.0)
    assert math.isnan(export.hist_quantile((1.0,), (0,), 0.5))


# --- window-DAG attribution -----------------------------------------------------


def _async_trace(seg_cls, windows=3, slow="slow", fast="fast", slow_fit=3.0):
    """Two contributors; ``slow``'s fit is slow_fit per window (the
    reference test's synthetic async trace)."""
    def seg(name, node, start, end, rnd, span_id="", parent_id="", **extra):
        return seg_cls(name=name, node=node, start_s=start, end_s=end, span_id=span_id, parent_id=parent_id,
                       trace_id="t", round=rnd, extra=extra)

    segs, t_fast, t_slow = [], 0.0, 0.0
    for w in range(windows):
        segs.append(seg("fit", fast, t_fast, t_fast + 0.5, w))
        segs.append(seg("diffuse:async_model", fast, t_fast + 0.5, t_fast + 0.6, w))
        segs.append(seg("fit", slow, t_slow, t_slow + slow_fit, w, span_id=f"sf{w}"))
        segs.append(seg("diffuse:async_model", slow, t_slow + slow_fit, t_slow + slow_fit + 0.1, w, span_id=f"sd{w}"))
        arrive = t_slow + slow_fit + 0.05
        segs.append(seg("recv:async_model", fast, arrive, arrive + 0.02, w, span_id=f"r{w}", parent_id=f"sd{w}"))
        segs.append(seg("async_window_wait", fast, t_fast + 0.6, arrive + 0.05, w))
        segs.append(seg("window_close", fast, arrive + 0.05, arrive + 0.05, w,
                        reason="fill" if w < windows - 1 else "timeout", mean_lag=1.0, fill=2))
        t_fast, t_slow = arrive + 0.1, t_slow + slow_fit + 0.2
    return segs


def test_window_report_equals_jax():
    an = CriticalPathAnalyzer(_async_trace(Seg), slack_s=0.5)
    rep = an.window_report(staleness_alpha=0.5)
    assert rep == RefAnalyzer(_async_trace(RefSeg), slack_s=0.5).window_report(staleness_alpha=0.5)
    assert rep["top_gating_contributor"] == "slow" and rep["gating_counts"]["slow"] == 3
    assert rep["close_reason_counts"] == {"fill": 2, "timeout": 1}
    assert rep["windows"]["1"]["staleness_discount"] == pytest.approx(1.0 - 2.0 ** -0.5, abs=1e-3)
    assert "window_report" in an.report()
    sync = CriticalPathAnalyzer([Seg(name="fit", node="a", start_s=0.0, end_s=1.0, span_id="", parent_id="",
                                     trace_id="t", round=0, extra={})])
    assert not sync.has_windows() and "window_report" not in sync.report()


# --- flight recorder ---------------------------------------------------------------


def test_flight_recorder_ring_dump_and_containment(tmp_path):
    rec = FlightRecorder("ring-node", capacity=8)
    fam = REGISTRY.get("p2pfl_flightrec_events_dropped_total")
    before = fam.labels("ring-node").value
    for i in range(20):
        rec.record("tick", i=i)
    assert [e["i"] for e in rec.events()] == list(range(12, 20))
    assert fam.labels("ring-node").value - before == 12
    rec = FlightRecorder("mem://node 3:99/x", capacity=16)
    rec.record("stage", stage="TrainStage", round=1)
    rec.record("reject", reason="norm", source="mem://evil")
    path = rec.dump("crash", directory=str(tmp_path))
    from p2pfl_tpu.telemetry.flight_recorder import FlightRecorder as RefRecorder

    assert path == RefRecorder("mem://node 3:99/x").dump_path(str(tmp_path))
    with open(path) as f:
        doc = json.load(f)
    assert doc["trigger"] == "crash" and doc["node"] == "mem://node 3:99/x"
    assert [e["kind"] for e in doc["events"]] == ["stage", "reject"] and all("t" in e for e in doc["events"])
    assert doc["header"]["kind"] == "flightrec" and doc["header"]["schema_version"] == 2
    blocked = tmp_path / "blocked"
    blocked.write_text("a file, not a directory")
    assert rec.dump("crash", directory=str(blocked)) is None
