"""The port's device observatory against the JAX package's MeshSimulation.

Both packages flag, in each round, a non-finite member loss or aggregate
("nonfinite") and a cohort loss above ``DEVOBS_LOSS_DIVERGE_MULT`` times the
chunk's best finite one ("loss_diverge"), read the flags once per chunk of
``rounds_per_call`` rounds and, under ``DEVOBS_TRIP_ACTION="abort"``, raise
``RuntimeError("devobs tripwire: <kind> at round <r> (chunk <c>); flight
recorder dump: <path>; ...")`` with the population state parked at the end
of the tripped chunk (under ``"park"`` the partial result returns with
``tripped``). Each round also computes on the device the bucket statistics
of its members' update norms (``device_bucket_stats``), folded per chunk
into the ``update_norm`` sketch and the ``p2pfl_mesh_*`` gauges. Each case
runs both packages on one input and holds the port to the reference's kind,
round, chunk, ``completed_rounds``, sketches and snapshot documents. Both
sides dump their flight recorders under ``artifacts/`` of the working
directory and their bundles under ``DOCTOR_BUNDLE_DIR``, so the tests run in
their tmp dir with the bundle directory inside it.
"""

import json
import os
import re
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from p2pfl_tpu.config import Settings as JaxSettings
from p2pfl_tpu.learning.dataset import RandomIIDPartitionStrategy as JaxRandomIID
from p2pfl_tpu.learning.dataset import synthetic_mnist as jax_synthetic_mnist
from p2pfl_tpu.parallel.mesh import make_mesh
from p2pfl_tpu.parallel.simulation import MeshSimulation as JaxMeshSimulation
from p2pfl_tpu_torch.config import Settings
from p2pfl_tpu_torch.learning.dataset import RandomIIDPartitionStrategy, synthetic_mnist
from p2pfl_tpu_torch.parallel.simulation import MeshSimulation, _first_trip
from test_torch_classification import mlp_handles

TRIP = re.compile(r"devobs tripwire: (\w+) at round (\d+) \(chunk (\d+)\); flight recorder dump: .*; "
                  r"state parked at round (\d+)")
# A diverging run: every member's update scaled 10x (the "scaled" Byzantine
# attack) at lr 0.1 takes round 1's cohort loss past 100 times round 0's,
# finite throughout.
DIVERGE = dict(batch_size=64, lr=0.1, byzantine_mask=np.ones(4, np.float32), byzantine_attack="scaled")
SCHED = np.array([[0, 1], [2, 3], [0, 2], [1, 3]], np.int32)


@pytest.fixture(autouse=True)
def _in_tmp(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    bundles = str(tmp_path / "bundles")
    with JaxSettings.overridden(DOCTOR_BUNDLE_DIR=bundles), Settings.overridden(DOCTOR_BUNDLE_DIR=bundles):
        yield


def sims(**kw):
    """The JAX and port simulations of ROADMAP.md C2's input (the MLP, 256
    synthetic MNIST samples over 4 IID nodes, committee 2, batch 32, lr
    1e30: round 0's aggregate is NaN) from the same weights; ``kw``
    overrides its arguments."""
    jh, ph = mlp_handles()
    data = dict(n_train=256, n_test=64)
    args = {**dict(train_set_size=2, batch_size=32, lr=1e30, seed=0), **kw}
    jsim = JaxMeshSimulation(jh, jax_synthetic_mnist(**data).generate_partitions(4, JaxRandomIID),
                             mesh=make_mesh(devices=jax.devices()[:1]), **args)
    sim = MeshSimulation(ph, synthetic_mnist(**data).generate_partitions(4, RandomIIDPartitionStrategy),
                         device="cpu", **args)
    return jsim, sim


def trip_of(sim, **run_kw):
    """``(kind, round, chunk, parked round, completed_rounds)`` of the run's
    tripwire error."""
    with pytest.raises(RuntimeError, match="devobs tripwire") as err:
        sim.run(**run_kw)
    m = TRIP.search(str(err.value))
    assert m is not None, str(err.value)
    return m[1], int(m[2]), int(m[3]), int(m[4]), sim.completed_rounds


@pytest.mark.parametrize("rounds_per_call", [1, 2])
def test_nonfinite_round_aborts_as_in_jax(rounds_per_call):
    jsim, sim = sims()
    want = trip_of(jsim, rounds=2, rounds_per_call=rounds_per_call)
    got = trip_of(sim, rounds=2, rounds_per_call=rounds_per_call)
    assert got == want == ("nonfinite", 0, 0, rounds_per_call, rounds_per_call)


def test_diverging_loss_aborts_as_in_jax():
    jsim, sim = sims(**DIVERGE)
    run = dict(rounds=4, rounds_per_call=4, committee_schedule=SCHED)
    want = trip_of(jsim, **run)
    assert trip_of(sim, **run) == want == ("loss_diverge", 1, 0, 4, 4)


def test_one_round_chunks_never_diverge_and_agree_with_jax():
    # The divergence floor restarts each chunk: at one round a chunk the same
    # run completes on both sides, with the same losses.
    jsim, sim = sims(**DIVERGE)
    run = dict(rounds=4, rounds_per_call=1, committee_schedule=SCHED)
    ref, res = jsim.run(**run), sim.run(**run)
    np.testing.assert_allclose(res.test_loss, ref.test_loss, rtol=1e-5)
    assert max(res.test_loss) > 100 * 2.3  # the losses do diverge
    assert sim.completed_rounds == jsim.completed_rounds == 4


def test_disabled_tripwires_return_nan_as_in_jax():
    jsim, sim = sims()
    with JaxSettings.overridden(DEVOBS_ENABLED=False), Settings.overridden(DEVOBS_ENABLED=False):
        ref, res = jsim.run(rounds=2), sim.run(rounds=2)
    assert np.isnan(ref.test_loss).all() and np.isnan(res.test_loss).all()
    assert len(res.test_loss) == len(ref.test_loss) == 2
    assert sim.completed_rounds == jsim.completed_rounds == 2


def test_park_is_not_ported():
    """Ported now: ``DEVOBS_TRIP_ACTION="park"`` returns the partial result
    with the reference's trip record (kind, round, chunk, action, and the
    paths of the flight-recorder dump and the bundle)."""
    jsim, sim = sims()
    with JaxSettings.overridden(DEVOBS_TRIP_ACTION="park"), Settings.overridden(DEVOBS_TRIP_ACTION="park"):
        ref, res = jsim.run(rounds=2), sim.run(rounds=2)
    keys = ("kind", "round", "chunk", "action")
    assert {k: res.tripped[k] for k in keys} == {k: ref.tripped[k] for k in keys} == {
        "kind": "nonfinite", "round": 0, "chunk": 0, "action": "park"}
    assert res.rounds == ref.rounds == 1 and sim.completed_rounds == jsim.completed_rounds == 1
    assert res.tripped["flightrec"] == ref.tripped["flightrec"] == "artifacts/flightrec_mesh-sim.json"
    assert res.tripped["bundle"] is not None and len(res.committees) == len(ref.committees) == 1


#: Every setting the device observatory and the telemetry plane read.
SETTINGS = ("DEVOBS_ENABLED", "DEVOBS_TRIP_ACTION", "DEVOBS_LOSS_DIVERGE_MULT", "DEVOBS_PROFILE_CHUNKS",
            "DEVOBS_MEM_TTL_S", "DEVOBS_NAN_INJECT_ROUND", "RUN_ID", "TRACE_MAX_SPANS",
            "FLIGHTREC_CAPACITY", "SKETCH_REL_ERR", "SKETCH_MAX_BINS", "OBS_REFRESH_MIN_S", "OBS_MAX_TRACKED",
            "OBS_PEER_TTL", "DOCTOR_BUNDLE_ENABLED", "DOCTOR_MIN_CONFIDENCE",
            "PERF_TRACE_DIR", "LEDGER_SNAPSHOT_TAIL")


def test_settings_match_jax():
    for name in SETTINGS:
        assert getattr(Settings, name) == getattr(JaxSettings, name), name


@pytest.mark.parametrize("name,value", [("SKETCH_REL_ERR", "0.05"), ("DEVOBS_NAN_INJECT_ROUND", "3"),
                                        ("DOCTOR_BUNDLE_DIR", None), ("OBS_MAX_TRACKED", "7")])
def test_settings_env_overrides_match_jax(name, value):
    """The same ``P2PFL_TPU_<NAME>`` value sets (or refuses) the same
    setting in both packages, each imported in a fresh interpreter."""
    code = ("import sys, importlib; m = importlib.import_module(sys.argv[1]); "
            "print(repr(getattr(m.Settings, sys.argv[2])))")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {k: v for k, v in os.environ.items() if k != f"P2PFL_TPU_{name}"}
    if value is not None:  # None: the default
        env[f"P2PFL_TPU_{name}"] = value
    outs = [subprocess.run([sys.executable, "-c", code, mod, name], cwd=root, env=env, capture_output=True,
                           text=True, timeout=120) for mod in ("p2pfl_tpu.config", "p2pfl_tpu_torch.config")]
    assert [o.returncode for o in outs] == [o.returncode for o in outs[:1]] * 2, [o.stderr[-300:] for o in outs]
    assert outs[0].stdout.strip().splitlines()[-1:] == outs[1].stdout.strip().splitlines()[-1:]


def test_first_trip_prefers_the_earlier_round_then_nonfinite():
    flags = np.array([[False, False], [False, True], [True, True]])
    assert _first_trip(flags, 10, 3) == {"kind": "loss_diverge", "round": 11, "chunk": 3}
    assert _first_trip(flags[[0, 2]], 0, 0) == {"kind": "nonfinite", "round": 1, "chunk": 0}
    assert _first_trip(flags[:1], 0, 0) is None


# --- the device observatory's aux stream ----------------------------------------------


def test_device_bucket_stats_matches_jax():
    """The same values through the JAX function and the port's: integer
    fields exact, the sum within 1e-6, min and max exact (zeros, non-finite
    values and both window clips included)."""
    from p2pfl_tpu.telemetry import sketches as jax_sketches
    from p2pfl_tpu_torch.telemetry import sketches

    rng = np.random.default_rng(0)
    v = np.exp(rng.uniform(np.log(1e-8), np.log(1e5), 4096)).astype(np.float32) * rng.choice([-1, 1], 4096)
    v[:8] = [0.0, np.nan, np.inf, -np.inf, 1e-12, 5e-10, 1e4, 1e-7]
    spec = sketches.device_bucket_spec()
    assert spec == jax_sketches.device_bucket_spec()
    kw = dict(gamma_log=spec[0], lo_idx=spec[1], nbins=spec[2])
    got = sketches.device_bucket_stats(torch.from_numpy(v), **kw)
    want = {k: np.asarray(a) for k, a in jax_sketches.device_bucket_stats(v, **kw).items()}
    assert got["counts"].dtype == torch.int32 and got["counts"].shape == (spec[2],)
    np.testing.assert_array_equal(got["counts"].numpy(), want["counts"])
    assert int(got["zeros"]) == int(want["zeros"]) == 3  # 0, 1e-12, 5e-10
    assert float(got["min"]) == float(want["min"]) and float(got["max"]) == float(want["max"])
    np.testing.assert_allclose(float(got["sum"]), float(want["sum"]), rtol=1e-6)
    empty = sketches.device_bucket_stats(torch.tensor([np.nan, 0.0]), **kw)
    assert int(empty["counts"].sum()) == 0 and float(empty["min"]) == np.inf and float(empty["max"]) == -np.inf


SANE = dict(batch_size=64, lr=1e-3)  # one batch a node: the shuffles only reorder a mean
SCHED6 = np.array([[0, 1], [2, 3], [0, 2], [1, 3], [0, 3], [1, 2]], np.int32)


def _port_hash(sim):
    from p2pfl_tpu_torch.telemetry.ledger import canonical_params_hash

    return canonical_params_hash({k: v[0] for k, v in sim.params_stack.items()})


def test_devobs_on_and_off_give_the_same_params():
    hashes = []
    for on in (True, False):
        _, sim = sims(**SANE)
        with Settings.overridden(DEVOBS_ENABLED=on):
            sim.run(rounds=3, rounds_per_call=2, warmup=False)
        hashes.append(_port_hash(sim))
    assert hashes[0] == hashes[1]


def test_devobs_summary_matches_jax_and_is_invariant_to_rounds_per_call():
    """The update-norm and train-loss sketches after 6 scheduled rounds:
    counts equal to the reference's (committee x rounds), quantiles within
    the sketch's relative error of the reference's, and the port's own
    summary the same at 1, 2 and 6 rounds a chunk."""
    from p2pfl_tpu.telemetry.sketches import SKETCHES as JAX_SKETCHES
    from p2pfl_tpu_torch.telemetry.sketches import SKETCHES

    summaries = {}
    for rpc in (1, 2, 6):
        SKETCHES.reset()
        _, sim = sims(**SANE)
        sim.run(rounds=6, rounds_per_call=rpc, committee_schedule=SCHED6, warmup=False)
        extras, sk = sim.devobs_summary()
        summaries[rpc] = (sk["update_norm"].to_wire(), sk["train_loss"].to_wire(),
                          {k: v for k, v in extras.items() if k != "mem_bytes"})
    assert summaries[1] == summaries[2] == summaries[6]
    JAX_SKETCHES.reset()
    jsim, _ = sims(**SANE)
    jsim.run(rounds=6, rounds_per_call=2, committee_schedule=SCHED6, warmup=False)
    jextras, jsk = jsim.devobs_summary()
    _, psk = sim.devobs_summary()
    rel = Settings.SKETCH_REL_ERR
    for metric in ("update_norm", "train_loss"):
        assert psk[metric].count == jsk[metric].count == (12 if metric == "update_norm" else 6)
        for q in (0.1, 0.5, 0.9):
            assert psk[metric].quantile(q) == pytest.approx(jsk[metric].quantile(q), rel=2 * rel + 1e-6), (metric, q)
    extras = summaries[2][2]
    assert extras["tripped"] is None and jextras["tripped"] is None
    assert extras["update_norm_p90"] == pytest.approx(jextras["update_norm_p90"], rel=2 * rel)
    assert extras["train_loss"] == pytest.approx(jextras["train_loss"], rel=1e-5)


def test_mesh_prometheus_family_is_exported():
    from p2pfl_tpu_torch.telemetry.export import render_prometheus

    _, sim = sims(**SANE)
    sim.run(rounds=2, rounds_per_call=2, committee_schedule=SCHED6[:2], warmup=False)
    text = render_prometheus()
    for fam in ("p2pfl_mesh_round", "p2pfl_mesh_train_loss", "p2pfl_mesh_weight_mass",
                "p2pfl_mesh_participants_total"):
        assert f'{fam}{{node="mesh-sim"}}' in text, fam
    assert "p2pfl_sketch_update_norm" in text


@pytest.mark.parametrize("action", ["park", "abort"])
@pytest.mark.parametrize("rounds_per_call", [1, 2])
def test_nan_injection_trips_as_in_jax(action, rounds_per_call):
    """``DEVOBS_NAN_INJECT_ROUND=1`` on a sane run: both trip ``nonfinite``
    at round 1, in the chunk holding it, and the abort message names the
    flight-recorder dump, whose chunk events carry the bytes in use."""
    jsim, sim = sims(**SANE)
    knobs = dict(DEVOBS_NAN_INJECT_ROUND=1, DEVOBS_TRIP_ACTION=action)
    with JaxSettings.overridden(**knobs), Settings.overridden(**knobs):
        if action == "abort":
            want = trip_of(jsim, rounds=4, rounds_per_call=rounds_per_call)
            with pytest.raises(RuntimeError, match="flight recorder dump: artifacts/flightrec_mesh-sim.json;"):
                sim.run(rounds=4, rounds_per_call=rounds_per_call)
            assert (want[0], want[1], want[2]) == ("nonfinite", 1, 1 // rounds_per_call)
            assert sim.completed_rounds == jsim.completed_rounds == 2
        else:
            ref, res = jsim.run(rounds=4, rounds_per_call=rounds_per_call), sim.run(
                rounds=4, rounds_per_call=rounds_per_call)
            keys = ("kind", "round", "chunk", "action")
            assert {k: res.tripped[k] for k in keys} == {k: ref.tripped[k] for k in keys}
            assert res.tripped["round"] == 1 and res.rounds == ref.rounds == 2
    with open("artifacts/flightrec_mesh-sim.json") as f:
        events = json.load(f)["events"]
    starts = [e for e in events if e["kind"] == "chunk_start"]
    assert starts and all(e["bytes_in_use"] > 0 for e in starts)
    assert events[-1]["kind"] == "devobs_trip" and events[-1]["round"] == 1


def test_fleet_health_and_snapshot_match_jax(tmp_path):
    """Same schedule and node speeds: the health arrays equal the
    reference's (step time from each side's own measured s/round), and the
    snapshot documents have the same shape, peers and straggler."""
    speed = np.array([1.0, 5.0, 1.0, 1.0], np.float32)
    jsim, sim = sims(node_speed=speed, **SANE)
    ref = jsim.run(rounds=4, committee_schedule=SCHED6[:4], warmup=False)
    res = sim.run(rounds=4, committee_schedule=SCHED6[:4], warmup=False)
    got, want = sim.fleet_health(res), jsim.fleet_health(ref)
    assert set(got) == set(want)
    for key in ("participation", "round_lag", "round", "rejections", "cohort_fill"):
        np.testing.assert_array_equal(got[key], want[key])
    np.testing.assert_allclose(got["step_time"] / res.seconds_per_round, want["step_time"] / ref.seconds_per_round,
                               rtol=1e-6)
    path = str(tmp_path / "snap.json")
    snap = sim.fleet_snapshot(res, top_n=2, path=path)
    jsnap = jsim.fleet_snapshot(ref, top_n=2, path=str(tmp_path / "jax_snap.json"))
    from p2pfl_tpu_torch.telemetry.observatory import snapshot_shape_diff

    assert snapshot_shape_diff(snap, jsnap) == [] and snapshot_shape_diff(jsnap, snap) == []
    assert set(snap["peers"]) == set(jsnap["peers"]) and snap["top_straggler"] == jsnap["top_straggler"] == \
        "vnode/00001"
    with open(path) as f:
        assert json.load(f)["fleet"]["size"] == 5


# --- the async population engine's devobs stream (the JAX package's test_devobs.py) ---------

ASYNC_KW = dict(cohort_fraction=0.5, seed=7, samples_per_node=8, feature_dim=8, num_classes=4, hidden=(8,),
                batch_size=4, lr=0.05)


def _sketch_counts(node):
    from p2pfl_tpu_torch.telemetry.sketches import SKETCHES

    un, tl = SKETCHES.get("update_norm", node), SKETCHES.get("train_loss", node)
    return (0 if un is None else un.count, 0 if tl is None else tl.count)


def test_async_engine_aux_stream_and_park_trip():
    """The async engine's aux stream fills the update-norm and train-loss
    sketches without changing a bit of the trajectory; a NaN injected at
    window 2 with ``park`` stops at the end of its chunk (4 windows run)."""
    from p2pfl_tpu_torch.population import AsyncPopulationEngine
    from p2pfl_tpu_torch.telemetry.ledger import canonical_params_hash
    from p2pfl_tpu_torch.telemetry.sketches import SKETCHES

    SKETCHES.reset()
    with Settings.overridden(DEVOBS_ENABLED=True):
        with AsyncPopulationEngine(8, device="cpu", **ASYNC_KW) as eng:
            eng.run(4, eval_every=4, windows_per_call=2)
            h_on = canonical_params_hash(eng.global_params())
    on_counts = _sketch_counts("asyncpop-engine")
    assert on_counts[0] > 0 and on_counts[1] > 0
    SKETCHES.reset()
    with Settings.overridden(DEVOBS_ENABLED=False):
        with AsyncPopulationEngine(8, device="cpu", **ASYNC_KW) as eng:
            eng.run(4, eval_every=4, windows_per_call=2)
            h_off = canonical_params_hash(eng.global_params())
    assert h_on == h_off
    assert _sketch_counts("asyncpop-engine") == (0, 0)

    with Settings.overridden(DEVOBS_ENABLED=True, DEVOBS_NAN_INJECT_ROUND=2, DEVOBS_TRIP_ACTION="park"):
        with AsyncPopulationEngine(8, device="cpu", **ASYNC_KW) as eng:
            res = eng.run(6, eval_every=6, windows_per_call=2)
            assert eng.completed_windows == 4
    assert res.tripped is not None and res.tripped["kind"] == "nonfinite"
    assert res.tripped["round"] == 2 and res.windows == 4 and res.tripped["chunk"] == 1
    assert res.tripped["bundle"] is not None and os.path.exists(res.tripped["flightrec"])


def test_async_engine_aux_stream_equals_the_jax_package():
    """Same windows (the JAX engine's initial globals carried in, one batch
    a vnode, f32 compute): the update-norm bucket counts, zeros and
    participants of the aux stream equal the JAX package's, the quantiles
    and the last window loss within the sketch's error; abort raises the
    JAX package's message at the same window with the state parked."""
    from p2pfl_tpu.population import AsyncPopulationEngine as JaxAsyncPopulationEngine
    from p2pfl_tpu.telemetry.sketches import SKETCHES as JAX_SKETCHES
    from p2pfl_tpu_torch.models.convert import flax_to_torch
    from p2pfl_tpu_torch.population import AsyncPopulationEngine
    from p2pfl_tpu_torch.telemetry.sketches import SKETCHES

    kw = {**ASYNC_KW, "batch_size": 8, "speed_tiers": (1.0, 2.0, 3.0)}
    SKETCHES.reset()
    JAX_SKETCHES.reset()
    with Settings.overridden(COMPUTE_DTYPE="float32", DEVOBS_ENABLED=True), \
            JaxSettings.overridden(COMPUTE_DTYPE="float32", DEVOBS_ENABLED=True), \
            JaxAsyncPopulationEngine(12, **kw) as ref, AsyncPopulationEngine(12, device="cpu", **kw) as eng:
        eng.history = flax_to_torch(jax.tree.map(np.asarray, ref.history), device="cpu")
        ref.run(6, eval_every=6, windows_per_call=3)
        eng.run(6, eval_every=6, windows_per_call=3)
        (extras, sk), (jextras, jsk) = eng.devobs_summary(), ref.devobs_summary()
    assert sk["update_norm"].count == jsk["update_norm"].count
    assert sk["update_norm"].zero_count == jsk["update_norm"].zero_count > 0  # the empty slots
    assert sk["train_loss"].count == jsk["train_loss"].count
    for q in (0.1, 0.5, 0.9):
        assert sk["update_norm"].quantile(q) == pytest.approx(jsk["update_norm"].quantile(q), rel=1e-4)
    assert extras["train_loss"] == pytest.approx(jextras["train_loss"], rel=1e-5)
    knobs = dict(DEVOBS_ENABLED=True, DEVOBS_NAN_INJECT_ROUND=3, DEVOBS_TRIP_ACTION="abort")
    msgs = []
    with Settings.overridden(**knobs), JaxSettings.overridden(**knobs):
        for cls, extra in ((JaxAsyncPopulationEngine, {}), (AsyncPopulationEngine, {"device": "cpu"})):
            with cls(12, **kw, **extra) as e:
                with pytest.raises(RuntimeError, match="devobs tripwire") as err:
                    e.run(6, eval_every=6, windows_per_call=2)
                assert e.completed_windows == 4 and e.global_params() is not None
                msgs.append(re.sub(r"dump: \S+;", "dump: -;", str(err.value)))
    assert msgs[0] == msgs[1]
