"""The port's async population subsystem (``p2pfl_tpu_torch/population/
arrivals.py``, ``async_engine.py``) against the JAX package's on the CPU.

* arrivals: trace intensities, arrival delays and compiled window schedules
  equal the JAX package's exactly, for any seed, trace and chunking;
* the engine's windows: the JAX engine's initial globals carried into the
  port's ring (``models/convert.py``), one batch a vnode and f32 compute on
  both sides: the windows' fills, close codes and lags equal, the globals
  and test losses within 1e-5, zero-lag and lagged streams alike;
* the port's own bit-exact contracts (the JAX package's ``test_asyncpop.py``
  cases): zero-lag windows equal the port's sync engine, chunked runs equal
  one long run, a checkpoint resume replays the window stream, the wire
  replay aligns through ``parity_diff``, the snapshot carries the window
  columns.
"""

import importlib.util
import json
import math
import os
import subprocess
import sys

import jax
import numpy as np
import pytest

from p2pfl_tpu.config import Settings as JaxSettings
from p2pfl_tpu.population import AsyncPopulationEngine as JaxAsyncPopulationEngine
from p2pfl_tpu.population.arrivals import AsyncWindowPlan as JaxAsyncWindowPlan
from p2pfl_tpu.population.arrivals import arrival_delay as jax_arrival_delay
from p2pfl_tpu.population.arrivals import compile_window_schedule as jax_compile_window_schedule
from p2pfl_tpu.population.arrivals import trace_intensity as jax_trace_intensity
from p2pfl_tpu_torch.config import Settings
from p2pfl_tpu_torch.management.checkpoint import FLCheckpointer
from p2pfl_tpu_torch.models.convert import flax_to_torch
from p2pfl_tpu_torch.population import (
    AsyncPopulationEngine,
    PopulationEngine,
    vnode_names,
    wire_window_replay,
)
from p2pfl_tpu_torch.population.arrivals import (
    CLOSE_FILL,
    TRACES,
    AsyncWindowPlan,
    arrival_delay,
    compile_window_schedule,
    trace_intensity,
)
from p2pfl_tpu_torch.telemetry.ledger import LEDGERS, canonical_params_hash

from test_torch_comm import RAW_VALUES, ROOT, SETTINGS_PROBE

SCHEDULE_FIELDS = ("members", "present", "origin", "lag", "rank", "target", "solicited", "queue_depth", "dropped")
SMALL = dict(samples_per_node=8, feature_dim=8, num_classes=4, hidden=(8,), batch_size=4)


def _parity_diff():
    spec = importlib.util.spec_from_file_location("parity_diff", os.path.join(ROOT, "scripts", "parity_diff.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _speeds(n: int, tiers, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed + 0x7153)
    return np.asarray(tiers, np.float32)[rng.integers(0, len(tiers), size=n)]


# --- settings -------------------------------------------------------------------------

ASYNCPOP_FIELDS = (
    "ASYNCPOP_FILL_FRACTION", "ASYNCPOP_TIMEOUT_TICKS", "ASYNCPOP_STALL_PATIENCE", "ASYNCPOP_MAX_LAG",
    "ASYNCPOP_STATE_DTYPE", "ASYNCPOP_ARRIVAL_TRACE", "ARRIVAL_TRACE_PERIOD", "ARRIVAL_FLASH_MULT",
    "SUPERVISOR_JOURNAL_EVERY", "SUPERVISOR_MAX_RETRIES", "SUPERVISOR_BACKOFF_S", "SUPERVISOR_DEGRADE",
    "CAMPAIGN_STALL_PATIENCE",
)


def test_asyncpop_settings_match_reference_defaults_and_bounds():
    """The 13 settings of the async engine, the supervisor and the scenario
    campaign have the reference's defaults, parse the same environment
    values to the same value and reject the same ones at import."""
    raws = RAW_VALUES + ("bfloat16", "flash", "chunks", "off")
    cases = [[name, raw] for name in ASYNCPOP_FIELDS for raw in raws]
    env = {k: v for k, v in os.environ.items() if not k.startswith("P2PFL_TPU_")}
    outs = {}
    for module in ("p2pfl_tpu_torch.config", "p2pfl_tpu.config"):
        proc = subprocess.run([sys.executable, "-c", SETTINGS_PROBE, module, json.dumps(cases)], cwd=ROOT, env=env,
                              capture_output=True, text=True, timeout=240)
        assert proc.returncode == 0, proc.stderr[-2000:]
        outs[module] = json.loads(proc.stdout.strip().splitlines()[-1])
    assert outs["p2pfl_tpu_torch.config"] == outs["p2pfl_tpu.config"]
    by_case = dict(zip(map(tuple, cases), outs["p2pfl_tpu_torch.config"]))
    assert by_case[("ASYNCPOP_MAX_LAG", "0")][0] == "ValueError"  # the bounds are checked at all
    assert by_case[("ASYNCPOP_STATE_DTYPE", "bfloat16")] == ["ok", "'bfloat16'"]
    assert all(by_case[(name, None)][0] == "ok" for name in ASYNCPOP_FIELDS)


# --- arrivals against the JAX package -------------------------------------------------


@pytest.mark.parametrize("trace", TRACES)
def test_trace_intensity_equals_the_jax_package(trace):
    for period in (2, 5, 8, 24):
        for flash_mult in (None, 3.0, 10.0):
            got = [trace_intensity(trace, w, period, flash_mult) for w in range(3 * period + 1)]
            want = [jax_trace_intensity(trace, w, period, flash_mult) for w in range(3 * period + 1)]
            assert got == want, (trace, period, flash_mult)
    assert trace_intensity(trace, 7) == jax_trace_intensity(trace, 7)  # the settings' defaults


@pytest.mark.parametrize("seed", [0, 9, 2**31 - 1])
def test_arrival_delay_equals_the_jax_package(seed):
    for speed in (0.5, 1.0, 2.0, 3.0, 5.0, 7.5):
        got = [arrival_delay(seed, w, f"vnode/{i:05d}", speed) for w in range(12) for i in range(10)]
        assert got == [jax_arrival_delay(seed, w, f"vnode/{i:05d}", speed) for w in range(12) for i in range(10)]


def _plans(seed, names, **kw):
    return (AsyncWindowPlan(seed=seed, names=tuple(names), **kw),
            JaxAsyncWindowPlan(seed=seed, names=tuple(names), **kw))


def _assert_schedules_equal(a, b):
    assert (a.start_window, a.cohort_k, a.windows) == (b.start_window, b.cohort_k, b.windows)
    for attr in SCHEDULE_FIELDS:
        x, y = getattr(a, attr), getattr(b, attr)
        assert x.dtype == y.dtype, attr
        np.testing.assert_array_equal(x, y, err_msg=attr)


@pytest.mark.parametrize("trace", TRACES)
@pytest.mark.parametrize("seed", [3, 11, 1234])
def test_window_schedule_equals_the_jax_package(seed, trace):
    """Members, presence, origins, lags, ranks, targets and the queue and
    drop counters equal the JAX package's, for whole and chunked streams
    (slow tiers, churn, stall patience and a tight lag bound)."""
    n = 40
    names = vnode_names(n)
    speeds = _speeds(n, (1.0, 1.0, 2.0, 5.0), seed)
    plan, jplan = _plans(seed, names, fraction=0.2, churn_rate=0.1, trace=trace, period=6, stall_patience=2,
                         max_lag=3)
    whole = compile_window_schedule(plan, names, 14, speeds=speeds)
    _assert_schedules_equal(whole, jax_compile_window_schedule(jplan, names, 14, speeds=speeds))
    for start, count in ((0, 5), (5, 9), (9, 3)):
        _assert_schedules_equal(compile_window_schedule(plan, names, count, start_window=start, speeds=speeds),
                                jax_compile_window_schedule(jplan, names, count, start_window=start, speeds=speeds))
    # The present slots are a prefix of each row (the engine folds a prefix).
    fill = whole.fill()
    assert all(whole.present[w, :fill[w]].all() and not whole.present[w, fill[w]:].any() for w in range(14))


def test_window_schedule_validates_like_the_jax_package():
    names = vnode_names(4)
    plan, jplan = _plans(0, names, fraction=0.5)
    for fn, p in ((compile_window_schedule, plan), (jax_compile_window_schedule, jplan)):
        with pytest.raises(ValueError, match="must be >= 0"):
            fn(p, names, -1)
        with pytest.raises(ValueError, match="speeds has shape"):
            fn(p, names, 2, speeds=np.ones(3, np.float32))
    for cls in (AsyncWindowPlan, JaxAsyncWindowPlan):
        with pytest.raises(ValueError, match="unknown arrival trace"):
            cls(seed=0, fraction=0.5, trace="bursty")
    assert plan.resolved() == jplan.resolved()
    with Settings.overridden(ASYNCPOP_MAX_LAG=7), JaxSettings.overridden(ASYNCPOP_MAX_LAG=7):
        assert plan.resolved() == jplan.resolved() and plan.resolved()[3] == 7


# --- arrivals: the JAX package's test_asyncpop.py cases ---------------------------------


def test_trace_intensity_profiles():
    p = 8
    assert all(trace_intensity("uniform", w, p) == 1.0 for w in range(3 * p))
    for trace in ("diurnal", "regional"):
        vals = [trace_intensity(trace, w, p) for w in range(3 * p)]
        assert all(0.0 < v <= 1.0 for v in vals)
        assert vals[:p] == vals[p: 2 * p]  # periodic in the ABSOLUTE window index
    spike = max(1, p // 5)
    for w in range(2 * p):
        assert trace_intensity("flash", w, p, flash_mult=10.0) == (1.0 if (w % p) < spike else pytest.approx(0.1))
    with pytest.raises(ValueError, match="unknown arrival trace"):
        trace_intensity("bursty", 0, p)


def test_arrival_delay_tiers_and_determinism():
    assert all(arrival_delay(9, w, "vnode/00003", 1.0) == 0 for w in range(50))
    for speed in (2.0, 3.0, 5.0):
        draws = [arrival_delay(9, w, f"vnode/{i:05d}", speed) for w in range(20) for i in range(8)]
        assert min(draws) >= 0 and max(draws) <= math.ceil(speed) - 1
        assert max(draws) > 0  # the slow tier really is late sometimes


def test_window_schedule_chunk_and_cursor_invariance():
    n, seed = 24, 3
    names = vnode_names(n)
    speeds = _speeds(n, (1.0, 1.0, 2.0, 5.0), seed)
    plan = AsyncWindowPlan(seed=seed, fraction=0.25, names=tuple(names))
    whole = compile_window_schedule(plan, names, 8, start_window=0, speeds=speeds)
    head = compile_window_schedule(plan, names, 5, start_window=0, speeds=speeds)
    tail = compile_window_schedule(plan, names, 3, start_window=5, speeds=speeds)
    for attr in SCHEDULE_FIELDS:
        np.testing.assert_array_equal(np.concatenate([getattr(head, attr), getattr(tail, attr)]),
                                      getattr(whole, attr), err_msg=attr)
    assert whole.windows == 8 and tail.start_window == 5
    w_abs = np.arange(8)[:, None]
    np.testing.assert_array_equal(whole.lag[whole.present], (w_abs - whole.origin)[whole.present])


def test_window_schedule_backpressure_and_staleness_gate():
    n, seed = 64, 11
    names = vnode_names(n)
    slow = np.full(n, 5.0, np.float32)  # everyone up to 4 windows late
    plan = AsyncWindowPlan(seed=seed, fraction=0.25, names=tuple(names), trace="flash", period=6,
                           stall_patience=2, max_lag=4)
    sched = compile_window_schedule(plan, names, 24, speeds=slow)
    assert sched.queue_depth.max() <= (2 + 1) * sched.cohort_k
    assert (sched.lag[sched.present] <= 4).all()
    strict = AsyncWindowPlan(seed=seed, fraction=0.25, names=tuple(names), trace="flash", period=6,
                             stall_patience=2, max_lag=0)
    sgate = compile_window_schedule(strict, names, 24, speeds=slow)
    assert (sgate.lag[sgate.present] == 0).all() and int(sgate.dropped.sum()) > 0


def test_staleness_discount_is_the_wire_weight():
    from p2pfl_tpu.learning.aggregators import staleness_discount as jax_staleness_discount
    from p2pfl_tpu_torch.learning.aggregators.async_buffer import staleness_discount, staleness_weight

    alpha = float(Settings.ASYNC_STALENESS_ALPHA)
    fused = staleness_discount(list(range(6)), alpha).numpy()
    wire = np.asarray([staleness_weight(lag) for lag in range(6)], np.float32)
    np.testing.assert_array_equal(fused, wire)
    np.testing.assert_allclose(fused, np.asarray(jax_staleness_discount(np.arange(6), alpha)), rtol=1e-6)
    assert fused[0] == 1.0 and (np.diff(fused) < 0).all()


# --- the engine against the JAX package -------------------------------------------------


@pytest.mark.parametrize("tiers,trace", [((), "uniform"), ((1.0, 1.0, 2.0, 5.0), "uniform"),
                                         ((1.0, 2.0, 5.0), "flash")])
def test_engine_windows_track_the_jax_package(tiers, trace):
    """Host pieces equal (names, tiers, data, schedules); the JAX engine's
    initial globals carried into the port's ring; six windows (one batch a
    vnode, f32 compute) agree within 1e-5, lagged streams included."""
    spec = dict(cohort_fraction=0.25, seed=5, speed_tiers=tiers, trace=trace, trace_period=4,
                samples_per_node=8, feature_dim=8, num_classes=4, hidden=(8,), batch_size=8)
    with Settings.overridden(COMPUTE_DTYPE="float32"), JaxSettings.overridden(COMPUTE_DTYPE="float32"), \
            JaxAsyncPopulationEngine(24, **spec) as ref, AsyncPopulationEngine(24, device="cpu", **spec) as eng:
        assert eng.names == ref.names and eng.cohort_k == ref.cohort_k and eng.history_depth == ref.history_depth
        np.testing.assert_array_equal(eng.node_speed, ref.node_speed)
        np.testing.assert_array_equal(eng.x.numpy(), np.asarray(ref.x))
        sched, jsched = eng.schedule(6), ref.schedule(6)
        _assert_schedules_equal(sched, jsched)
        if tiers:
            assert sched.lag[sched.present].max() > 0  # staleness is live
        eng.history = flax_to_torch(jax.tree.map(np.asarray, ref.history), device="cpu")
        jres, res = ref.run(6, eval_every=2, windows_per_call=3), eng.run(6, eval_every=2, windows_per_call=3)
        for attr in ("fills", "close_codes", "durations", "lag_sums"):
            np.testing.assert_array_equal(getattr(res, attr), getattr(jres, attr), err_msg=attr)
        assert res.windows == jres.windows and res.sim_time_ticks == jres.sim_time_ticks
        np.testing.assert_allclose(res.test_loss, jres.test_loss, atol=1e-5)
        want = flax_to_torch(jax.tree.map(lambda a: np.asarray(a[0]), ref.history), device="cpu")
        got = eng.global_params()
        assert set(got) == set(want)
        for k in got:
            np.testing.assert_allclose(got[k], want[k].numpy(), atol=1e-5, err_msg=k)
        np.testing.assert_array_equal(eng.window_fill(), ref.window_fill())
        assert res.summary()["close_reasons"] == jres.summary()["close_reasons"]


# --- the port's bit-exact contracts --------------------------------------------------------


def test_zero_lag_async_matches_sync_engine():
    """All tiers 1.0 + uniform trace: every window folds its full cohort
    fresh with a discount of exactly 1.0, so the window IS the sync round —
    the same hash, bit for bit."""
    kw = dict(cohort_fraction=0.5, seed=7, lr=0.05, device="cpu", **SMALL)
    with PopulationEngine(12, **kw) as sync:
        sres = sync.run(5)
        sync_hash = canonical_params_hash(sync.gather_params(0))
    with AsyncPopulationEngine(12, **kw) as a:
        res = a.run(5, eval_every=5)
        async_hash = canonical_params_hash(a.global_params())
    assert async_hash == sync_hash
    assert res.test_acc[-1] == sres.test_acc[-1]
    assert (res.close_codes == CLOSE_FILL).all()
    assert (res.schedule.lag[res.schedule.present] == 0).all()


def test_chunked_windows_equal_one_long_run():
    """3 + 5 windows (and 8 windows in chunks of 3) equal 8 windows in one
    call, bit for bit, with a lagged stream."""
    kw = dict(cohort_fraction=0.5, seed=2, speed_tiers=(1.0, 2.0, 5.0), device="cpu", **SMALL)
    with AsyncPopulationEngine(12, **kw) as one:
        r1 = one.run(8, eval_every=4)
        want = canonical_params_hash(one.global_params())
    with AsyncPopulationEngine(12, **kw) as two:
        two.run(3, eval_every=4)
        r2 = two.run(5, eval_every=4)
        assert two.completed_windows == 8
        assert canonical_params_hash(two.global_params()) == want
        np.testing.assert_array_equal(two.window_fill(), one.window_fill())
    with AsyncPopulationEngine(12, **kw) as chunked:
        r3 = chunked.run(8, eval_every=4, windows_per_call=3)
        assert canonical_params_hash(chunked.global_params()) == want
    assert r1.test_acc[-1] == r2.test_acc[-1] == r3.test_acc[-1]
    np.testing.assert_array_equal(r1.lag_sums, r3.lag_sums)


def test_async_checkpoint_resume_replays_window_stream(tmp_path):
    """Kill after 4 windows, restore, run 3 more: the same global hash and
    the same per-vnode fold accounting as the uninterrupted 7-window run;
    a seed-mismatched checkpoint refuses."""
    kw = dict(cohort_fraction=0.5, seed=4, speed_tiers=(1.0, 2.0, 5.0), device="cpu", **SMALL)
    with AsyncPopulationEngine(12, **kw) as ref:
        ref.run(7, eval_every=10)
        ref_hash = canonical_params_hash(ref.global_params())
        ref_fill = ref.window_fill()
    ckpt = FLCheckpointer(str(tmp_path))
    with AsyncPopulationEngine(12, **kw) as victim:
        victim.run(4, eval_every=10)
        assert victim.save_to(ckpt)
        victim.run(1, eval_every=10)  # the ring moves on in place; the saved copy must not
    with AsyncPopulationEngine(12, **kw) as healed:
        assert healed.load_from(ckpt) == 4
        healed.run(3, eval_every=10)
        assert canonical_params_hash(healed.global_params()) == ref_hash
        np.testing.assert_allclose(healed.window_fill(), ref_fill)
    with AsyncPopulationEngine(12, **{**kw, "seed": 5}) as wrong:
        with pytest.raises(ValueError, match="seed"):
            wrong.load_from(ckpt)


def test_wire_vs_fused_async_parity_n4():
    """The real AsyncBufferedAggregator replaying the compiled window stream
    emits a ledger that aligns with the engine's: aggregate hashes
    bit-exact, final params bit-equal (staleness weights and all)."""
    parity_diff = _parity_diff()
    par_kw = dict(cohort_fraction=1.0, seed=1236, speed_tiers=(1.0, 1.0, 2.0, 3.0), device="cpu", **SMALL)
    LEDGERS.reset()
    with AsyncPopulationEngine(4, **par_kw) as fused:
        led = fused.attach_ledger("fused-async-test")
        res = fused.run(4, eval_every=100, windows_per_call=1)
        fused_ev = led.canonical_events()
        fused_params = fused.global_params()
    assert res.schedule.lag[res.schedule.present].max() > 0  # staleness live
    weng = AsyncPopulationEngine(4, **par_kw)
    wire = wire_window_replay(weng, 4, node="wire-async-test")
    weng.close()
    report = parity_diff.compare_ledgers(LEDGERS.get("wire-async-test").canonical_events(), fused_ev)
    assert report["status"] == "OK", report
    assert report["hashes_compared"] >= 1
    assert set(wire["final_params"]) == set(fused_params)
    for k, v in fused_params.items():
        np.testing.assert_array_equal(wire["final_params"][k], v)


def test_async_snapshot_carries_window_columns():
    with AsyncPopulationEngine(8, cohort_fraction=0.5, seed=3, device="cpu", **SMALL) as eng:
        res = eng.run(3, eval_every=3)
        snap = eng.snapshot(res, top_n=4)
    assert len(snap["peers"]) == 4 + 1  # top_n virtual rows + the observer's own row
    for name, peer in snap["peers"].items():
        if name == "asyncpop-engine":
            continue
        assert peer["window"] is not None and peer["window"] >= 0
        assert peer["window_fill"] is not None and 0.0 <= peer["window_fill"] <= 1.0


def test_padded_bf16_engine_runs_and_closed_engine_refuses():
    """A mesh whose "nodes" axis is 4 pads 6 vnodes with 2 zero rows; the
    bf16 ring trains and evaluates finite; a closed engine refuses to run."""
    from p2pfl_tpu_torch.parallel.mesh import make_mesh

    with AsyncPopulationEngine(6, cohort_fraction=0.5, seed=1, state_dtype="bfloat16",
                               mesh=make_mesh((4, 1), devices=["cpu"]), device="cpu", **SMALL) as eng:
        assert eng.x.shape[0] == 8 and eng.num_nodes == 6
        assert all(v.dtype.is_floating_point and v.dtype.itemsize == 2 for v in eng.history.values())
        res = eng.run(3, eval_every=3)
        assert np.isfinite(res.test_acc[-1])
    with pytest.raises(RuntimeError, match="closed"):
        eng.run(1)
    with pytest.raises(ValueError, match="state_dtype"):
        AsyncPopulationEngine(4, state_dtype="float16", device="cpu", **SMALL)
