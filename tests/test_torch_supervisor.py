"""The port's engine supervisor (``p2pfl_tpu_torch/population/supervisor.py``)
over both port engines on the CPU: the JAX package's ``test_supervisor.py``
cases (seeded fault traces, equal to the JAX package's; healing to bit
identity, the degrade ladder, torn-checkpoint tolerance on both engines, the
digest's supervisor fields), both engines healed through the soak gate's
faults with a replay-identical event log, a real chunk of either engine
failing part-way healed to the fault-free hash, and a
``torch.cuda.OutOfMemoryError`` classified ``oom``.
"""

import os

import pytest
import torch

from p2pfl_tpu_torch.chaos.plane import ChaosPlane, HostFaultEvent
from p2pfl_tpu_torch.management.checkpoint import FLCheckpointer
from p2pfl_tpu_torch.population import AsyncPopulationEngine, EngineSupervisor, PopulationEngine
from p2pfl_tpu_torch.telemetry import REGISTRY
from p2pfl_tpu_torch.telemetry.ledger import canonical_params_hash

_SHAPE = dict(cohort_fraction=0.5, cohort_min=2, seed=11, samples_per_node=8, feature_dim=8, hidden=(4,),
              batch_size=4)


def _factory(**kw):
    return PopulationEngine(**{"num_nodes": 6, **_SHAPE, "device": "cpu", **kw})


def _async_factory(**kw):
    return AsyncPopulationEngine(**{"num_nodes": 6, **_SHAPE, "speed_tiers": (1.0, 2.0, 3.0), "device": "cpu", **kw})


def _hash(engine) -> str:
    return canonical_params_hash(engine.global_params() if hasattr(engine, "global_params")
                                 else engine.gather_params(0))


@pytest.fixture(autouse=True)
def in_tmp_dir(tmp_path, monkeypatch):
    """Park bundles and flight-recorder dumps land under ``./artifacts``."""
    monkeypatch.chdir(tmp_path)


# --- seeded fault traces ------------------------------------------------------------


def test_plan_host_faults_seeded_one_slot_per_kind():
    from p2pfl_tpu.chaos.plane import ChaosPlane as JaxChaosPlane

    plane = ChaosPlane()
    trace = plane.plan_host_faults(10, seed=7)
    assert trace == plane.plan_host_faults(10, seed=7)
    assert trace != plane.plan_host_faults(10, seed=8)
    assert len(trace) == 3 and {ev.kind for ev in trace} == {"kill", "oom", "sigterm"}
    whens = [ev.when for ev in trace]
    assert len(set(whens)) == len(whens) and all(1 <= w < 10 for w in whens)
    assert list(trace) == sorted(trace, key=lambda ev: (ev.when, ev.kind))
    ref = JaxChaosPlane().plan_host_faults(10, seed=7)
    assert [(ev.when, ev.kind) for ev in trace] == [(ev.when, ev.kind) for ev in ref]


def test_supervisor_rejects_bad_config():
    with pytest.raises(ValueError, match="degrade"):
        EngineSupervisor(_factory, None, degrade="bogus")
    with pytest.raises(ValueError, match="fault kind"):
        EngineSupervisor(_factory, None, faults=(HostFaultEvent(1, "meteor"),))
    with pytest.raises(ValueError, match="two host faults"):
        EngineSupervisor(_factory, None, faults=(HostFaultEvent(1, "kill"), HostFaultEvent(1, "oom")))


# --- healing to bit identity ----------------------------------------------------------


def test_supervised_run_heals_every_fault_kind_bit_exact(tmp_path):
    """kill / OOM / SIGTERM / slow across one supervised sync run: the final
    hash equals a fault-free control's, every planned kind fires, and the
    snapshot grafts the RESTARTS / DEGRADE columns onto every peer."""
    with _factory() as ctrl:
        ctrl.run(5)
        control_hash = _hash(ctrl)
    faults = (HostFaultEvent(1, "kill"), HostFaultEvent(2, "oom"), HostFaultEvent(3, "sigterm"),
              HostFaultEvent(4, "slow"))
    ck = FLCheckpointer(str(tmp_path / "ck"))
    with EngineSupervisor(_factory, ck, node="sup-test", faults=faults, backoff_s=0.0) as sup:
        report = sup.run(5, chunk=1)
        healed_hash = _hash(sup.engine)
        snap = sup.snapshot(report.results[-1], top_n=4)
    assert not report.parked and report.completed == 5
    assert healed_hash == control_hash
    assert report.faults_executed == faults
    assert report.restarts == {"kill": 1, "oom": 1, "sigterm": 1}
    assert report.retries == 2 and report.degrade_steps == ()
    assert "fault:kill@1" in report.events and "journal:defensive@4" in report.events
    assert all("@" in ev and ":" in ev for ev in report.events)
    assert snap["supervisor"]["restarts"] == 3 and snap["supervisor"]["parked"] is False
    assert all(p["restarts"] == 3 and p["degrade"] == 0 for p in snap["peers"].values())
    fam = REGISTRY.get("p2pfl_supervisor_restarts_total")
    assert {lbl["kind"] for lbl, c in fam.samples() if lbl["node"] == "sup-test" and c.value} == {
        "kill", "oom", "sigterm"}


@pytest.mark.parametrize("which", ["sync", "async"])
def test_soak_faults_heal_and_replay(tmp_path, which):
    """The soak gate's drill at 16 vnodes on each engine: kill, OOM and
    SIGTERM from the seeded trace heal to the fault-free hash, and a second
    supervised run replays the identical event log."""
    shape = dict(num_nodes=16, samples_per_node=8, feature_dim=8, hidden=(8,), batch_size=4, cohort_fraction=0.25,
                 cohort_min=4, seed=20260807)
    if which == "async":
        shape["speed_tiers"] = (1.0, 1.0, 2.0, 5.0)
    cls = PopulationEngine if which == "sync" else AsyncPopulationEngine

    def factory(**kw):
        return cls(**{**shape, "device": "cpu", **kw})

    faults = ChaosPlane().plan_host_faults(5, seed=shape["seed"], kinds=("kill", "oom", "sigterm"))
    with factory() as ctrl:
        ctrl.run(5)
        control = _hash(ctrl)
    logs = []
    for run in ("a", "b"):
        with EngineSupervisor(factory, FLCheckpointer(str(tmp_path / run), max_to_keep=2), node=f"soak-{which}",
                              faults=faults, backoff_s=0.0) as sup:
            report = sup.run(5, chunk=1)
            assert not report.parked and report.completed == 5
            assert {ev.kind for ev in report.faults_executed} == {"kill", "oom", "sigterm"}
            assert report.restarts == {"kill": 1, "oom": 1, "sigterm": 1} and report.retries == 2
            assert _hash(sup.engine) == control
            logs.append(report.events)
    assert logs[0] == logs[1]
    assert [e.split("@")[0] for e in logs[0]].count("journal:cadence") == 5  # one after each chunk that ran


# --- degrade ladder ---------------------------------------------------------------------


class _FailingEngine(PopulationEngine):
    """An engine whose chunk launch always dies — drives the full ladder."""

    def run(self, *a, **kw):  # noqa: D102 - synthetic failure
        raise RuntimeError("synthetic chunk failure")


def _failing_factory(**kw):
    return _FailingEngine(**{"num_nodes": 8, **_SHAPE, "device": "cpu", **kw})


def test_degrade_ladder_deterministic_then_park(tmp_path):
    def run_once(sub):
        with EngineSupervisor(_failing_factory, FLCheckpointer(str(tmp_path / sub)), node=f"sup-degrade-{sub}",
                              max_retries=0, backoff_s=0.0, degrade="cohort") as sup:
            return sup.run(5, chunk=4)

    first = run_once("a")
    assert first.parked and first.park_reason == "runtime" and first.completed == 0
    assert [a for a, _ in first.degrade_steps] == ["chunks", "chunks", "cohort"]  # 4 -> 2 -> 1, K 4 -> 2
    assert first.chunk_final == 1 and first.cohort_final == 2
    assert first.events[-1].startswith("park:runtime@")
    assert first.events == run_once("b").events
    assert os.path.isdir("artifacts")  # the park bundle


def test_degrade_off_parks_after_retry_budget(tmp_path):
    with EngineSupervisor(_failing_factory, FLCheckpointer(str(tmp_path / "ck")), node="sup-off", max_retries=1,
                          backoff_s=0.0, degrade="off") as sup:
        report = sup.run(2, chunk=1)
    assert report.parked and report.degrade_steps == () and report.retries == 1


class _OomEngine(PopulationEngine):
    """A stub engine whose first chunk fails as the card's allocator does
    (``torch.cuda.OutOfMemoryError`` under the ``RuntimeError`` both engines
    raise for a failed chunk); the second fails with an unrelated error."""

    calls = 0

    def run(self, *a, **kw):  # noqa: D102 - synthetic failure
        type(self).calls += 1
        if type(self).calls == 1:
            try:
                raise torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to allocate 2.00 GiB")
            except torch.cuda.OutOfMemoryError as e:
                raise RuntimeError("chunk failed with the population state part-written") from e
        raise ValueError("an unrelated failure")


@pytest.mark.parametrize("which", ["sync", "async"])
def test_a_real_chunk_failing_mid_chunk_heals_bit_exact(tmp_path, monkeypatch, which):
    """A real engine whose second round (window) of a three-round chunk
    raises ``torch.cuda.OutOfMemoryError`` from inside its training step:
    the engine drops the part-written state, the supervisor classifies the
    failure ``oom`` and restores the journal, and the healed run ends on the
    fault-free hash."""
    from p2pfl_tpu_torch.parallel import simulation
    from p2pfl_tpu_torch.population import async_engine

    factory = _factory if which == "sync" else _async_factory
    with factory() as ctrl:
        # The training calls the first round (window) makes: the next call
        # lies inside the second, before the chunk ends.
        if which == "sync":
            first = ctrl.cohort_k
        else:
            fill = ctrl.schedule(3).fill()
            first = int(fill[0])
            assert fill[1:].sum() > 0
        ctrl.run(6)
        control_hash = _hash(ctrl)
    module = simulation if which == "sync" else async_engine
    real_step, calls = module.local_train_step, []

    def step(*a, **kw):
        calls.append(1)
        if len(calls) == first + 1:
            raise torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to allocate 2.00 GiB")
        return real_step(*a, **kw)

    monkeypatch.setattr(module, "local_train_step", step)
    with EngineSupervisor(factory, FLCheckpointer(str(tmp_path / "ck")), node=f"sup-midchunk-{which}",
                          backoff_s=0.0) as sup:
        report = sup.run(6, chunk=3)
        healed_hash = _hash(sup.engine)
    assert len(calls) > first + 1
    assert not report.parked and report.completed == 6
    assert report.restarts == {"oom": 1} and report.retries == 1
    assert [e for e in report.events if e.startswith("retry:")] == ["retry:oom:1@0"]
    assert healed_hash == control_hash


def test_a_cuda_out_of_memory_error_is_classified_oom(tmp_path):
    _OomEngine.calls = 0
    with EngineSupervisor(lambda **kw: _OomEngine(**{"num_nodes": 6, **_SHAPE, "device": "cpu", **kw}),
                          FLCheckpointer(str(tmp_path / "ck")), node="sup-oom", max_retries=2, backoff_s=0.0,
                          degrade="off") as sup:
        report = sup.run(2, chunk=1)
    assert report.restarts == {"oom": 1, "runtime": 1}
    assert report.parked and report.park_reason == "runtime"
    assert [e for e in report.events if e.startswith("retry:")] == ["retry:oom:1@0", "retry:runtime:2@0"]


# --- torn-checkpoint tolerance ------------------------------------------------------------


def _tear_state(ck_dir: str, step: int) -> None:
    """A kill mid-save: the step's meta record and commit marker survive,
    its state file is gone."""
    path = os.path.join(ck_dir, str(step), "state.pt")
    assert os.path.isfile(path)
    os.remove(path)


@pytest.mark.parametrize("which", ["sync", "async"])
def test_engine_load_from_skips_torn_newest_step(tmp_path, which):
    factory = _factory if which == "sync" else _async_factory
    with factory() as ctrl:
        ctrl.run(3)
        control_hash = _hash(ctrl)
    ck = FLCheckpointer(str(tmp_path / "ck"))
    with factory() as victim:
        victim.run(1)
        assert victim.save_to(ck)
        victim.run(1)
        assert victim.save_to(ck)
        ck.wait()
    _tear_state(ck.directory, 2)
    with factory() as healed:
        # meta@2 still reads: the coherent walk falls back wholesale to 1.
        assert healed.load_from(FLCheckpointer(str(tmp_path / "ck"))) == 1
        healed.run(2)
        assert _hash(healed) == control_hash


# --- digest optional fields -----------------------------------------------------------------


def test_digest_supervisor_fields_cross_version_round_trip():
    from p2pfl_tpu_torch.telemetry import digest as digest_mod

    payload = digest_mod.HealthDigest(node="mem://sup", ts=1.0, restarts=3, degrade=1).encode()
    assert '"restarts":3' in payload and '"degrade":1' in payload
    back = digest_mod.decode(payload)
    assert back.restarts == 3 and back.degrade == 1
    zero = digest_mod.decode(digest_mod.HealthDigest(node="mem://z", restarts=0, degrade=0).encode())
    assert zero.restarts == 0 and zero.degrade == 0
    wire = digest_mod.HealthDigest(node="mem://old", ts=1.0).encode()
    assert "restarts" not in wire and "degrade" not in wire
    old = digest_mod.decode(wire)
    assert old.restarts is None and old.degrade is None
