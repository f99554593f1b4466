"""The port's run context, evidence bundles and diagnosis against the JAX
package's (tests/test_doctor.py, less the cases that need the ``Node``, the
population engines, the supervisor or the campaigns, which come later).

The run-id plane and the rule catalog are framework-free copies: each case
runs both packages on the same inputs and holds the port to the reference
(the same minted ids, the same findings and confidences, the same incident
document). The devobs trip's bundle is written by both packages'
``MeshSimulation`` on the same NaN-injected MLP run and held member for
member. Every bundle lands under the test's ``tmp_path``.
"""

from __future__ import annotations

import glob
import json
import os
from dataclasses import asdict

import pytest

from p2pfl_tpu.config import Settings as RefSettings
from p2pfl_tpu.telemetry import bundle as ref_bundle
from p2pfl_tpu.telemetry import diagnosis as ref_diagnosis
from p2pfl_tpu.telemetry import flight_recorder as ref_flightrec
from p2pfl_tpu.telemetry.ledger import LEDGERS as REF_LEDGERS
from p2pfl_tpu_torch.config import Settings
from p2pfl_tpu_torch.telemetry import bundle, diagnosis, flight_recorder
from p2pfl_tpu_torch.telemetry.ledger import LEDGERS

PAIRS = {"port": (bundle, diagnosis, Settings, LEDGERS), "ref": (ref_bundle, ref_diagnosis, RefSettings, REF_LEDGERS)}


@pytest.fixture(autouse=True)
def _clean(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)  # flight-recorder dumps default to ./artifacts
    for b, _, _, led in PAIRS.values():
        led.reset()
        b.reset_run()
    flight_recorder.reset_live_recorders()
    ref_flightrec.reset_live_recorders()
    yield
    for b, _, _, led in PAIRS.values():
        led.reset()
        b.reset_run()


def _one_bundle(root):
    dirs = [d for d in glob.glob(os.path.join(root, "bundle_*")) if os.path.isdir(d)]
    assert len(dirs) == 1, dirs
    return dirs[0]


# --- run-id plane -------------------------------------------------------------


def test_mint_and_establish_equal_jax():
    out = {}
    for key, (b, _, settings, led) in PAIRS.items():
        a = b.mint_run_id(seed=42, name="engine")
        assert a == b.mint_run_id(seed=42, name="engine") and len(a) == 17 and a[12] == "-"
        assert b.mint_run_id(seed=43, name="engine") != a and b.mint_run_id() != b.mint_run_id()
        rid = b.establish_run(seed=5, name="engine")
        assert b.establish_run(seed=999, name="other") == rid == b.current_run_id()
        assert led.run_id == rid  # the ledgers join the run
        fresh = b.establish_run(fresh=True)
        b.adopt_run_id("other-federation", force=False)
        kept = b.current_run_id()
        b.adopt_run_id("other-federation", force=True)
        b.reset_run()
        with settings.overridden(RUN_ID="pinned-by-ci"):
            pinned = (b.establish_run(seed=1), b.current_run_id())
        b.reset_run()
        led.reset()
        led.configure("campaign-pinned")
        adopted = b.establish_run(seed=3, name="engine")
        h = b.artifact_header(node="n0", kind="flightrec", schema_version=2)
        out[key] = (a, rid, fresh != rid, kept == fresh, b.current_run_id(), pinned, adopted,
                    {k: v for k, v in h.items() if k != "clock"}, sorted(h["clock"]))
    assert out["port"] == out["ref"]
    assert out["port"][4:7] == ("campaign-pinned", ("pinned-by-ci", "pinned-by-ci"), "campaign-pinned")


def test_engine_establishes_the_run_as_in_jax():
    """Both packages' MeshSimulation join the run at construction with the
    same seeded id (the ``engine`` name keeps same-seed runs on one id)."""
    from test_torch_devobs import sims

    sims()  # the JAX simulation first (it establishes the reference's run)
    assert bundle.current_run_id() == ref_bundle.current_run_id() == bundle.mint_run_id(0, "engine")


# --- bundles --------------------------------------------------------------------


@pytest.mark.parametrize("action", ["park", "abort"])
def test_devobs_trip_bundle_matches_jax(tmp_path, action):
    """A NaN injected at round 1 trips both simulations at the chunk's end:
    each writes one bundle whose manifest names the same members, whose
    context is the trip and whose diagnosis tops on the device tripwire."""
    from test_torch_devobs import sims

    jsim, sim = sims(lr=1e-3)
    rids, members = {}, {}
    for key, s, settings in (("ref", jsim, RefSettings), ("port", sim, Settings)):
        root = str(tmp_path / key)
        with settings.overridden(DOCTOR_BUNDLE_DIR=root, DEVOBS_NAN_INJECT_ROUND=1, DEVOBS_TRIP_ACTION=action):
            if action == "abort":
                with pytest.raises(RuntimeError, match="devobs tripwire: nonfinite at round 1"):
                    s.run(rounds=4, rounds_per_call=2)
            else:
                assert s.run(rounds=4, rounds_per_call=2).tripped["kind"] == "nonfinite"
        out = _one_bundle(root)
        man = bundle.load_manifest(out)
        assert man["trigger"] == "devobs_trip"
        rids[key] = man["run_id"]
        members[key] = sorted((m["name"], m["kind"]) for m in man["members"])
        ctx = json.load(open(os.path.join(out, "context.json")))
        assert ctx["context"] == {"kind": "nonfinite", "round": 1, "chunk": 0, "action": action}
        assert json.load(open(os.path.join(out, "incident.json")))["top"] == "device_tripwire"
    assert members["port"] == members["ref"]
    assert rids["port"] == bundle.current_run_id()


def test_manifest_determinism_and_master_switch(tmp_path):
    comparable = {}
    for key, (b, _, settings, led) in PAIRS.items():
        b.establish_run(run_id="det-run")
        led.emit("n0", "round_open", round=1)
        outs = []
        for sub in ("a", "b"):
            with settings.overridden(DOCTOR_BUNDLE_DIR=str(tmp_path / key / sub)):
                outs.append(b.write_bundle("manual"))
        man_a, man_b = b.load_manifest(outs[0]), b.load_manifest(outs[1])
        assert "written_at" in man_a["excluded"]
        assert b.comparable_manifest(man_a) == b.comparable_manifest(man_b)
        led_members = [m for m in man_a["members"] if m["kind"] == "ledger"]
        assert led_members and all("sha256" in m for m in led_members)
        comparable[key] = b.comparable_manifest(man_a)
        with settings.overridden(DOCTOR_BUNDLE_DIR=str(tmp_path / key / "off"), DOCTOR_BUNDLE_ENABLED=False):
            assert b.write_bundle("manual") is None
        assert not os.path.exists(tmp_path / key / "off")
    assert comparable["port"] == comparable["ref"]


def test_happy_path_writes_no_bundle(tmp_path):
    from test_torch_devobs import sims

    _, sim = sims(lr=1e-3)
    with Settings.overridden(DOCTOR_BUNDLE_DIR=str(tmp_path / "b")):
        assert sim.run(rounds=2, rounds_per_call=2).tripped is None
    assert not glob.glob(str(tmp_path / "b" / "bundle_*")) and not os.path.exists(tmp_path / "artifacts")


# --- diagnosis rules --------------------------------------------------------------


def _evidence(diag, case):
    ev = diag.Evidence(run_id="r7") if case == "incident" else diag.Evidence()
    rej = lambda r, sender, reason: {"kind": "admission_rejected", "round": r, "sender": sender,  # noqa: E731
                                     "reason": reason}
    flap = {"node": "n0", "events": [{"kind": "peer_lost", "peer": "n2"}, {"kind": "peer_recovered", "peer": "n2"}]}
    chaos = lambda fault, v: {"p2pfl_chaos_faults_total": {"samples": [  # noqa: E731
        {"labels": {"fault": fault}, "value": v}]}}
    if case == "codec_storm":
        ev.ledgers["n0"] = [rej(r, f"n{r}", "decode_error") for r in (1, 2, 3)]
    elif case == "byzantine":
        ev.ledgers["n0"] = [rej(r, "adv", "norm_screen") for r in (1, 2, 3)]
        ev.snapshot = {"peers": {"adv": {"scores": {"suspect": 3.0}}}}
    elif case == "under_rejection":
        ev.metrics = chaos("byzantine_zero", 2.0)
    elif case == "under_rejection_answered":
        ev.metrics = chaos("byzantine_zero", 2.0)
        ev.ledgers["n0"] = [rej(r, "adv", "norm_screen") for r in (1, 2)]
    elif case == "false_death":
        ev.flightrecs["n0"] = flap
    elif case == "chaos_flap":
        ev.flightrecs["n0"] = flap
        ev.metrics = chaos("partition", 1.0)
    elif case == "parity":
        ev.parity = {"status": "DIVERGED", "compared_events": 17,
                     "first_divergence": {"round": 3, "kind": "aggregate_committed"}}
    elif case == "oom":
        ev.context = {"trigger": "supervisor_park", "error": {"message": "RESOURCE_EXHAUSTED: out of memory"}}
    elif case == "devobs":
        ev.context = {"trigger": "devobs_trip", "context": {"kind": "nonfinite", "round": 1}}
    elif case == "incident":
        ev.parity = {"status": "DIVERGED", "first_divergence": {"round": 1}}
    return ev


CASES = {"clean": None, "codec_storm": "codec_corruption_storm", "byzantine": "byzantine_active",
         "under_rejection": "adversary_under_rejection", "under_rejection_answered": "byzantine_active",
         "false_death": "heartbeat_false_death", "chaos_flap": None, "parity": "parity_divergence",
         "oom": "oom_degrade_ladder", "devobs": "device_tripwire", "incident": "parity_divergence"}


@pytest.mark.parametrize("case", sorted(CASES))
def test_diagnosis_equals_jax(case):
    got = diagnosis.diagnose(_evidence(diagnosis, case))
    want = ref_diagnosis.diagnose(_evidence(ref_diagnosis, case))
    assert [asdict(f) for f in got] == [asdict(f) for f in want]
    rules = [f.rule for f in got]
    assert (rules[0] if rules else None) == CASES[case] or (case == "chaos_flap" and "heartbeat_false_death"
                                                                not in rules)
    if case == "byzantine":
        assert got[0].confidence > 0.6 and got[0].exonerated
    if case == "under_rejection_answered":
        assert "adversary_under_rejection" not in rules
    if case == "incident":
        doc = diagnosis.incident_doc(got, run_id="r7", source="here")
        ref_doc = ref_diagnosis.incident_doc(want, run_id="r7", source="here")
        assert {k: v for k, v in doc.items() if k != "generated_at"} == {
            k: v for k, v in ref_doc.items() if k != "generated_at"}
        assert diagnosis.render_report(doc) == ref_diagnosis.render_report(ref_doc)
        assert doc["top"] == "parity_divergence" and "run r7" in diagnosis.render_report(doc)


def test_min_confidence_floor_filters():
    for diag, settings in ((diagnosis, Settings), (ref_diagnosis, RefSettings)):
        assert diag.diagnose(_evidence(diag, "false_death"))
        with settings.overridden(DOCTOR_MIN_CONFIDENCE=0.9):
            assert diag.diagnose(_evidence(diag, "false_death")) == []
