"""The port's campaign universe against the JAX package's, on the CPU.

The sampler, the family builders, the invariant catalogs and the adaptive
adversary's schedule are pure functions of integers: the port's must give
the JAX package's keys, fields and decisions exactly. ``grade_scenario``
is fed the same synthetic wire / fused / parity dicts and the same
scenario-scoped metrics on both packages and must render the same
violations. One scenario (the adaptive family's first, the head of the
committed check prefix) runs end to end on port Nodes and the port's fused
round: verdict ``ok``, wire hashes equal to fused hashes and to the port's
committed fixture (``tests/torch_campaign_fixtures/``), and the attack
ladder of the JAX package's fixture.
"""

from __future__ import annotations

import dataclasses
import json
import os

import pytest

from p2pfl_tpu import campaigns as ref
from p2pfl_tpu.campaigns import invariants as ref_invariants
from p2pfl_tpu.chaos import plane as ref_plane
from p2pfl_tpu.telemetry import REGISTRY as REF_REGISTRY
from p2pfl_tpu_torch import campaigns as port
from p2pfl_tpu_torch.campaigns import invariants as port_invariants
from p2pfl_tpu_torch.chaos import plane as port_plane
from p2pfl_tpu_torch.telemetry import REGISTRY

# The campaign-scoped families live in the modules that instrument them.
import p2pfl_tpu.comm.admission  # noqa: F401,E402
import p2pfl_tpu.learning.aggregators.base  # noqa: F401,E402
import p2pfl_tpu_torch.comm.admission  # noqa: F401,E402
import p2pfl_tpu_torch.learning.aggregators.base  # noqa: F401,E402

from test_torch_comm import ROOT, port_transport  # noqa: F401
from test_torch_node import one_intra_op_thread  # noqa: F401

SEED = 20260806
PORT_FIXTURE = os.path.join(ROOT, "tests", "torch_campaign_fixtures", "campaign_baseline.json")
REF_FIXTURE = os.path.join(ROOT, "tests", "campaign_fixtures", "campaign_baseline.json")
BOTH = ((ref, REF_REGISTRY, ref_plane), (port, REGISTRY, port_plane))


@pytest.fixture(autouse=True)
def scoped_metrics():
    """Every test starts and ends with both packages' campaign-scoped
    series at zero."""
    for pkg, registry, _ in BOTH:
        registry.clear_families(pkg.CAMPAIGN_SCOPED_FAMILIES)
    yield
    for pkg, registry, _ in BOTH:
        registry.clear_families(pkg.CAMPAIGN_SCOPED_FAMILIES)


def _fields(cs):
    return (cs.family, cs.index, cs.key, cs.trace, dataclasses.asdict(cs.scenario))


# --- sampler and catalogs ---------------------------------------------------------------


@pytest.mark.parametrize("seed", [SEED, 1, 4242])
def test_sampler_keys_and_scenarios_equal_jax(seed):
    got, want = port.sample_campaign(seed, 20), ref.sample_campaign(seed, 20)
    assert [cs.key for cs in got] == [cs.key for cs in want]
    assert [_fields(cs) for cs in got] == [_fields(cs) for cs in want]
    assert len({cs.key for cs in got}) == 20
    # prefix stability: the first k of any campaign are the same scenarios
    assert [cs.key for cs in port.sample_campaign(seed, 7)] == [cs.key for cs in got[:7]]
    assert port.campaign_id(seed, 20) == ref.campaign_id(seed, 20)


def test_build_scenario_fields_and_catalogs_equal_jax():
    assert port.AXES == ref.AXES and port.FAMILIES == ref.FAMILIES
    assert port.FAMILY_INVARIANTS == ref.FAMILY_INVARIANTS
    assert port_invariants.ACCURACY_FLOORS == ref_invariants.ACCURACY_FLOORS
    assert port_invariants.AGG_WAIT_BOUNDS == ref_invariants.AGG_WAIT_BOUNDS
    assert port_invariants.AGG_WAIT_BOUND_S == ref_invariants.AGG_WAIT_BOUND_S
    assert port.CAMPAIGN_SCOPED_FAMILIES == ref.CAMPAIGN_SCOPED_FAMILIES
    from p2pfl_tpu.campaigns.engine import BASELINE_HASH_FAMILIES as REF_HASH_FAMILIES
    from p2pfl_tpu_torch.campaigns.engine import BASELINE_HASH_FAMILIES

    assert BASELINE_HASH_FAMILIES == REF_HASH_FAMILIES
    for family in port.FAMILIES:
        for index in range(3):
            assert _fields(port.build_scenario(SEED, family, index)) == \
                _fields(ref.build_scenario(SEED, family, index))
    with pytest.raises(ValueError, match="unknown campaign family"):
        port.build_scenario(SEED, "no_such_family", 0)
    with pytest.raises(ValueError):
        port.sample_campaign(SEED, 0)


# --- the adaptive adversary --------------------------------------------------------------


def test_adaptive_schedule_closed_form_and_live_equal_jax():
    for rounds, patience in ((3, 1), (5, 2), (9, 1), (0, 1)):
        assert port_plane.adaptive_attack_schedule(rounds, patience=patience) == \
            ref_plane.adaptive_attack_schedule(rounds, patience=patience)
    for family_index in range(3):
        a, b = port.build_scenario(SEED, "adaptive", family_index), ref.build_scenario(SEED, "adaptive", family_index)
        assert a.scenario.adaptive_schedule() == b.scenario.adaptive_schedule()
    # Live: both observers, fed the same attributed rejections (one per
    # rejected-stage round), realize the same decisions and switches.
    decisions = []
    for _, registry, plane in BOTH:
        rejected = registry.get("p2pfl_updates_rejected_total")
        adv = plane.AdaptiveAdversary("unit-adv", patience=2)
        for rnd in range(7):
            if adv.attack_for_round(rnd) in plane.ADAPTIVE_REJECTED_STAGES:
                rejected.labels("honest-0", "norm", "unit-adv").inc()
        switches = sum(int(c.value) for lbl, c in registry.get("p2pfl_chaos_faults_total").samples()
                       if lbl.get("node") == "unit-adv" and lbl.get("fault") == "adaptive_switch")
        decisions.append((adv.decisions, switches))
    assert decisions[0] == decisions[1]
    assert [d["attack"] for d in decisions[0][0]] == list(port_plane.adaptive_attack_schedule(7, patience=2))


# --- grading --------------------------------------------------------------------------------


def _synthetic_run(cs, *, diverge_fused=False, drop_fused_round=False, privacy_events=True):
    """Minimal wire / fused / parity dicts shaped like the scenario runners'
    output (the JAX package's test helper)."""
    scn = cs.scenario
    stitched, wire_hashes, fused_hashes = [], {}, {}
    for r in range(scn.rounds):
        stitched.append({"kind": "round_open", "round": r})
        h = f"hash-{cs.family}-{r}"
        stitched.append({"kind": "aggregate_committed", "round": r, "hash": h})
        if scn.privacy and privacy_events:
            stitched.append({"kind": "privacy_masked", "round": r})
        wire_hashes[r] = h
        fused_hashes[r] = (h + "-fused") if diverge_fused else h
    if drop_fused_round:
        fused_hashes.pop(scn.rounds - 1)
    return {"stitched": stitched}, {"hashes": fused_hashes}, {"status": "DIVERGED" if diverge_fused else "OK"}


def _grade_both(family, *, index=0, strip_trace=False, metrics=None, decisions=None, **run_kw):
    """Both packages' renderings of one synthetic run of ``family`` with
    the same scenario-scoped metrics (``metrics(registry, scenario)``)."""
    out = []
    for pkg, registry, _ in BOTH:
        registry.clear_families(pkg.CAMPAIGN_SCOPED_FAMILIES)
        cs = pkg.build_scenario(SEED, family, index)
        if strip_trace:
            cs = type(cs)(family=cs.family, index=cs.index, scenario=cs.scenario, trace=None)
        if metrics is not None:
            metrics(registry, cs.scenario)
        wire, fused, report = _synthetic_run(cs, **run_kw)
        if decisions is not None:
            wire["adaptive"] = {"decisions": decisions(cs.scenario)}
        kw = {"device": "cpu"} if pkg is port else {}
        out.append([v.render() for v in pkg.grade_scenario(cs, wire, fused, report, **kw)])
    assert out[0] == out[1], out
    return out[0]


@pytest.mark.parametrize("family", ["baseline", "chaos_drop", "byzantine", "churn", "tier_skew", "noniid",
                                    "recovery", "host_fault"])
def test_clean_synthetic_runs_grade_clean_on_both_packages(family):
    assert _grade_both(family) == []


def test_parity_and_missing_rounds_render_the_same_violations():
    assert any("parity_exact" in v for v in _grade_both("baseline", diverge_fused=True))
    vs = _grade_both("baseline", drop_fused_round=True)
    assert any("rounds_complete" in v for v in vs) and any("parity_exact" in v for v in vs)
    assert any("trace_deterministic" in v for v in _grade_both("recovery", strip_trace=True))
    assert any("supervisor_recovered" in v for v in _grade_both("host_fault", strip_trace=True))


def test_privacy_family_is_graded_structurally_on_both_packages():
    assert _grade_both("privacy", diverge_fused=True) == []
    assert any("masked_divergence" in v for v in _grade_both("privacy"))
    vs = _grade_both("privacy", diverge_fused=True, privacy_events=False)
    assert len(vs) == 1 and "privacy_engaged" in vs[0]


def test_aggregation_wait_bound_is_per_family_on_both_packages():
    def long_wait(registry, scn):
        registry.get("p2pfl_aggregation_wait_seconds").labels("wait-unit").observe(45.0)

    assert _grade_both("chaos_drop", metrics=long_wait) == []
    vs = _grade_both("baseline", metrics=long_wait)
    assert len(vs) == 1 and "agg_wait_bounded" in vs[0]


def test_adaptive_oracle_and_attribution_render_the_same_violations():
    def oracle_decisions(scn):
        return [{"round": r, "attack": a, "rejections": r} for r, a in enumerate(scn.adaptive_schedule())]

    def honest_telemetry(registry, scn, bystander=False):
        adv = scn.node_names[scn.adaptive_adversary]
        registry.get("p2pfl_updates_rejected_total").labels(scn.node_names[0], "norm", adv).inc(3)
        oracle = scn.adaptive_schedule()
        for _ in range(sum(1 for a, b in zip(oracle, oracle[1:]) if a != b)):
            registry.get("p2pfl_chaos_faults_total").labels(adv, "adaptive_switch").inc()
        if bystander:
            other = next(n for n in scn.node_names[1:] if n != adv)
            registry.get("p2pfl_updates_rejected_total").labels(scn.node_names[0], "norm", other).inc()

    assert _grade_both("adaptive", metrics=honest_telemetry, decisions=oracle_decisions) == []

    def wrong_last(scn):
        d = oracle_decisions(scn)
        d[-1]["attack"] = "signflip"
        return d

    assert any("adaptive_oracle" in v for v in _grade_both("adaptive", metrics=honest_telemetry,
                                                            decisions=wrong_last))
    vs = _grade_both("adaptive", metrics=lambda r, s: honest_telemetry(r, s, bystander=True),
                     decisions=oracle_decisions)
    assert any("rejection_attribution" in v for v in vs)
    # no telemetry at all: no switches, no attribution
    vs = _grade_both("adaptive", decisions=oracle_decisions)
    assert any("adaptive_oracle" in v for v in vs) and any("rejection_attribution" in v for v in vs)


def test_accuracy_floor_evaluates_the_final_params_as_jax():
    """``evaluate_final_params`` runs the template MLP in torch: on the
    fused round's final parameters (the JAX package's template, converted
    to the port's layout) it gives the JAX package's accuracy."""
    import numpy as np
    import torch

    from p2pfl_tpu_torch.models.convert import flax_to_torch

    cs_port, cs_ref = port.build_scenario(SEED, "baseline", 0), ref.build_scenario(SEED, "baseline", 0)
    ref_params = cs_ref.scenario.template_model().params
    torch_params = flax_to_torch(ref_params, device="cpu")
    final = {n: t.detach().cpu().numpy() for n, t in torch_params.items()}
    got = port.evaluate_final_params(cs_port.scenario, final)
    want = ref.evaluate_final_params(cs_ref.scenario, ref_params)
    assert got == pytest.approx(want, abs=1.0 / cs_port.scenario.data()[1].size)
    assert port.evaluate_final_params(cs_port.scenario, {n: torch.as_tensor(v) for n, v in final.items()}) == got
    assert 0.0 <= got <= 1.0 and np.isfinite(got)


# --- scoping and the engine ----------------------------------------------------------------


def test_campaign_scoped_registry_reset_is_selective():
    rejected = REGISTRY.get("p2pfl_updates_rejected_total")
    scenarios_total = REGISTRY.get("p2pfl_campaign_scenarios_total")
    rejected.labels("scope-unit", "norm", "scope-adv").inc(5)
    scenarios_total.labels("scope-family", "ok").inc()
    before = sum(int(c.value) for lbl, c in scenarios_total.samples() if lbl.get("family") == "scope-family")
    REGISTRY.clear_families(port.CAMPAIGN_SCOPED_FAMILIES)
    assert all(int(c.value) == 0 for lbl, c in rejected.samples() if lbl.get("node") == "scope-unit")
    after = sum(int(c.value) for lbl, c in scenarios_total.samples() if lbl.get("family") == "scope-family")
    assert after == before >= 1
    REGISTRY.clear_families(("p2pfl_not_a_family_total",))  # unknown names are tolerated


def test_run_campaign_captures_backend_errors_and_restores_scope(monkeypatch, tmp_path):
    from p2pfl_tpu_torch.population import scenarios as pop_scenarios
    from p2pfl_tpu_torch.telemetry.ledger import LEDGERS

    seen = []

    def boom(scn, **kw):
        seen.append((LEDGERS.campaign, kw.get("device")))
        raise RuntimeError("backend exploded")

    monkeypatch.setattr(pop_scenarios, "run_scenario_wire", boom)
    monkeypatch.setattr(pop_scenarios, "run_scenario_fused", boom)
    rep = port.run_campaign(SEED, 2, differ=object(), device="cpu")
    assert rep["ok"] is False and rep["violations_total"] == 2
    assert [s["verdict"] for s in rep["scenarios"]] == ["error", "error"]
    assert all("backend exploded" in s["error"] and s["bundle"] for s in rep["scenarios"])
    assert rep["families"]["adaptive"]["violations"] == 1
    assert seen == [(port.campaign_id(SEED, 2), "cpu")] * 2  # scoped while running, on the device asked
    assert LEDGERS.campaign == ""  # scope restored after the run


# --- the committed fixture and one scenario end to end ------------------------------------


def _ladder(decisions):
    return [(d["round"], d["attack"]) for d in decisions]


def test_port_fixture_matches_the_sampler_and_the_jax_fixtures_keys_and_ladder():
    with open(PORT_FIXTURE) as f:
        mine = json.load(f)
    with open(REF_FIXTURE) as f:
        theirs = json.load(f)
    assert (mine["campaign_seed"], mine["check_scenarios"]) == (theirs["campaign_seed"], theirs["check_scenarios"])
    assert (mine["campaign_seed"], mine["check_scenarios"]) == (SEED, 4) and mine["device"] == "cpu"
    sampled = port.sample_campaign(mine["campaign_seed"], mine["check_scenarios"])
    for cs, a, b in zip(sampled, mine["scenarios"], theirs["scenarios"]):
        assert cs.key == a["key"] == b["key"]
        assert (a["family"], a["index"], a["run_id"], a["seed"]) == (b["family"], b["index"], b["run_id"], b["seed"])
        assert (a["wire_hashes"] is None) == (b["wire_hashes"] is None)
        if a["wire_hashes"] is not None:
            assert a["wire_hashes"] == a["fused_hashes"]
            assert sorted(a["wire_hashes"]) == sorted(b["wire_hashes"])
        assert (a["adaptive_decisions"] is None) == (b["adaptive_decisions"] is None)
        if a["adaptive_decisions"] is not None:
            assert _ladder(a["adaptive_decisions"]) == _ladder(b["adaptive_decisions"])
            assert [d["attack"] for d in a["adaptive_decisions"]] == list(cs.scenario.adaptive_schedule())


def test_the_adaptive_scenario_runs_end_to_end_on_both_backends():
    """The check prefix's head, on port Nodes and the port's fused round on
    the CPU: verdict ``ok``, every round's wire hash equal to the fused
    hash and to the port's committed fixture, the JAX package's attack
    ladder. The rejection counts beside the ladder count re-shipped
    rejected frames before the adversary's next fit, which follow the
    gossip loop's timing in both packages: they are held to their
    structure (none before the first rejected stage, then growing)."""
    with open(PORT_FIXTURE) as f:
        mine = json.load(f)["scenarios"][0]
    with open(REF_FIXTURE) as f:
        theirs = json.load(f)["scenarios"][0]
    rep = port.run_campaign(SEED, 1, device="cpu")
    (s,) = rep["scenarios"]
    assert rep["ok"] and s["verdict"] == "ok" and s["parity_status"] == "OK", s
    assert s["family"] == "adaptive" and s["key"] == mine["key"] == theirs["key"]
    assert s["wire_hashes"] == s["fused_hashes"] == mine["wire_hashes"]
    got = s["adaptive"]["decisions"]
    assert _ladder(got) == _ladder(theirs["adaptive_decisions"]) == _ladder(mine["adaptive_decisions"])
    counts = [d["rejections"] for d in got]
    assert counts[0] == 0 and all(b > a for a, b in zip(counts, counts[1:])), counts
