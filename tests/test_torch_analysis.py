"""The port's correctness analysis plane against the JAX package's.

The static checkers are the reference's AST passes pointed at the port:
on the JAX package's seeded-defect fixtures (``tests/analysis_fixtures/``,
read as data) the port's C1, C2, C3 and C5 find exactly the reference's
finding keys. C4 follows torch's tracing and capture entry points
(``torch.compile``, ``torch.jit.script`` / ``trace``, ``torch.cuda.graph``
/ ``make_graphed_callables``) and flags the seeded defects of
``tests/torch_analysis_fixtures/``, and only C4 fires there. The port's
tree stays clean against ``analysis_baseline_torch.json``, whose every
suppression carries a reason; ``scripts/torch_analyze.py`` keeps the exit
code contract. The runtime lock sentinel records, clears and reports lock
orders as the reference's does.
"""

from __future__ import annotations

import json
import subprocess
import sys
import threading
from pathlib import Path

import pytest

from p2pfl_tpu.analysis import run_checkers as ref_run_checkers
from p2pfl_tpu_torch.analysis import ALL_CHECKERS, SENTINEL, Baseline, LockOrderSentinel, compare, run_checkers
from p2pfl_tpu_torch.analysis.baseline import Suppression

REPO = Path(__file__).resolve().parent.parent
TESTS = Path(__file__).resolve().parent
BASELINE = REPO / "analysis_baseline_torch.json"


@pytest.fixture(scope="module")
def fixture_findings():
    return run_checkers(TESTS, ("analysis_fixtures",))


@pytest.fixture(scope="module")
def torch_fixture_findings():
    return run_checkers(TESTS, ("torch_analysis_fixtures",))


def _keys(findings, checker):
    return sorted(f.key for f in findings if f.checker == checker)


# --- the seeded defects ---------------------------------------------------------------------


@pytest.mark.parametrize("checker", ["C1", "C2", "C3", "C5"])
def test_checker_finds_the_references_keys_on_its_fixtures(checker, fixture_findings):
    want = _keys(ref_run_checkers(TESTS, ("analysis_fixtures",), [checker]), checker)
    got = _keys(fixture_findings, checker)
    assert got == want and got, (got, want)
    assert [f.line for f in fixture_findings if f.checker == checker] == \
        [f.line for f in ref_run_checkers(TESTS, ("analysis_fixtures",), [checker])]


def test_c4_flags_the_seeded_defects_under_torchs_trace_and_capture(torch_fixture_findings):
    keys = _keys(torch_fixture_findings, "C4")
    assert any("noisy_step" in k and "inc" in k for k in keys), keys  # @torch.compile
    assert any("noisy_step" in k and "np.random" in k for k in keys), keys
    assert any("_scaled_loss_impl" in k and "time.time" in k for k in keys), keys  # torch.compile(F)
    assert any("_captured_step" in k and "print" in k for k in keys), keys  # under torch.cuda.graph
    hows = {f.message.split("(traced via ", 1)[1].split(")", 1)[0] for f in torch_fixture_findings}
    assert hows == {"decorator", "passed to torch.compile", "captured under torch.cuda.graph"}, hows


def test_only_the_intended_checker_fires_on_each_fixture(fixture_findings, torch_fixture_findings):
    assert {f.checker for f in torch_fixture_findings} == {"C4"}
    by = {"C1": "lock_inversion.py", "C2": "blocking_send.py", "C3": "unguarded_write.py"}
    for checker, path in by.items():
        hits = [f for f in fixture_findings if f.checker == checker]
        assert hits and all(f.path.endswith(path) for f in hits), (checker, hits)
    # jax.jit is not one of the port's entry points: the JAX fixture's
    # defects are no C4 finding for the port's pass
    assert not [f for f in fixture_findings if f.checker == "C4"]


def test_c4_recognises_each_torch_entry_point(tmp_path):
    src = tmp_path / "pkg"
    src.mkdir()
    (src / "mod.py").write_text(
        "import time\nimport functools\nimport torch\n\n"
        "@torch.jit.script\ndef a(x):\n    time.sleep(0)\n    return x\n\n"
        "@functools.partial(torch.compile, mode='max-autotune')\ndef b(x):\n    print(x)\n    return x\n\n"
        "def c(x):\n    time.time()\n    return x\n\n"
        "traced = torch.jit.trace(c, (torch.zeros(1),))\n\n"
        "def d(x):\n    print(x)\n    return x\n\n"
        "graphed = torch.cuda.make_graphed_callables(d, (torch.zeros(1),))\n\n"
        "@torch.compile(fullgraph=True)\ndef e(x):\n    time.time()\n    return x\n\n"
        "def pure(x):\n    return x * 2\n\nfast = torch.compile(pure)\n"
    )
    findings = run_checkers(tmp_path, ("pkg",), ["C4"])
    flagged = {f.key.split("::", 1)[1].split(":", 1)[0] for f in findings}
    assert flagged == {"a", "b", "c", "d", "e"}, [f.render() for f in findings]


# --- the port's tree and its baseline ---------------------------------------------------------


def test_port_tree_clean_against_its_baseline():
    findings = run_checkers(REPO, ("p2pfl_tpu_torch",))
    new, suppressed, stale = compare(findings, Baseline.load(BASELINE))
    assert not new, "new findings:\n" + "\n".join(f.render() for f in new)
    assert not stale, f"stale suppressions: {[s.key for s in stale]}"
    assert [f.key for f in suppressed] == ["C5:env:p2pfl_tpu_torch/entry.py:P2PFL_TPU_DRYRUN_BUDGET"]


def test_baseline_small_and_reasoned():
    doc = json.loads(BASELINE.read_text())
    sups = doc["suppressions"]
    assert len(sups) <= 10, "baseline growing — fix findings, don't suppress"
    assert all(len(s.get("reason", "").strip()) > 20 for s in sups)
    assert all("__graft_entry__.py:95" in s["reason"] for s in sups if s["key"].startswith("C5:env:"))


def test_baseline_rejects_reasonless_entries(tmp_path):
    p = tmp_path / "b.json"
    p.write_text(json.dumps({"version": 1, "suppressions": [{"checker": "C1", "key": "x", "reason": " "}]}))
    with pytest.raises(ValueError, match="reason"):
        Baseline.load(p)
    p.write_text(json.dumps({"version": 2, "suppressions": []}))
    with pytest.raises(ValueError, match="version"):
        Baseline.load(p)


def test_compare_partitions_new_suppressed_stale(fixture_findings):
    some = fixture_findings[0]
    baseline = Baseline([Suppression(some.checker, some.key, "seeded fixture"),
                         Suppression("C1", "C1:cycle:never-matches", "stale on purpose")])
    new, suppressed, stale = compare(fixture_findings, baseline)
    assert [f.key for f in suppressed] == [some.key]
    assert len(new) == len(fixture_findings) - 1
    assert [s.key for s in stale] == ["C1:cycle:never-matches"]


def test_finding_keys_are_line_number_free(fixture_findings, torch_fixture_findings):
    for f in list(fixture_findings) + list(torch_fixture_findings):
        for part in f.key.split(":"):
            assert not part.isdigit(), f.key


def _analyze(*args):
    return subprocess.run([sys.executable, str(REPO / "scripts" / "torch_analyze.py"), *args],
                          capture_output=True, text=True, timeout=120)


def test_cli_exit_codes(tmp_path):
    r = _analyze("--baseline", str(BASELINE))  # 0: the port's tree against its baseline
    assert r.returncode == 0, r.stdout + r.stderr
    r = _analyze("--root", str(TESTS), "--subdirs", "torch_analysis_fixtures")  # 1: a new finding
    assert r.returncode == 1 and "[C4]" in r.stdout, r.stdout + r.stderr
    stale = tmp_path / "stale.json"
    stale.write_text(json.dumps({"version": 1, "suppressions": [
        *json.loads(BASELINE.read_text())["suppressions"],
        {"checker": "C1", "key": "C1:cycle:ghost", "reason": "stale on purpose"}]}))
    r = _analyze("--baseline", str(stale))  # 2: a stale suppression
    assert r.returncode == 2, r.stdout + r.stderr
    r = _analyze("--checks", "C9")  # 3: usage
    assert r.returncode == 3
    assert sorted(ALL_CHECKERS) == ["C1", "C2", "C3", "C4", "C5"]


def test_learner_first_segment_gauge_is_emitted():
    """``p2pfl_learner_first_segment_seconds`` (the port's stand-in for the
    JAX package's ``p2pfl_learner_jit_compile_seconds``: the first training
    segment's wall time, where torch's lazy initialisation lands) is set by
    a node's first fit, once."""
    from p2pfl_tpu_torch.learning.dataset import RandomIIDPartitionStrategy, synthetic_mnist
    from p2pfl_tpu_torch.learning.learner import TorchLearner
    from p2pfl_tpu_torch.models.mlp import mlp_model
    from p2pfl_tpu_torch.telemetry import REGISTRY

    part = synthetic_mnist(n_train=64, n_test=16).generate_partitions(1, RandomIIDPartitionStrategy)[0]
    learner = TorchLearner(mlp_model(seed=0, hidden_sizes=(8,), device="cpu"), part, "gauge-node", batch_size=32,
                           device="cpu")
    learner.fit()
    gauge = REGISTRY.get("p2pfl_learner_first_segment_seconds")
    first = {lbl.get("node"): c.value for lbl, c in gauge.samples()}["gauge-node"]
    assert first > 0.0
    learner.fit()
    assert {lbl.get("node"): c.value for lbl, c in gauge.samples()}["gauge-node"] == first


# --- the runtime sentinel ---------------------------------------------------------------------


def test_sentinel_records_and_clears_edges():
    s = LockOrderSentinel()
    with s.patched():
        a = threading.Lock()
        b = threading.Lock()
        with a:
            with b:
                pass
    ((held, acq),) = s.edges()
    assert "test_torch_analysis.py" in held and "test_torch_analysis.py" in acq
    assert s.find_cycle() is None
    s.assert_acyclic()
    s.reset()
    assert s.edges() == {} and s.stats()["edges"] == 0


def test_sentinel_detects_deliberate_inversion():
    s = LockOrderSentinel()
    with s.patched():
        a = threading.Lock()
        b = threading.Lock()
        with a:
            with b:
                pass
        with b:
            with a:
                pass
    assert s.find_cycle() is not None
    with pytest.raises(AssertionError, match="cycle"):
        s.assert_acyclic()


def test_sentinel_cross_thread_inversion_detected():
    s = LockOrderSentinel()
    with s.patched():
        a = threading.Lock()
        b = threading.Lock()

        def t1():
            with a:
                with b:
                    pass

        def t2():
            with b:
                with a:
                    pass

        for fn in (t1, t2):
            th = threading.Thread(target=fn)
            th.start()
            th.join()
    assert s.find_cycle() is not None


def test_sentinel_rlock_reentry_is_not_an_edge():
    s = LockOrderSentinel()
    with s.patched():
        r = threading.RLock()
        with r:
            with r:
                pass
    assert s.edges() == {}
    s.assert_acyclic()


def test_condition_and_event_survive_instrumentation():
    s = LockOrderSentinel()
    with s.patched():
        cond = threading.Condition()
        ev = threading.Event()
        box = []

        def producer():
            with cond:
                box.append(1)
                cond.notify_all()
            ev.set()

        th = threading.Thread(target=producer)
        with cond:
            th.start()
            assert cond.wait_for(lambda: box, timeout=5.0)
        assert ev.wait(5.0)
        th.join()
    assert s.stats()["locks"] >= 1
    s.assert_acyclic()


def test_process_sentinel_is_a_lock_order_sentinel():
    assert isinstance(SENTINEL, LockOrderSentinel)
    stats = SENTINEL.stats()
    assert set(stats) >= {"locks", "edges"}
