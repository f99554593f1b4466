"""Parity of the port's wire federation on the CPU: port ``run_wire`` (real
port Nodes over the in-memory transport) against port ``run_fused`` (hashes
bit-equal every round, ``scripts/parity_diff.py`` exit 0), with and without
a straggler; port ``run_wire`` against the JAX package's ``run_wire`` on the
same f32 scenario (equal canonical events, final parameters within 1e-5);
and a mixed federation, two port Nodes and two JAX-package Nodes in one
in-memory registry, training two MLP rounds together.

The port's settings, registry, chaos plane and run context get
``test_torch_comm.port_transport``'s fast timings and clean slate. Every
federation test keeps each node's flight recorder and ledger under its
``tmp_path`` and, when it fails, prints each node's stage, round and
neighbors with both packages' heartbeat inter-arrival gauges
(:func:`postmortem`).
"""

import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

from p2pfl_tpu.config import Settings as JaxSettings
from p2pfl_tpu.parity import ParityScenario as JaxScenario
from p2pfl_tpu.parity import run_wire as jax_run_wire
from p2pfl_tpu_torch.comm.memory.registry import InMemoryRegistry
from p2pfl_tpu_torch.config import Settings
from p2pfl_tpu_torch.parity import ParityScenario, run_fused, run_wire
from p2pfl_tpu_torch.telemetry.ledger import LEDGERS, TRAJECTORY_KINDS

from test_torch_comm import ROOT, _wait, port_transport  # noqa: F401
from test_torch_node import one_intra_op_thread  # noqa: F401
from test_torch_parity import _F32Scenario

# The JAX package's tier-1 wire scenario (tests/test_ledger.py::_tiny_scenario):
# two nodes keep a federation's heartbeats steady beside the other test workers.
SCENARIO = dict(seed=77, n_nodes=2, rounds=2, samples_per_node=32, batch_size=16, hidden=(16,))


@pytest.fixture
def postmortem(monkeypatch, tmp_path):
    """A federation's postmortem: every port and JAX-package Node that stops
    dumps its flight recorder into ``tmp_path`` and leaves a snapshot of its
    stage, round and neighbors. Returns ``report(nodes=())``, the text a
    failed assertion prints: those snapshots (``nodes`` are snapshotted live
    first), both packages' heartbeat inter-arrival gauges and missed-beat
    counters, and where the ledgers (dumped too) and recorders lie."""
    from p2pfl_tpu.node import Node as RefNode
    from p2pfl_tpu.telemetry import REGISTRY as REF_REGISTRY
    from p2pfl_tpu.telemetry.ledger import LEDGERS as REF_LEDGERS
    from p2pfl_tpu_torch.node import Node
    from p2pfl_tpu_torch.telemetry import REGISTRY

    seen = {}

    def snapshot(node, when):
        try:
            seen[node.addr] = (f"{when}: stage {node.state.current_stage!r} round {node.state.round} "
                               f"neighbors {sorted(node.get_neighbors())}")
            node.protocol.flight_recorder.dump(when, str(tmp_path))
        except Exception as exc:  # noqa: BLE001 — a postmortem must not raise
            seen[node.addr] = f"{when}: unreadable ({exc!r})"

    for cls in (Node, RefNode):
        def recording_stop(node, _stop=cls.stop):
            if node.addr not in seen:
                snapshot(node, "stop")
            _stop(node)

        monkeypatch.setattr(cls, "stop", recording_stop)

    def report(nodes=()):
        for node in nodes:
            snapshot(node, "failure")
        for hub in (LEDGERS, REF_LEDGERS):
            hub.dump_all(str(tmp_path))
        lines = [f"flight recorders and ledgers under {tmp_path}"]
        lines += [f"{addr}: {snap}" for addr, snap in sorted(seen.items())]
        for pkg, reg in (("port", REGISTRY), ("jax", REF_REGISTRY)):
            for fam_name in ("p2pfl_heartbeat_interarrival_seconds", "p2pfl_heartbeat_missed_total"):
                fam = reg.get(fam_name)
                for lbl, child in (fam.samples() if fam is not None else []):
                    lines.append(f"{pkg} {fam_name} {lbl.get('node')} <- {lbl.get('peer')}: {child.value:.3f}")
        return "\n".join(lines)

    return report


@pytest.fixture
def reference_liveness(monkeypatch):
    """The JAX package's ``run_wire`` at the port's liveness timeout: its
    ``set_test_settings`` sets ``HEARTBEAT_TIMEOUT`` to 1.5 s, and under the
    test workers' load a beat silence past that made a reference Node write
    off its live peer and close round 0 alone (C12 in ROADMAP queue C, C10's
    mechanism in the reference's harness). The port's ``run_wire`` keeps
    30 s, so the reference gets the same 30 s; nothing else of its run
    changes."""
    from p2pfl_tpu.utils import utils as ref_utils

    set_test_settings = ref_utils.set_test_settings

    def at_the_ports_liveness_timeout():
        set_test_settings()
        JaxSettings.HEARTBEAT_TIMEOUT = 30.0

    monkeypatch.setattr(ref_utils, "set_test_settings", at_the_ports_liveness_timeout)


def _trajectory(events):
    """The trajectory events (committees, folds, commits, closes) without
    their sequence numbers and hashes; membership and fault events follow
    the hosts' timing and are no part of a run's trajectory."""
    return [{k: v for k, v in e.items() if k not in ("seq", "hash")} for e in events
            if e["kind"] in TRAJECTORY_KINDS]


@pytest.mark.parametrize("straggler", [{}, {1: 0.4}], ids=["clean", "straggler"])
def test_port_run_wire_and_run_fused_bit_equal_and_parity_diff_passes(straggler, tmp_path, postmortem):
    scn = ParityScenario(straggler=straggler, **SCENARIO)
    wire = run_wire(scn, ledger_dir=str(tmp_path), device="cpu")
    report = postmortem()
    LEDGERS.reset()
    fused = run_fused(scn, ledger_dir=str(tmp_path), device="cpu")
    assert sorted(fused["hashes"]) == list(range(scn.rounds))
    for name in scn.node_names:
        assert wire["hashes"][name] == fused["hashes"], f"{name}\n{report}"
    for a, b in zip(wire["params"][scn.node_names[0]], fused["params"]):
        np.testing.assert_array_equal(a, b)
    for name in scn.node_names:
        out = subprocess.run([sys.executable, "scripts/parity_diff.py", wire["ledgers"][name], fused["ledger"]],
                             cwd=ROOT, capture_output=True, text=True, timeout=60)
        assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-2000:]


def test_port_run_wire_matches_jax_run_wire(monkeypatch, postmortem, reference_liveness):
    """The same f32 scenario, with a signflip node, on port Nodes and on
    JAX-package Nodes: every node's trajectory events (committees, folds
    with their senders and sample counts, commits with their contributors)
    equal but for the hashes (f32 sums in another order), and the final
    parameters within 1e-5. One batch a node (the two packages draw their
    shuffles from different generators). Both packages' Nodes run at the
    port's 30 s liveness timeout (``reference_liveness``)."""
    from p2pfl_tpu import node as jax_node

    final = {}
    stop = jax_node.Node.stop

    def keep_final_params(node):
        final.setdefault(node.addr, [np.asarray(p) for p in node.learner.get_model().get_parameters()])
        stop(node)

    monkeypatch.setattr(jax_node.Node, "stop", keep_final_params)
    kw = {**SCENARIO, "batch_size": SCENARIO["samples_per_node"], "byzantine": {1: "signflip"}}
    with JaxSettings.overridden(COMPUTE_DTYPE="float32"):
        ref = jax_run_wire(JaxScenario(**kw))
    got = run_wire(_F32Scenario(**kw), device="cpu")
    names = ParityScenario(**kw).node_names
    assert set(got["events"]) == set(ref["events"]) == set(names)
    report = postmortem()
    for name in names:
        assert _trajectory(got["events"][name]) == _trajectory(ref["events"][name]), f"{name}\n{report}"
        assert _trajectory(got["events"][name])
        assert len(got["params"][name]) == len(final[name])
        for a, b in zip(got["params"][name], final[name]):
            np.testing.assert_allclose(a, b, atol=1e-5, rtol=0)


def test_a_beat_silence_after_round_0s_vote_keeps_the_reference_run_wire_whole(monkeypatch, reference_liveness):
    """The interleaving behind a once-seen fault of
    ``test_port_run_wire_matches_jax_run_wire``, forced on the JAX package's
    ``run_wire``: right after the first round-0 vote, ``parity-001`` drops
    every beat it receives for 2.2 s, as a loaded host that stalls a beater
    does. At the reference's own 1.5 s ``HEARTBEAT_TIMEOUT`` it wrote
    ``parity-000`` off and both Nodes committed round 0 with
    ``parity-001`` alone (the failure once seen: ``parity-000`` folded its
    own model, then adopted ``['parity-001']``). At the port's 30 s, which
    ``reference_liveness`` gives the reference, nobody is written off and
    every round folds both contributions, as the port's trajectory does."""
    import time

    from p2pfl_tpu.comm.heartbeater import Heartbeater as RefHeartbeater
    from p2pfl_tpu.stages import base_node as ref_stages
    from p2pfl_tpu.telemetry import REGISTRY as REF_REGISTRY

    silence = {"until": 0.0, "armed": True}
    lock = threading.Lock()
    beat, vote = RefHeartbeater.beat, ref_stages.VoteTrainSetStage.execute

    def deaf_beat(self, source, timestamp):
        if self._self_addr == "parity-001" and time.monotonic() < silence["until"]:
            return None
        return beat(self, source, timestamp)

    def silencing_vote(node):
        out = vote(node)
        with lock:
            if silence["armed"] and node.state.round == 0:
                silence["armed"], silence["until"] = False, time.monotonic() + 2.2
        return out

    def write_offs():  # the reference's process-wide counter, read before and after
        fam = REF_REGISTRY.get("p2pfl_heartbeat_missed_total")
        return {(lbl.get("node"), lbl.get("peer")): child.value for lbl, child in (fam.samples() if fam else [])}

    monkeypatch.setattr(RefHeartbeater, "beat", deaf_beat)
    monkeypatch.setattr(ref_stages.VoteTrainSetStage, "execute", staticmethod(silencing_vote))
    kw = {**SCENARIO, "batch_size": SCENARIO["samples_per_node"], "byzantine": {1: "signflip"}}
    before = write_offs()
    with JaxSettings.overridden(COMPUTE_DTYPE="float32"):
        ref = jax_run_wire(JaxScenario(**kw))
    after = write_offs()
    assert not silence["armed"] and silence["until"] > 0.0
    names = ParityScenario(**kw).node_names
    for name in names:
        commits = [(e["round"], e["contributors"], e["num_samples"]) for e in ref["events"][name]
                   if e["kind"] == "aggregate_committed"]
        assert commits == [(r, names, 64) for r in range(kw["rounds"])], f"{name}: {commits}"
    assert after == before, (before, after)


def test_a_round_full_model_checked_before_the_commit_never_lands_on_the_next_rounds_fit(monkeypatch, postmortem):
    """The interleaving behind a once-seen fault of
    ``test_port_run_wire_matches_jax_run_wire``, forced: node 0 still waits
    in round 0's aggregation when node 1's round-0 full model arrives and
    passes ``FullModelCommand``'s round checks; its adoption is held until
    node 0 has committed round 0 and fitted round 1, and the round-1 fit's
    snapshot is held until the adoption has run. The late adoption must not
    replace the fitted model: every fold is one sender's own 32 samples and
    the wire's hashes equal the fused round's (before the repair node 0
    folded the round-0 aggregate, ``parity-000+parity-001`` with 64
    samples, as its round-1 contribution)."""
    from p2pfl_tpu_torch.comm.admission import AdmissionController
    from p2pfl_tpu_torch.comm.commands.impl import FullModelCommand
    from p2pfl_tpu_torch.learning.aggregators import CanonicalFedAvg
    from p2pfl_tpu_torch.parity import ParityLearner

    scn = ParityScenario(**SCENARIO)
    slow = scn.node_names[0]
    entered, fitted, landed = threading.Event(), threading.Event(), threading.Event()
    wait, screen, execute, fit = (CanonicalFedAvg.wait_and_get_aggregation, AdmissionController.screen,
                                  FullModelCommand.execute, ParityLearner.fit)

    def late_wait(self, *a, **kw):
        if self.node_addr == slow and self._round == 0:
            entered.wait(20.0)  # a peer's round-0 full model is past its checks
        return wait(self, *a, **kw)

    def held_screen(self, arrays, local_model, **kw):
        if kw.get("cmd") == "full_model" and self._addr == slow and not fitted.is_set():
            entered.set()
            fitted.wait(20.0)
        return screen(self, arrays, local_model, **kw)

    def noted_execute(self, source, round, *a, **kw):
        try:
            return execute(self, source, round, *a, **kw)
        finally:
            if self._node.addr == slow and round == 0 and fitted.is_set():
                landed.set()

    def held_fit(self):
        out = fit(self)
        if self._self_addr == slow and self._fits == 2:
            fitted.set()
            landed.wait(20.0)
        return out

    monkeypatch.setattr(CanonicalFedAvg, "wait_and_get_aggregation", late_wait)
    monkeypatch.setattr(AdmissionController, "screen", held_screen)
    monkeypatch.setattr(FullModelCommand, "execute", noted_execute)
    monkeypatch.setattr(ParityLearner, "fit", held_fit)
    wire = run_wire(scn, device="cpu")
    report = postmortem()
    assert entered.is_set() and fitted.is_set() and landed.is_set(), (entered, fitted, landed, report)
    LEDGERS.reset()
    fused = run_fused(scn, device="cpu")
    for name in scn.node_names:
        folds = [(e["round"], e["sender"], e["num_samples"]) for e in wire["events"][name]
                 if e["kind"] == "contribution_folded"]
        assert sorted(folds) == [(r, n, 32) for r in range(scn.rounds) for n in scn.node_names], \
            f"{name}: {folds}\n{report}"
        assert wire["hashes"][name] == fused["hashes"], f"{name}\n{report}"


def test_mixed_federation_of_port_and_jax_nodes_trains_two_rounds(monkeypatch, postmortem):
    """Two port Nodes and two JAX-package Nodes, fully connected on one
    in-memory wire (the port's registry pointed at the reference's; explicit
    addresses), f32 MLPs from one seed, FedAvg in its canonical order on
    both packages (raw per-sender models: FedAvg's partial merges can
    overlap under load and count a member twice, in both packages): the port
    node's kickoff runs two rounds on all four, whose final parameters agree
    within 1e-5, and every ledger records the same committee, contributors
    and sample counts each round."""
    from p2pfl_tpu.comm.memory.registry import InMemoryRegistry as RefRegistry
    from p2pfl_tpu.learning.aggregators import CanonicalFedAvg as RefCanonicalFedAvg
    from p2pfl_tpu.learning.dataset import RandomIIDPartitionStrategy as RefIID
    from p2pfl_tpu.learning.dataset import synthetic_mnist as ref_mnist
    from p2pfl_tpu.node import Node as RefNode
    from p2pfl_tpu.telemetry.ledger import LEDGERS as REF_LEDGERS
    from p2pfl_tpu_torch.learning.aggregators import CanonicalFedAvg
    from p2pfl_tpu_torch.learning.dataset import RandomIIDPartitionStrategy, synthetic_mnist
    from p2pfl_tpu_torch.node import Node
    from test_torch_classification import mlp_handles

    monkeypatch.setattr(InMemoryRegistry, "_servers", RefRegistry._servers)
    monkeypatch.setattr(InMemoryRegistry, "_lock", RefRegistry._lock)
    Settings.RESOURCE_MONITOR_PERIOD = JaxSettings.RESOURCE_MONITOR_PERIOD = 0
    Settings.LEDGER_ENABLED = JaxSettings.LEDGER_ENABLED = True
    # As the parity harness's wire runs: the JAX nodes' first fit compiles,
    # so coverage reports stay frozen for seconds; the gossip loop and the
    # aggregation wait outlast it instead of abandoning a member's model.
    Settings.GOSSIP_EXIT_ON_X_EQUAL_ROUNDS = JaxSettings.GOSSIP_EXIT_ON_X_EQUAL_ROUNDS = 400
    Settings.AGGREGATION_STALL_PATIENCE = JaxSettings.AGGREGATION_STALL_PATIENCE = 60.0
    Settings.AGGREGATION_TIMEOUT = JaxSettings.AGGREGATION_TIMEOUT = 120.0
    # No Node dies here, so a write-off can only be false: a loaded host
    # silenced every beater of both packages for 1.7-1.8 s during the JAX
    # Nodes' first compile. Write-offs shrink each Node's committee on its
    # own and a heal does not restore it, so a Node that wrote off everyone
    # closes the round alone while its peers wait for its model; both
    # packages do that (scripts/torch_beat_pause_probe.py). The liveness
    # timeout outlasts such a silence, as parity.run_wire's does.
    Settings.HEARTBEAT_TIMEOUT = JaxSettings.HEARTBEAT_TIMEOUT = 30.0
    LEDGERS.reset()
    REF_LEDGERS.reset()
    kw = dict(n_train=4 * 128, n_test=64)
    ref_parts = ref_mnist(**kw).generate_partitions(4, RefIID)
    parts = synthetic_mnist(**kw).generate_partitions(4, RandomIIDPartitionStrategy)
    addrs = ["mem://mixed-port-0", "mem://mixed-ref-1", "mem://mixed-port-2", "mem://mixed-ref-3"]
    nodes = []
    with JaxSettings.overridden(COMPUTE_DTYPE="float32"):
        for i, addr in enumerate(addrs):
            jh, ph = mlp_handles(0)
            if "port" in addr:
                nodes.append(Node(ph, parts[i], addr=addr, aggregator=CanonicalFedAvg(), batch_size=32, lr=1e-3,
                                  seed=i, device="cpu"))
            else:
                nodes.append(RefNode(jh, ref_parts[i], addr=addr, aggregator=RefCanonicalFedAvg(), batch_size=32,
                                     lr=1e-3, seed=i))
        try:
            for nd in nodes:
                nd.start()
            for nd in nodes[1:]:
                nd.connect(nodes[0].addr)
            assert _wait(lambda: all(len(nd.get_neighbors()) == 3 for nd in nodes), timeout=15.0), \
                postmortem(nodes)
            nodes[0].set_start_learning(rounds=2, epochs=1)
            assert _wait(lambda: all(not nd.learning_in_progress() and nd.learning_workflow is not None
                                     for nd in nodes), timeout=120.0), postmortem(nodes)
            for nd in nodes:
                assert nd.learning_workflow.history.count("RoundFinishedStage") == 2, nd.learning_workflow.history
            leaves = [[np.asarray(p.detach().cpu() if isinstance(p, torch.Tensor) else p)
                       for p in nd.learner.get_model().get_parameters()] for nd in nodes]
            for other in leaves[1:]:
                for a, b in zip(leaves[0], other):
                    np.testing.assert_allclose(a, b, atol=1e-5, rtol=0)

            def trajectory(hub, addr):
                evs = hub.peek(addr).canonical_events()
                return ([(e["round"], tuple(e["members"])) for e in evs if e["kind"] == "round_open"],
                        [(e["round"], tuple(e["contributors"]), e["num_samples"]) for e in evs
                         if e["kind"] == "aggregate_committed"])

            seen = [trajectory(LEDGERS if "port" in a else REF_LEDGERS, a) for a in addrs]
            assert seen[0][0] == [(0, tuple(sorted(addrs))), (1, tuple(sorted(addrs)))]
            assert [r for r, *_ in seen[0][1]] == [0, 1]
            assert all(s == seen[0] for s in seen), f"{seen}\n{postmortem()}"
        finally:
            for nd in nodes:
                nd.stop()
            RefRegistry.reset()


def test_heartbeat_digest_reads_memory_without_a_heap_sweep(monkeypatch):
    """Every beat carries a health digest built on the heartbeat's thread. Its
    memory reading must not walk the garbage collector's objects (the
    live-tensor sweep): under the test workers' load that walk held port
    beats back past ``HEARTBEAT_TIMEOUT`` and live peers were written off
    mid-round, which broke the wire parity runs and stalled the mixed
    federation above."""
    import gc

    from p2pfl_tpu_torch.telemetry import digest

    sweeps = []
    get_objects = gc.get_objects
    monkeypatch.setattr(gc, "get_objects", lambda *a, **kw: sweeps.append(1) or get_objects(*a, **kw))
    dig = digest.collect("mem://beat-probe")
    assert sweeps == [] and dig.mem_bytes > 0
