"""Parity of the port's wire federation on the CPU: port ``run_wire`` (real
port Nodes over the in-memory transport) against port ``run_fused`` (hashes
bit-equal every round, ``scripts/parity_diff.py`` exit 0), with and without
a straggler; port ``run_wire`` against the JAX package's ``run_wire`` on the
same f32 scenario (equal canonical events, final parameters within 1e-5);
and a mixed federation, two port Nodes and two JAX-package Nodes in one
in-memory registry, training two MLP rounds together.

The port's settings, registry, chaos plane and run context get
``test_torch_comm.port_transport``'s fast timings and clean slate.
"""

import subprocess
import sys

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


def _trajectory(events):
    """The trajectory events (committees, folds, commits, closes) without
    their sequence numbers and hashes; membership and fault events follow
    the hosts' timing and are no part of a run's trajectory."""
    return [{k: v for k, v in e.items() if k not in ("seq", "hash")} for e in events
            if e["kind"] in TRAJECTORY_KINDS]


@pytest.mark.parametrize("straggler", [{}, {1: 0.4}], ids=["clean", "straggler"])
def test_port_run_wire_and_run_fused_bit_equal_and_parity_diff_passes(straggler, tmp_path):
    scn = ParityScenario(straggler=straggler, **SCENARIO)
    wire = run_wire(scn, ledger_dir=str(tmp_path), device="cpu")
    LEDGERS.reset()
    fused = run_fused(scn, ledger_dir=str(tmp_path), device="cpu")
    assert sorted(fused["hashes"]) == list(range(scn.rounds))
    for name in scn.node_names:
        assert wire["hashes"][name] == fused["hashes"], name
    for a, b in zip(wire["params"][scn.node_names[0]], fused["params"]):
        np.testing.assert_array_equal(a, b)
    for name in scn.node_names:
        out = subprocess.run([sys.executable, "scripts/parity_diff.py", wire["ledgers"][name], fused["ledger"]],
                             cwd=ROOT, capture_output=True, text=True, timeout=60)
        assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-2000:]


def test_port_run_wire_matches_jax_run_wire(monkeypatch):
    """The same f32 scenario, with a signflip node, on port Nodes and on
    JAX-package Nodes: every node's trajectory events (committees, folds
    with their senders and sample counts, commits with their contributors)
    equal but for the hashes (f32 sums in another order), and the final
    parameters within 1e-5. One batch a node (the two packages draw their
    shuffles from different generators)."""
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
    for name in names:
        assert _trajectory(got["events"][name]) == _trajectory(ref["events"][name]), name
        assert _trajectory(got["events"][name])
        assert len(got["params"][name]) == len(final[name])
        for a, b in zip(got["params"][name], final[name]):
            np.testing.assert_allclose(a, b, atol=1e-5, rtol=0)


def test_mixed_federation_of_port_and_jax_nodes_trains_two_rounds(monkeypatch):
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
                {nd.addr: nd.get_neighbors() for nd in nodes}
            nodes[0].set_start_learning(rounds=2, epochs=1)
            assert _wait(lambda: all(not nd.learning_in_progress() and nd.learning_workflow is not None
                                     for nd in nodes), timeout=120.0), \
                {nd.addr: nd.state.current_stage for nd in nodes}
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
            assert all(s == seen[0] for s in seen), seen
        finally:
            for nd in nodes:
                nd.stop()
            RefRegistry.reset()
