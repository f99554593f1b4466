"""The port's wire ``Node`` (``p2pfl_tpu_torch/node.py`` and its stages) on
the CPU: the in-memory cases of the JAX package's ``test_node_e2e.py`` and
the two Node cases of ``test_chaos.py`` run against port Nodes (MLPs, every
node on ``device="cpu"``), then the Node's settings against the JAX
package's (the write-ahead journal's cases are in
``test_torch_checkpoint.py``). The privacy plane's Node cases are in
``test_torch_privacy_nodes.py``. The e2e cases the JAX package marks
``slow`` keep the mark: several nodes' heartbeats at 0.25 s beside the
other test workers flap under load (a peer starved for seconds is
declared dead mid-round).

The port's settings, registry, chaos plane and run context get
``test_torch_comm.port_transport``'s fast timings and clean slate (the JAX
package's ``set_test_settings``). Every wait polls against a deadline.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from p2pfl_tpu_torch.comm.memory.memory_protocol import InMemoryCommunicationProtocol
from p2pfl_tpu_torch.config import Settings
from p2pfl_tpu_torch.learning.dataset import RandomIIDPartitionStrategy, synthetic_mnist
from p2pfl_tpu_torch.management.logger import logger
from p2pfl_tpu_torch.models.mlp import mlp_model
from p2pfl_tpu_torch.node import Node
from p2pfl_tpu_torch.utils.utils import check_equal_models, wait_convergence

from test_torch_comm import RAW_VALUES, ROOT, SETTINGS_PROBE, _wait, port_transport  # noqa: F401

PROTOCOLS = {"memory": InMemoryCommunicationProtocol}


@pytest.fixture(autouse=True)
def one_intra_op_thread():
    """Node tests run several fits at once on the executor's threads. On the
    CPU each gets one intra-op thread: with torch's default, every
    concurrent op brings a team of one thread per core, and a federation's
    fits beside the other test workers oversubscribe the machine (fits
    then outlast the executor's timeout)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)



def _spawn(n, batch_size=32, protocol=None, **node_kw):
    data = synthetic_mnist(n_train=256 * n, n_test=128)
    parts = data.generate_partitions(n, RandomIIDPartitionStrategy)
    kw = dict(batch_size=batch_size, device="cpu", **node_kw)
    if protocol is not None:
        kw["protocol"] = PROTOCOLS[protocol]
    nodes = [Node(mlp_model(seed=i, device="cpu"), parts[i], **kw) for i in range(n)]
    for node in nodes:
        node.start()
    return nodes


def _wait_finished(nodes, timeout=240.0):
    assert _wait(lambda: all(not n.learning_in_progress() and n.learning_workflow is not None for n in nodes),
                 timeout=timeout), "learning did not finish"


def _expected_history(rounds, trained_flags):
    hist = ["StartLearningStage"]
    for r in range(rounds):
        hist += ["VoteTrainSetStage", "TrainStage" if trained_flags[r] else "WaitAggregatedModelsStage",
                 "GossipModelStage", "RoundFinishedStage"]
    return hist


def _accuracy(node):
    acc = node.learner.evaluate().get("test_acc")
    assert acc is not None and acc > 0.5, acc


# --- test_node_e2e.py's in-memory cases ----------------------------------------------


@pytest.mark.parametrize("n_nodes,rounds", [(2, 2)])
def test_e2e_convergence_small(n_nodes, rounds):
    Settings.RESOURCE_MONITOR_PERIOD = 0
    nodes = _spawn(n_nodes)
    try:
        nodes[1].connect(nodes[0].addr)
        wait_convergence(nodes, n_nodes - 1, wait=5)
        nodes[0].set_start_learning(rounds=rounds, epochs=1)
        _wait_finished(nodes)
        for node in nodes:
            hist = node.learning_workflow.history
            trained = [h == "TrainStage" for h in hist if h in ("TrainStage", "WaitAggregatedModelsStage")]
            assert hist == _expected_history(rounds, trained)
        check_equal_models(nodes)
        # Each node's final test accuracy, from the port's logger.
        addrs = {n.addr for n in nodes}
        final_accs = {}
        for exp in logger.get_global_logs().values():
            for node_addr, node_metrics in exp.items():
                if node_addr not in addrs:
                    continue
                for name, vals in node_metrics.items():
                    if name == "test_acc" and vals:
                        rnd, acc = sorted(vals)[-1]
                        prev = final_accs.get(node_addr)
                        if prev is None or rnd >= prev[0]:
                            final_accs[node_addr] = (rnd, acc)
        assert set(final_accs) == addrs, final_accs
        for addr, (_, acc) in final_accs.items():
            assert acc > 0.5, f"node {addr} final test_acc {acc} <= 0.5"
    finally:
        for node in nodes:
            node.stop()


@pytest.mark.slow  # as the JAX package's
def test_e2e_line_topology_with_non_trainers():
    Settings.RESOURCE_MONITOR_PERIOD = 0
    n_nodes, rounds = 4, 2
    with Settings.overridden(TRAIN_SET_SIZE=2):
        nodes = _spawn(n_nodes)
        try:
            for i in range(1, n_nodes):
                nodes[i].connect(nodes[i - 1].addr)
            wait_convergence(nodes, n_nodes - 1, wait=8)
            nodes[0].set_start_learning(rounds=rounds, epochs=1)
            _wait_finished(nodes)
            assert sum("WaitAggregatedModelsStage" in n.learning_workflow.history for n in nodes) >= 1
            check_equal_models(nodes)
        finally:
            for node in nodes:
                node.stop()


@pytest.mark.slow  # as the JAX package's
def test_e2e_six_node_line_three_rounds():
    Settings.RESOURCE_MONITOR_PERIOD = 0
    n_nodes, rounds = 6, 3
    with Settings.overridden(TRAIN_SET_SIZE=4):
        nodes = _spawn(n_nodes)
        try:
            for i in range(1, n_nodes):
                nodes[i].connect(nodes[i - 1].addr)
            wait_convergence(nodes, n_nodes - 1, wait=10)
            nodes[0].set_start_learning(rounds=rounds, epochs=1)
            _wait_finished(nodes, timeout=240)
            assert sum("WaitAggregatedModelsStage" in n.learning_workflow.history for n in nodes) >= 1
            for n in nodes:
                hist = n.learning_workflow.history
                trained = [h == "TrainStage" for h in hist if h in ("TrainStage", "WaitAggregatedModelsStage")]
                assert hist == _expected_history(rounds, trained)
            check_equal_models(nodes)
        finally:
            for node in nodes:
                node.stop()


@pytest.mark.slow  # as the JAX package's
def test_stop_learning_mid_run():
    Settings.RESOURCE_MONITOR_PERIOD = 0
    nodes = _spawn(2)
    try:
        nodes[1].connect(nodes[0].addr)
        wait_convergence(nodes, 1, wait=5)
        nodes[0].set_start_learning(rounds=50, epochs=1)
        assert _wait(lambda: nodes[0].state.round is not None and nodes[0].state.round >= 1, timeout=30)
        nodes[0].set_stop_learning()
        assert _wait(lambda: all(not n.learning_in_progress() for n in nodes), timeout=30)
    finally:
        for node in nodes:
            node.stop()


@pytest.mark.parametrize("protocol", ["memory"])
@pytest.mark.slow  # as the JAX package's
def test_e2e_with_int8_wire_compression(protocol):
    Settings.RESOURCE_MONITOR_PERIOD = 0
    with Settings.overridden(WIRE_COMPRESSION="int8"):
        nodes = _spawn(2, protocol=protocol)
        try:
            nodes[1].connect(nodes[0].addr)
            wait_convergence(nodes, 1, wait=5)
            nodes[0].set_start_learning(rounds=2, epochs=1)
            _wait_finished(nodes)
            check_equal_models(nodes)
            for node in nodes:
                _accuracy(node)
        finally:
            for node in nodes:
                node.stop()


@pytest.mark.parametrize("protocol", ["memory"])
@pytest.mark.slow  # as the JAX package's
def test_node_down_during_learning(protocol):
    """An unannounced crash mid-experiment: survivors notice it by the
    heartbeat sweep and finish with equal models."""
    Settings.RESOURCE_MONITOR_PERIOD = 0
    nodes = _spawn(3, protocol=protocol)
    try:
        nodes[1].connect(nodes[0].addr)
        nodes[2].connect(nodes[0].addr)
        wait_convergence(nodes, 2, wait=5)
        nodes[0].set_start_learning(rounds=3, epochs=1)
        assert _wait(lambda: nodes[0].state.round is not None, timeout=10)
        crashed = nodes[2].protocol
        crashed._running = False
        crashed.heartbeater.stop()
        crashed.gossiper.stop()
        crashed._server_stop()
        survivors = nodes[:2]
        _wait_finished(survivors, timeout=150)
        for n in survivors:
            assert nodes[2].addr not in n.protocol.get_neighbors(only_direct=False)
        check_equal_models(survivors)
        for n in survivors:
            _accuracy(n)
    finally:
        for node in nodes:
            node.stop()


@pytest.mark.slow  # as the JAX package's
def test_e2e_scaffold_with_wire_compression():
    """SCAFFOLD under bf16 frames: the control-variate deltas ride the frame
    metadata uncompressed."""
    from p2pfl_tpu_torch.learning.aggregators import Scaffold

    Settings.RESOURCE_MONITOR_PERIOD = 0
    with Settings.overridden(WIRE_COMPRESSION="bf16"):
        parts = synthetic_mnist(n_train=512, n_test=128).generate_partitions(2, RandomIIDPartitionStrategy)
        nodes = [Node(mlp_model(seed=i, device="cpu"), parts[i], aggregator=Scaffold(), batch_size=32, device="cpu")
                 for i in range(2)]
        for node in nodes:
            node.start()
        try:
            nodes[1].connect(nodes[0].addr)
            wait_convergence(nodes, 1, wait=5)
            nodes[0].set_start_learning(rounds=2, epochs=2)
            _wait_finished(nodes)
            check_equal_models(nodes)
            for node in nodes:
                _accuracy(node)
        finally:
            for node in nodes:
                node.stop()


@pytest.mark.slow  # as the JAX package's
def test_e2e_krum_excludes_poisoned_node():
    """One of four nodes trains on flipped labels; Krum's aggregate leaves it
    out of the contributors and still learns."""
    from p2pfl_tpu_torch.learning.aggregators import Krum
    from p2pfl_tpu_torch.learning.dataset import flip_labels

    Settings.RESOURCE_MONITOR_PERIOD = 0
    parts = synthetic_mnist(n_train=1024, n_test=128).generate_partitions(4, RandomIIDPartitionStrategy)
    parts[3] = flip_labels(parts[3], num_classes=10)
    nodes = [Node(mlp_model(seed=i, device="cpu"), parts[i], aggregator=Krum(num_byzantine=1, num_selected=2),
                  batch_size=32, device="cpu") for i in range(4)]
    for node in nodes:
        node.start()
    try:
        for i in range(1, 4):
            nodes[i].connect(nodes[0].addr)
        wait_convergence(nodes, 3, wait=8)
        nodes[0].set_start_learning(rounds=2, epochs=1)
        _wait_finished(nodes)
        check_equal_models(nodes)
        contributors = nodes[0].learner.get_model().contributors
        assert contributors, "aggregated model lost provenance"
        assert nodes[3].addr not in contributors, contributors
        assert nodes[0].learner.evaluate()["test_acc"] > 0.5
    finally:
        for node in nodes:
            node.stop()


# --- test_chaos.py's Node cases -------------------------------------------------------


def test_heartbeat_death_during_round_unblocks_survivors():
    """A full-committee member crashing after learning starts: the survivors
    finish the round well under the fixed timeouts."""
    Settings.RESOURCE_MONITOR_PERIOD = 0
    n = 3
    with Settings.overridden(TRAIN_SET_SIZE=3):
        parts = synthetic_mnist(n_train=128 * n, n_test=64).generate_partitions(n, RandomIIDPartitionStrategy)
        nodes = [Node(mlp_model(seed=i, device="cpu"), parts[i], batch_size=32, device="cpu") for i in range(n)]
        for nd in nodes:
            nd.start()
        try:
            for i in range(1, n):
                nodes[i].connect(nodes[0].addr)
            wait_convergence(nodes, n - 1, wait=8)
            t0 = time.monotonic()
            nodes[0].set_start_learning(rounds=1, epochs=1)
            assert _wait(lambda: nodes[0].state.round == 0, timeout=10.0)
            victim = nodes[2]
            victim.crash()
            survivors = nodes[:2]
            assert _wait(lambda: all(not nd.learning_in_progress() and nd.learning_workflow is not None
                                     for nd in survivors),
                         timeout=Settings.VOTE_TIMEOUT + Settings.AGGREGATION_TIMEOUT), "survivors did not finish"
            assert time.monotonic() - t0 < Settings.AGGREGATION_TIMEOUT
            for nd in survivors:
                assert nd.learning_workflow.history.count("RoundFinishedStage") == 1
                assert victim.addr not in nd.get_neighbors()
        finally:
            for nd in nodes:
                nd.stop()


def test_dense_full_model_resyncs_round_anchor():
    """A restarted node adopting a dense full model for round r resyncs its
    delta anchor to r + 1, so the next round's sparse frames decode."""
    from p2pfl_tpu_torch.comm.commands.impl import FullModelCommand
    from p2pfl_tpu_torch.comm.delta import DeltaWireCodec
    from p2pfl_tpu_torch.exceptions import DeltaAnchorError

    with Settings.overridden(WIRE_COMPRESSION="topk", EXECUTOR_MAX_WORKERS=0):
        parts = synthetic_mnist(n_train=128, n_test=32).generate_partitions(1, RandomIIDPartitionStrategy)
        node = Node(mlp_model(seed=0, device="cpu"), parts[0], batch_size=32, device="cpu")
        node.state.set_experiment("rejoin-test", 5)
        node.state.experiment.round = 2
        assert node.state.wire.anchor_round == -1
        sender_model = mlp_model(seed=1, device="cpu")
        sender_model.contributors = ["s"]
        sender_codec = DeltaWireCodec("sender", device="cpu")
        FullModelCommand(node).execute("sender", 2, weights=sender_model.encode_parameters())
        assert node.state.last_full_model_round == 2
        assert node.state.wire.anchor_round == 3
        sender_codec.set_anchor(sender_model.get_parameters(), 3)
        perturbed = sender_model.build_copy(params=[p + 0.01 for p in sender_model.get_parameters()],
                                            contributors=["s"], num_samples=1)
        sparse = sender_codec.encode_model(perturbed, 3)
        assert sparse is not None
        arrays, _ = node.state.wire.decode_frame(sparse)
        assert len(arrays) == len(sender_model.get_parameters())
        sender_codec.set_anchor(sender_model.get_parameters(), 7)
        with pytest.raises(DeltaAnchorError):
            node.state.wire.decode_frame(sender_codec.encode_model(perturbed, 7))


# --- the Node's settings against the JAX package's ---------------------------------------

NODE_FIELDS = (
    "WAIT_HEARTBEATS_CONVERGENCE", "VOTE_TIMEOUT", "ADMISSION_ENABLED", "ADMISSION_NORM_MULT",
    "ADMISSION_NORM_WINDOW", "MAX_CLAIMED_SAMPLES", "OVERLAP_TRAIN_DIFFUSE", "OVERLAP_DRAIN_JOIN_S",
    "ASYNC_BUFFER_K", "ASYNC_ANCHOR_HISTORY", "ASYNC_SUSPECT_GATE", "ASYNC_STRAGGLER_GATE", "PRIVACY_SECAGG",
    "RECOVERY_QUORUM_FRACTION", "RECOVERY_PARK_POLL_S", "RECOVERY_PARK_MAX_S", "RECOVERY_JOURNAL_KEEP",
    "RECOVERY_JOURNAL_EVERY", "RECOVERY_RECONCILE_MIN_LEAD",
    "RECOVERY_RECONCILE_COOLDOWN_S", "EXECUTOR_MAX_WORKERS", "LOG_LEVEL", "LOG_DIR", "RESOURCE_MONITOR_PERIOD",
    "POP_COHORT_ENABLED", "POP_COHORT_FRACTION", "POP_COHORT_MIN", "POP_COHORT_SEED", "POP_CHURN_RATE",
)


def test_node_settings_match_reference_defaults_and_bounds():
    """Each setting the Node added has the reference's default, parses the
    same environment values to the same value, and rejects the same ones."""
    cases = [[name, raw] for name in NODE_FIELDS for raw in RAW_VALUES]
    env = {k: v for k, v in os.environ.items() if not k.startswith("P2PFL_TPU_")}
    outs = {}
    for module in ("p2pfl_tpu_torch.config", "p2pfl_tpu.config"):
        proc = subprocess.run([sys.executable, "-c", SETTINGS_PROBE, module, json.dumps(cases)], cwd=ROOT, env=env,
                              capture_output=True, text=True, timeout=240)
        assert proc.returncode == 0, proc.stderr[-2000:]
        outs[module] = json.loads(proc.stdout.strip().splitlines()[-1])
    assert outs["p2pfl_tpu_torch.config"] == outs["p2pfl_tpu.config"]
    by_case = dict(zip(map(tuple, cases), outs["p2pfl_tpu_torch.config"]))
    assert by_case[("ADMISSION_NORM_WINDOW", "1")][0] == "ValueError"  # the bounds are checked at all
    assert all(by_case[(name, None)][0] == "ok" for name in NODE_FIELDS)


def test_executor_fits_run_on_the_learners_device():
    """The default executor wraps the learner; its fit trains the node's
    model on the node's device (here the CPU) and the handle stays there."""
    from p2pfl_tpu_torch.parallel.executor import VirtualNodeLearner

    parts = synthetic_mnist(n_train=64, n_test=32).generate_partitions(1, RandomIIDPartitionStrategy)
    with Settings.overridden(EXECUTOR_MAX_WORKERS=2):
        node = Node(mlp_model(seed=0, device="cpu"), parts[0], batch_size=32, device="cpu")
    assert isinstance(node.learner, VirtualNodeLearner)
    before = [p.clone() for p in node.learner.get_model().get_parameters()]
    node.learner.fit()
    after = node.learner.get_model().get_parameters()
    assert all(p.device.type == "cpu" for p in after)
    assert any(not torch.equal(a, b) for a, b in zip(before, after))
    assert node.state.wire.device == torch.device("cpu")
    assert np.isfinite(node.learner.evaluate()["test_loss"])
