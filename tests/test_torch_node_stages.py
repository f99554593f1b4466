"""The port Node's schedulers and recovery plane on the CPU: the Node and
stage cases of the JAX package's ``test_async.py`` (the async commands, the
participation gate, the scheduler registry, a mid-run join over the sparse
wire), ``test_recovery.py`` (reconcile offers, the catch-up exchange,
quorum parking, the partition-heal federations of both schedulers; not its
checkpoint cases, which wait for the journal) and the two e2e cases of
``test_sparse_delta.py``, against port Nodes (MLPs on ``device="cpu"``).
The partition-heal federations and the eight-node top-k acceptance run keep
the JAX package's ``slow`` marks (15-140 s each here).

The port's settings, registry, chaos plane and run context get
``test_torch_comm.port_transport``'s fast timings and clean slate. Every
wait polls against a deadline.
"""

import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from p2pfl_tpu_torch.chaos import CHAOS
from p2pfl_tpu_torch.comm.memory.registry import InMemoryRegistry
from p2pfl_tpu_torch.config import Settings
from p2pfl_tpu_torch.learning.aggregators.async_buffer import AsyncBufferedAggregator
from p2pfl_tpu_torch.learning.dataset import RandomIIDPartitionStrategy, synthetic_mnist
from p2pfl_tpu_torch.models.mlp import mlp_model
from p2pfl_tpu_torch.node import Node
from p2pfl_tpu_torch.telemetry import REGISTRY

from test_torch_comm import ROOT, _wait, port_transport  # noqa: F401
from test_torch_node import one_intra_op_thread  # noqa: F401


def _metric(name: str) -> dict:
    fam = REGISTRY.get(name)
    if fam is None:
        return {}
    return {tuple(labels.values()): child.value for labels, child in fam.samples()}


def _nodes(n, n_train=64, batch=16, **kw):
    parts = synthetic_mnist(n_train=n_train * n, n_test=32).generate_partitions(n, RandomIIDPartitionStrategy)
    return [Node(mlp_model(seed=i, device="cpu"), parts[i], batch_size=batch, device="cpu", **kw) for i in range(n)]


def _async_node():
    node = _nodes(1, n_train=128, batch=32)[0]
    node.state.set_experiment("async-exp", 3)
    node.state.fed_mode = "async"
    node.async_agg = AsyncBufferedAggregator(node.addr)
    return node


def _all_finished(nodes):
    return all(not nd.learning_in_progress() and nd.learning_workflow is not None for nd in nodes)


# --- test_async.py: command handlers and stages -----------------------------------------


def test_async_contribution_ignored_outside_async_session():
    from p2pfl_tpu_torch.comm.commands.impl import AsyncContributionCommand

    with Settings.overridden(EXECUTOR_MAX_WORKERS=0):
        node = _nodes(1, n_train=128, batch=32)[0]
        payload = node.learner.get_model().encode_parameters()
        AsyncContributionCommand(node).execute("peer", 0, weights=payload)
        node.state.set_experiment("sync-exp", 3)
        node.state.fed_mode = "sync"
        AsyncContributionCommand(node).execute("peer", 0, weights=payload)
        assert node.async_agg is None


def test_async_contribution_folds_and_screens():
    from p2pfl_tpu_torch.comm.commands.impl import AsyncContributionCommand

    with Settings.overridden(EXECUTOR_MAX_WORKERS=0):
        node = _async_node()
        node.async_agg.open_window(1)
        payload = node.learner.get_model().encode_parameters()
        AsyncContributionCommand(node).execute("peer", 1, weights=payload, contributors=["peer"], num_samples=17)
        assert node.async_agg.fill() == 1
        assert node.async_agg.seen_contributors.get("peer") == 1
        AsyncContributionCommand(node).execute("peer2", 1, weights=b"garbage")
        assert node.async_agg.fill() == 1


def test_suspect_gate_blocks_contribution():
    from p2pfl_tpu_torch.comm.commands.impl import AsyncContributionCommand
    from p2pfl_tpu_torch.telemetry.digest import HealthDigest

    with Settings.overridden(EXECUTOR_MAX_WORKERS=0, ASYNC_SUSPECT_GATE=1.0):
        node = _async_node()
        node.async_agg.open_window(0)
        node.observatory.ingest(HealthDigest(node="reporter", ts=time.time(), rejected_by_source={"evil": 5.0}))
        assert node.observatory.suspect_score("evil") == 5.0
        payload = node.learner.get_model().encode_parameters()
        AsyncContributionCommand(node).execute("evil", 0, weights=payload, contributors=["evil"], num_samples=1)
        assert node.async_agg.fill() == 0
        dropped = {labels["reason"]: c.value for labels, c in REGISTRY.get("p2pfl_async_dropped_total").samples()
                   if labels.get("node") == node.addr}
        assert dropped.get("suspect", 0) >= 1


def test_async_done_removes_peer_from_fill_target():
    from p2pfl_tpu_torch.comm.commands.impl import AsyncDoneCommand
    from p2pfl_tpu_torch.stages.async_node import select_participants

    with Settings.overridden(EXECUTOR_MAX_WORKERS=0):
        node = _async_node()
        node.protocol.get_neighbors = lambda only_direct=False: ["p1", "p2"]
        assert select_participants(node) == (["p1", "p2"], ["p1", "p2"])
        AsyncDoneCommand(node).execute("p1", 3)
        assert select_participants(node) == (["p2"], ["p2"])
        node.state.set_experiment("async-exp-2", 3)
        assert node.state.async_done_peers == set()


def test_start_learning_command_mode_backcompat():
    from p2pfl_tpu_torch.comm.commands.impl import StartLearningCommand

    calls = []

    class FakeNode:
        def start_learning_thread(self, rounds, epochs, mode="sync"):
            calls.append((rounds, epochs, mode))

    cmd = StartLearningCommand(FakeNode())
    cmd.execute("src", 0, "3", "2")
    cmd.execute("src", 0, "3", "2", "async")
    assert calls == [(3, 2, "sync"), (3, 2, "async")]


def test_scheduler_registry():
    from p2pfl_tpu_torch.stages.async_node import AsyncStartStage
    from p2pfl_tpu_torch.stages.base_node import StartLearningStage
    from p2pfl_tpu_torch.stages.workflow import scheduler_start_stage

    assert scheduler_start_stage("sync") is StartLearningStage
    assert scheduler_start_stage("async") is AsyncStartStage
    with pytest.raises(ValueError):
        scheduler_start_stage("semi-sync")


def _paced(nodes, delay):
    for nd in nodes:
        orig = nd.learner.fit

        def slow_fit(orig=orig):
            time.sleep(delay)
            return orig()

        nd.learner.fit = slow_fit


def test_async_join_bootstraps_and_decodes_sparse_wire():
    """A cold node joins a running async federation over the top-k wire: the
    dense catch-up and anchor resync let it decode peers' sparse frames, and
    the established nodes fold it within 2 windows of the join."""
    n, windows = 2, 4
    with Settings.overridden(WIRE_COMPRESSION="topk", ASYNC_WINDOW_TIMEOUT=8.0, LOG_LEVEL="WARNING"):
        parts = synthetic_mnist(n_train=128 * (n + 1), n_test=32).generate_partitions(n + 1,
                                                                                       RandomIIDPartitionStrategy)
        nodes = [Node(mlp_model(seed=i, device="cpu"), parts[i], batch_size=32, device="cpu") for i in range(n)]
        _paced(nodes, 0.8)
        for nd in nodes:
            nd.start()
        joiner = None
        try:
            nodes[1].connect(nodes[0].addr)
            assert _wait(lambda: len(nodes[0].get_neighbors()) == 1, 10)
            nodes[0].set_start_learning(rounds=windows, epochs=1, mode="async")
            assert _wait(lambda: (nodes[0].state.round or 0) >= 1, 30)
            joiner = Node(mlp_model(seed=9, device="cpu"), parts[n], batch_size=32, device="cpu")
            joiner.start()
            joiner.connect(nodes[0].addr)
            # The joiner knows both members before it asks to join: its first
            # window's contribution goes to every peer whose fill target
            # counts it (a member that never gets it waits out the window
            # timeout and falls a window behind the joiner's sparse frames).
            assert _wait(lambda: set(joiner.get_neighbors()) == {nd.addr for nd in nodes}, 10)
            joiner.request_async_join()
            join_window = nodes[0].state.round or 0
            alln = nodes + [joiner]
            assert _wait(lambda: _all_finished(alln), 90), \
                {nd.addr: (nd.learning_workflow.history if nd.learning_workflow else None) for nd in alln}
            jh = joiner.learning_workflow.history
            assert jh.count("AsyncWindowFinishedStage") >= 1, jh
            assert nodes[0].state.wire.sparse_frames > 0
            for nd in nodes:
                first = nd.async_agg.seen_contributors.get(joiner.addr)
                assert first is not None, nd.async_agg.seen_contributors
                assert first - join_window <= 2, (first, join_window)
        finally:
            for nd in nodes:
                nd.stop()
            if joiner is not None:
                joiner.stop()


# --- test_recovery.py: reconcile and parking ---------------------------------------------


def test_offer_take_reconcile_semantics():
    from p2pfl_tpu_torch.node_state import NodeState

    st = NodeState("me", device="cpu")
    st.set_experiment("e", 10)
    st.experiment.round = 3
    params = [torch.zeros(2)]
    assert not st.offer_reconcile(2, params, [], "p")
    assert not st.offer_reconcile(3, params, [], "p")
    assert st.offer_reconcile(5, params, [], "p")
    assert not st.offer_reconcile(4, params, [], "q")
    assert st.offer_reconcile(6, params, [], "q")
    assert st.reconcile_ahead()
    st.experiment.round = 7
    assert st.take_reconcile() is None
    assert not st.reconcile_ahead()


def test_reconcile_model_staged_and_applied_at_boundary():
    from p2pfl_tpu_torch.comm.commands.impl import ReconcileModelCommand
    from p2pfl_tpu_torch.stages.recovery import apply_pending_reconcile

    node = _nodes(1, executor=False)[0]
    node.start()
    try:
        state = node.state
        state.set_experiment("e", 10)
        state.experiment.round = 1
        state.wire.set_anchor(node.learner.get_model().get_parameters(), 1)
        ahead = node.learner.get_model().build_copy(params=[p + 0.5 for p in node.learner.get_model().get_parameters()])
        blob = ahead.encode_parameters()
        ReconcileModelCommand(node).execute("peer-x", 4, weights=blob, contributors=["peer-x"], num_samples=1)
        assert state.reconcile_ahead() and state.votes_ready_event.is_set()
        assert apply_pending_reconcile(node)
        assert state.round == 4 and state.wire.anchor_round == 4 and state.last_full_model_round == 3
        torch.testing.assert_close(node.learner.get_model().get_parameters()[0], ahead.get_parameters()[0],
                                   rtol=0, atol=1e-6)
        assert _metric("p2pfl_recovery_reconcile_total").get((node.addr, "catchup_rx")) == 1.0
        ReconcileModelCommand(node).execute("peer-x", 3, weights=blob, contributors=["peer-x"], num_samples=1)
        assert not state.reconcile_ahead()
    finally:
        node.stop()


def test_reconcile_ping_triggers_catchup_from_ahead_peer():
    node_b, node_a = _nodes(2, executor=False)
    node_a.start()
    node_b.start()
    try:
        node_b.connect(node_a.addr)
        assert _wait(lambda: node_a.addr in node_b.get_neighbors(), 10)
        node_a.state.set_experiment("e", 10)
        node_a.state.experiment.round = 5
        node_a.state.wire.set_anchor(node_a.learner.get_model().get_parameters(), 5)
        node_b.state.set_experiment("e", 10)
        node_b.state.experiment.round = 1
        assert node_b.send_reconcile_ping(node_a.addr)
        assert _wait(node_b.state.reconcile_ahead, 10)
        assert _metric("p2pfl_recovery_reconcile_total").get((node_a.addr, "catchup_tx"), 0) >= 1
    finally:
        node_a.stop()
        node_b.stop()


def test_park_until_quorum_parks_and_unparks():
    from p2pfl_tpu_torch.stages.recovery import park_until_quorum

    nodes = _nodes(3, executor=False)
    try:
        nodes[0].start()
        nodes[1].start()
        nodes[1].connect(nodes[0].addr)
        assert _wait(lambda: nodes[1].addr in nodes[0].get_neighbors(), 10)
        st = nodes[0].state
        st.set_experiment("park", 3)
        st.session_members = {nodes[0].addr, nodes[1].addr, nodes[2].addr}
        result = [None]
        with Settings.overridden(RECOVERY_QUORUM_FRACTION=0.9, RECOVERY_PARK_MAX_S=30.0):
            t = threading.Thread(target=lambda: result.__setitem__(0, park_until_quorum(nodes[0])))
            t.start()
            assert _wait(lambda: st.parked, 5)
            nodes[2].start()
            nodes[2].connect(nodes[0].addr)
            t.join(timeout=15)
            assert result[0] is True and not st.parked
        assert _metric("p2pfl_recovery_parks_total").get((nodes[0].addr,)) == 1.0
        assert _metric("p2pfl_recovery_parked_seconds_total").get((nodes[0].addr,), 0) > 0
        assert _metric("p2pfl_recovery_parked").get((nodes[0].addr,)) == 0.0
    finally:
        for nd in nodes:
            nd.stop()


def test_park_early_stop_and_cap():
    from p2pfl_tpu_torch.stages.recovery import park_until_quorum

    node = _nodes(1, executor=False)[0]
    node.start()
    try:
        st = node.state
        st.set_experiment("park", 3)
        st.session_members = {node.addr, "mem://ghost-a", "mem://ghost-b"}
        result = [None]
        with Settings.overridden(RECOVERY_QUORUM_FRACTION=1.0, RECOVERY_PARK_MAX_S=0.0):
            t = threading.Thread(target=lambda: result.__setitem__(0, park_until_quorum(node)))
            t.start()
            assert _wait(lambda: st.parked, 5)
            st.experiment = None
            t.join(timeout=10)
            assert result[0] is False
        st.set_experiment("park2", 3)
        st.session_members = {node.addr, "mem://ghost-a", "mem://ghost-b"}
        with Settings.overridden(RECOVERY_QUORUM_FRACTION=1.0, RECOVERY_PARK_MAX_S=0.6):
            assert park_until_quorum(node) is True
            assert not st.parked
        with Settings.overridden(RECOVERY_QUORUM_FRACTION=0.0):
            assert park_until_quorum(node) is True
    finally:
        node.stop()


def test_recovery_settings_validated():
    env = {**os.environ, "P2PFL_TPU_RECOVERY_QUORUM_FRACTION": "1.7"}
    out = subprocess.run([sys.executable, "-c", "import p2pfl_tpu_torch.config"], capture_output=True, text=True,
                         timeout=120, env=env, cwd=ROOT)
    assert out.returncode != 0 and "RECOVERY_QUORUM_FRACTION" in out.stderr


def _split_and_heal(nodes, limit):
    """Partition the four nodes 2 | 2 for about two rounds, then heal."""
    CHAOS.partition([nodes[0].addr, nodes[1].addr], [nodes[2].addr, nodes[3].addr])
    base = nodes[0].state.round or 0
    _wait(lambda: (nodes[0].state.round or limit) >= base + 2 or not nodes[0].learning_in_progress(), 60)
    CHAOS.heal()
    assert _wait(lambda: _all_finished(nodes), 150), {nd.addr: nd.state.current_stage for nd in nodes}


@pytest.mark.slow  # as the JAX package's
def test_partition_heal_reconciles_sync():
    """4-node sync federation split 2 | 2 for about two rounds, then healed:
    every node finishes, heals are detected, the halves exchange progress,
    and all four end on the saturated task."""
    n, rounds = 4, 6
    with Settings.overridden(LOG_LEVEL="WARNING", TRAIN_SET_SIZE=4):
        nodes = _nodes(n, n_train=128, batch=32)
        for nd in nodes:
            nd.start()
        try:
            for i in range(1, n):
                nodes[i].connect(nodes[0].addr)
            assert _wait(lambda: all(len(nd.get_neighbors()) == n - 1 for nd in nodes), 20)
            nodes[0].set_start_learning(rounds=rounds, epochs=1)
            assert _wait(lambda: (nodes[0].state.round or 0) >= 1, 30)
            _split_and_heal(nodes, rounds)
            assert sum(v for (node, *_), v in _metric("p2pfl_recovery_heals_total").items()
                       if node in {nd.addr for nd in nodes}) >= 2
            assert any(role == "ping_tx" for (_, role) in _metric("p2pfl_recovery_reconcile_total"))
            accs = [nd.learner.evaluate().get("test_acc", 0.0) for nd in nodes]
            assert min(accs) == max(accs) == 1.0, accs
        finally:
            for nd in nodes:
                nd.stop()


@pytest.mark.slow  # as the JAX package's
def test_partition_heal_reconciles_async():
    """The same split under the async scheduler: both halves keep closing
    windows, and after the heal every node finishes on the saturated task."""
    n, windows = 4, 5
    with Settings.overridden(LOG_LEVEL="WARNING", ASYNC_WINDOW_TIMEOUT=8.0):
        nodes = _nodes(n, n_train=128, batch=32)
        _paced(nodes, 0.5)
        for nd in nodes:
            nd.start()
        try:
            for i in range(1, n):
                nodes[i].connect(nodes[0].addr)
            assert _wait(lambda: all(len(nd.get_neighbors()) == n - 1 for nd in nodes), 20)
            nodes[0].set_start_learning(rounds=windows, epochs=1, mode="async")
            assert _wait(lambda: (nodes[0].state.round or 0) >= 1, 30)
            _split_and_heal(nodes, windows)
            accs = [nd.learner.evaluate().get("test_acc", 0.0) for nd in nodes]
            assert min(accs) == 1.0, accs
            for nd in nodes:
                assert nd.learning_workflow.history.count("AsyncWindowFinishedStage") >= 1
        finally:
            for nd in nodes:
                nd.stop()


# --- test_sparse_delta.py: the e2e cases --------------------------------------------------


def _run_federation(n_nodes, rounds):
    """(total model-plane TX bytes, mean final accuracy, sparse frames) of an
    in-memory federation under the current settings."""
    parts = synthetic_mnist(n_train=256 * n_nodes, n_test=128).generate_partitions(n_nodes,
                                                                                   RandomIIDPartitionStrategy)
    nodes = [Node(mlp_model(seed=i, device="cpu"), parts[i], batch_size=32, device="cpu") for i in range(n_nodes)]
    for node in nodes:
        node.start()
    try:
        from p2pfl_tpu_torch.utils.utils import wait_convergence

        for i in range(1, n_nodes):
            nodes[i].connect(nodes[0].addr)
        wait_convergence(nodes, n_nodes - 1, wait=15)
        nodes[0].set_start_learning(rounds=rounds, epochs=1)
        assert _wait(lambda: _all_finished(nodes), 360), "federation did not finish"
        tx_bytes = sum(n.protocol.gossiper.total_tx_bytes() for n in nodes)
        accs = [n.learner.evaluate()["test_acc"] for n in nodes]
        return tx_bytes, float(np.mean(accs)), sum(n.state.wire.sparse_frames for n in nodes)
    finally:
        for node in nodes:
            node.stop()
        InMemoryRegistry.reset()


def test_e2e_topk_two_nodes_converges_and_shrinks_wire():
    Settings.RESOURCE_MONITOR_PERIOD = 0
    with Settings.overridden(TRAIN_SET_SIZE=2):
        with Settings.overridden(WIRE_COMPRESSION="none"):
            dense_bytes, _, _ = _run_federation(2, 2)
        with Settings.overridden(WIRE_COMPRESSION="topk", WIRE_TOPK_RATIO=0.1, WIRE_TOPK_VALUES="bf16"):
            sparse_bytes, sparse_acc, sparse_frames = _run_federation(2, 2)
    assert sparse_frames > 0, "sparse delta path never engaged"
    assert sparse_acc > 0.5, sparse_acc
    assert dense_bytes > 2.5 * sparse_bytes, (dense_bytes, sparse_bytes)


@pytest.mark.slow  # as the JAX package's
def test_e2e_topk_eight_nodes_acceptance():
    """8 nodes, full committee, top-k 10 % against dense: at least 8x fewer
    model-plane bytes a round, final accuracy within 1 point."""
    Settings.RESOURCE_MONITOR_PERIOD = 0
    rounds = 3
    with Settings.overridden(TRAIN_SET_SIZE=8):
        with Settings.overridden(WIRE_COMPRESSION="none"):
            dense_bytes, dense_acc, _ = _run_federation(8, rounds)
        with Settings.overridden(WIRE_COMPRESSION="topk", WIRE_TOPK_RATIO=0.1, WIRE_TOPK_VALUES="bf16"):
            sparse_bytes, sparse_acc, sparse_frames = _run_federation(8, rounds)
    assert sparse_frames > 0
    assert dense_bytes / rounds >= 8 * sparse_bytes / rounds, (dense_bytes, sparse_bytes)
    assert sparse_acc >= dense_acc - 0.01, (sparse_acc, dense_acc)
