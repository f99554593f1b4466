"""The port's nodes-mode learner executor (``p2pfl_tpu_torch/parallel/
executor.py``) and topologies (``utils/topologies.py``) on the CPU: the
cases of the JAX package's ``test_executor.py`` (capacity bound, crash
isolation, delegation, device placement, a 20-node federation sharing one
pool) and ``test_topologies.py`` (every type's matrix equal to the
reference's for every n), and the kernels' launch counter under concurrent
fits. The 20-node federation keeps the JAX package's ``slow`` mark; the
other executor cases, slow there as a file, run here in a few seconds.

The port's settings, registry, chaos plane and run context get
``test_torch_comm.port_transport``'s fast timings and clean slate.
"""

import sys
import threading
import time

import numpy as np
import pytest
import torch

from p2pfl_tpu.utils.topologies import TopologyFactory as RefTopologyFactory
from p2pfl_tpu.utils.topologies import TopologyType as RefTopologyType
from p2pfl_tpu_torch.config import Settings
from p2pfl_tpu_torch.learning.dataset import RandomIIDPartitionStrategy, synthetic_mnist
from p2pfl_tpu_torch.learning.learner import Learner, TorchLearner
from p2pfl_tpu_torch.models.mlp import mlp_model
from p2pfl_tpu_torch.ops import _kernels
from p2pfl_tpu_torch.parallel.executor import LearnerExecutor, VirtualNodeLearner
from p2pfl_tpu_torch.utils.topologies import TopologyFactory, TopologyType

from test_torch_comm import port_transport  # noqa: F401
from test_torch_node import one_intra_op_thread  # noqa: F401


class SlowLearner(Learner):
    """Test double: fit sleeps; records concurrency."""

    active = 0
    peak = 0
    _class_lock = threading.Lock()

    def __init__(self, delay=0.3, fail=False):
        super().__init__()
        self.delay = delay
        self.fail = fail
        self.fits = 0

    def fit(self):
        with SlowLearner._class_lock:
            SlowLearner.active += 1
            SlowLearner.peak = max(SlowLearner.peak, SlowLearner.active)
        try:
            if self.fail:
                raise RuntimeError("boom")
            time.sleep(self.delay)
            self.fits += 1
            return None
        finally:
            with SlowLearner._class_lock:
                SlowLearner.active -= 1

    def interrupt_fit(self):
        pass

    def evaluate(self):
        return {"test_acc": 1.0}

    def get_framework(self):
        return "test"


# --- test_executor.py's cases ----------------------------------------------------------


def test_capacity_bound_and_queueing():
    SlowLearner.active = SlowLearner.peak = 0
    ex = LearnerExecutor(max_workers=2)
    try:
        learners = [SlowLearner(delay=0.2) for _ in range(6)]
        for i, ln in enumerate(learners):
            ex.submit("fit", f"n{i}", ln)
        for i in range(6):
            ex.get_result(f"n{i}", timeout=10)
        assert SlowLearner.peak <= 2
        assert all(ln.fits == 1 for ln in learners)
        assert ex.stats()["jobs_done"] == 6
    finally:
        ex.shutdown()


def test_crash_isolation():
    ex = LearnerExecutor(max_workers=2)
    try:
        ex.submit("fit", "bad", SlowLearner(fail=True))
        with pytest.raises(RuntimeError, match="boom"):
            ex.get_result("bad", timeout=10)
        ok = SlowLearner(delay=0.05)
        ex.submit("fit", "good", ok)
        ex.get_result("good", timeout=10)
        assert ok.fits == 1
        stats = ex.stats()
        assert stats["jobs_failed"] == 1 and stats["jobs_done"] == 2
    finally:
        ex.shutdown()


def test_virtual_learner_delegates_and_executes():
    data = synthetic_mnist(n_train=256, n_test=64)
    ex = LearnerExecutor(max_workers=2)
    try:
        inner = TorchLearner(mlp_model(seed=0, device="cpu"), data, "v0", batch_size=32, device="cpu")
        virt = VirtualNodeLearner(inner, ex, addr="v0")
        virt.set_epochs(1)
        assert virt.epochs == 1 and inner.epochs == 1
        virt.fit()
        assert virt.get_model() is inner.get_model()
        assert virt.get_model().get_contributors() == ["v0"]
        assert "test_acc" in virt.evaluate()
        assert virt.get_framework() == "torch"
        assert virt.device == torch.device("cpu")  # learner attributes fall through
        virt.interrupt_fit()
    finally:
        ex.shutdown()


def test_device_placement_round_robin():
    """Jobs cycle over the given devices (a CPU device pins nothing)."""
    devices = [torch.device("cpu")] * 2
    ex = LearnerExecutor(max_workers=4, devices=devices)
    try:
        data = synthetic_mnist(n_train=128, n_test=32)
        learners = [TorchLearner(mlp_model(seed=i, device="cpu"), data, f"d{i}", batch_size=32, device="cpu")
                    for i in range(4)]
        for i, ln in enumerate(learners):
            ex.submit("fit", f"d{i}", ln)
        for i in range(4):
            ex.get_result(f"d{i}", timeout=60)
        for ln in learners:
            assert ln.get_model().get_contributors()
    finally:
        ex.shutdown()


@pytest.mark.slow  # as the JAX package's (its whole test_executor.py is)
def test_20_node_federation_bounded_and_crash_tolerant():
    """20 nodes share one capacity-8 executor; the round stays bounded and
    the federation survives a learner raising mid-fit."""
    from p2pfl_tpu_torch.node import Node
    from p2pfl_tpu_torch.utils.utils import wait_convergence, wait_to_finish

    n_nodes = 20
    Settings.RESOURCE_MONITOR_PERIOD = 0
    parts = synthetic_mnist(n_train=64 * n_nodes, n_test=64).generate_partitions(n_nodes, RandomIIDPartitionStrategy)
    ex = LearnerExecutor(max_workers=8)
    crashed = {"done": False}
    crash_lock = threading.Lock()

    class CrashingLearner(TorchLearner):
        """The first fit in the whole federation raises."""

        def fit(self):
            with crash_lock:
                first = not crashed["done"]
                crashed["done"] = True
            if first:
                raise RuntimeError("injected mid-fit crash")
            return super().fit()

    nodes = []
    try:
        with Settings.overridden(TRAIN_SET_SIZE=6):
            for i in range(n_nodes):
                nodes.append(Node(mlp_model(seed=i, device="cpu"), parts[i], learner=CrashingLearner, executor=ex,
                                  batch_size=32, device="cpu"))
            for n in nodes:
                n.start()
            for i in range(1, n_nodes):
                nodes[i].connect(nodes[0].addr)
            wait_convergence(nodes, n_nodes - 1, wait=15)
            t0 = time.monotonic()
            nodes[0].set_start_learning(rounds=1, epochs=1)
            wait_to_finish(nodes, timeout=180)
            elapsed = time.monotonic() - t0
            assert crashed["done"]
            assert elapsed < 120, f"round took {elapsed}s"
            stats = ex.stats()
            assert stats["peak_active"] <= 8
            assert stats["jobs_done"] >= 6
            assert stats["jobs_failed"] == 1
    finally:
        for n in nodes:
            n.stop()
        ex.shutdown()


def test_launch_counter_sums_exactly_under_threads():
    """Eight threads counting one kernel's launches at once, switching every
    microsecond, lose none (the Node's executor runs several nodes' fits on
    threads at once)."""
    _kernels.reset_launches()
    per_thread = 20000
    start = threading.Barrier(8)

    def work():
        start.wait()
        for _ in range(per_thread):
            _kernels.count_launch("flash_fwd")

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert _kernels.LAUNCHES["flash_fwd"] == 8 * per_thread
    assert sum(_kernels.LAUNCHES.values()) == 8 * per_thread
    _kernels.reset_launches()
    assert sum(_kernels.LAUNCHES.values()) == 0


def test_shared_module_applies_each_callers_parameters_under_threads():
    """Handles built from one template share its module; each thread's
    forward runs on its own parameters however the threads interleave
    (``functional_call`` swaps tensors into the module for the call)."""
    template = mlp_model(seed=0, hidden_sizes=(16,), device="cpu")
    handles = [template.build_copy(params=[p * (i + 1) for p in template.get_parameters()]) for i in range(8)]
    x = torch.randn(4, 28, 28, generator=torch.Generator().manual_seed(0))
    want = [h.apply(h.params, x) for h in handles]
    got = [[] for _ in handles]
    start = threading.Barrier(len(handles))

    def work(i):
        start.wait()
        for _ in range(50):
            got[i].append(handles[i].apply(handles[i].params, x))

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(i,)) for i in range(len(handles))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    for i, outs in enumerate(got):
        assert len(outs) == 50 and all(torch.equal(o, want[i]) for o in outs), i


# --- test_topologies.py's cases, held to the reference's matrices ------------------------


def _connected(adj: np.ndarray) -> bool:
    n = adj.shape[0]
    seen, frontier = {0}, [0]
    while frontier:
        i = frontier.pop()
        for j in TopologyFactory.neighbors_of(adj, i):
            if j not in seen:
                seen.add(j)
                frontier.append(j)
    return len(seen) == n


@pytest.mark.parametrize("topology", list(TopologyType))
@pytest.mark.parametrize("n", [1, 2, 5, 9])
def test_matrix_invariants(topology, n):
    """Every topology gives a symmetric, hollow, connected 0/1 matrix, equal
    to the JAX package's for the same type, n and seed."""
    adj = TopologyFactory.generate_matrix(topology, n, seed=3)
    ref = RefTopologyFactory.generate_matrix(RefTopologyType(topology.value), n, seed=3)
    np.testing.assert_array_equal(adj, ref)
    assert adj.dtype == ref.dtype and adj.shape == (n, n)
    assert set(np.unique(adj)) <= {0, 1}
    np.testing.assert_array_equal(adj, adj.T)
    assert np.diagonal(adj).sum() == 0
    if n > 1:
        assert _connected(adj), topology


def test_exact_structures():
    star = TopologyFactory.generate_matrix(TopologyType.STAR, 5)
    assert star[0].sum() == 4 and all(star[i].sum() == 1 for i in range(1, 5))
    line = TopologyFactory.generate_matrix(TopologyType.LINE, 5)
    assert line.sum() == 2 * 4
    assert line[0].sum() == 1 and line[2].sum() == 2
    ring = TopologyFactory.generate_matrix(TopologyType.RING, 5)
    assert (ring.sum(axis=0) == 2).all()
    full = TopologyFactory.generate_matrix(TopologyType.FULL, 5)
    assert (full.sum(axis=0) == 4).all()


def test_grid_degrees():
    adj = TopologyFactory.generate_matrix(TopologyType.GRID, 9)
    assert sorted(adj.sum(axis=0).tolist()) == [2, 2, 2, 2, 3, 3, 3, 3, 4]


def test_erdos_renyi_seeded_and_connected():
    a = TopologyFactory.generate_matrix(TopologyType.ERDOS_RENYI, 12, p=0.2, seed=7)
    b = TopologyFactory.generate_matrix(TopologyType.ERDOS_RENYI, 12, p=0.2, seed=7)
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(a, RefTopologyFactory.generate_matrix(RefTopologyType.ERDOS_RENYI, 12, p=0.2,
                                                                        seed=7))
    c = TopologyFactory.generate_matrix(TopologyType.ERDOS_RENYI, 12, p=0.2, seed=8)
    assert not np.array_equal(a, c)
    assert _connected(TopologyFactory.generate_matrix(TopologyType.ERDOS_RENYI, 12, p=0.0, seed=1))


def test_connect_nodes_wires_real_federation():
    from p2pfl_tpu_torch.node import Node

    parts = synthetic_mnist(n_train=128, n_test=32).generate_partitions(4, RandomIIDPartitionStrategy)
    with Settings.overridden(RESOURCE_MONITOR_PERIOD=0):
        nodes = [Node(mlp_model(seed=i, device="cpu"), parts[i], device="cpu") for i in range(4)]
        for node in nodes:
            node.start()
        try:
            adj = TopologyFactory.generate_matrix(TopologyType.STAR, 4)
            TopologyFactory.connect_nodes(adj, nodes)
            assert set(nodes[0].get_neighbors(only_direct=True)) == {nodes[i].addr for i in (1, 2, 3)}
            for i in (1, 2, 3):
                assert set(nodes[i].get_neighbors(only_direct=True)) == {nodes[0].addr}
        finally:
            for node in nodes:
                node.stop()
