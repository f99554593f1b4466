"""The port's checkpoint and recovery plane (``p2pfl_tpu_torch/management/
checkpoint.py``, ``MeshSimulation.save_to`` / ``load_from`` /
``run(checkpointer=)``, ``Node.resume``) on the CPU: the cases of the JAX
package's ``test_checkpoint.py`` (but ``test_orbax_not_imported_by_core``,
which guards an import the port does not have) and the two torn-step cases
of its ``test_recovery.py``, against port simulations and Nodes at tier-1
size, then the storage layer's own contract (host copies taken before
``save`` returns, restore placement, dtype and shape checks, a writer error
raised), and two parity checks against the JAX package: a resumed
trajectory, and the journals of one Node state.

The two packages write different formats (orbax there, ``torch.save`` of a
flat dict here); neither reads the other's files, so each side reads its own
back. Node cases take ``test_torch_comm.port_transport``'s fast timings.
"""

import os
import threading

import jax
import numpy as np
import pytest
import torch

from p2pfl_tpu_torch.config import Settings
from p2pfl_tpu_torch.learning.dataset import RandomIIDPartitionStrategy, synthetic_mnist
from p2pfl_tpu_torch.management.checkpoint import (
    FLCheckpointer,
    NodeJournal,
    _jsonable,
    attach_node_checkpointing,
    attach_node_journal,
)
from p2pfl_tpu_torch.models.convert import flax_to_torch
from p2pfl_tpu_torch.models.mlp import mlp_model
from p2pfl_tpu_torch.node import Node
from p2pfl_tpu_torch.optim import AdamState
from p2pfl_tpu_torch.parallel.simulation import MeshSimulation
from p2pfl_tpu_torch.utils.utils import wait_convergence

from test_torch_comm import _wait, port_transport  # noqa: F401
from test_torch_node import one_intra_op_thread  # noqa: F401


@pytest.fixture
def parts8():
    return synthetic_mnist(n_train=8 * 32, n_test=64).generate_partitions(8, RandomIIDPartitionStrategy)


def _model(seed=0):
    return mlp_model(seed=seed, device="cpu")


def _sim(parts, **kw):
    return MeshSimulation(_model(), parts, device="cpu", **kw)


def _trees_equal(a, b):
    assert set(a) == set(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k


# --- the JAX package's test_checkpoint.py ---------------------------------------------------


def test_model_roundtrip(tmp_path):
    model = _model(seed=3)
    model.contributors = ["a", "b"]
    model.num_samples = 17
    model.additional_info = {"tag": "x", "vec": np.arange(3.0)}
    with FLCheckpointer(str(tmp_path / "ck")) as ck:
        assert ck.save_model(0, model)
        ck.wait()
        restored = ck.restore_model(_model(seed=0))
    _trees_equal(restored.params, model.params)
    assert restored.contributors == ["a", "b"]
    assert restored.num_samples == 17
    assert restored.additional_info["tag"] == "x"
    assert restored.additional_info["vec"] == [0.0, 1.0, 2.0]


def test_retention_and_interval(tmp_path):
    model = _model()
    with FLCheckpointer(str(tmp_path / "ck"), max_to_keep=2, save_interval=2) as ck:
        for step in range(5):
            assert ck.save_model(step, model) == (step % 2 == 0)
        ck.wait()
        assert ck.latest_step() == 4
        assert ck.all_steps() == [2, 4]


def test_restore_missing_raises(tmp_path):
    with FLCheckpointer(str(tmp_path / "empty")) as ck:
        with pytest.raises(FileNotFoundError):
            ck.restore_model(_model())


def test_simulation_resume_bit_identical(tmp_path, parts8):
    """4 straight rounds == 2 rounds + checkpoint + restore + 2 rounds."""
    kw = dict(train_set_size=4, batch_size=16, seed=5)
    sim_full = _sim(parts8, **kw)
    res_full = sim_full.run(rounds=4, epochs=1, warmup=False)

    sim_a = _sim(parts8, **kw)
    sim_a.run(rounds=2, epochs=1, warmup=False)
    with FLCheckpointer(str(tmp_path / "sim")) as ck:
        sim_a.save_to(ck)
        ck.wait()
        sim_b = _sim(parts8, **kw)
        assert sim_b.load_from(ck) == 2
    res_b = sim_b.run(rounds=2, epochs=1, warmup=False)

    _trees_equal(sim_full.params_stack, sim_b.params_stack)
    _trees_equal(sim_full.opt_stack.mu, sim_b.opt_stack.mu)
    assert torch.equal(sim_full.opt_stack.count, sim_b.opt_stack.count)
    assert res_full.test_acc[2:] == res_b.test_acc
    np.testing.assert_array_equal(res_full.committees[2:], res_b.committees)
    assert sim_b.completed_rounds == 4


def test_simulation_run_with_checkpointer(tmp_path, parts8):
    sim = _sim(parts8, train_set_size=4, batch_size=16, seed=1)
    with FLCheckpointer(str(tmp_path / "auto")) as ck:
        sim.run(rounds=3, epochs=1, warmup=False, checkpointer=ck)
        ck.wait()
        assert ck.latest_step() == 3
        assert len(ck.all_steps()) >= 1


def test_simulation_final_round_always_saved(tmp_path, parts8):
    """An off-cadence final chunk still lands on disk, and checkpoint_every=0
    is clamped to 1 as in the JAX package."""
    sim = _sim(parts8, train_set_size=4, batch_size=16, seed=1)
    with FLCheckpointer(str(tmp_path / "cad")) as ck:
        sim.run(rounds=3, epochs=1, warmup=False, checkpointer=ck, checkpoint_every=2)
        ck.wait()
        assert ck.all_steps() == [2, 3]  # 2 (cadence) and 3 (final)
    sim2 = _sim(parts8, train_set_size=4, batch_size=16, seed=1)
    with FLCheckpointer(str(tmp_path / "zero")) as ck:
        sim2.run(rounds=2, epochs=1, warmup=False, checkpointer=ck, checkpoint_every=0)
        ck.wait()
        assert ck.latest_step() == 2


def test_simulation_resume_adopts_checkpoint_seed(tmp_path, parts8):
    """The checkpointed seed wins over the constructor's: round draws are
    keyed by (seed, round)."""
    kw = dict(train_set_size=4, batch_size=16)
    sim_full = _sim(parts8, seed=5, **kw)
    sim_full.run(rounds=3, epochs=1, warmup=False)
    sim_a = _sim(parts8, seed=5, **kw)
    sim_a.run(rounds=1, epochs=1, warmup=False)
    with FLCheckpointer(str(tmp_path / "seed")) as ck:
        sim_a.save_to(ck)
        ck.wait()
        sim_b = _sim(parts8, seed=999, **kw)
        sim_b.load_from(ck)
    assert sim_b.seed == 5
    sim_b.run(rounds=2, epochs=1, warmup=False)
    _trees_equal(sim_full.params_stack, sim_b.params_stack)


def test_jsonable_numpy_scalars_and_tensors(tmp_path):
    model = _model()
    model.additional_info = {"acc": np.float32(0.91), "n": np.int64(7), "t": torch.arange(3), "drop": object()}
    with FLCheckpointer(str(tmp_path / "scal")) as ck:
        ck.save_model(0, model)
        ck.wait()
        restored = ck.restore_model(_model())
    assert restored.additional_info["acc"] == pytest.approx(0.91)
    assert restored.additional_info["n"] == 7
    assert restored.additional_info["t"] == [0, 1, 2]
    assert "drop" not in restored.additional_info
    assert _jsonable({"x": np.zeros(2)}) == {"x": [0.0, 0.0]}


def test_node_round_end_checkpointing(tmp_path):
    Settings.RESOURCE_MONITOR_PERIOD = 0
    parts = synthetic_mnist(n_train=256, n_test=64).generate_partitions(2, RandomIIDPartitionStrategy)
    nodes = [Node(_model(seed=i), parts[i], batch_size=16, device="cpu") for i in range(2)]
    with FLCheckpointer(str(tmp_path / "node0"), max_to_keep=5) as ck:
        attach_node_checkpointing(nodes[0], ck)
        for n in nodes:
            n.start()
        try:
            nodes[1].connect(nodes[0].addr)
            wait_convergence(nodes, 1, wait=10)
            nodes[0].set_start_learning(rounds=2, epochs=1)
            assert _wait(lambda: all(not n.learning_in_progress() and n.learning_workflow is not None
                                     for n in nodes), timeout=120)
        finally:
            for n in nodes:
                n.stop()
        ck.wait()
        assert len(ck.all_steps()) >= 2  # one snapshot per finished round
        restored = ck.restore_model(_model())
    _trees_equal(restored.params, nodes[0].learner.get_model().params)


def _journal_node(parts, seed=3, addr=None):
    """A port Node mid-experiment (round 2 of 5) whose wire codec holds a
    top-k anchor and non-zero error-feedback residuals, as the JAX
    package's journal test builds it."""
    node = Node(_model(seed=seed), parts[0], addr=addr, batch_size=16, executor=False, device="cpu")
    node.state.set_experiment("journal", 5)
    node.state.experiment.round = 2
    with Settings.overridden(WIRE_COMPRESSION="topk"):
        model = node.learner.get_model()
        node.state.wire.set_anchor(model.get_parameters(), 2)
        moved = model.build_copy(params=[p + 0.01 for p in model.get_parameters()])
        assert node.state.wire.encode_model(moved, 2) is not None
    return node


def test_node_journal_restores_anchors_and_residuals_bit_exact(tmp_path):
    """A restored node holds the exact params, sparse-delta anchor and
    error-feedback residuals it journaled, and its privacy keys."""
    Settings.RESOURCE_MONITOR_PERIOD = 0
    parts = synthetic_mnist(n_train=128, n_test=32).generate_partitions(2, RandomIIDPartitionStrategy)
    node = _journal_node(parts)
    before = node.state.wire.export_state()
    assert before["anchor"] is not None and before["residual"] is not None
    with NodeJournal(str(tmp_path / "journal")) as journal:
        assert journal.snapshot(node)
        journal.wait()
        assert not journal.snapshot(node)  # same round: already durable
        restored = Node.resume(_model(seed=0), parts[1], journal, batch_size=16, executor=False, device="cpu")
    assert restored.addr == node.addr
    assert restored.recovery_journal is journal
    after = restored.state.wire.export_state()
    assert after["anchor_round"] == 2 and after["anchor_crc"] == before["anchor_crc"]
    for a, b in zip(before["anchor"], after["anchor"]):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(before["residual"], after["residual"]):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(node.learner.get_model().get_parameters(), restored.learner.get_model().get_parameters()):
        assert torch.equal(a, b)
    assert restored.state.privacy.export_state() == node.state.privacy.export_state()
    meta = restored._resume_meta
    assert meta["round"] == 2 and meta["fed_mode"] == "sync" and meta["journal_version"] == 1


def test_journal_now_without_journal_is_a_noop_and_resume_learning_needs_a_snapshot(tmp_path):
    parts = synthetic_mnist(n_train=64, n_test=32).generate_partitions(1, RandomIIDPartitionStrategy)
    node = Node(_model(), parts[0], device="cpu", executor=False)
    node.journal_now()  # no journal attached: a no-op, as in the JAX package
    with pytest.raises(ValueError, match="Node.resume"):
        node.resume_learning()
    with pytest.raises(FileNotFoundError):
        Node.resume(_model(), parts[0], NodeJournal(str(tmp_path / "empty")), device="cpu")


def test_journal_now_logs_a_failed_snapshot_and_carries_on(tmp_path):
    Settings.RESOURCE_MONITOR_PERIOD = 0
    parts = synthetic_mnist(n_train=128, n_test=32).generate_partitions(2, RandomIIDPartitionStrategy)
    node = _journal_node(parts)
    journal = NodeJournal(str(tmp_path / "j"))
    attach_node_journal(node, journal)

    def broken(*_a, **_k):
        raise OSError("disk full")

    journal._ck.save = broken
    node.journal_now()  # logged, not raised, as the JAX package's Node does
    assert journal.all_steps() == []


def test_node_crash_restart_resume_roundtrip(tmp_path, monkeypatch):
    """A 3-node federation loses one journaled node mid-experiment;
    Node.resume rebuilds it as itself (same address), it re-enters the
    stage machine, trains real rounds, and the federation finishes."""
    monkeypatch.chdir(tmp_path)  # the crash dumps the victim's flight recorder under ./artifacts
    Settings.RESOURCE_MONITOR_PERIOD = 0
    n, rounds = 3, 5
    parts = synthetic_mnist(n_train=128 * n, n_test=64).generate_partitions(n, RandomIIDPartitionStrategy)
    nodes = [Node(_model(seed=i), parts[i], batch_size=32, device="cpu") for i in range(n)]
    journals = [NodeJournal(str(tmp_path / f"j{i}")) for i in range(n)]
    with Settings.overridden(LOG_LEVEL="WARNING", TRAIN_SET_SIZE=3):
        for nd, journal in zip(nodes, journals):
            attach_node_journal(nd, journal)
            nd.start()
        try:
            for i in range(1, n):
                nodes[i].connect(nodes[0].addr)
            wait_convergence(nodes, n - 1, wait=15)
            nodes[0].set_start_learning(rounds=rounds, epochs=1)
            victim = nodes[2]
            victim_addr = victim.addr
            # Crash only after the victim's first snapshot is durable.
            assert _wait(lambda: bool(journals[2].all_steps()), timeout=60), "victim never journaled"
            victim.crash()
            journals[2].wait()
            resumed = Node.resume(_model(seed=99), parts[2], journals[2], batch_size=32, device="cpu")
            assert resumed.addr == victim_addr  # identity restored from disk
            resumed.start()
            resumed.resume_learning()
            assert resumed.learning_in_progress()
            nodes[2] = resumed
            assert _wait(lambda: all(not nd.learning_in_progress() and nd.learning_workflow is not None
                                     for nd in nodes), timeout=150), {nd.addr: nd.state.current_stage for nd in nodes}
            history = resumed.learning_workflow.history
            assert history[0] == "ResumeStage"
            assert history.count("TrainStage") >= 1, history
            assert history.count("RoundFinishedStage") >= 1, history
            accs = [nd.learner.evaluate().get("test_acc", 0.0) for nd in nodes]
            assert min(accs) == 1.0, accs
        finally:
            for nd in nodes:
                nd.stop()
            for journal in journals:
                journal.close()


def _dp_sim(parts, sigma):
    return MeshSimulation(_model(), parts, train_set_size=2, batch_size=32, seed=0, dp_clip_norm=1.0,
                          dp_noise_multiplier=sigma, device="cpu")


def test_dp_step_counter_survives_resume(tmp_path):
    parts = synthetic_mnist(n_train=128, n_test=32).generate_partitions(2, RandomIIDPartitionStrategy)
    ckpt = FLCheckpointer(str(tmp_path / "dp-ckpt"))
    sim = _dp_sim(parts, 0.5)
    sim.run(rounds=2, epochs=1, warmup=False, checkpointer=ckpt)
    spent_first = sim.privacy_spent()
    assert spent_first["steps"] == 2 * (64 // 32)
    resumed = _dp_sim(parts, 0.5)
    resumed.load_from(ckpt)
    assert resumed.privacy_spent()["steps"] == spent_first["steps"]
    resumed.run(rounds=2, epochs=1, warmup=False)
    assert resumed.privacy_spent()["steps"] == 2 * spent_first["steps"]
    assert resumed.privacy_spent()["epsilon"] > spent_first["epsilon"]
    ckpt.close()


def test_dp_resume_rejects_changed_noise_parameters(tmp_path):
    parts = synthetic_mnist(n_train=128, n_test=32).generate_partitions(2, RandomIIDPartitionStrategy)
    ckpt = FLCheckpointer(str(tmp_path / "dp-mismatch"))
    sim = _dp_sim(parts, 0.5)
    sim.run(rounds=1, epochs=1, warmup=False, checkpointer=ckpt)
    with pytest.raises(ValueError, match="re-price"):
        _dp_sim(parts, 2.0).load_from(ckpt)
    ok = _dp_sim(parts, 0.5)
    ok.load_from(ckpt)
    assert ok.privacy_spent()["steps"] == sim.privacy_spent()["steps"]
    ckpt.close()


def test_simulation_fedopt_resume_bit_identical(tmp_path, parts8):
    """FedOpt's server moments survive the resume: 4 straight rounds == 2 +
    save / restore + 2."""
    kw = dict(train_set_size=4, batch_size=16, seed=5, server_optimizer="fedadam", server_lr=0.003)
    sim_full = _sim(parts8, **kw)
    res_full = sim_full.run(rounds=4, epochs=1, warmup=False)
    sim_a = _sim(parts8, **kw)
    sim_a.run(rounds=2, epochs=1, warmup=False)
    with FLCheckpointer(str(tmp_path / "fedopt")) as ck:
        sim_a.save_to(ck)
        ck.wait()
        sim_b = _sim(parts8, **kw)
        assert sim_b.load_from(ck) == 2
    res_b = sim_b.run(rounds=2, epochs=1, warmup=False)
    _trees_equal(sim_full.params_stack, sim_b.params_stack)
    full_srv, b_srv = sim_full.c_global["server_opt"], sim_b.c_global["server_opt"]
    _trees_equal(full_srv.mu, b_srv.mu)
    _trees_equal(full_srv.nu, b_srv.nu)
    assert torch.equal(full_srv.count, b_srv.count)
    assert res_full.test_acc[2:] == res_b.test_acc


def test_fedopt_resume_rejects_changed_server_optimizer(tmp_path, parts8):
    """adam and yogi share a state structure, so a mismatched resume would
    restore cleanly and silently diverge: the meta pin rejects it."""
    kw = dict(train_set_size=4, batch_size=16, seed=5)
    sim_a = _sim(parts8, server_optimizer="fedadam", server_lr=0.003, **kw)
    sim_a.run(rounds=1, epochs=1, warmup=False)
    with FLCheckpointer(str(tmp_path / "pin")) as ck:
        sim_a.save_to(ck)
        ck.wait()
        for bad in (dict(server_optimizer="fedyogi", server_lr=0.003),  # rule swap
                    dict(server_optimizer="fedadam", server_lr=0.1),  # lr swap
                    dict()):  # dropped entirely
            with pytest.raises(ValueError, match="server"):
                _sim(parts8, **kw, **bad).load_from(ck)
        assert _sim(parts8, server_optimizer="fedadam", server_lr=0.003, **kw).load_from(ck) == 1


# --- the JAX package's test_recovery.py: torn steps ------------------------------------------


def test_torn_step_directories_are_skipped(tmp_path):
    """A bare step directory (a crash mid-save) is invisible to
    latest_step / all_steps, and restore falls back to the newest good
    snapshot instead of raising."""
    tree = {"w": np.arange(4.0, dtype=np.float32)}
    with FLCheckpointer(str(tmp_path / "ck"), max_to_keep=5) as ck:
        ck.save(1, {"w": tree["w"] * 1}, {"step": 1})
        ck.save(2, {"w": tree["w"] * 2}, {"step": 2})
        ck.wait()
        # Crash artifacts: a bare step dir, and a marker-only dir whose
        # payload never landed.
        os.makedirs(str(tmp_path / "ck" / "9"))
        os.makedirs(str(tmp_path / "ck" / "7"))
        open(str(tmp_path / "ck" / "7" / "_CHECKPOINT_METADATA"), "w").close()
        assert 9 not in ck.all_steps()
        assert ck.latest_step() in (7, 2)  # 7 passes the marker check but must fall through on restore
        state, meta = ck.restore({"w": np.zeros(4, np.float32)})
        assert meta["step"] == 2
        np.testing.assert_array_equal(state["w"], tree["w"] * 2)
        assert ck.restore_meta()["step"] == 2


def test_empty_checkpointer_still_raises(tmp_path):
    with FLCheckpointer(str(tmp_path / "empty")) as ck:
        with pytest.raises(FileNotFoundError):
            ck.restore({"w": np.zeros(2, np.float32)})
        with pytest.raises(FileNotFoundError):
            ck.restore_meta()


# --- the storage layer ---------------------------------------------------------------------


def test_save_takes_its_host_copy_before_returning(tmp_path, monkeypatch):
    """The tensors a save was handed are updated in place right after it
    returns (the population's next round does that); the step holds the
    values at the call, even while the writer is held back."""
    import p2pfl_tpu_torch.management.checkpoint as ckmod

    gate = threading.Event()
    real = ckmod.FLCheckpointer._write_step

    def held(self, *args):
        gate.wait(10)
        real(self, *args)

    monkeypatch.setattr(ckmod.FLCheckpointer, "_write_step", held)
    w = torch.arange(8, dtype=torch.float32)
    with FLCheckpointer(str(tmp_path / "ck")) as ck:
        ck.save(1, {"w": w, "n": np.arange(3)}, {})
        w.mul_(-1)  # the next round's in-place update
        gate.set()
        state, _ = ck.restore({"w": torch.zeros(8), "n": np.zeros(3, np.int64)})
    assert torch.equal(state["w"], torch.arange(8, dtype=torch.float32))
    np.testing.assert_array_equal(state["n"], np.arange(3))


def test_restore_keeps_dtypes_and_places_by_the_template(tmp_path):
    state = {
        "opt": AdamState(mu={"a.weight": torch.randn(2, 3)}, nu={"a.weight": torch.rand(2, 3)},
                         count=torch.tensor([3, 4], dtype=torch.int32)),
        "bf": torch.randn(5).bfloat16(),
        "host": np.arange(6, dtype=np.float32).reshape(2, 3),
        "none": None,
    }
    with FLCheckpointer(str(tmp_path / "ck")) as ck:
        ck.save(0, state, {"k": 1})
        template = {"opt": AdamState(mu={"a.weight": torch.zeros(2, 3)}, nu={"a.weight": torch.zeros(2, 3)},
                                     count=torch.zeros(2, dtype=torch.int32)),
                    "bf": torch.zeros(5, dtype=torch.bfloat16), "host": np.zeros((2, 3), np.float32), "none": None}
        got, meta = ck.restore(template)
        assert meta == {"k": 1}
        assert isinstance(got["opt"], AdamState) and got["opt"].count.dtype == torch.int32
        assert torch.equal(got["opt"].count, state["opt"].count)
        assert torch.equal(got["opt"].mu["a.weight"], state["opt"].mu["a.weight"])
        assert got["bf"].dtype == torch.bfloat16 and torch.equal(got["bf"], state["bf"])
        assert isinstance(got["host"], np.ndarray) and np.array_equal(got["host"], state["host"])
        assert got["none"] is None
        # A shape or dtype that differs from the template's is an unreadable
        # step: restore(step=...) raises, the newest-first walk skips it.
        bad = dict(template, bf=torch.zeros(5, dtype=torch.float32))
        with pytest.raises(ValueError, match="bf"):
            ck.restore(bad, step=0)
        with pytest.raises(FileNotFoundError):
            ck.restore(dict(template, host=np.zeros((3, 2), np.float32)))


def test_restore_coherent_falls_back_wholesale_from_a_torn_state(tmp_path):
    """A step whose meta reads but whose state is gutted falls back to the
    previous step for both (no mixing of cursors and weights)."""
    with FLCheckpointer(str(tmp_path / "ck"), max_to_keep=5) as ck:
        for s in (1, 2):
            ck.save(s, {"w": np.full(2, float(s), np.float32)}, {"completed_rounds": s})
        ck.wait()
        os.remove(str(tmp_path / "ck" / "2" / "state.pt"))
        seen = []
        state, meta = ck.restore_coherent({"w": np.zeros(2, np.float32)}, check_meta=seen.append)
    assert meta["completed_rounds"] == 1 and np.array_equal(state["w"], np.ones(2, np.float32))
    assert [m["completed_rounds"] for m in seen] == [2, 1]


def test_stale_temp_directories_are_swept_and_writer_errors_raise(tmp_path, monkeypatch):
    import p2pfl_tpu_torch.management.checkpoint as ckmod

    root = tmp_path / "ck"
    os.makedirs(str(root / ".tmp-5-deadbeef"))
    ck = FLCheckpointer(str(root))
    assert not (root / ".tmp-5-deadbeef").exists()

    def disk_full(*_a, **_k):
        raise OSError(28, "No space left on device")

    with monkeypatch.context() as m:
        m.setattr(ckmod.torch, "save", disk_full)
        ck.save(1, {"w": np.zeros(2, np.float32)}, {})
        with pytest.raises(RuntimeError, match="checkpoint write"):
            ck.wait()
    assert os.listdir(str(root)) == []  # the failed step's staging is gone
    ck.save(2, {"w": np.zeros(2, np.float32)}, {})
    ck.wait()
    assert ck.all_steps() == [2]


def test_a_save_drains_the_one_in_flight_from_another_thread(tmp_path):
    """The writer does not care which thread asked: a save issued on a
    second thread waits for the first thread's save and both land (a
    restarted node journals from a new workflow thread)."""
    ck = FLCheckpointer(str(tmp_path / "ck"), max_to_keep=5)
    ck.save(1, {"w": np.ones(2, np.float32)}, {"s": 1})
    t = threading.Thread(target=lambda: ck.save(2, {"w": np.full(2, 2.0, np.float32)}, {"s": 2}))
    t.start()
    t.join()
    ck.wait()
    assert ck.all_steps() == [1, 2]
    assert ck.restore_meta(1) == {"s": 1} and ck.restore_meta()["s"] == 2


def test_concurrent_saves_all_land(tmp_path):
    """Saves from more threads than cores, under a short switch interval:
    every step lands whole (no writer handle lost between a drain and the
    next start)."""
    import sys

    ck = FLCheckpointer(str(tmp_path / "ck"), max_to_keep=100)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda s=s: ck.save(s, {"w": np.full(64, float(s), np.float32)}, {"s": s}))
                   for s in range(2 * (os.cpu_count() or 1) + 4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        ck.wait()
    finally:
        sys.setswitchinterval(interval)
    assert ck.all_steps() == list(range(len(threads)))
    for s in ck.all_steps():
        state, meta = ck.restore({"w": np.zeros(64, np.float32)}, step=s)
        assert meta == {"s": s} and np.all(state["w"] == s)


def test_a_reader_draining_during_a_save_joins_a_started_writer(tmp_path, monkeypatch):
    """A reader on another thread (``all_steps``, as a waiting caller polls
    it) drains while ``save`` hands over its writer: the handle it joins has
    been started, never one still unstarted."""
    from types import SimpleNamespace

    from p2pfl_tpu_torch.management import checkpoint as ck_mod

    ck = FLCheckpointer(str(tmp_path / "ck"))
    errors, drained = [], threading.Event()

    def reader():
        try:
            ck.all_steps()
        except Exception as exc:  # noqa: BLE001 - collected for the assertion
            errors.append(exc)
        finally:
            drained.set()

    class ReaderFirst(threading.Thread):
        """Lets the reader drain just before the writer starts, where the
        save allows it."""

        def start(self):
            threading.Thread(target=reader).start()
            drained.wait(0.5)
            super().start()

    monkeypatch.setattr(ck_mod, "threading", SimpleNamespace(Thread=ReaderFirst, Lock=threading.Lock))
    assert ck.save(1, {"w": np.ones(2, np.float32)}, {"s": 1})
    assert drained.wait(10)
    ck.wait()
    assert errors == [] and ck.all_steps() == [1]


# --- parity with the JAX package -------------------------------------------------------------


def test_resumed_trajectory_matches_the_jax_package(tmp_path):
    """Both packages run 2 rounds, save with their own checkpointer, restore
    into a fresh simulation and run 2 more, on one committee schedule from
    the same initial weights (batch = a node's samples): the final params
    agree within 1e-5."""
    from p2pfl_tpu.management.checkpoint import FLCheckpointer as JaxFLCheckpointer
    from p2pfl_tpu.parallel.mesh import make_mesh
    from p2pfl_tpu.parallel.simulation import MeshSimulation as JaxMeshSimulation
    from test_torch_classification import LR, SAMPLES, mlp_handles, mnist_partitions, node_params

    sched = np.array([[0, 2], [1, 2], [3, 0], [1, 3]], np.int32)
    jh, ph = mlp_handles()
    jp, pp = mnist_partitions()
    kw = dict(train_set_size=2, batch_size=SAMPLES, lr=LR, seed=0)
    run = dict(epochs=1, warmup=False)

    def jax_sim():
        return JaxMeshSimulation(jh, jp, mesh=make_mesh(devices=jax.devices()[:1]), **kw)

    ja = jax_sim()
    ja.run(rounds=2, committee_schedule=sched[:2], **run)
    with JaxFLCheckpointer(str(tmp_path / "jax")) as jck:
        ja.save_to(jck)
        jck.wait()
        jb = jax_sim()
        assert jb.load_from(jck) == 2
    jres = jb.run(rounds=2, committee_schedule=sched[2:], **run)

    pa = MeshSimulation(ph, pp, device="cpu", **kw)
    pa.run(rounds=2, committee_schedule=sched[:2], **run)
    with FLCheckpointer(str(tmp_path / "port")) as ck:
        pa.save_to(ck)
        ck.wait()
        pb = MeshSimulation(ph, pp, device="cpu", **kw)
        assert pb.load_from(ck) == 2
    res = pb.run(rounds=2, committee_schedule=sched[2:], **run)

    np.testing.assert_allclose(res.test_loss, jres.test_loss, atol=1e-5)
    got, want = node_params(jb, pb)
    diffs = jax.tree.map(lambda a, b: float(np.max(np.abs(a - b))), got, want)
    assert max(jax.tree.leaves(diffs)) < 1e-5, diffs
    assert pb.completed_rounds == jb.completed_rounds == 4


def test_journal_holds_what_the_jax_package_journals(tmp_path):
    """One Node state (the same weights, anchor, top-k encode and privacy
    key) journaled by both packages: equal meta but for the address, and
    bit-equal params, anchor and residuals, each side reading its own
    files back."""
    from p2pfl_tpu.config import Settings as JaxSettings
    from p2pfl_tpu.learning.dataset import RandomIIDPartitionStrategy as JaxIID
    from p2pfl_tpu.learning.dataset import synthetic_mnist as jax_synthetic_mnist
    from p2pfl_tpu.management.checkpoint import NodeJournal as JaxNodeJournal
    from p2pfl_tpu.models import mlp_model as jax_mlp_model
    from p2pfl_tpu.node import Node as JaxNode
    from p2pfl_tpu.privacy.masking import PairwiseMasker as JaxPairwiseMasker
    from p2pfl_tpu_torch.privacy.masking import PairwiseMasker

    key = 0x5EC4A6_0001
    Settings.RESOURCE_MONITOR_PERIOD = 0
    JaxSettings.RESOURCE_MONITOR_PERIOD = 0
    jparts = jax_synthetic_mnist(n_train=128, n_test=32).generate_partitions(2, JaxIID)
    jnode = JaxNode(jax_mlp_model(seed=3), jparts[0], batch_size=16, executor=False)
    pnode = Node(_model(), synthetic_mnist(n_train=128, n_test=32).generate_partitions(
        2, RandomIIDPartitionStrategy)[0], batch_size=16, executor=False, device="cpu")
    pnode.learner.get_model().set_parameters(flax_to_torch(jnode.learner.get_model().params, device="cpu"))
    for node, masker in ((jnode, JaxPairwiseMasker), (pnode, PairwiseMasker)):
        node.state.set_experiment("journal", 5)
        node.state.experiment.round = 2
        node.state.privacy.masker = masker(node.addr, _private=key)
    with Settings.overridden(WIRE_COMPRESSION="topk"), JaxSettings.overridden(WIRE_COMPRESSION="topk"):
        jm, pm = jnode.learner.get_model(), pnode.learner.get_model()
        jnode.state.wire.set_anchor(jm.get_parameters(), 2)
        pnode.state.wire.set_anchor(pm.get_parameters(), 2)
        assert jnode.state.wire.encode_model(
            jm.build_copy(params=[np.asarray(p) + 0.01 for p in jm.get_parameters()]), 2) is not None
        assert pnode.state.wire.encode_model(pm.build_copy(params=[p + 0.01 for p in pm.get_parameters()]), 2)
    with JaxNodeJournal(str(tmp_path / "jax")) as jj, NodeJournal(str(tmp_path / "port")) as pj:
        assert jj.snapshot(jnode) and pj.snapshot(pnode)
        jj.wait()
        pj.wait()
        jmeta, pmeta = jj.latest_meta(), pj.latest_meta()
        assert jmeta.pop("addr") == jnode.addr and pmeta.pop("addr") == pnode.addr
        for meta, addr in ((jmeta, jnode.addr), (pmeta, pnode.addr)):
            meta["contributors"] = ["<self>" if c == addr else c for c in meta["contributors"]]
        assert pmeta == jmeta
        sizes = [int(np.prod(s)) for s in pmeta["anchor_shapes"]]
        template = {"params": [np.asarray(p) for p in jm.get_parameters()],
                    "anchor": [np.zeros(n, np.float32) for n in sizes],
                    "residual": [np.zeros(n, np.float32) for n in sizes]}
        jtree, _ = jj._ck.restore(template, 2)
        ptree, _ = pj._ck.restore(dict(template, params=list(pm.get_parameters())), 2)
    for part in ("params", "anchor", "residual"):
        assert len(jtree[part]) == len(ptree[part])
        for a, b in zip(jtree[part], ptree[part]):
            np.testing.assert_array_equal(np.asarray(a), b.numpy() if isinstance(b, torch.Tensor) else b)
    assert any(np.any(r != 0) for r in ptree["residual"])
