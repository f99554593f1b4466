"""The port's wire admission (``p2pfl_tpu_torch/comm/admission.py``) on the
CPU: the admission and Node cases of the JAX package's ``test_byzantine.py``
run against the port. The screen's cases hand the same frames (one seeded
f32 MLP's canonical leaves, perturbed alike) to the JAX package's
``AdmissionController`` and the port's, and hold the port's verdicts and
per-reason rejection counters to the reference's. The Node cases drive the
port's command handlers and a three-node federation with a scaled adversary.

The port's settings, registry, chaos plane and run context get
``test_torch_comm.port_transport``'s fast timings and clean slate.
"""

import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from p2pfl_tpu.comm.admission import AdmissionController as RefAdmission
from p2pfl_tpu.config import Settings as RefSettings
from p2pfl_tpu_torch.chaos import CHAOS, ChaosPlane
from p2pfl_tpu_torch.comm.admission import MIN_NORM_HISTORY, AdmissionController
from p2pfl_tpu_torch.comm.envelope import Envelope
from p2pfl_tpu_torch.comm.memory.registry import InMemoryRegistry
from p2pfl_tpu_torch.config import Settings
from p2pfl_tpu_torch.learning.aggregators import FedAvg, Krum
from p2pfl_tpu_torch.models.mlp import mlp_model
from p2pfl_tpu_torch.telemetry import REGISTRY

from test_torch_classification import mlp_handles
from test_torch_comm import ROOT, port_transport  # noqa: F401
from test_torch_node import one_intra_op_thread  # noqa: F401


def _rejected(reason=None, node=None) -> int:
    fam = REGISTRY.get("p2pfl_updates_rejected_total")
    total = 0
    if fam is not None:
        for labels, child in fam.samples():
            if (reason is None or labels.get("reason") == reason) and (node is None or labels.get("node") == node):
                total += int(child.value)
    return total


class Pair:
    """One model in both packages (the same canonical f32 leaves) and one
    admission controller each, so every frame is screened by both."""

    def __init__(self, name: str, seed: int = 0) -> None:
        self.ref_model, self.port_model = mlp_handles(seed)
        self.ref = RefAdmission(f"ref-{name}")
        self.port = AdmissionController(f"port-{name}")

    def leaves(self):
        return [np.asarray(p) for p in self.ref_model.get_parameters()]

    def screen(self, frame, **kw):
        """Both verdicts on ``frame`` (numpy leaves); asserts they agree."""
        ref = self.ref.screen(frame, self.ref_model, **kw)
        got = self.port.screen([torch.from_numpy(np.array(a)) for a in frame], self.port_model, **kw)
        assert got == ref, (got, ref)
        return got

    def screen_init(self, frame):
        ref = self.ref.screen_init(frame, self.ref_model)
        got = self.port.screen_init([torch.from_numpy(np.array(a)) for a in frame], self.port_model)
        assert got == ref, (got, ref)
        return got

    def counts_agree(self, *reasons) -> None:
        for reason in (None, *reasons):
            assert self.port.rejected_count(reason) == self.ref.rejected_count(reason), reason


# --- admission control: the screen, held to the reference's ---------------------


def test_admission_legit_frame_passes_and_builds_history():
    pair = Pair("legit")
    for i in range(MIN_NORM_HISTORY + 1):
        assert pair.screen([p + 0.01 * (i + 1) for p in pair.leaves()], source="peer") is None
    assert pair.port.rejected_count() == 0
    pair.counts_agree()


def test_admission_structural_rejections():
    pair = Pair("struct")
    params = pair.leaves()
    assert pair.screen(params[:-1]) == "tree"
    bad = [p.copy() for p in params]
    i2d = next(i for i, p in enumerate(bad) if p.ndim == 2)
    bad[i2d] = bad[i2d].T.copy()
    assert pair.screen(bad) == "shape"
    bad = [p.copy() for p in params]
    bad[0] = bad[0].astype(np.int32)
    assert pair.screen(bad) == "dtype"
    for reason in ("tree", "shape", "dtype"):
        assert pair.port.rejected_count(reason) == 1
    pair.counts_agree("tree", "shape", "dtype")


def test_admission_rejects_nonfinite():
    pair = Pair("nan")
    nan_frame = [p.copy() for p in pair.leaves()]
    nan_frame[0].reshape(-1)[0] = np.nan
    assert pair.screen(nan_frame) == "nonfinite"
    inf_frame = [p.copy() for p in pair.leaves()]
    inf_frame[-1][...] = np.inf
    assert pair.screen(inf_frame) == "nonfinite"
    assert pair.port.rejected_count("nonfinite") == 2
    pair.counts_agree("nonfinite")


def test_admission_norm_bound_bootstrap_and_adaptive():
    pair = Pair("norm")
    params = pair.leaves()
    assert pair.screen([-p for p in params]) == "norm"
    assert pair.screen([10.0 * p for p in params]) == "norm"
    for i in range(MIN_NORM_HISTORY):
        assert pair.screen([p + 0.01 * (i + 1) for p in params]) is None
    assert pair.screen([p + 1.0 for p in params]) == "norm"
    assert pair.screen([p + 0.02 for p in params]) is None
    pair.counts_agree("norm")


def test_admission_disabled_admits_everything():
    pair = Pair("off")
    nan_frame = [np.full_like(p, np.nan) for p in pair.leaves()]
    with Settings.overridden(ADMISSION_ENABLED=False), RefSettings.overridden(ADMISSION_ENABLED=False):
        assert pair.screen(nan_frame) is None
        assert pair.screen(nan_frame[:-1]) is None
    assert pair.port.rejected_count() == 0


def test_admission_skips_norm_check_when_asked():
    pair = Pair("rejoin")
    assert pair.screen([p + 100.0 for p in pair.leaves()], check_norm=False) is None
    assert pair.screen([np.full_like(p, np.nan) for p in pair.leaves()], check_norm=False) == "nonfinite"
    pair.counts_agree("nonfinite")


def test_num_samples_clamp():
    adm, ref = AdmissionController("adm-clamp"), RefAdmission("adm-clamp")
    cap = Settings.MAX_CLAIMED_SAMPLES
    assert cap == RefSettings.MAX_CLAIMED_SAMPLES
    for claim in (17, cap, cap * 1000, -3):
        assert adm.clamp_num_samples(claim, "peer") == ref.clamp_num_samples(claim, "peer")
    assert [adm.clamp_num_samples(c, "peer") for c in (17, cap, cap * 1000, -3)] == [17, cap, cap, 0]
    fam = REGISTRY.get("p2pfl_claimed_samples_clamped_total")
    assert sum(int(c.value) for labels, c in fam.samples() if labels.get("node") == "adm-clamp") == 2


def test_admission_env_validation_fails_fast():
    for var, bad in (
        ("P2PFL_TPU_MAX_CLAIMED_SAMPLES", "lots"),
        ("P2PFL_TPU_MAX_CLAIMED_SAMPLES", "0"),
        ("P2PFL_TPU_ADMISSION_NORM_MULT", "0.5"),
        ("P2PFL_TPU_ADMISSION_NORM_WINDOW", "2"),
    ):
        proc = subprocess.run([sys.executable, "-c", "import p2pfl_tpu_torch.config"], capture_output=True, text=True,
                              env={**os.environ, var: bad}, cwd=ROOT)
        assert proc.returncode != 0, (var, bad)
        assert "ValueError" in proc.stderr and var in proc.stderr, proc.stderr


def test_admission_init_screen():
    pair = Pair("init")
    other = [np.asarray(p) for p in mlp_handles(7)[0].get_parameters()]
    assert pair.screen_init(other) is None
    assert pair.screen_init([10.0 * p for p in other]) == "init_norm"
    assert pair.screen_init([np.full_like(p, np.nan) for p in other]) == "nonfinite"
    assert pair.screen_init([-p for p in other]) is None
    pair.counts_agree("init_norm", "nonfinite")


# --- admission on the command path --------------------------------------------------


def _make_node(seed=0, aggregator=None):
    from p2pfl_tpu_torch.learning.dataset import RandomIIDPartitionStrategy, synthetic_mnist
    from p2pfl_tpu_torch.node import Node

    data = synthetic_mnist(n_train=64, n_test=32)
    parts = data.generate_partitions(1, RandomIIDPartitionStrategy)
    return Node(mlp_model(seed=seed, device="cpu"), parts[0], batch_size=32, aggregator=aggregator or FedAvg(),
                device="cpu")


def _leaves(node):
    return [p.clone() for p in node.learner.get_model().get_parameters()]


def test_init_model_command_rejects_scaled_init():
    from p2pfl_tpu_torch.comm.commands.impl import InitModelCommand

    with Settings.overridden(EXECUTOR_MAX_WORKERS=0):
        node = _make_node()
        before = _leaves(node)
        evil = mlp_model(seed=3, device="cpu")
        evil_frame = evil.build_copy(params=[10.0 * p for p in evil.get_parameters()]).encode_parameters()
        InitModelCommand(node).execute("evil", 0, weights=evil_frame)
        assert not node.state.model_initialized_event.is_set()
        for a, b in zip(before, node.learner.get_model().get_parameters()):
            assert torch.equal(a, b)
        assert _rejected("init_norm", node.addr) == 1


def test_corrupt_frame_counted_not_raised():
    from p2pfl_tpu_torch.comm.commands.impl import FullModelCommand, PartialModelCommand

    with Settings.overridden(EXECUTOR_MAX_WORKERS=0):
        node = _make_node()
        node.state.set_experiment("corrupt-test", 3)
        PartialModelCommand(node).execute("evil", 0, weights=b"PFLTgarbage")
        FullModelCommand(node).execute("evil", 0, weights=b"\x00\x01\x02")
        assert _rejected("corrupt", node.addr) == 2


def test_partial_model_rejected_before_aggregator():
    from p2pfl_tpu_torch.comm.commands.impl import PartialModelCommand

    with Settings.overridden(EXECUTOR_MAX_WORKERS=0):
        node = _make_node()
        node.state.set_experiment("screen-test", 3)
        node.state.train_set = [node.addr, "evil"]
        node.aggregator.set_nodes_to_aggregate([node.addr, "evil"])
        model = node.learner.get_model()
        evil = model.build_copy(params=[10.0 * p for p in model.get_parameters()], contributors=["evil"],
                                num_samples=1)
        PartialModelCommand(node).execute("evil", 0, weights=evil.encode_parameters(), contributors=["evil"],
                                          num_samples=1)
        assert _rejected("norm", node.addr) == 1
        assert node.aggregator.get_aggregated_models() == []


def test_masked_partial_frame_refused_as_structure():
    """A masked lattice frame (a privacy-plane peer's) is refused as
    ``masked_structure``, as the JAX package refuses one with
    ``PRIVACY_SECAGG`` off, and never reaches the aggregator."""
    from p2pfl_tpu_torch.comm.commands.impl import MASKED_META_KEY, PartialModelCommand
    from p2pfl_tpu_torch.ops.serialization import serialize_arrays

    with Settings.overridden(EXECUTOR_MAX_WORKERS=0):
        node = _make_node()
        node.state.set_experiment("masked-test", 3)
        node.aggregator.set_nodes_to_aggregate([node.addr, "evil"])
        frame = serialize_arrays([np.zeros(4, np.uint32)], {"contributors": ["evil"], "num_samples": 1,
                                                             MASKED_META_KEY: {"bits": 32, "n": 2, "round": 0}})
        PartialModelCommand(node).execute("evil", 0, weights=frame, contributors=["evil"], num_samples=1)
        assert _rejected("masked_structure", node.addr) == 1
        assert node.aggregator.get_aggregated_models() == []


def test_inflated_num_samples_clamped_on_partial_path():
    from p2pfl_tpu_torch.comm.commands.impl import PartialModelCommand

    with Settings.overridden(EXECUTOR_MAX_WORKERS=0):
        node = _make_node()
        node.start()
        try:
            node.state.set_experiment("clamp-test", 3)
            node.state.train_set = [node.addr, "evil"]
            node.aggregator.set_nodes_to_aggregate([node.addr, "evil"])
            m = node.learner.get_model()
            frame = m.build_copy(params=[p + 0.001 for p in m.get_parameters()], contributors=["evil"], num_samples=1)
            PartialModelCommand(node).execute("evil", 0, weights=frame.encode_parameters(), contributors=["evil"],
                                              num_samples=10**15)
            stored = [mm for mm in node.aggregator._models if "evil" in mm.contributors]
            assert stored and stored[0].get_num_samples() == Settings.MAX_CLAIMED_SAMPLES
        finally:
            node.stop()


def test_full_model_first_wins_blocks_overwrite():
    from p2pfl_tpu_torch.comm.commands.impl import FullModelCommand

    with Settings.overridden(EXECUTOR_MAX_WORKERS=0):
        node = _make_node()
        node.start()
        try:
            node.state.set_experiment("firstwins-test", 3)
            node.state.last_full_model_round = 0
            before = _leaves(node)
            other = mlp_model(seed=9, device="cpu")
            other.contributors = ["evil"]
            FullModelCommand(node).execute("evil", 0, weights=other.encode_parameters())
            for a, b in zip(before, node.learner.get_model().get_parameters()):
                assert torch.equal(a, b)
        finally:
            node.stop()


# --- screening after sparse-delta reconstruction -------------------------------------


def test_poisoned_sparse_frame_rejected_and_anchor_survives():
    from p2pfl_tpu_torch.comm.commands.impl import PartialModelCommand
    from p2pfl_tpu_torch.comm.delta import DeltaWireCodec

    with Settings.overridden(EXECUTOR_MAX_WORKERS=0, WIRE_COMPRESSION="topk"):
        node = _make_node()
        node.state.set_experiment("sparse-poison", 3)
        node.state.train_set = [node.addr, "evil"]
        node.aggregator.set_nodes_to_aggregate([node.addr, "evil"])
        anchor = node.learner.get_model().get_parameters()
        node.state.wire.set_anchor(anchor, 0)
        sender = DeltaWireCodec("evil", device="cpu")
        sender.set_anchor(anchor, 0)
        honest = node.learner.get_model().build_copy(params=[p + 0.01 for p in anchor], contributors=["evil"],
                                                     num_samples=1)
        sparse = sender.encode_model(honest, 0)
        assert sparse is not None
        plane = ChaosPlane()
        plane.set_byzantine("evil", "nan")
        poisoned = plane.corrupt_weights("evil", Envelope.weights("evil", "partial_model", 0, sparse, ["evil"], 1)).payload
        PartialModelCommand(node).execute("evil", 0, weights=poisoned, contributors=["evil"], num_samples=1)
        assert _rejected("nonfinite", node.addr) == 1
        assert node.aggregator.get_aggregated_models() == []
        sender2 = DeltaWireCodec("evil2", device="cpu")
        sender2.set_anchor(anchor, 0)
        arrays, _ = node.state.wire.decode_frame(sender2.encode_model(honest, 0))
        assert all(bool(torch.isfinite(a.float()).all()) for a in arrays)


def test_hostile_quantized_frame_rejected_as_corrupt_before_anchor():
    from p2pfl_tpu_torch.comm.commands.impl import PartialModelCommand
    from p2pfl_tpu_torch.comm.delta import DeltaWireCodec
    from p2pfl_tpu_torch.ops.compression import CODEC_META_KEY
    from p2pfl_tpu_torch.ops.serialization import deserialize_arrays, serialize_arrays

    with Settings.overridden(EXECUTOR_MAX_WORKERS=0, WIRE_COMPRESSION="topk", WIRE_TOPK_VALUES="int8",
                             COALESCE_ENABLED=True):
        node = _make_node()
        node.state.set_experiment("quant-poison", 3)
        node.state.train_set = [node.addr, "evil"]
        node.aggregator.set_nodes_to_aggregate([node.addr, "evil"], round=0)
        anchor = node.learner.get_model().get_parameters()
        node.state.wire.set_anchor(anchor, 0)
        sender = DeltaWireCodec("evil", device="cpu")
        sender.set_anchor(anchor, 0)
        update = node.learner.get_model().build_copy(params=[p + 0.01 for p in anchor], contributors=["evil"],
                                                     num_samples=1)
        blob, label = sender.encode_tagged(update, 0)
        assert label == "topk-int8"
        arrays, meta = deserialize_arrays(bytes(blob))
        scales = [s for s in meta[CODEC_META_KEY] if s.get("values") in ("int8", "int4")]
        assert scales
        for s in scales:
            s["scale"] = float("nan")
        hostile = bytes(serialize_arrays([np.asarray(a) for a in arrays], meta))
        before = node.state.wire.export_state()
        PartialModelCommand(node).execute("evil", 0, weights=hostile, contributors=["evil"], num_samples=1)
        assert _rejected("corrupt", node.addr) == 1
        assert node.aggregator.get_aggregated_models() == []
        after = node.state.wire.export_state()
        assert after["anchor_round"] == before["anchor_round"]
        for a, b in zip(before["anchor"], after["anchor"]):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        arrays2, _ = node.state.wire.decode_frame(bytes(blob))
        assert all(bool(torch.isfinite(a.float()).all()) for a in arrays2)


# --- e2e: adversary screened out, round survives ---------------------------------------


def test_e2e_adversary_screened_round_completes():
    from p2pfl_tpu_torch.learning.dataset import RandomIIDPartitionStrategy, synthetic_mnist
    from p2pfl_tpu_torch.node import Node
    from p2pfl_tpu_torch.utils.utils import wait_convergence

    Settings.RESOURCE_MONITOR_PERIOD = 0
    n = 3
    with Settings.overridden(TRAIN_SET_SIZE=3):
        parts = synthetic_mnist(n_train=128 * n, n_test=64).generate_partitions(n, RandomIIDPartitionStrategy)
        nodes = [Node(mlp_model(seed=i, device="cpu"), parts[i], batch_size=32, aggregator=Krum(num_byzantine=1),
                      device="cpu") for i in range(n)]
        adversary, honest = nodes[2], nodes[:2]
        for nd in nodes:
            nd.start()
        try:
            CHAOS.set_byzantine(adversary.addr, "scaled")
            for i in range(1, n):
                nodes[i].connect(nodes[0].addr)
            wait_convergence(nodes, n - 1, wait=8)
            rejected_before = _rejected()
            t0 = time.monotonic()
            nodes[0].set_start_learning(rounds=1, epochs=1)
            deadline = time.time() + Settings.VOTE_TIMEOUT + Settings.AGGREGATION_TIMEOUT
            while not all(not nd.learning_in_progress() and nd.learning_workflow is not None for nd in honest):
                if time.time() >= deadline:
                    pytest.fail("honest nodes did not finish under the adversary")
                time.sleep(0.05)
            assert time.monotonic() - t0 < Settings.AGGREGATION_TIMEOUT
            for nd in honest:
                assert nd.learning_workflow.history.count("RoundFinishedStage") == 1
            assert _rejected() > rejected_before, "no poisoned frame was screened"
        finally:
            CHAOS.reset()
            for nd in nodes:
                nd.stop()
            InMemoryRegistry.reset()
