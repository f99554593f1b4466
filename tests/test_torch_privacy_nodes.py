"""The privacy plane on port ``Node`` s over the in-memory transport, on the
CPU: the legs and gates of the JAX package's ``scripts/privacy_check.py``
at tier-1 size, the privacy frames through the real command handlers, and
a mixed secure-aggregation federation of a port Node and a JAX-package
Node.

* masked against its maskless twin: two MLP Nodes under
  ``PRIVACY_SECAGG`` train two rounds, and the same run with
  ``mask_own(..., mask=False)`` commits equal hashes every round;
* masker dropout: ``CHAOS.plan_masker_dropout`` picks the masker killed in
  round 1, after it was elected and before its frame ships; the survivor
  finishes with applied repairs and no ``range`` outcome, within
  ``privacy_check``'s bound of the plaintext run with the same kill;
* the budget: with DP-SGD on, every node reports a nonzero epsilon through
  ``BUDGETS`` and its health digest.

The wire federations have two Nodes: with three or more, FedAvg's
overlapping partials can count a member twice under load (both packages;
ROADMAP queue C). Three-member committees are covered without the wire by
``test_torch_privacy.py``.
"""

import time

import numpy as np
import pytest
import torch

from p2pfl_tpu_torch.chaos import CHAOS
from p2pfl_tpu_torch.comm.memory.registry import InMemoryRegistry
from p2pfl_tpu_torch.config import Settings
from p2pfl_tpu_torch.learning.dataset import RandomIIDPartitionStrategy, synthetic_mnist
from p2pfl_tpu_torch.models.mlp import mlp_model
from p2pfl_tpu_torch.node import Node
from p2pfl_tpu_torch.privacy import BUDGETS, PrivacyPlane, wire_epsilon
from p2pfl_tpu_torch.telemetry import REGISTRY
from p2pfl_tpu_torch.telemetry.ledger import LEDGERS

from test_torch_comm import _wait, port_transport  # noqa: F401
from test_torch_node import one_intra_op_thread  # noqa: F401
from test_torch_node_parity import postmortem  # noqa: F401

ADDRS = ["mem://secagg-0", "mem://secagg-1"]
KILL_ROUND = 1
#: privacy_check's dropout legs: eight rounds (rand-k with error feedback
#: repays its lattice and support error over a few rounds), the survivor
#: within 2 * 0.1 of the plaintext run with the same kill.
DROPOUT_ROUNDS = 8
DROPOUT_ACC_TOL = 0.2


@pytest.fixture(autouse=True)
def privacy_settings():
    """``privacy_check``'s settings: inline fits, and the plaintext legs on
    the sparse wire (top-k int8 at the masked ratio)."""
    Settings.RESOURCE_MONITOR_PERIOD = 0
    Settings.EXECUTOR_MAX_WORKERS = 0
    Settings.WIRE_COMPRESSION = "topk"
    Settings.WIRE_TOPK_RATIO = 0.1
    Settings.WIRE_TOPK_VALUES = "int8"
    Settings.LEDGER_ENABLED = True
    Settings.PRIVACY_KEY_WAIT_S = 8.0
    LEDGERS.reset()
    BUDGETS.reset()
    REGISTRY.reset()
    yield
    BUDGETS.reset()


def _partitions(n=2):
    return synthetic_mnist(n_train=128 * n, n_test=128).generate_partitions(n, RandomIIDPartitionStrategy)


def _counter(name, **match):
    fam = REGISTRY.get(name)
    if fam is None:
        return {}
    return {tuple(lbl[k] for k in sorted(lbl) if k not in match): c.value for lbl, c in fam.samples()
            if all(lbl.get(k) == v for k, v in match.items()) and c.value}


def _federate(parts, rounds, report, secagg=True, victim_at=None, **node_kw):
    """Two port Nodes (explicit addresses, seeded learners) train ``rounds``
    rounds; returns ``(nodes, killed)``. ``victim_at`` names the node to kill
    mid-round ``KILL_ROUND``: its fit in that round is held until it is
    dead, so its masked frame never ships."""
    Settings.PRIVACY_SECAGG = secagg
    nodes = [Node(mlp_model(seed=i, device="cpu"), parts[i], addr=a, batch_size=32, seed=i, device="cpu", **node_kw)
             for i, a in enumerate(ADDRS)]
    victim = next((nd for nd in nodes if nd.addr == victim_at), None)
    if victim is not None:
        fit = victim.learner.fit

        def held_fit():
            if (victim.state.round or 0) >= KILL_ROUND:
                _wait(lambda: not victim._running, timeout=30.0)
            return fit()

        victim.learner.fit = held_fit
    for nd in nodes:
        nd.start()
    nodes[1].connect(nodes[0].addr)
    assert _wait(lambda: all(len(nd.get_neighbors()) == 1 for nd in nodes), timeout=15.0), report(nodes)
    nodes[0].set_start_learning(rounds=rounds, epochs=1)
    killed = False
    deadline = time.monotonic() + 120.0
    while time.monotonic() < deadline:
        if victim is not None and not killed and (victim.state.round or 0) >= KILL_ROUND \
                and victim.state.current_stage == "TrainStage":
            time.sleep(0.3)  # mid-round: committee elected, the survivor's frame out
            victim.crash()
            CHAOS.recovery(victim.addr, "crash")
            killed = True
        if all(not nd.learning_in_progress() and nd.learning_workflow is not None
               for nd in nodes if nd is not victim or not killed):
            break
        time.sleep(0.05)
    else:
        raise AssertionError("the federation did not finish\n" + report(nodes))
    return nodes, killed


def _hashes(addr):
    evs = LEDGERS.peek(addr).canonical_events()
    return {e["round"]: e["hash"] for e in evs if e["kind"] == "aggregate_committed"}


def _stop(nodes):
    for nd in nodes:
        try:
            nd.stop()
        except Exception:  # noqa: BLE001 — a crashed victim
            pass
    InMemoryRegistry.reset()
    CHAOS.reset()


def test_masked_federation_equals_its_maskless_twin_every_round(monkeypatch, postmortem):
    parts = _partitions()
    runs = []
    for mask in (True, False):
        if not mask:
            masked_own = PrivacyPlane.mask_own
            monkeypatch.setattr(PrivacyPlane, "mask_own",
                                lambda self, *a, **kw: masked_own(self, *a, **{**kw, "mask": False}))
        LEDGERS.reset()
        REGISTRY.reset()
        nodes, _ = _federate(parts, 2, postmortem)
        try:
            hashes = {a: _hashes(a) for a in ADDRS}
            assert sorted(hashes[ADDRS[0]]) == [0, 1], postmortem(nodes)
            assert hashes[ADDRS[0]] == hashes[ADDRS[1]], postmortem(nodes)
            ok = _counter("p2pfl_privacy_masked_rounds_total")
            assert ok == {(a, "ok"): 2.0 for a in ADDRS}, (ok, postmortem(nodes))
            frames = _counter("p2pfl_privacy_masked_frames_total")
            assert frames == {(a,): 2.0 for a in ADDRS}, frames
            runs.append(hashes[ADDRS[0]])
        finally:
            _stop(nodes)
    assert runs[0] == runs[1]


def test_masked_round_finalizes_on_its_own_anchor_when_a_full_model_races_ahead(monkeypatch, postmortem):
    """The mixed federation's fault under load, forced: node 0 finalizes
    each masked round only after adopting the peer's dense full model for
    that round has moved node 0's codec anchor to the next round. The
    finalize still unmasks onto the anchor the masks were computed against:
    every round ``ok`` on both nodes and equal final parameters (before the
    repair: ``structure`` and node 0 fell back to its own local model)."""
    from p2pfl_tpu_torch.stages.base_node import TrainStage

    finalize = TrainStage._finalize_masked
    raced = []

    def late_finalize(node, aggregated, own, committee, *rest):
        if node.addr == ADDRS[0]:
            r = node.state.round or 0
            # The adoption re-anchors last, after it notes the round's model.
            if _wait(lambda: node.state.wire.anchor_round > r, timeout=20.0):
                raced.append((r, node.state.wire.anchor_round))
        return finalize(node, aggregated, own, committee, *rest)

    monkeypatch.setattr(TrainStage, "_finalize_masked", staticmethod(late_finalize))
    Settings.WIRE_COMPRESSION = "none"  # dense full models, as in the mixed federation: adopting one re-anchors
    nodes, _ = _federate(_partitions(), 2, postmortem)
    try:
        assert raced and all(anchor_round == r + 1 for r, anchor_round in raced), (raced, postmortem(nodes))
        ok = _counter("p2pfl_privacy_masked_rounds_total")
        assert ok == {(a, "ok"): 2.0 for a in ADDRS}, (ok, postmortem(nodes))
        a, b = ([t.cpu().numpy() for t in nd.learner.get_model().get_parameters()] for nd in nodes)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    finally:
        _stop(nodes)


def test_masker_dropout_is_repaired_within_the_plaintext_same_kill_bound(postmortem):
    parts = _partitions()
    trace = CHAOS.plan_masker_dropout(DROPOUT_ROUNDS, ADDRS, seed=7, drop_round=KILL_ROUND)
    victim = trace[0].node
    accs = {}
    for secagg in (True, False):
        REGISTRY.reset()
        nodes, killed = _federate(parts, DROPOUT_ROUNDS, postmortem, secagg=secagg, victim_at=victim)
        try:
            assert killed, postmortem(nodes)
            survivor = next(nd for nd in nodes if nd.addr != victim)
            assert survivor.learning_workflow.history.count("RoundFinishedStage") == DROPOUT_ROUNDS
            accs[secagg] = survivor.learner.evaluate()["test_acc"]
            if secagg:
                outcomes = _counter("p2pfl_privacy_masked_rounds_total", node=survivor.addr)
                assert ("range",) not in outcomes and outcomes.get(("ok",), 0) == DROPOUT_ROUNDS, \
                    (outcomes, postmortem(nodes))
                repairs = _counter("p2pfl_privacy_repairs_total", node=survivor.addr)
                assert repairs.get(("applied",), 0) >= 1 and repairs.get(("tx",), 0) == 1, repairs
        finally:
            _stop(nodes)
    assert accs[True] >= accs[False] - DROPOUT_ACC_TOL, accs


def test_dp_budget_reports_nonzero_epsilon_on_every_node(postmortem):
    from p2pfl_tpu_torch.telemetry import digest

    Settings.PRIVACY_DP_CLIP = 8.0
    Settings.PRIVACY_DP_SIGMA = 0.005
    nodes, _ = _federate(_partitions(), 2, postmortem)
    try:
        for nd in nodes:
            eps = BUDGETS.epsilon(nd.addr)
            assert 0 < eps < float("inf"), eps
            assert digest.collect(nd.addr, nd.state).dp_epsilon == pytest.approx(wire_epsilon(eps))
        assert _counter("p2pfl_privacy_masked_rounds_total") == {(a, "ok"): 2.0 for a in ADDRS}
    finally:
        _stop(nodes)


# --- the Node and its command handlers ------------------------------------------------------


def _node(**kw):
    part = _partitions(1)[0]
    return Node(mlp_model(seed=0, device="cpu"), part, device="cpu", executor=False, **kw)


def test_secagg_node_defaults_to_masked_fedavg_and_refuses_robust_rules():
    from p2pfl_tpu_torch.learning.aggregators import FedAvg, Krum, MaskedFedAvg

    Settings.PRIVACY_SECAGG = True
    assert isinstance(_node().aggregator, MaskedFedAvg)
    assert type(_node(aggregator=FedAvg()).aggregator) is FedAvg  # a linear rule is kept
    with pytest.raises(ValueError, match="linear"):
        _node(aggregator=Krum())
    Settings.PRIVACY_SECAGG = False
    assert type(_node().aggregator) is FedAvg


def test_privacy_key_and_repair_frames_are_handled():
    """A peer's ``privacy_key`` is learned and answered with ours (once);
    a survivor's ``privacy_repair`` is stored when both parties sit on the
    round's committee, and recorded."""
    from p2pfl_tpu_torch.comm.commands.impl import PrivacyKeyCommand, PrivacyRepairCommand

    node = _node()
    sent = []
    node.protocol.send = lambda nei, env, **kw: sent.append((nei, env))
    peer = PrivacyPlane("peer", device="cpu")
    PrivacyKeyCommand(node).execute("peer", 0, peer.key_payload())
    assert node.state.privacy.masker.knows("peer")
    assert [(nei, env.cmd, env.args) for nei, env in sent] == [("peer", "privacy_key",
                                                                 [node.state.privacy.key_payload()])]
    PrivacyKeyCommand(node).execute("peer", 0, peer.key_payload())  # repeated: no second answer
    PrivacyKeyCommand(node).execute("other", 0, "zz")  # malformed: dropped
    assert len(sent) == 1 and not node.state.privacy.masker.knows("other")
    node.state.privacy.note_committee(3, [node.addr, "peer", "dead"])
    PrivacyRepairCommand(node).execute("peer", 3, "dead", "cd" * 32)
    PrivacyRepairCommand(node).execute("outsider", 3, "dead", "cd" * 32)
    assert list(node.state.privacy._repairs) == [(3, "peer", "dead")]
    kinds = [e["kind"] for e in node.protocol.flight_recorder.events()]
    assert kinds.count("privacy_repair") == 1


def test_masked_partial_frames_screened_by_the_handler():
    """Through ``PartialModelCommand``: a masked frame before the round's
    committee is elected is dropped silently; a hostile one (planes that
    disagree with ``ks``, another committee size, a contributor outside it)
    is a counted rejection; an honest one reaches the aggregator."""
    from p2pfl_tpu_torch.comm.commands.impl import PartialModelCommand
    from p2pfl_tpu_torch.ops.serialization import deserialize_arrays, serialize_arrays

    Settings.PRIVACY_SECAGG = True
    node = _node()
    node.state.set_experiment("masked-test", 3)
    committee = sorted([node.addr, "peer"])
    peer = PrivacyPlane("peer", device="cpu")
    for a, b in ((peer, node.state.privacy), (node.state.privacy, peer)):
        a.learn_key(b.addr, b.key_payload())
    model = node.learner.get_model()
    anchor = [p.clone() for p in model.get_parameters()]
    moved = model.build_copy(params=[p + 1e-3 for p in anchor], contributors=["peer"], num_samples=7)
    frame = PrivacyPlane.encode_frame(peer.mask_own(moved, anchor, 0, committee))
    cmd = PartialModelCommand(node)

    def send(blob, contributors=("peer",)):
        cmd.execute("peer", 0, weights=blob, contributors=list(contributors), num_samples=7)

    def rejected():
        return _counter("p2pfl_updates_rejected_total", node=node.addr)

    node.start()
    try:
        send(frame)  # no committee yet: dropped, not rejected
        assert rejected() == {} and node.aggregator.get_aggregated_models() == []
        node.state.train_set = committee
        node.aggregator.set_nodes_to_aggregate(committee)
        arrays, meta = deserialize_arrays(frame)
        send(serialize_arrays([a[:-3] for a in arrays], meta))
        send(serialize_arrays(arrays, {**meta, "__masked__": {**meta["__masked__"], "n": 3}}))
        send(frame, contributors=("outsider",))
        assert {k[0]: v for k, v in rejected().items()} == {"corrupt": 1, "masked_structure": 1, "masked_member": 1}
        send(frame)
        assert node.aggregator.get_aggregated_models() == ["peer"]
    finally:
        node.stop()


# --- a mixed secure-aggregation federation ----------------------------------------------------


def test_mixed_secagg_federation_of_a_port_and_a_jax_node(monkeypatch, postmortem):
    """A port Node and a JAX-package Node under ``PRIVACY_SECAGG`` on one
    in-memory wire (the port's registry pointed at the reference's, explicit
    addresses), f32 MLPs from one seed, each with its package's default
    ``MaskedFedAvg``: keys cross the packages, every masked round finalizes
    ``ok`` on both nodes (the masks cancel across the packages) and the
    final parameters agree within 1e-5."""
    from p2pfl_tpu.comm.memory.registry import InMemoryRegistry as RefRegistry
    from p2pfl_tpu.config import Settings as JaxSettings
    from p2pfl_tpu.learning.dataset import RandomIIDPartitionStrategy as RefIID
    from p2pfl_tpu.learning.dataset import synthetic_mnist as ref_mnist
    from p2pfl_tpu.node import Node as RefNode
    from p2pfl_tpu.telemetry import REGISTRY as REF_REGISTRY
    from test_torch_classification import mlp_handles

    monkeypatch.setattr(InMemoryRegistry, "_servers", RefRegistry._servers)
    monkeypatch.setattr(InMemoryRegistry, "_lock", RefRegistry._lock)
    JaxSettings.RESOURCE_MONITOR_PERIOD = 0
    JaxSettings.EXECUTOR_MAX_WORKERS = Settings.EXECUTOR_MAX_WORKERS
    Settings.WIRE_COMPRESSION = JaxSettings.WIRE_COMPRESSION = "none"
    # As the parity harness's wire runs: the JAX node's first fit compiles,
    # so coverage reports stay frozen for seconds; the gossip loop and the
    # aggregation wait outlast it instead of abandoning a member's model.
    Settings.GOSSIP_EXIT_ON_X_EQUAL_ROUNDS = JaxSettings.GOSSIP_EXIT_ON_X_EQUAL_ROUNDS = 400
    Settings.AGGREGATION_STALL_PATIENCE = JaxSettings.AGGREGATION_STALL_PATIENCE = 60.0
    Settings.AGGREGATION_TIMEOUT = JaxSettings.AGGREGATION_TIMEOUT = 120.0
    REF_REGISTRY.reset()
    kw = dict(n_train=2 * 128, n_test=64)
    ref_parts = ref_mnist(**kw).generate_partitions(2, RefIID)
    parts = synthetic_mnist(**kw).generate_partitions(2, RandomIIDPartitionStrategy)
    addrs = ["mem://secagg-port-0", "mem://secagg-ref-1"]
    jh, ph = mlp_handles(0)
    nodes = []
    with Settings.overridden(PRIVACY_SECAGG=True), \
            JaxSettings.overridden(PRIVACY_SECAGG=True, COMPUTE_DTYPE="float32"):
        nodes.append(Node(ph, parts[0], addr=addrs[0], batch_size=32, lr=1e-3, seed=0, device="cpu"))
        nodes.append(RefNode(jh, ref_parts[1], addr=addrs[1], batch_size=32, lr=1e-3, seed=1))
        try:
            for nd in nodes:
                nd.start()
            nodes[1].connect(nodes[0].addr)
            assert _wait(lambda: all(len(nd.get_neighbors()) == 1 for nd in nodes), timeout=15.0), \
                postmortem(nodes)
            nodes[0].set_start_learning(rounds=2, epochs=1)
            assert _wait(lambda: all(not nd.learning_in_progress() and nd.learning_workflow is not None
                                     for nd in nodes), timeout=120.0), postmortem(nodes)
            for nd in nodes:
                assert nd.learning_workflow.history.count("RoundFinishedStage") == 2, nd.learning_workflow.history
            assert type(nodes[1].aggregator).__name__ == "MaskedFedAvg"
            for reg, addr in ((REGISTRY, addrs[0]), (REF_REGISTRY, addrs[1])):
                fam = reg.get("p2pfl_privacy_masked_rounds_total")
                outcomes = {lbl["outcome"]: c.value for lbl, c in fam.samples() if lbl["node"] == addr and c.value}
                assert outcomes == {"ok": 2.0}, (addr, outcomes, postmortem(nodes))
            port, ref = ([np.asarray(p.detach().cpu() if isinstance(p, torch.Tensor) else p)
                          for p in nd.learner.get_model().get_parameters()] for nd in nodes)
            assert len(port) == len(ref)
            for a, b in zip(port, ref):
                np.testing.assert_allclose(a, b, atol=1e-5, rtol=0)
        finally:
            for nd in nodes:
                nd.stop()
            RefRegistry.reset()
