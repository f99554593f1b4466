"""The port's chaos plane (``p2pfl_tpu_torch/chaos/``) on the CPU: the
Node-free cases of the JAX package's ``test_chaos.py`` and the chaos-plane
cases of ``test_byzantine.py`` run against the port, then the plane against
the JAX package's: decision streams and retry backoff draw for draw, the
planners and the adaptive ladder event for event, every Byzantine attack's
corrupted frame byte for byte (frames built by the JAX package's codec), and
``adaptive_poison`` bit for bit.

The port's settings, registry, chaos plane and run context get
``test_torch_comm.port_transport``'s fast timings and clean slate. Every
wait polls against a deadline.
"""

import dataclasses
import os
import subprocess
import sys
import threading
import time
from typing import Any

import numpy as np
import pytest
import torch

from p2pfl_tpu.chaos import CHAOS as JAX_CHAOS
from p2pfl_tpu.chaos import ChaosPlane as JaxChaosPlane
from p2pfl_tpu.chaos.plane import adaptive_attack_schedule as jax_schedule
from p2pfl_tpu.chaos.plane import adaptive_poison as jax_adaptive_poison
from p2pfl_tpu.comm.envelope import Envelope as JaxEnvelope
from p2pfl_tpu.comm.protocol import jittered_backoff as jax_backoff
from p2pfl_tpu.config import Settings as JaxSettings
from p2pfl_tpu_torch.chaos import BYZANTINE_ATTACKS, CHAOS, ChaosPlane
from p2pfl_tpu_torch.chaos.plane import ADAPTIVE_LADDER, adaptive_attack_schedule, adaptive_poison
from p2pfl_tpu_torch.comm.commands.command import Command
from p2pfl_tpu_torch.comm.envelope import Envelope
from p2pfl_tpu_torch.comm.gossiper import Gossiper
from p2pfl_tpu_torch.comm.memory.memory_protocol import InMemoryCommunicationProtocol
from p2pfl_tpu_torch.comm.memory.registry import InMemoryRegistry
from p2pfl_tpu_torch.comm.protocol import jittered_backoff
from p2pfl_tpu_torch.config import Settings
from p2pfl_tpu_torch.exceptions import CommunicationError
from p2pfl_tpu_torch.learning.aggregators.fedavg import FedAvg
from p2pfl_tpu_torch.models.mlp import mlp_model
from p2pfl_tpu_torch.models.model_handle import ModelHandle
from p2pfl_tpu_torch.ops.serialization import deserialize_arrays
from p2pfl_tpu_torch.telemetry import REGISTRY
from test_torch_comm import ROOT, MockCommand, _mk, _wait, port_transport, rx_frames  # noqa: F401


def _small_model() -> ModelHandle:
    return mlp_model(seed=0, hidden_sizes=(16,), device="cpu")


def _retries() -> float:
    return sum(c.value for _, c in REGISTRY.get("p2pfl_send_retries_total").samples())


# --- the plane itself (test_chaos.py) ------------------------------------------------


def test_chaos_deterministic_same_seed():
    """Same seed + same intercept sequence => identical decisions AND
    identical fault counts."""
    p1, p2 = ChaosPlane(), ChaosPlane()
    pairs = [("a", "b"), ("b", "a"), ("a", "c"), ("c", "a")]
    with Settings.overridden(
        CHAOS_ENABLED=True, CHAOS_SEED=7, CHAOS_DROP_RATE=0.25,
        CHAOS_DUPLICATE_RATE=0.1, CHAOS_DELAY_JITTER_S=0.0,
    ):
        d1 = [p1.intercept(s, d) for _ in range(400) for s, d in pairs]
        d2 = [p2.intercept(s, d) for _ in range(400) for s, d in pairs]
    assert d1 == d2
    assert p1.fault_counts() == p2.fault_counts()
    assert p1.fault_counts().get("drop", 0) > 0  # faults actually fired


def test_chaos_different_seed_differs():
    p1, p2 = ChaosPlane(), ChaosPlane()
    with Settings.overridden(CHAOS_ENABLED=True, CHAOS_DROP_RATE=0.5):
        with Settings.overridden(CHAOS_SEED=1):
            d1 = [p1.intercept("a", "b").drop for _ in range(200)]
        with Settings.overridden(CHAOS_SEED=2):
            d2 = [p2.intercept("a", "b").drop for _ in range(200)]
    assert d1 != d2


def test_chaos_inactive_is_clean():
    p = ChaosPlane()
    assert not p.active
    d = p.intercept("a", "b")  # callable even when inactive: clean decision
    assert not d.drop and d.blocked is None and d.delay_s == 0.0


def test_chaos_env_validation_fails_fast():
    """A typo'd chaos env value must fail at config IMPORT, not mid-round in
    a gossip thread."""
    for var, bad in (
        ("P2PFL_TPU_CHAOS_SEED", "not-an-int"),
        ("P2PFL_TPU_CHAOS_DROP_RATE", "nope"),
        ("P2PFL_TPU_CHAOS_DROP_RATE", "1.5"),
        ("P2PFL_TPU_CHAOS_DUPLICATE_RATE", "-0.1"),
        ("P2PFL_TPU_CHAOS_DELAY_S", "99"),
    ):
        env = dict(os.environ)
        env[var] = bad
        proc = subprocess.run(
            [sys.executable, "-c", "import p2pfl_tpu_torch.config"],
            capture_output=True, text=True, env=env, cwd=ROOT, timeout=120,
        )
        assert proc.returncode != 0, (var, bad)
        assert "ValueError" in proc.stderr and var in proc.stderr, proc.stderr


# --- through the real send path ---------------------------------------------------------


def test_drop_injection_loses_message_silently():
    a, b = _mk(2)
    cmd = MockCommand()
    b.add_command(cmd)
    try:
        a.connect(b.addr)
        with CHAOS.overridden(drop_rate=1.0, seed=3):
            a.send(b.addr, a.build_msg("mock"))  # must NOT raise
            assert CHAOS.fault_counts().get("drop", 0) >= 1
        # healed: delivery works again, and the dropped frame never came
        a.send(b.addr, a.build_msg("mock", args=["after"]))
        assert _wait(lambda: cmd.calls)
        assert [args for _, _, args in cmd.calls] == [("after",)]
        assert rx_frames(b, "mock") == 1
    finally:
        a.stop()
        b.stop()


def test_duplicate_injection_is_deduped():
    """Duplicated control frames must execute exactly once (msg_id dedup)."""
    a, b = _mk(2)
    cmd = MockCommand()
    b.add_command(cmd)
    try:
        a.connect(b.addr)
        with CHAOS.overridden(duplicate_rate=1.0, seed=3):
            a.send(b.addr, a.build_msg("mock", args=["dup"]))
            # both copies were taken in (polls instead of sleeping)
            assert _wait(lambda: cmd.calls and rx_frames(b, "mock") == 2)
            assert len(cmd.calls) == 1
            assert CHAOS.fault_counts().get("duplicate", 0) >= 1
    finally:
        a.stop()
        b.stop()


def test_partition_writes_peer_off_and_fires_death_callback():
    a, b = _mk(2)
    deaths = []
    a.on_neighbor_removed(deaths.append)
    try:
        a.connect(b.addr)
        CHAOS.partition([a.addr], [b.addr])
        try:
            with pytest.raises(CommunicationError):
                a.send(b.addr, a.build_msg("mock"), retries=1)
        finally:
            CHAOS.reset()
        assert deaths == [b.addr]
        assert b.addr not in a.get_neighbors()
        # heal + reconnect works (the link was never really down)
        assert a.connect(b.addr)
    finally:
        a.stop()
        b.stop()


def test_send_retry_succeeds_after_transient_failure():
    """A transient blip must NOT write the peer off: bounded retry with
    backoff recovers the send and keeps the neighbor."""

    class Flaky(InMemoryCommunicationProtocol):
        def __init__(self):
            self.failures_left = 2
            super().__init__()

        def _transport_send(self, nei, env):
            if self.failures_left > 0:
                self.failures_left -= 1
                raise CommunicationError("transient blip")
            super()._transport_send(nei, env)

    a, b = Flaky(), InMemoryCommunicationProtocol()
    a.start()
    b.start()
    cmd = MockCommand()
    b.add_command(cmd)
    retries_before = _retries()
    try:
        a.connect(b.addr)
        a.send(b.addr, a.build_msg("mock"), retries=3)
        assert _wait(lambda: cmd.calls)
        assert b.addr in a.get_neighbors()  # never written off
        assert _retries() - retries_before >= 2
    finally:
        a.stop()
        b.stop()


# --- round survival -------------------------------------------------------------------------


def test_aggregation_wait_completes_via_death_callback():
    """With one trainset member dead, the aggregation wait finishes via
    remove_node in well under the timeout."""
    agg = FedAvg()
    agg.set_addr("n1")
    agg.set_nodes_to_aggregate(["n1", "n2", "n3"])
    m = mlp_model(seed=0, hidden_sizes=(8,), device="cpu")
    agg.add_model(ModelHandle(m.params, m.module, contributors=["n1"]))
    agg.add_model(ModelHandle(m.params, m.module, contributors=["n2"]))

    result = {}

    def waiter():
        t0 = time.monotonic()
        result["model"] = agg.wait_and_get_aggregation(timeout=30.0)
        result["waited"] = time.monotonic() - t0

    t = threading.Thread(target=waiter, daemon=True)
    t.start()
    t.join(timeout=0.3)
    assert t.is_alive() and agg.get_missing_models() == ["n3"]  # blocked on the missing n3
    assert agg.remove_node("n3") is True
    t.join(timeout=5.0)
    assert not t.is_alive()
    assert result["waited"] < 5.0, result  # well under the 30s timeout
    assert sorted(result["model"].get_contributors()) == ["n1", "n2"]


def test_aggregator_remove_node_keeps_arrived_contribution():
    agg = FedAvg()
    agg.set_nodes_to_aggregate(["n1", "n2"])
    m = mlp_model(seed=0, hidden_sizes=(8,), device="cpu")
    agg.add_model(ModelHandle(m.params, m.module, contributors=["n1"]))
    # n1 already contributed: its death must not drop the model
    assert agg.remove_node("n1") is False
    assert "n1" in agg.get_aggregated_models()
    # unknown node: no-op
    assert agg.remove_node("stranger") is False


# --- in-memory teardown hygiene ---------------------------------------------------------------


def test_inmemory_stop_with_handlers_in_flight_leaks_nothing():
    a, b = _mk(2)

    class Slow(Command):
        @staticmethod
        def get_name() -> str:
            return "slow"

        def execute(self, source, round, *args, **kwargs):
            time.sleep(0.5)

    b.add_command(Slow())
    a.connect(b.addr)
    for _ in range(8):  # more work than the 4 executor workers
        a.send(b.addr, a.build_msg("slow"))
    b_addr = b.addr
    b.stop()  # handlers still in flight
    a.stop()
    # registry entry released, address immediately reusable
    assert InMemoryRegistry.lookup(b_addr) is None
    fresh = InMemoryCommunicationProtocol(b_addr)
    fresh.start()
    fresh.stop()
    # executor worker threads are gone (bounded join in _server_stop)
    assert _wait(
        lambda: not any(t.name.startswith(f"memsrv-{b_addr}") and t.is_alive() for t in threading.enumerate()),
        timeout=5.0,
    ), [t.name for t in threading.enumerate()]


def test_inmemory_restart_same_addr_not_unregistered_by_old_instance():
    """Identity-guarded unregister: the OLD instance's late stop must not
    tear a restarted node out of the registry."""
    old = InMemoryCommunicationProtocol()
    old.start()
    addr = old.addr
    old.crash()  # unregisters old
    fresh = InMemoryCommunicationProtocol(addr)
    fresh.start()
    old.stop()  # late stop of the dead instance — must be a no-op
    try:
        assert InMemoryRegistry.lookup(addr) is fresh
    finally:
        fresh.stop()


def test_gossip_abandon_logs_and_counts(caplog):
    import logging

    sent = []
    g = Gossiper("mem://abandoner", send_fn=lambda n, e: sent.append(n), get_direct_neighbors_fn=lambda: [])
    fam = REGISTRY.get("p2pfl_gossip_abandoned_total")
    before = sum(c.value for _, c in fam.samples())
    with Settings.overridden(GOSSIP_EXIT_ON_X_EQUAL_ROUNDS=3):
        with caplog.at_level(logging.WARNING, logger="p2pfl_tpu_torch"):
            g.gossip_weights(
                early_stopping_fn=lambda: False,
                get_candidates_fn=lambda: ["mem://dead-peer"],
                status_fn=lambda: "stuck",  # never changes -> stall exit
                model_fn=lambda nei: None,
                period=0.01,
            )
    after = sum(c.value for _, c in fam.samples())
    assert after - before == 1
    assert any("ABANDONED" in r.message for r in caplog.records)


# --- Byzantine senders (test_byzantine.py's chaos-plane cases) ----------------------------------


def test_byzantine_attack_validation_and_active_flag():
    plane = ChaosPlane()
    with pytest.raises(ValueError, match="attack"):
        plane.set_byzantine("x", "meteor")
    assert not plane.active
    plane.set_byzantine("x", "signflip")
    assert plane.active
    assert plane.byzantine_peers() == {"x": "signflip"}
    plane.clear_byzantine("x")
    assert not plane.active
    plane.set_byzantine("x", "nan")
    plane.reset()
    assert not plane.active and plane.byzantine_peers() == {}


def test_byzantine_corruption_effects():
    m = _small_model()
    params = [p.numpy() for p in m.get_parameters()]
    payload = m.encode_parameters()
    env = Envelope.weights("adv", "partial_model", 0, payload, ["adv"], 128)
    plane = ChaosPlane()

    plane.set_byzantine("adv", "signflip")
    arrays, _ = deserialize_arrays(plane.corrupt_weights("adv", env).payload)
    np.testing.assert_allclose(np.asarray(arrays[0]), -params[0])

    plane.set_byzantine("adv", "scaled", scale=10.0)
    arrays, _ = deserialize_arrays(plane.corrupt_weights("adv", env).payload)
    np.testing.assert_allclose(np.asarray(arrays[0]), 10.0 * params[0], rtol=1e-6)

    plane.set_byzantine("adv", "nan")
    arrays, _ = deserialize_arrays(plane.corrupt_weights("adv", env).payload)
    assert not np.isfinite(np.asarray(arrays[0]).astype(np.float32)).any()

    plane.set_byzantine("adv", "inflate", inflate_factor=1000)
    out = plane.corrupt_weights("adv", env)
    assert out.num_samples == 128 * 1000
    assert out.payload == env.payload  # weights untouched by inflation

    # honest source / control frames are identity
    assert plane.corrupt_weights("honest", env) is env
    ctrl = Envelope.message("adv", "vote_train_set", args=["a", "1"])
    assert plane.corrupt_weights("adv", ctrl) is ctrl

    counts = plane.fault_counts()
    for attack in BYZANTINE_ATTACKS:
        assert counts.get(f"byzantine_{attack}", 0) >= 1, counts


def test_byzantine_corruption_deterministic():
    """Same attack + same frame sequence through two fresh planes =>
    identical corrupted payloads AND identical fault counts."""
    frame = _small_model().encode_parameters()
    outs = []
    for _ in range(2):
        plane = ChaosPlane()
        plane.set_byzantine("adv", "scaled")
        payloads = []
        for k in range(20):
            env = Envelope.weights("adv", "partial_model", k, frame, ["adv"], 1)
            payloads.append(plane.corrupt_weights("adv", env).payload)
        outs.append((payloads, plane.fault_counts()))
    assert outs[0] == outs[1]


def test_byzantine_through_real_send_path():
    """Corruption happens at the shared send choke point: a weights frame
    from a byzantine protocol arrives corrupted at the receiver."""
    received = []

    class Capture(Command):
        @staticmethod
        def get_name() -> str:
            return "partial_model"

        def execute(self, source: str, round: int, *args: str, **kwargs: Any) -> None:
            received.append(kwargs["weights"])

    a, b = _mk(2)
    b.add_command(Capture())
    try:
        a.connect(b.addr)
        m = _small_model()
        CHAOS.set_byzantine(a.addr, "signflip")
        try:
            a.send(b.addr, a.build_weights("partial_model", 0, m.encode_parameters(), ["a"], 1))
            assert _wait(lambda: received), "frame never arrived"
            arrays, _ = deserialize_arrays(received[0])
            np.testing.assert_allclose(np.asarray(arrays[0]), -m.get_parameters()[0].numpy())
            assert CHAOS.fault_counts().get("byzantine_signflip", 0) >= 1
        finally:
            CHAOS.reset()
    finally:
        a.stop()
        b.stop()


# --- against the JAX package's plane --------------------------------------------------------------

PAIRS = (("mem://node-0", "mem://node-1"), ("mem://node-1", "mem://node-0"),
         ("mem://node-0", "mem://node-2"), ("10.0.0.7:6666", "10.0.0.9:6666"))


def _both(**knobs):
    """The same overrides on the port's and the JAX package's settings."""
    import contextlib

    stack = contextlib.ExitStack()
    stack.enter_context(Settings.overridden(**knobs))
    stack.enter_context(JaxSettings.overridden(**knobs))
    return stack


@pytest.mark.parametrize("seed", [0, 7, 2**40 + 3])
def test_decision_streams_equal_reference_draw_for_draw(seed):
    """Port and JAX-package planes give the same decision for every one of
    500 sends on each of four pairs, with drop, duplicate and jitter on, and
    the same fault table."""
    knobs = dict(CHAOS_ENABLED=True, CHAOS_SEED=seed, CHAOS_DROP_RATE=0.2, CHAOS_DUPLICATE_RATE=0.3,
                 CHAOS_DELAY_S=0.001, CHAOS_DELAY_JITTER_S=0.01)
    port, ref = ChaosPlane(), JaxChaosPlane()
    port.set_slow("mem://node-2", 0.002)
    ref.set_slow("mem://node-2", 0.002)
    with _both(**knobs):
        got = [dataclasses.astuple(port.intercept(s, d)) for _ in range(500) for s, d in PAIRS]
        want = [dataclasses.astuple(ref.intercept(s, d)) for _ in range(500) for s, d in PAIRS]
    assert got == want
    assert port.fault_counts() == ref.fault_counts()
    assert {"drop", "delay", "duplicate"} <= set(port.fault_counts())


def test_jittered_backoff_equals_reference():
    for seed in (0, 11):
        with _both(CHAOS_SEED=seed, GOSSIP_SEND_BACKOFF=0.05):
            for src, dst in PAIRS:
                got = [jittered_backoff(src, dst, attempt) for attempt in range(6)]
                assert got == [jax_backoff(src, dst, attempt) for attempt in range(6)]
                assert len(set(got)) == 6


def test_planners_and_ladder_equal_reference():
    nodes = [f"mem://node-{i}" for i in range(7)]
    port, ref = ChaosPlane(), JaxChaosPlane()

    def same(fn_name, *args, **kwargs):
        got = [dataclasses.astuple(e) for e in getattr(port, fn_name)(*args, **kwargs)]
        assert got == [dataclasses.astuple(e) for e in getattr(ref, fn_name)(*args, **kwargs)], fn_name
        return got

    with _both(CHAOS_SEED=5):
        for seed in (None, 3):
            assert same("plan_churn", 6, nodes[:4], nodes[4:], seed=seed, leaves_per_round=2)
            assert same("plan_recovery", 8, nodes, seed=seed, partition_round=3, groups=3)
            assert same("plan_masker_dropout", 4, nodes[:5], seed=seed, drop_round=2)
            assert same("plan_host_faults", 10, seed=seed, kinds=("kill", "oom", "sigterm", "slow"))
        assert same("plan_recovery", 2, nodes, crash_round=5) == []
    for rounds, patience in ((0, 1), (7, 1), (9, 3)):
        assert adaptive_attack_schedule(rounds, patience=patience) == jax_schedule(rounds, patience=patience)
    assert adaptive_attack_schedule(5, ladder=("scaled", "signflip"), patience=2) == \
        jax_schedule(5, ladder=("scaled", "signflip"), patience=2)
    for plane in (port, ref):
        with pytest.raises(ValueError):
            plane.plan_host_faults(3, kinds=("meteor",))


def _reference_frames():
    """The JAX package's frames of one seeded MLP, by name: dense f32, bf16
    and int8, and the delta codec's top-k frames (coalesced bf16, int8,
    int4, float32; one bf16 frame not coalesced)."""
    from p2pfl_tpu.comm.delta import DeltaWireCodec as JaxCodec
    from test_torch_wire import _codec_pair

    jh, _, anchor = _codec_pair(2)
    frames = {f"dense {c}": bytes(jh.encode_parameters(compression=c)) for c in ("none", "bf16", "int8")}
    for values, coalesce in (("bf16", True), ("int8", True), ("int4", True), ("float32", True), ("bf16", False)):
        with JaxSettings.overridden(WIRE_COMPRESSION="topk", WIRE_TOPK_RATIO=0.1, WIRE_TOPK_VALUES=values,
                                    COALESCE_ENABLED=coalesce, QUANT_MIN_VALUES=4):
            codec = JaxCodec("adv")
            codec.set_anchor(anchor, 1)
            frames[f"topk {values}{'' if coalesce else ' loose'}"] = bytes(codec.encode_tagged(jh, 1)[0])
    return frames


@pytest.fixture(scope="module")
def reference_frames():
    return _reference_frames()


@pytest.mark.parametrize("attack", BYZANTINE_ATTACKS)
def test_corrupted_frames_byte_equal_reference(attack, reference_frames):
    """Each attack turns each of the JAX package's frames into the same
    bytes (and the same num_samples claim) through either plane."""
    port, ref = ChaosPlane(), JaxChaosPlane()
    port.set_byzantine("adv", attack, scale=7.5, inflate_factor=1000)
    ref.set_byzantine("adv", attack, scale=7.5, inflate_factor=1000)
    for name, frame in reference_frames.items():
        got = port.corrupt_weights("adv", Envelope.weights("adv", "partial_model", 1, frame, ["adv"], 9))
        want = ref.corrupt_weights("adv", JaxEnvelope.weights("adv", "partial_model", 1, frame, ["adv"], 9))
        assert got.payload == want.payload, (name, attack)
        assert got.num_samples == want.num_samples
        # a dense int8 frame holds no float tensor and no quantized spec:
        # both planes pass it through unchanged
        assert (got.payload != frame) == (attack != "inflate" and name != "dense int8"), name
    assert port.fault_counts() == ref.fault_counts() == {f"byzantine_{attack}": len(reference_frames)}
    JAX_CHAOS.reset()


@pytest.mark.parametrize("attack", ADAPTIVE_LADDER)
def test_adaptive_poison_bit_equal_reference(attack):
    rng = np.random.default_rng(4)
    for shape in ((33, 17), (257,), ()):
        new = np.asarray(rng.normal(size=shape), np.float32)
        old = np.asarray(new + 0.01 * rng.normal(size=shape), np.float32)
        got = adaptive_poison(torch.from_numpy(new), torch.from_numpy(old), attack)
        want = np.asarray(jax_adaptive_poison(new, old, attack))
        assert got.dtype == torch.float32 and tuple(got.shape) == shape
        np.testing.assert_array_equal(got.numpy().view(np.uint32), want.view(np.uint32))
        assert np.array_equal(adaptive_poison(new, old, attack).numpy(), got.numpy())  # numpy leaves too
    with pytest.raises(ValueError):
        adaptive_poison(torch.zeros(1), torch.zeros(1), "meteor")


@pytest.mark.parametrize("attack", ("signflip", "scaled", "nan"))
def test_bf16_attacks_equal_reference_on_every_bit_pattern(attack):
    """A dense bf16 frame holding all 65,536 bf16 bit patterns (NaNs of both
    signs and every payload, infinities, subnormals) corrupts to the JAX
    package's bytes (its ml_dtypes arithmetic); so does the coalesced value
    plane's negate-through-float32 path on the same values."""
    import ml_dtypes

    from p2pfl_tpu.ops.serialization import serialize_arrays as jax_serialize
    from p2pfl_tpu_torch.chaos.plane import _bf16_attack, _Byzantine

    bits = np.arange(1 << 16, dtype=np.uint32).astype(np.uint16)
    frame = bytes(jax_serialize([bits.view(ml_dtypes.bfloat16).reshape(256, 256)], {"num_samples": 1}))
    port, ref = ChaosPlane(), JaxChaosPlane()
    port.set_byzantine("adv", attack, scale=3.0)
    ref.set_byzantine("adv", attack, scale=3.0)
    with np.errstate(all="ignore"):
        got = port.corrupt_weights("adv", Envelope.weights("adv", "partial_model", 0, frame, [], 1))
        want = ref.corrupt_weights("adv", JaxEnvelope.weights("adv", "partial_model", 0, frame, [], 1))
        assert got.payload == want.payload
        vals = bits.view(ml_dtypes.bfloat16).astype(np.float32)
        plane = {"signflip": -vals, "scaled": vals * np.float32(3.0), "nan": np.full_like(vals, np.nan)}[attack]
        np.testing.assert_array_equal(_bf16_attack(bits, _Byzantine(attack, 3.0), negate_bits=False),
                                      plane.astype(ml_dtypes.bfloat16).view(np.uint16))
