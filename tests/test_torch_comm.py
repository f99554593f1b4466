"""The port's transport (``p2pfl_tpu_torch/comm/``) on the CPU: the
Node-free cases of the JAX package's ``test_communication.py`` (in-memory
transport), ``test_telemetry.py``, ``test_observatory.py`` and
``test_critical_path.py`` run against the port; its settings against the JAX
package's; and a mixed in-memory federation of port and JAX-package
protocols exchanging heartbeats, digests, gossiped commands and PFLT frames
both ways.

The port's singletons (``Settings``, ``InMemoryRegistry``, ``CHAOS``, the run
context, the live flight recorders) are not the JAX package's, so
``port_transport`` gives them what ``conftest.py`` gives the reference: the
fast test timings, and a clean slate after each test. Every wait polls
against a deadline.
"""

import json
import os
import subprocess
import sys
import threading
import time
import types
from pathlib import Path
from typing import Any

import numpy as np
import pytest

from p2pfl_tpu_torch.chaos import CHAOS
from p2pfl_tpu_torch.comm.commands.command import Command
from p2pfl_tpu_torch.comm.memory.memory_protocol import InMemoryCommunicationProtocol
from p2pfl_tpu_torch.comm.memory.registry import InMemoryRegistry
from p2pfl_tpu_torch.comm.protocol import CommunicationProtocol
from p2pfl_tpu_torch.config import Settings
from p2pfl_tpu_torch.exceptions import (
    CommunicationError,
    NeighborNotConnectedError,
    ProtocolNotStartedError,
)
from p2pfl_tpu_torch.telemetry import REGISTRY, TRACER, tracing

ROOT = Path(__file__).resolve().parents[1]


def reference_test_settings() -> dict:
    """The values ``p2pfl_tpu.utils.utils.set_test_settings`` gives the JAX
    package's settings, for the fields the port has."""
    import p2pfl_tpu.utils.utils as ref_utils

    rec = types.SimpleNamespace()
    saved, ref_utils.Settings = ref_utils.Settings, rec
    try:
        ref_utils.set_test_settings()
    finally:
        ref_utils.Settings = saved
    port = Settings.snapshot()
    return {k: v for k, v in vars(rec).items() if k in port}


@pytest.fixture(autouse=True)
def port_transport(monkeypatch, tmp_path):
    """The port's counterpart of ``conftest.py``'s fixtures: fast timings on
    the port's ``Settings`` (restored after), every port protocol the test
    started stopped, and the port's registry, chaos plane, run context and
    live flight recorders reset."""
    from p2pfl_tpu_torch.telemetry import bundle
    from p2pfl_tpu_torch.telemetry.flight_recorder import reset_live_recorders

    started = []
    start = CommunicationProtocol.start

    def tracked_start(self):
        started.append(self)
        start(self)

    monkeypatch.setattr(CommunicationProtocol, "start", tracked_start)
    snap = Settings.snapshot()
    Settings.restore(reference_test_settings())
    Settings.DOCTOR_BUNDLE_DIR = str(tmp_path / "bundles")
    try:
        yield
    finally:
        for p in started:
            try:
                p.stop()
            except Exception:  # noqa: BLE001 - a test's own failure is reported by the test
                pass
        InMemoryRegistry.reset()
        CHAOS.reset()
        Settings.restore(snap)
        bundle.reset_run()
        reset_live_recorders()


class MockCommand(Command):
    def __init__(self):
        self.calls = []

    @staticmethod
    def get_name() -> str:
        return "mock"

    def execute(self, source: str, round: int, *args: str, **kwargs: Any) -> None:
        self.calls.append((source, round, args))


def _mk(n, cls=InMemoryCommunicationProtocol):
    protos = [cls() for _ in range(n)]
    for p in protos:
        p.start()
    return protos


def _wait(cond, timeout=5.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if cond():
            return True
        time.sleep(0.05)
    return False


def rx_frames(proto, cmd: str) -> int:
    """Inbound envelopes ``proto`` has taken in for ``cmd`` (counted before
    dedup, so duplicates count too)."""
    fam = REGISTRY.get("p2pfl_gossip_rx_frames_total")
    return int(sum(c.value for lbl, c in fam.samples() if lbl == {"node": proto.addr, "cmd": cmd}))


# --- test_communication.py's in-memory cases ---------------------------------------


def test_not_started_raises():
    p = InMemoryCommunicationProtocol()
    with pytest.raises(ProtocolNotStartedError):
        p.connect("mem://nowhere")
    with pytest.raises(ProtocolNotStartedError):
        p.broadcast(p.build_msg("mock"))


def test_invalid_connect_raises():
    (p,) = _mk(1)
    try:
        with pytest.raises(CommunicationError):
            p.connect("mem://does-not-exist")
    finally:
        p.stop()


def test_send_to_unconnected_raises():
    a, b = _mk(2)
    try:
        with pytest.raises(NeighborNotConnectedError):
            a.send(b.addr, a.build_msg("mock"))
    finally:
        a.stop()
        b.stop()


def test_command_dispatch_and_ttl_gossip():
    a, b, c = _mk(3)
    cmds = {}
    for p in (a, b, c):
        cmd = MockCommand()
        cmds[p.addr] = cmd
        p.add_command(cmd)
    try:
        # line: a - b - c
        a.connect(b.addr)
        b.connect(c.addr)
        a.broadcast(a.build_msg("mock", args=["x", "y"], round=3))
        # direct delivery to b, TTL re-gossip to c
        assert _wait(lambda: cmds[b.addr].calls and cmds[c.addr].calls)
        src, rnd, args = cmds[c.addr].calls[0]
        assert src == a.addr and rnd == 3 and args == ("x", "y")
        # dedup: c re-gossips the message back to b, whose second copy must
        # not execute again (polls for that copy instead of sleeping)
        assert _wait(lambda: rx_frames(b, "mock") >= 2)
        assert len(cmds[b.addr].calls) == 1
        assert len(cmds[c.addr].calls) == 1
    finally:
        for p in (a, b, c):
            p.stop()


def test_neighbor_discovery_via_heartbeats():
    protos = _mk(5)
    try:
        for p in protos[1:]:
            p.connect(protos[0].addr)
        # star topology: heartbeat TTL-gossip should reveal everyone
        assert _wait(
            lambda: all(len(p.get_neighbors(only_direct=False)) == 4 for p in protos),
            timeout=8.0,
        ), {p.addr: p.get_neighbors() for p in protos}
        # direct neighbors stay as-connected
        assert len(protos[0].get_neighbors(only_direct=True)) == 4
        assert all(len(p.get_neighbors(only_direct=True)) == 1 for p in protos[1:])
    finally:
        for p in protos:
            p.stop()


def test_disconnect_reconvergence():
    a, b, c = _mk(3)
    try:
        b.connect(a.addr)
        c.connect(a.addr)
        assert _wait(lambda: len(a.get_neighbors()) == 2)
        c.stop()  # abrupt death
        assert _wait(lambda: c.addr not in a.get_neighbors(), timeout=8.0)
        assert _wait(lambda: c.addr not in b.get_neighbors(only_direct=False), timeout=8.0)
    finally:
        a.stop()
        b.stop()


def test_weights_envelope_roundtrip():
    a, b = _mk(2)
    received = {}

    class WeightsCmd(Command):
        @staticmethod
        def get_name() -> str:
            return "weights_test"

        def execute(self, source, round, *args, **kwargs):
            received.update(kwargs, source=source, round=round)

    b.add_command(WeightsCmd())
    try:
        a.connect(b.addr)
        env = a.build_weights("weights_test", 2, b"PAYLOAD", ["a", "b"], 17)
        a.send(b.addr, env)
        assert _wait(lambda: received)
        assert received["weights"] == b"PAYLOAD"
        assert received["contributors"] == ["a", "b"]
        assert received["num_samples"] == 17
        assert received["round"] == 2
    finally:
        a.stop()
        b.stop()


def test_unknown_command_is_contained():
    """An unregistered command must not crash the receiver or tear down the
    link; registered commands keep working after it."""
    a, b = _mk(2)
    try:
        cmd = MockCommand()
        b.add_command(cmd)
        a.connect(b.addr)
        assert _wait(lambda: b.addr in a.get_neighbors(only_direct=True))
        a.broadcast(a.build_msg("no-such-command", args=["x"]))
        # the receiver took the unknown frame in (polls instead of sleeping)
        assert _wait(lambda: rx_frames(b, "no-such-command") >= 1)
        a.broadcast(a.build_msg("mock", args=["after"]))
        assert _wait(lambda: any(args == ("after",) for _, _, args in cmd.calls))
        assert b.addr in a.get_neighbors(only_direct=True)
    finally:
        for p in (a, b):
            p.stop()


# --- test_telemetry.py, test_observatory.py, test_critical_path.py --------------------


def test_trace_propagates_across_in_memory_transport():
    """A control message sent inside a span on node A dispatches inside a
    receiver span on node B with the SAME trace id."""
    got = {}
    done = threading.Event()

    class Probe(Command):
        @staticmethod
        def get_name():
            return "trace_probe"

        def execute(self, source, round, *args, **kwargs):
            got["trace_id"] = tracing.current_trace_id()
            done.set()

    a = InMemoryCommunicationProtocol()
    b = InMemoryCommunicationProtocol()
    b.add_command(Probe())
    a.start()
    b.start()
    try:
        a.connect(b.addr)
        TRACER.reset()
        with TRACER.span("sender_side", node=a.addr) as ctx:
            a.send(b.addr, a.build_msg("trace_probe"))
        assert done.wait(5.0), "probe command never dispatched"
        assert got["trace_id"] == ctx.trace_id
        assert _wait(lambda: [s for s in TRACER.spans() if s.name == "recv:trace_probe"])
        recv = [s for s in TRACER.spans() if s.name == "recv:trace_probe"]
        assert recv[0].trace_id == ctx.trace_id and recv[0].parent_id == ctx.span_id
        assert recv[0].node == b.addr
    finally:
        a.stop()
        b.stop()


def test_untraced_envelopes_record_no_recv_spans():
    """Heartbeat-style traffic (no ambient span) must not churn the span
    buffer: recv_span is a no-op for an empty wire context."""
    a = InMemoryCommunicationProtocol()
    b = InMemoryCommunicationProtocol()
    a.start()
    b.start()
    try:
        a.connect(b.addr)
        beats = []
        beat = b.heartbeater.beat
        b.heartbeater.beat = lambda source, ts: (beats.append(ts), beat(source, ts))
        TRACER.reset()
        a.send(b.addr, a.build_msg("beat", args=["123.0"]))
        # the explicit beat was dispatched (polls instead of sleeping)
        assert _wait(lambda: 123.0 in beats)
        assert [s for s in TRACER.spans() if s.name.startswith("recv:")] == []
    finally:
        a.stop()
        b.stop()


def test_digests_ride_heartbeats_in_memory():
    a = InMemoryCommunicationProtocol()
    b = InMemoryCommunicationProtocol()
    c = InMemoryCommunicationProtocol()
    c.set_digest_source(None)  # digest-free node: pre-digest wire format
    for p in (a, b, c):
        p.start()
    try:
        b.connect(a.addr)
        c.connect(a.addr)
        # a and b must assemble each other (c emits nothing but still
        # ingests); all three keep beating on one shared wire.
        assert _wait(
            lambda: all(set(p.observatory.scores()) >= {a.addr, b.addr} for p in (a, b, c)), timeout=20.0
        ), {p.addr: sorted(p.observatory.scores()) for p in (a, b, c)}
        # The digest-free node never appears in anyone's fleet view...
        assert c.addr not in a.observatory.scores()
        # ...yet stays a first-class member of the federation.
        assert c.addr in a.get_neighbors()
        assert a.addr in c.get_neighbors()
    finally:
        for p in (a, b, c):
            p.stop()


def test_protocol_export_trace_annotates_node_and_skews(tmp_path):
    proto = InMemoryCommunicationProtocol("mem://trace-export-test")
    proto.heartbeater.beat("mem://peer", time.time() - 2.0)
    path = proto.export_trace(str(tmp_path / "trace.json"))
    with open(path) as f:
        doc = json.load(f)
    assert doc["metadata"]["node"] == "mem://trace-export-test"
    skews = doc["metadata"]["peer_clock_skew_s"]
    assert skews["mem://peer"] == pytest.approx(2.0, abs=1.0)
    assert "wall_epoch_s" in doc["metadata"]


# --- settings -----------------------------------------------------------------------

TRANSPORT_FIELDS = (
    "HEARTBEAT_PERIOD", "HEARTBEAT_TIMEOUT", "TTL", "GOSSIP_PERIOD", "GOSSIP_MESSAGES_PER_PERIOD",
    "GOSSIP_MODELS_PERIOD", "GOSSIP_MODELS_PER_ROUND", "GOSSIP_EXIT_ON_X_EQUAL_ROUNDS",
    "AMOUNT_LAST_MESSAGES_SAVED", "GOSSIP_SEND_RETRIES", "GOSSIP_SEND_BACKOFF", "CHAOS_ENABLED", "CHAOS_SEED",
    "CHAOS_DROP_RATE", "CHAOS_DELAY_S", "CHAOS_DELAY_JITTER_S", "CHAOS_DUPLICATE_RATE",
    "RECOVERY_PROBE_ENABLED", "RECOVERY_PROBE_MAX", "DIGEST_ENABLED", "DIGEST_EVERY_BEATS",
)
# Raw environment values tried on every field: garbage, and each side of the
# reference's bounds (0 / 1 / 10 / 16 / 1000 / 1024 and the int64 range).
RAW_VALUES = (None, "junk", "true", "-1", "-0.5", "0", "0.5", "1", "1.5", "10", "10.5", "16", "17", "1000", "1001",
              "1024", "1025", "9223372036854775807", "9223372036854775808", "-9223372036854775809")

SETTINGS_PROBE = """
import importlib, json, os, sys
mod = importlib.import_module(sys.argv[1])
out = []
for name, raw in json.loads(sys.argv[2]):
    key = "P2PFL_TPU_" + name
    if raw is not None:
        os.environ[key] = raw
    try:
        out.append(["ok", repr(getattr(importlib.reload(mod).Settings, name))])
    except ValueError:
        out.append(["ValueError", None])
    finally:
        os.environ.pop(key, None)
print(json.dumps(out))
"""


def test_transport_settings_match_reference_defaults_and_bounds():
    """Each transport / chaos / probe / digest setting the port added has the
    reference's default, parses the same environment values to the same
    value, and rejects the same ones at import."""
    cases = [[name, raw] for name in TRANSPORT_FIELDS for raw in RAW_VALUES]
    env = {k: v for k, v in os.environ.items() if not k.startswith("P2PFL_TPU_")}
    outs = {}
    for module in ("p2pfl_tpu_torch.config", "p2pfl_tpu.config"):
        proc = subprocess.run([sys.executable, "-c", SETTINGS_PROBE, module, json.dumps(cases)], cwd=ROOT, env=env,
                              capture_output=True, text=True, timeout=240)
        assert proc.returncode == 0, proc.stderr[-2000:]
        outs[module] = json.loads(proc.stdout.strip().splitlines()[-1])
    assert outs["p2pfl_tpu_torch.config"] == outs["p2pfl_tpu.config"]
    by_case = dict(zip(map(tuple, cases), outs["p2pfl_tpu_torch.config"]))
    assert by_case[("CHAOS_DROP_RATE", "1.5")][0] == "ValueError"  # the bounds are checked at all
    assert by_case[("DIGEST_EVERY_BEATS", "0")][0] == "ValueError"
    assert all(by_case[(name, None)][0] == "ok" for name in TRANSPORT_FIELDS)


# --- a mixed federation of port and JAX-package protocols --------------------------------


def test_mixed_federation_heartbeats_digests_gossip_and_frames(monkeypatch):
    """Port and JAX-package protocols on one in-memory wire (the port's
    registry pointed at the reference's, in this test only; explicit
    addresses, since both registries count ``mem://node-<n>`` on their own):
    a line port - reference - port - reference finds itself by heartbeats,
    each package ingests the other's digests, a TTL-gossiped command from an
    end reaches the far protocol of the other package, and dense PFLT frames
    of one seeded MLP decode across both ways to the sender's leaves."""
    from p2pfl_tpu.comm.commands.command import Command as RefCommand
    from p2pfl_tpu.comm.memory.memory_protocol import InMemoryCommunicationProtocol as RefProtocol
    from p2pfl_tpu.comm.memory.registry import InMemoryRegistry as RefRegistry
    from p2pfl_tpu.models.model_handle import decode_wire_frame as ref_decode
    from p2pfl_tpu_torch.comm.delta import DeltaWireCodec
    from test_torch_classification import mlp_handles

    monkeypatch.setattr(InMemoryRegistry, "_servers", RefRegistry._servers)
    monkeypatch.setattr(InMemoryRegistry, "_lock", RefRegistry._lock)

    def recorder(base):
        class Record(base):
            def __init__(self, name):
                self.name, self.calls = name, []

            def get_name(self):
                return self.name

            def execute(self, source, round, *args, **kwargs):
                self.calls.append((source, round, args, kwargs))

        return Record

    pa, pc = InMemoryCommunicationProtocol("mem://mixed-port-a"), InMemoryCommunicationProtocol("mem://mixed-port-c")
    rb, rd = RefProtocol("mem://mixed-ref-b"), RefProtocol("mem://mixed-ref-d")
    line = (pa, rb, pc, rd)
    cmds, frames = {}, {}
    for p in line:
        rec = recorder(Command if p in (pa, pc) else RefCommand)
        cmds[p.addr], frames[p.addr] = rec("mock"), rec("weights_test")
        p.add_command([cmds[p.addr], frames[p.addr]])
    try:
        for p in line:
            p.start()
        pa.connect(rb.addr)
        rb.connect(pc.addr)
        pc.connect(rd.addr)
        addrs = {p.addr for p in line}
        assert _wait(lambda: all(set(p.get_neighbors()) == addrs - {p.addr} for p in line), timeout=10.0), \
            {p.addr: p.get_neighbors() for p in line}
        assert _wait(lambda: all(set(p.observatory.scores()) >= addrs for p in line), timeout=10.0), \
            {p.addr: sorted(p.observatory.scores()) for p in line}

        pa.broadcast(pa.build_msg("mock", args=["from-port"], round=4))
        rd.broadcast(rd.build_msg("mock", args=["from-reference"], round=5))
        assert _wait(lambda: any(c[2] == ("from-port",) for c in cmds[rd.addr].calls)
                     and any(c[2] == ("from-reference",) for c in cmds[pa.addr].calls))
        assert (pa.addr, 4, ("from-port",), {}) in cmds[rd.addr].calls
        assert (rd.addr, 5, ("from-reference",), {}) in cmds[pa.addr].calls

        jh, ph = mlp_handles(3)
        jh.set_contribution(["mem://mixed-ref-b"], 11)
        ph.set_contribution(["mem://mixed-port-a"], 13)
        rb.send(pa.addr, rb.build_weights("weights_test", 2, jh.encode_parameters(), jh.contributors, 11))
        pa.send(rb.addr, pa.build_weights("weights_test", 2, ph.encode_parameters(), ph.contributors, 13))
        assert _wait(lambda: frames[pa.addr].calls and frames[rb.addr].calls)
        src, rnd, _, kw = frames[pa.addr].calls[0]
        assert (src, rnd, kw["num_samples"], kw["contributors"]) == (rb.addr, 2, 11, ["mem://mixed-ref-b"])
        leaves, meta = DeltaWireCodec(pa.addr, device="cpu").decode_frame(kw["weights"])
        assert meta["num_samples"] == 11
        for got, want in zip(leaves, jh.get_parameters(), strict=True):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        src, rnd, _, kw = frames[rb.addr].calls[0]
        assert (src, rnd, kw["num_samples"]) == (pa.addr, 2, 13)
        arrays, meta = ref_decode(kw["weights"])
        assert meta["contributors"] == ["mem://mixed-port-a"]
        for got, want in zip(arrays, ph.get_parameters(), strict=True):
            np.testing.assert_array_equal(np.asarray(got), want.numpy())
    finally:
        for p in line:
            p.stop()
