"""The port's gRPC transport (``p2pfl_tpu_torch/comm/grpc/``) on the CPU:
``_env_to_pb`` bytes equal to the JAX package's for the same envelopes (the
reserved trailing digest, trace and run-id args included) and ``_pb_to_env``
round-trips them; the schema is the JAX package's; the address cases; two
port Nodes training two MLP rounds over localhost gRPC; mTLS from the port's
certificates end to end, and clients without the CA's certificate refused; a
port Node and a JAX-package Node finishing two rounds together over real
gRPC sockets; and the two-process quickstart (``examples/node1.py`` /
``node2.py``) with ``--device cpu``.

Every federation test carries its own time limit (``_wait``'s timeout).
"""

import subprocess
import sys

import numpy as np
import pytest
import torch

from p2pfl_tpu.comm.envelope import Envelope as JaxEnvelope
from p2pfl_tpu.comm.grpc import grpc_protocol as jax_grpc
from p2pfl_tpu.comm.grpc.address import parse_address as jax_parse_address
from p2pfl_tpu.config import Settings as JaxSettings
from p2pfl_tpu_torch.comm.envelope import Envelope
from p2pfl_tpu_torch.comm.grpc import GrpcCommunicationProtocol, node_pb2
from p2pfl_tpu_torch.comm.grpc import grpc_protocol as port_grpc
from p2pfl_tpu_torch.comm.grpc.address import free_port, parse_address
from p2pfl_tpu_torch.config import Settings
from p2pfl_tpu_torch.exceptions import CommunicationError

from test_torch_comm import ROOT, MockCommand, _wait, port_transport  # noqa: F401
from test_torch_node import one_intra_op_thread  # noqa: F401

ENVELOPES = [
    dict(source="127.0.0.1:1", cmd="beat", round=3, args=["1.5"], ttl=7, msg_id=2**62 + 5,
         digest='{"v":2}', trace="ab:cd", run_id="run-9"),
    dict(source="[::1]:2", cmd="vote", round=0, args=["a", "", "b"], ttl=1, msg_id=1, trace="t:s"),
    dict(source="unix:/tmp/x", cmd="stop", args=[], ttl=0, msg_id=0),
    dict(source="h:3", cmd="ping", args=["x"], ttl=2, msg_id=9, run_id="r"),
    dict(source="h:4", cmd="partial_model", round=2, payload=b"PFLT\x00\xff" * 100,
         contributors=["h:4", "h:5"], num_samples=64),
]


@pytest.mark.parametrize("fields", ENVELOPES, ids=[e["cmd"] for e in ENVELOPES])
def test_env_to_pb_bytes_equal_the_jax_packages_and_round_trip(fields):
    got = port_grpc._env_to_pb(Envelope(**fields)).SerializeToString()
    ref = jax_grpc._env_to_pb(JaxEnvelope(**fields)).SerializeToString()
    assert got == ref
    back = port_grpc._pb_to_env(node_pb2.Envelope.FromString(got))
    want = Envelope(**fields)
    if want.is_weights:  # weights frames carry no ttl / id / trace slots
        want = Envelope(**{k: v for k, v in fields.items() if k not in ("ttl", "msg_id")})
    assert back == want
    # and the JAX package reads the port's message as its own
    assert jax_grpc._pb_to_env(jax_grpc.node_pb2.Envelope.FromString(got)).cmd == fields["cmd"]


def test_schema_and_service_are_the_jax_packages():
    from p2pfl_tpu.comm.grpc import node_pb2 as jax_pb2

    assert node_pb2.DESCRIPTOR.serialized_pb == jax_pb2.DESCRIPTOR.serialized_pb
    assert node_pb2.DESCRIPTOR.package == "p2pfl_tpu"
    assert port_grpc._SERVICE == jax_grpc._SERVICE == "p2pfl_tpu.NodeService"
    assert (ROOT / "p2pfl_tpu_torch/comm/grpc/node.proto").read_bytes() == \
        (ROOT / "p2pfl_tpu/comm/grpc/node.proto").read_bytes()
    out = subprocess.run([sys.executable, "-m", "p2pfl_tpu_torch.comm.grpc.generate_proto", "--check"], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


@pytest.mark.parametrize("addr,want", [
    ("127.0.0.1:5000", "127.0.0.1:5000"),
    ("localhost:6", "localhost:6"),
    ("[::1]:7000", "[::1]:7000"),
    ("unix:/tmp/p2pfl.sock", "unix:/tmp/p2pfl.sock"),
    ("unix:///tmp/p2pfl.sock", "unix:///tmp/p2pfl.sock"),
])
def test_address_cases_equal_the_jax_packages(addr, want):
    assert parse_address(addr) == jax_parse_address(addr) == (want, want)


@pytest.mark.parametrize("addr,pattern", [(None, "127.0.0.1:"), ("", "127.0.0.1:"), ("10.0.0.1", "10.0.0.1:"),
                                          ("::1", "[::1]:"), ("myhost", "myhost:")])
def test_address_without_a_port_gets_a_free_one(addr, pattern):
    target, public = parse_address(addr)
    assert target == public and target.startswith(pattern)
    assert 0 < int(target.rsplit(":", 1)[1]) < 65536
    assert 0 < free_port() < 65536


def _mk(n):
    protos = [GrpcCommunicationProtocol("127.0.0.1") for _ in range(n)]
    for p in protos:
        p.start()
    return protos


def test_grpc_ttl_gossip_is_forwarded_and_a_failed_send_removes_the_neighbor():
    a, b, c = _mk(3)
    cmds = {}
    for p in (a, b, c):
        cmds[p.addr] = MockCommand()
        p.add_command(cmds[p.addr])
    try:
        # line: a - b - c; a does not know c, b re-gossips a's TTL'd message
        a.connect(b.addr)
        b.connect(c.addr)
        assert _wait(lambda: b.addr in a.get_neighbors() and c.addr in b.get_neighbors())
        a.broadcast(a.build_msg("mock", args=["hop"], round=1))
        assert _wait(lambda: cmds[b.addr].calls and cmds[c.addr].calls, timeout=10.0)
        assert cmds[c.addr].calls[0] == (a.addr, 1, ("hop",))
        c.crash()  # no goodbye: b learns of it from the failed send
        with pytest.raises(CommunicationError):
            b.send(c.addr, b.build_msg("mock"), raise_error=True)
        assert _wait(lambda: c.addr not in b.get_neighbors())
    finally:
        for p in (a, b):
            p.stop()


GRPC_FIELDS = ("GRPC_TIMEOUT", "USE_SSL", "SSL_SERVER_KEY", "SSL_SERVER_CRT", "SSL_CLIENT_KEY", "SSL_CLIENT_CRT",
               "SSL_CA_CRT", "NO_NATIVE")


def test_grpc_and_native_settings_match_the_jax_packages():
    """The eight fields the transport and the codec read: the JAX package's
    defaults, and the same value (or the same refusal) for every raw
    environment value."""
    import json
    import os

    from test_torch_comm import RAW_VALUES, SETTINGS_PROBE

    cases = [[name, raw] for name in GRPC_FIELDS for raw in RAW_VALUES]
    env = {k: v for k, v in os.environ.items() if not k.startswith("P2PFL_TPU_")}
    outs = {}
    for module in ("p2pfl_tpu_torch.config", "p2pfl_tpu.config"):
        proc = subprocess.run([sys.executable, "-c", SETTINGS_PROBE, module, json.dumps(cases)], cwd=ROOT, env=env,
                              capture_output=True, text=True, timeout=240)
        assert proc.returncode == 0, proc.stderr[-2000:]
        outs[module] = json.loads(proc.stdout.strip().splitlines()[-1])
    assert outs["p2pfl_tpu_torch.config"] == outs["p2pfl_tpu.config"]
    assert all(getattr(Settings, f) == getattr(JaxSettings, f) for f in GRPC_FIELDS if f != "GRPC_TIMEOUT")


def _grpc_settings(both=False):
    for s in (Settings, JaxSettings) if both else (Settings,):
        s.RESOURCE_MONITOR_PERIOD = 0
        s.GRPC_TIMEOUT = 10.0
        # No Node dies in these runs: a write-off could only be a starved
        # beat (the JAX Nodes' first fit compiles), as in parity.run_wire.
        s.HEARTBEAT_TIMEOUT = 30.0
        s.GOSSIP_EXIT_ON_X_EQUAL_ROUNDS = 400
        s.AGGREGATION_STALL_PATIENCE = 60.0
        s.AGGREGATION_TIMEOUT = 120.0


def _final(node):
    return [np.asarray(p.detach().cpu() if isinstance(p, torch.Tensor) else p)
            for p in node.learner.get_model().get_parameters()]


def test_two_port_nodes_train_two_rounds_over_grpc():
    from p2pfl_tpu_torch.learning.aggregators import CanonicalFedAvg
    from p2pfl_tpu_torch.learning.dataset import RandomIIDPartitionStrategy, synthetic_mnist
    from p2pfl_tpu_torch.models.mlp import mlp_model
    from p2pfl_tpu_torch.node import Node

    _grpc_settings()
    parts = synthetic_mnist(n_train=256, n_test=64).generate_partitions(2, RandomIIDPartitionStrategy)
    nodes = [Node(mlp_model(0, hidden_sizes=(16, 8), device="cpu"), parts[i], addr="127.0.0.1",
                  protocol=GrpcCommunicationProtocol, aggregator=CanonicalFedAvg(), batch_size=64, seed=i,
                  device="cpu") for i in range(2)]
    try:
        for nd in nodes:
            nd.start()
        nodes[1].connect(nodes[0].addr)
        assert _wait(lambda: all(len(nd.get_neighbors()) == 1 for nd in nodes), timeout=15.0)
        nodes[0].set_start_learning(rounds=2, epochs=1)
        assert _wait(lambda: all(not nd.learning_in_progress() and nd.learning_workflow is not None
                                 for nd in nodes), timeout=90.0)
        for nd in nodes:
            assert nd.learning_workflow.history.count("RoundFinishedStage") == 2, nd.learning_workflow.history
            assert nd.protocol.gossiper.bytes_for_round(0) > 0
        for a, b in zip(*(_final(nd) for nd in nodes)):
            np.testing.assert_array_equal(a, b)
    finally:
        for nd in nodes:
            nd.stop()


def _mtls(paths):
    return dict(USE_SSL=True, SSL_CA_CRT=paths["ca_crt"], SSL_SERVER_KEY=paths["server_key"],
                SSL_SERVER_CRT=paths["server_crt"], SSL_CLIENT_KEY=paths["client_key"],
                SSL_CLIENT_CRT=paths["client_crt"])


def test_mtls_from_the_ports_certificates_end_to_end(tmp_path):
    from test_torch_comm import Command

    from p2pfl_tpu_torch.utils.certificates import generate_certificates

    paths = generate_certificates(str(tmp_path))
    received = {}

    class WeightsCmd(Command):
        @staticmethod
        def get_name() -> str:
            return "weights_test"

        def execute(self, source, round, *args, **kwargs):
            received.update(kwargs, source=source, round=round)

    with Settings.overridden(**_mtls(paths)):
        a, b = _mk(2)
        cmd = MockCommand()
        b.add_command(cmd)
        b.add_command(WeightsCmd())
        try:
            a.connect(b.addr)
            assert _wait(lambda: b.addr in a.get_neighbors())
            a.send(b.addr, a.build_msg("mock", args=["secure"], round=1))
            assert _wait(lambda: cmd.calls)
            assert cmd.calls[0][2] == ("secure",)
            a.send(b.addr, a.build_weights("weights_test", 1, bytearray(b"TLS-PAYLOAD"), ["a"], 3))
            assert _wait(lambda: received.get("weights") == b"TLS-PAYLOAD")
            assert received["num_samples"] == 3 and received["round"] == 1
        finally:
            a.stop()
            b.stop()


def test_mtls_refuses_a_client_without_the_cas_certificate(tmp_path):
    import grpc

    from p2pfl_tpu_torch.utils.certificates import generate_certificates

    paths = generate_certificates(str(tmp_path / "good"))
    rogue = generate_certificates(str(tmp_path / "rogue"))  # another CA
    with Settings.overridden(**_mtls(paths)):
        (server,) = _mk(1)
    try:
        # a certificate signed by another CA, trusting the right one
        with Settings.overridden(**{**_mtls(rogue), "SSL_CA_CRT": paths["ca_crt"]}):
            (client,) = _mk(1)
            try:
                with pytest.raises(CommunicationError):
                    client.connect(server.addr)
            finally:
                client.stop()
        # no client certificate at all, and a plaintext channel
        ca = open(paths["ca_crt"], "rb").read()
        for channel in (grpc.secure_channel(server.addr, grpc.ssl_channel_credentials(root_certificates=ca)),
                        grpc.insecure_channel(server.addr)):
            call = channel.unary_unary(f"/{port_grpc._SERVICE}/Handshake",
                                       request_serializer=node_pb2.Hello.SerializeToString,
                                       response_deserializer=node_pb2.Ack.FromString)
            with pytest.raises(grpc.RpcError):
                call(node_pb2.Hello(addr="intruder"), timeout=5.0)
            channel.close()
        assert server.get_neighbors() == []
    finally:
        server.stop()


def test_a_port_node_and_a_jax_node_finish_two_rounds_over_grpc(one_intra_op_thread):  # noqa: F811
    """One port Node and one JAX-package Node, f32 MLPs from one seed, real
    gRPC sockets (the same service on both), ``CanonicalFedAvg`` on both:
    two rounds on both, final parameters within 1e-5."""
    from p2pfl_tpu.comm.grpc import GrpcCommunicationProtocol as JaxGrpc
    from p2pfl_tpu.learning.aggregators import CanonicalFedAvg as RefCanonicalFedAvg
    from p2pfl_tpu.learning.dataset import RandomIIDPartitionStrategy as RefIID
    from p2pfl_tpu.learning.dataset import synthetic_mnist as ref_mnist
    from p2pfl_tpu.node import Node as RefNode
    from p2pfl_tpu.utils.utils import set_test_settings as ref_test_settings
    from p2pfl_tpu_torch.learning.aggregators import CanonicalFedAvg
    from p2pfl_tpu_torch.learning.dataset import RandomIIDPartitionStrategy, synthetic_mnist
    from p2pfl_tpu_torch.node import Node
    from test_torch_classification import mlp_handles

    ref_test_settings()
    _grpc_settings(both=True)
    kw = dict(n_train=2 * 128, n_test=64)
    ref_parts = ref_mnist(**kw).generate_partitions(2, RefIID)
    parts = synthetic_mnist(**kw).generate_partitions(2, RandomIIDPartitionStrategy)
    jh, ph = mlp_handles(0)
    with JaxSettings.overridden(COMPUTE_DTYPE="float32"):
        nodes = [Node(ph, parts[0], addr="127.0.0.1", protocol=GrpcCommunicationProtocol,
                      aggregator=CanonicalFedAvg(), batch_size=32, lr=1e-3, seed=0, device="cpu"),
                 RefNode(jh, ref_parts[1], addr="127.0.0.1", protocol=JaxGrpc, aggregator=RefCanonicalFedAvg(),
                         batch_size=32, lr=1e-3, seed=1)]
        try:
            for nd in nodes:
                nd.start()
            nodes[1].connect(nodes[0].addr)
            assert _wait(lambda: all(len(nd.get_neighbors()) == 1 for nd in nodes), timeout=15.0)
            nodes[0].set_start_learning(rounds=2, epochs=1)
            assert _wait(lambda: all(not nd.learning_in_progress() and nd.learning_workflow is not None
                                     for nd in nodes), timeout=120.0)
            for nd in nodes:
                assert nd.learning_workflow.history.count("RoundFinishedStage") == 2, nd.learning_workflow.history
            for a, b in zip(*(_final(nd) for nd in nodes)):
                np.testing.assert_allclose(a, b, atol=1e-5, rtol=0)
        finally:
            for nd in nodes:
                nd.stop()


def test_node1_and_node2_quickstart_in_two_processes():
    port = free_port()
    env_cmd = [sys.executable, "-m", "p2pfl_tpu_torch.examples"]
    common = ["--device", "cpu", "--wait", "60"]
    node1 = subprocess.Popen([*env_cmd[:2], "p2pfl_tpu_torch.examples.node1", "--addr", f"127.0.0.1:{port}",
                              "--rounds", "1", *common], cwd=ROOT, stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True)
    try:
        node2 = subprocess.run([*env_cmd[:2], "p2pfl_tpu_torch.examples.node2", "--peer", f"127.0.0.1:{port}",
                                *common], cwd=ROOT, capture_output=True, text=True, timeout=150)
        out1, _ = node1.communicate(timeout=60)
    finally:
        node1.kill()
    assert node1.returncode == 0 and node2.returncode == 0, out1[-3000:] + node2.stdout[-2000:] + node2.stderr[-2000:]
    assert "done:" in out1 and "test_acc" in out1 and "done:" in node2.stdout


WITHOUT_GRPC = """
import importlib, pkgutil, sys
for name in ("grpc", "google.protobuf", "cryptography", "keras", "tensorflow"):
    sys.modules[name] = None  # the card's machine may lack each of them
import p2pfl_tpu_torch
names = [m.name for m in pkgutil.walk_packages(p2pfl_tpu_torch.__path__, "p2pfl_tpu_torch.")]
grpc_names = [n for n in names if n.startswith("p2pfl_tpu_torch.comm.grpc")]
for name in names:
    if name not in grpc_names:
        importlib.import_module(name)
try:
    importlib.import_module("p2pfl_tpu_torch.comm.grpc")
except ImportError:
    pass
else:
    raise AssertionError("the gRPC package imported without grpc")
from p2pfl_tpu_torch.learning.interop import KERAS_AVAILABLE
print(len(names), len(grpc_names), KERAS_AVAILABLE)
"""


def test_the_port_imports_without_grpc_protobuf_cryptography_or_keras():
    """``p2pfl_tpu_torch.comm`` (and every module but the gRPC package's
    own) imports where grpcio, protobuf, cryptography and keras are
    missing."""
    out = subprocess.run([sys.executable, "-c", WITHOUT_GRPC], cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    total, grpc_modules, keras = out.stdout.split()
    assert int(total) > 100 and int(grpc_modules) >= 1 and keras == "False"
