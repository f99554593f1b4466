"""gRPC communication protocol (the port's copy of
``p2pfl_tpu/comm/grpc/grpc_protocol.py``: the same schema, service paths,
reserved trailing control args and PFLT payloads, so port Nodes and
JAX-package Nodes federate over it).

Capability parity with the reference's gRPC stack
(grpc_communication_protocol.py:50-263, grpc_server.py:36-237,
grpc_client.py:35-208, grpc_neighbors.py:32-144): handshake/disconnect/send
unary RPCs, 1 GiB message cap, optional mTLS from Settings, send-failure
removes the neighbor, TTL-decrement re-gossip on the server side.

Implementation notes (departures by design):
* the service is registered through grpc's *generic handler* API with
  serializers from the protoc-generated ``node_pb2`` (no grpcio-tools, no
  generated stub class) — the same wire format.
* the server thread pool is 8 workers (the reference caps at 2,
  grpc_server.py:67, which serializes model reception).
"""

from __future__ import annotations

import concurrent.futures
import logging
from typing import Any, Optional

import grpc

from p2pfl_tpu_torch.comm.envelope import Envelope
from p2pfl_tpu_torch.comm.grpc import node_pb2
from p2pfl_tpu_torch.comm.grpc.address import parse_address
from p2pfl_tpu_torch.comm.neighbors import Neighbors
from p2pfl_tpu_torch.comm.protocol import CommunicationProtocol
from p2pfl_tpu_torch.config import Settings
from p2pfl_tpu_torch.exceptions import CommunicationError
from p2pfl_tpu_torch.telemetry import bundle as bundle_mod
from p2pfl_tpu_torch.telemetry import digest as digest_mod
from p2pfl_tpu_torch.telemetry import tracing

log = logging.getLogger("p2pfl_tpu_torch")

_SERVICE = "p2pfl_tpu.NodeService"


def _env_to_pb(env: Envelope) -> node_pb2.Envelope:
    pb = node_pb2.Envelope(source=env.source, cmd=env.cmd, round=env.round)
    if env.is_weights:
        # protobuf only accepts bytes; the native codec hands out bytearray.
        # No trace slot here: traced weights frames carry their span context
        # in the PFLT header (tracing.TRACE_META_KEY) instead.
        pb.weights.payload = bytes(env.payload)
        pb.weights.contributors.extend(env.contributors)
        pb.weights.num_samples = env.num_samples
    else:
        pb.control.args.extend(env.args)
        if env.digest:
            # Reserved trailing args (digest, then trace, then run id,
            # popped in reverse by _pb_to_env): the schema predates
            # tracing and digests and stays the JAX package's byte for
            # byte; every receiver strips these before dispatch, and a
            # version-skewed peer just sees extra args (handlers index
            # from the front).
            pb.control.args.append(digest_mod.WIRE_ARG_PREFIX + env.digest)
        if env.trace:
            pb.control.args.append(tracing.WIRE_ARG_PREFIX + env.trace)
        if env.run_id:
            pb.control.args.append(bundle_mod.WIRE_ARG_PREFIX + env.run_id)
        pb.control.ttl = env.ttl
        pb.control.msg_id = env.msg_id
    return pb


def _pb_to_env(pb: node_pb2.Envelope) -> Envelope:
    if pb.WhichOneof("body") == "weights":
        return Envelope(
            source=pb.source,
            cmd=pb.cmd,
            round=pb.round,
            payload=bytes(pb.weights.payload),
            contributors=list(pb.weights.contributors),
            num_samples=int(pb.weights.num_samples),
        )
    args = list(pb.control.args)
    run_id = ""
    if args and args[-1].startswith(bundle_mod.WIRE_ARG_PREFIX):
        run_id = args.pop()[len(bundle_mod.WIRE_ARG_PREFIX):]
    trace = ""
    if args and args[-1].startswith(tracing.WIRE_ARG_PREFIX):
        trace = args.pop()[len(tracing.WIRE_ARG_PREFIX):]
    digest = ""
    if args and args[-1].startswith(digest_mod.WIRE_ARG_PREFIX):
        digest = args.pop()[len(digest_mod.WIRE_ARG_PREFIX):]
    return Envelope(
        source=pb.source,
        cmd=pb.cmd,
        round=pb.round,
        args=args,
        ttl=int(pb.control.ttl),
        msg_id=int(pb.control.msg_id),
        trace=trace,
        digest=digest,
        run_id=run_id,
    )


class _GrpcConnection:
    """Channel + unary callables for one neighbor."""

    def __init__(self, addr: str, self_addr: str) -> None:
        options = [
            ("grpc.max_send_message_length", Settings.MAX_MESSAGE_BYTES),
            ("grpc.max_receive_message_length", Settings.MAX_MESSAGE_BYTES),
        ]
        if Settings.USE_SSL:
            with open(Settings.SSL_CLIENT_KEY, "rb") as f:
                key = f.read()
            with open(Settings.SSL_CLIENT_CRT, "rb") as f:
                crt = f.read()
            with open(Settings.SSL_CA_CRT, "rb") as f:
                ca = f.read()
            creds = grpc.ssl_channel_credentials(
                root_certificates=ca, private_key=key, certificate_chain=crt
            )
            self.channel = grpc.secure_channel(addr, creds, options=options)
        else:
            self.channel = grpc.insecure_channel(addr, options=options)
        self._self_addr = self_addr
        self.handshake = self.channel.unary_unary(
            f"/{_SERVICE}/Handshake",
            request_serializer=node_pb2.Hello.SerializeToString,
            response_deserializer=node_pb2.Ack.FromString,
        )
        self.disconnect = self.channel.unary_unary(
            f"/{_SERVICE}/Disconnect",
            request_serializer=node_pb2.Hello.SerializeToString,
            response_deserializer=node_pb2.Ack.FromString,
        )
        self.send = self.channel.unary_unary(
            f"/{_SERVICE}/Send",
            request_serializer=node_pb2.Envelope.SerializeToString,
            response_deserializer=node_pb2.Ack.FromString,
        )

    def close(self) -> None:
        try:
            self.channel.close()
        except Exception:
            pass


class _GrpcNeighbors(Neighbors):
    def connect_to(self, addr: str, *, handshake: bool) -> _GrpcConnection:
        conn = _GrpcConnection(addr, self.self_addr)
        if handshake:
            try:
                ack = conn.handshake(
                    node_pb2.Hello(addr=self.self_addr), timeout=Settings.GRPC_TIMEOUT
                )
                if ack.error:
                    raise CommunicationError(ack.error)
            except grpc.RpcError as exc:
                conn.close()
                raise CommunicationError(f"handshake with {addr} failed: {exc.code()}") from exc
        return conn

    def disconnect_from(self, addr: str, conn: _GrpcConnection, *, notify: bool) -> None:
        if notify:
            try:
                conn.disconnect(
                    node_pb2.Hello(addr=self.self_addr), timeout=Settings.GRPC_TIMEOUT
                )
            except grpc.RpcError:
                pass
        conn.close()


class GrpcCommunicationProtocol(CommunicationProtocol):
    """Real-network transport (reference grpc_communication_protocol.py:50)."""

    def __init__(self, addr: Optional[str] = None) -> None:
        bind_target, public = parse_address(addr)
        self._bind_target = bind_target
        super().__init__(public)
        self._server: Optional[grpc.Server] = None

    def _default_addr(self) -> str:  # pragma: no cover - set via __init__
        raise RuntimeError("address resolved in __init__")

    def _build_neighbors(self, addr: str) -> Neighbors:
        return _GrpcNeighbors(addr)

    # --- server -------------------------------------------------------------

    def _server_start(self) -> None:
        protocol = self

        def handshake(request: node_pb2.Hello, context: Any) -> node_pb2.Ack:
            try:
                protocol.neighbors.add(request.addr, non_direct=False, handshake=False)
                return node_pb2.Ack()
            except Exception as exc:  # pragma: no cover
                return node_pb2.Ack(error=str(exc))

        def disconnect(request: node_pb2.Hello, context: Any) -> node_pb2.Ack:
            # Graceful goodbye from the peer — not a failure departure.
            protocol.neighbors.remove(request.addr, notify=False, departed=False)
            return node_pb2.Ack()

        def send(request: node_pb2.Envelope, context: Any) -> node_pb2.Ack:
            try:
                protocol.handle_envelope(_pb_to_env(request))
                return node_pb2.Ack()
            except Exception as exc:
                log.exception("error handling %s from %s", request.cmd, request.source)
                return node_pb2.Ack(error=str(exc))

        rpcs = {
            "Handshake": grpc.unary_unary_rpc_method_handler(
                handshake,
                request_deserializer=node_pb2.Hello.FromString,
                response_serializer=node_pb2.Ack.SerializeToString,
            ),
            "Disconnect": grpc.unary_unary_rpc_method_handler(
                disconnect,
                request_deserializer=node_pb2.Hello.FromString,
                response_serializer=node_pb2.Ack.SerializeToString,
            ),
            "Send": grpc.unary_unary_rpc_method_handler(
                send,
                request_deserializer=node_pb2.Envelope.FromString,
                response_serializer=node_pb2.Ack.SerializeToString,
            ),
        }
        self._server = grpc.server(
            concurrent.futures.ThreadPoolExecutor(
                max_workers=8, thread_name_prefix=f"grpc-{self.addr}"
            ),
            handlers=[grpc.method_handlers_generic_handler(_SERVICE, rpcs)],
            options=[
                ("grpc.max_send_message_length", Settings.MAX_MESSAGE_BYTES),
                ("grpc.max_receive_message_length", Settings.MAX_MESSAGE_BYTES),
            ],
        )
        if Settings.USE_SSL:
            with open(Settings.SSL_SERVER_KEY, "rb") as f:
                key = f.read()
            with open(Settings.SSL_SERVER_CRT, "rb") as f:
                crt = f.read()
            with open(Settings.SSL_CA_CRT, "rb") as f:
                ca = f.read()
            creds = grpc.ssl_server_credentials(
                [(key, crt)], root_certificates=ca, require_client_auth=True
            )
            port = self._server.add_secure_port(self._bind_target, creds)
        else:
            port = self._server.add_insecure_port(self._bind_target)
        if port == 0:
            raise CommunicationError(f"could not bind gRPC server at {self._bind_target}")
        self._server.start()

    def _server_stop(self) -> None:
        if self._server is not None:
            self._server.stop(grace=0.5)
            self._server = None

    # --- client -------------------------------------------------------------

    def _transport_send(self, nei: str, env: Envelope) -> None:
        conn = self.neighbors.get(nei)
        if conn is None:
            # Non-direct neighbor: open a transient connection (reference
            # create_connection path, grpc_client.py:140-160).
            conn = _GrpcConnection(nei, self.addr)
            try:
                ack = conn.send(_env_to_pb(env), timeout=Settings.GRPC_TIMEOUT)
            finally:
                conn.close()
        else:
            ack = conn.send(_env_to_pb(env), timeout=Settings.GRPC_TIMEOUT)
        if ack.error:
            raise CommunicationError(f"{nei} rejected {env.cmd}: {ack.error}")
