"""gRPC transport for real (multi-process / multi-host) federations (the
port's copy of ``p2pfl_tpu/comm/grpc/``; same schema, same service paths,
so a port Node and a JAX-package Node talk over gRPC).

Importing this package imports ``grpc`` and ``google.protobuf``;
``p2pfl_tpu_torch.comm`` itself does not, so the port runs where they are
not installed."""

from p2pfl_tpu_torch.comm.grpc.grpc_protocol import GrpcCommunicationProtocol  # noqa: F401
