"""In-process transport for single-host simulation and tests."""

from p2pfl_tpu_torch.comm.memory.memory_protocol import InMemoryCommunicationProtocol  # noqa: F401
