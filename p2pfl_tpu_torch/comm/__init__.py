"""The port's communication plane: envelopes, the protocol (membership,
gossip, heartbeats, command dispatch, the chaos intercept), the in-memory
transport (``memory/``), the sparse-delta wire codec (``delta.py``), wire
admission (``admission.py``) and the Node's commands (``commands/impl.py``)."""

from p2pfl_tpu_torch.comm.envelope import Envelope  # noqa: F401
from p2pfl_tpu_torch.comm.protocol import CommunicationProtocol  # noqa: F401
