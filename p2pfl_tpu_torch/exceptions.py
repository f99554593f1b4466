"""Framework exceptions (a copy of ``p2pfl_tpu/exceptions.py``; the port keeps
its own, since it imports nothing of the JAX package).

Parity with the reference's exception surface (p2pfl/exceptions.py,
p2pfl/communication/protocols/exceptions.py,
p2pfl/learning/frameworks/exceptions.py — SURVEY.md §2.1).
"""


class P2pflTpuError(Exception):
    """Base class for all framework errors."""


class NodeRunningException(P2pflTpuError):
    """Operation requires the node to be stopped (or vice versa)."""


class ZeroRoundsException(P2pflTpuError):
    """Learning was started with zero rounds."""


class LearningRunningException(P2pflTpuError):
    """Operation not allowed while a learning session is in progress."""


class ProtocolNotStartedError(P2pflTpuError):
    """The communication protocol was used before ``start()``."""


class NeighborNotConnectedError(P2pflTpuError):
    """Tried to message a neighbor that is not connected."""


class CommunicationError(P2pflTpuError):
    """Transport-level send/connect failure."""


class DecodingParamsError(P2pflTpuError):
    """Received a weights payload that could not be decoded."""


class DeltaAnchorError(P2pflTpuError):
    """A sparse delta frame could not be applied: the receiver holds no round
    anchor for the frame's round (yet). NOT a corruption error — the frame is
    valid, the receiver is just out of phase; the caller drops it and the
    gossip loop re-ships on a later tick (comm/delta.py)."""


class ModelNotMatchingError(P2pflTpuError):
    """Received parameters do not match the local model's structure."""
