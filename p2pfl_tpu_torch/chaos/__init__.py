"""Chaos/fault-injection plane: deterministic message drop, delay, duplication,
partitions, crash simulation and Byzantine peer behaviors on the transport
send path (see :mod:`p2pfl_tpu_torch.chaos.plane`, the port's copy of
``p2pfl_tpu/chaos/plane.py``)."""

from p2pfl_tpu_torch.chaos.plane import (  # noqa: F401
    BYZANTINE_ATTACKS,
    CHAOS,
    HOST_FAULT_KINDS,
    ChaosPlane,
    ChurnEvent,
    Decision,
    HostFaultEvent,
    RecoveryEvent,
)

__all__ = [
    "BYZANTINE_ATTACKS",
    "CHAOS",
    "HOST_FAULT_KINDS",
    "ChaosPlane",
    "ChurnEvent",
    "Decision",
    "HostFaultEvent",
    "RecoveryEvent",
]
