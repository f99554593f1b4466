"""Transport-agnostic message envelope (the port's copy of
``p2pfl_tpu/comm/envelope.py``: the same fields in the same order, so the
in-memory transports of both packages hand each other these dataclasses).

Plays the role of the reference's protobuf ``RootMessage`` with its
``Message``/``Weights`` oneof (grpc/proto/node.proto:26-59): a command name
plus either small string args (control plane, TTL-gossiped) or a weights
payload (model plane). Both transports carry this same shape — the in-memory
transport passes the dataclass directly, the gRPC transport maps it onto its
proto schema.
"""

from __future__ import annotations

import secrets
from dataclasses import dataclass, field
from typing import List, Optional

from p2pfl_tpu_torch.config import Settings
from p2pfl_tpu_torch.telemetry import tracing
from p2pfl_tpu_torch.telemetry.bundle import current_run_id


@dataclass
class Envelope:
    source: str
    cmd: str
    round: int = 0
    args: List[str] = field(default_factory=list)
    ttl: int = 0
    msg_id: int = 0
    payload: Optional[bytes] = None  # serialized weights (ops.serialization)
    contributors: List[str] = field(default_factory=list)
    num_samples: int = 0
    # Wire-propagated span context ("<trace_id>:<span_id>", empty when the
    # frame was built outside any span — e.g. heartbeats). The in-memory
    # transport carries it as-is; gRPC maps it onto a reserved trailing
    # control arg (weights frames carry it in the PFLT header instead —
    # telemetry/tracing.py module docstring).
    trace: str = ""
    # Piggybacked health digest (telemetry/digest.py encoded JSON, normally
    # only on heartbeats). Same wire story as ``trace``: native on the
    # in-memory transport, a reserved trailing control arg on gRPC. Empty =
    # absent, and absent digests MUST be tolerated by every receiver —
    # digest-free (older or opted-out) nodes share the wire.
    digest: str = ""
    # Federation-wide run id (telemetry/bundle.py) correlating every
    # artifact of one experiment. Same wire story as ``trace``: native on
    # the in-memory transport, a reserved trailing control arg on gRPC;
    # weights frames skip it (the control plane converges the id before
    # any model traffic flows). Empty = sender predates run contexts or
    # none established — receivers MUST tolerate that.
    run_id: str = ""
    # SENDER-LOCAL codec attribution for weights payloads ("topk" /
    # "topk-int8" / "topk-int4" / "dense"; comm/delta.py CODEC_LABELS).
    # Never serialized onto the wire — the frame itself is self-describing;
    # this tag only feeds the gossiper's TX accounting and the per-codec
    # compression metrics at the send choke point.
    codec: str = "dense"

    @property
    def is_weights(self) -> bool:
        return self.payload is not None

    @staticmethod
    def message(source: str, cmd: str, args: Optional[List[str]] = None, round: int = 0) -> "Envelope":
        """Control-plane message with fresh TTL and a random dedup id
        (reference grpc_client.py:56-88)."""
        return Envelope(
            source=source,
            cmd=cmd,
            round=round,
            args=[str(a) for a in (args or [])],
            ttl=Settings.TTL,
            msg_id=secrets.randbits(63),
            trace=tracing.current_wire(),
            run_id=current_run_id(),
        )

    @staticmethod
    def weights(
        source: str,
        cmd: str,
        round: int,
        payload: bytes,
        contributors: List[str],
        num_samples: int,
        codec: str = "dense",
    ) -> "Envelope":
        """Model-plane message (reference grpc_client.py:90-123). Not
        TTL-gossiped; routed point-to-point by the model gossip loop."""
        return Envelope(
            source=source,
            cmd=cmd,
            round=round,
            ttl=0,
            msg_id=secrets.randbits(63),
            # coerce once: the native codec hands out bytearray, and the
            # envelope is reused across gossip fan-out (bytes(bytes) is free)
            payload=bytes(payload),
            contributors=list(contributors),
            num_samples=int(num_samples),
            trace=tracing.current_wire(),
            codec=codec or "dense",
        )
