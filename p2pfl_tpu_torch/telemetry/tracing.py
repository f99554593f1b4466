"""The wire slot of distributed round tracing (from
``p2pfl_tpu/telemetry/tracing.py``).

A node's active span context (``"<trace_id>:<span_id>"``) rides every PFLT
weights frame it builds, under ``TRACE_META_KEY`` in the header (the same
mechanism as the ``__codec__`` spec), so that a receiver's spans parent onto
the sender's. The port holds only that slot: the ``Tracer`` (span buffer,
Chrome-trace export, adopting a received context) comes with the ``Node``
and its stages, which open the spans; until then no span is active and
frames carry no context, as a reference frame built outside any span.
"""

from __future__ import annotations

import contextvars
from dataclasses import dataclass
from typing import Optional

#: PFLT weights-frame metadata key carrying the sender's wire context.
TRACE_META_KEY = "__trace__"


@dataclass(frozen=True)
class SpanContext:
    trace_id: str
    span_id: str

    def wire(self) -> str:
        return f"{self.trace_id}:{self.span_id}"


_current: contextvars.ContextVar[Optional[SpanContext]] = contextvars.ContextVar(
    "p2pfl_tpu_span", default=None
)


def current_wire() -> str:
    """Wire form of the active span context ("" outside any span) — what
    frame encoders stamp onto outbound frames."""
    ctx = _current.get()
    return ctx.wire() if ctx is not None else ""
