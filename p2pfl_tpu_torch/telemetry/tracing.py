"""Distributed round tracing: spans whose IDs ride the gossip wire (the
port's framework-free copy of ``p2pfl_tpu/telemetry/tracing.py``).

A *span* is a named, timed interval on one node (a stage, a gossip wait, a
received-frame handler). Spans form a tree through a ``contextvars``-based
current-span slot: entering ``TRACER.span(...)`` makes the new span the
parent of anything opened inside it — including on the *receiving* node,
because the wire context (``"<trace_id>:<span_id>"``) is stamped onto every
outbound frame built inside a span and re-attached around inbound dispatch. One experiment therefore produces ONE
trace id shared by every node it touches, and cross-node questions — where
did round N's wall-clock go, how long did model diffusion take between
sender and receiver — fall out of the span table.

Wire formats:

* ``Envelope.trace`` — the envelopes' slot (``comm/envelope.py``):
  carried natively by the in-memory transport and, in the JAX package, as
  a reserved trailing ``__trace__:`` arg on gRPC control frames.
* ``TRACE_META_KEY`` (``"__trace__"``) — the PFLT weights-frame header slot
  (same mechanism as the ``__codec__`` spec), used because the gRPC weights
  oneof has no args field.

Export: :meth:`Tracer.export_chrome_trace` renders the span buffer as Chrome
trace-event JSON — loadable in Perfetto / chrome://tracing, matching
``management/profiler.py``'s device-trace viewer story. Each node becomes a
"process" row; spans carry trace/span ids and the round in ``args``.
"""

from __future__ import annotations

import contextlib
import contextvars
import secrets
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Dict, Iterator, List, Optional

from p2pfl_tpu_torch.telemetry.metrics import REGISTRY

_SPANS_DROPPED = REGISTRY.counter(
    "p2pfl_trace_spans_dropped_total",
    "Spans evicted from the bounded tracer buffer (oldest first) — nonzero "
    "means the exported trace is a suffix of the experiment",
)

#: PFLT weights-frame metadata key carrying the sender's wire context.
TRACE_META_KEY = "__trace__"

#: Reserved prefix for the trailing gRPC control-frame trace arg.
WIRE_ARG_PREFIX = "__trace__:"

_current: contextvars.ContextVar[Optional["SpanContext"]] = contextvars.ContextVar(
    "p2pfl_tpu_span", default=None
)


@dataclass(frozen=True)
class SpanContext:
    trace_id: str
    span_id: str

    def wire(self) -> str:
        return f"{self.trace_id}:{self.span_id}"


@dataclass
class Span:
    name: str
    trace_id: str
    span_id: str
    parent_id: str
    node: str
    start_s: float  # module-epoch-relative seconds (shared in-process clock)
    dur_s: float
    tid: int
    args: Dict[str, Any] = field(default_factory=dict)


def new_id() -> str:
    return secrets.token_hex(8)


def current_context() -> Optional[SpanContext]:
    return _current.get()


def current_trace_id() -> Optional[str]:
    ctx = _current.get()
    return ctx.trace_id if ctx is not None else None


def current_wire() -> str:
    """Wire form of the active span context ("" outside any span) — what
    frame encoders stamp onto outbound frames."""
    ctx = _current.get()
    return ctx.wire() if ctx is not None else ""


def parse_wire(wire: str) -> Optional[SpanContext]:
    if not wire:
        return None
    trace_id, sep, span_id = wire.partition(":")
    if not sep or not trace_id or not span_id:
        return None
    return SpanContext(trace_id, span_id)


@contextlib.contextmanager
def attach_wire(wire: str) -> Iterator[Optional[SpanContext]]:
    """Adopt a remote span context for the enclosed block, so spans opened
    inside parent onto the SENDER's span (no-op for empty/malformed wire)."""
    ctx = parse_wire(wire)
    if ctx is None:
        yield None
        return
    token = _current.set(ctx)
    try:
        yield ctx
    finally:
        _current.reset(token)


class Tracer:
    """Bounded process-wide span buffer + span factory.

    All in-process nodes share one tracer (and one monotonic clock), so
    cross-node timelines line up without clock-sync machinery. A real
    multi-host deployment has one tracer PER PROCESS, each on its own
    clock: every exported trace therefore carries a wall-clock epoch
    anchor (:meth:`wall_epoch`), and
    :mod:`p2pfl_tpu_torch.telemetry.critical_path` merges per-process exports
    onto one timeline, correcting residual NTP skew with the heartbeat
    clock-skew gauge (``CommunicationProtocol.export_trace`` annotates
    each dump with its node's per-peer skew snapshot).
    """

    def __init__(self, max_spans: Optional[int] = None) -> None:
        if max_spans is None:
            # Deferred import: config is dependency-free, but keeping the
            # read lazy lets tests construct bespoke tracers with explicit
            # caps without touching Settings.
            from p2pfl_tpu_torch.config import Settings

            max_spans = Settings.TRACE_MAX_SPANS
        self._spans: deque[Span] = deque(maxlen=max_spans)
        self._lock = threading.Lock()
        self._epoch = time.perf_counter()
        # Wall clock at construction — kept for reference only; the export
        # anchor is RECOMPUTED at export time (see wall_epoch) so an NTP
        # step between construction and export cannot skew the mapping.
        self._epoch_wall_at_init = time.time()
        self.dropped = 0  # spans evicted by the bound

    def wall_epoch(self) -> float:
        """Wall-clock time (epoch seconds) corresponding to span time 0.

        ``span.start_s + wall_epoch()`` maps any span onto the wall clock.
        Recomputed from the CURRENT wall clock on every call: the monotonic
        span clock never steps, so anchoring through "now" reflects any NTP
        corrections since construction instead of freezing the stale offset.
        """
        return time.time() - (time.perf_counter() - self._epoch)

    def new_trace_id(self) -> str:
        return new_id()

    @contextlib.contextmanager
    def span(
        self,
        name: str,
        node: str = "",
        trace_id: Optional[str] = None,
        **args: Any,
    ) -> Iterator[SpanContext]:
        """Open a span as a child of the current context (or a fresh trace).

        ``trace_id`` pins the span to a known trace (e.g. the experiment
        trace adopted from a start_learning frame) regardless of ambient
        context; the parent link is kept only when it belongs to the same
        trace.
        """
        parent = _current.get()
        if trace_id is None:
            trace_id = parent.trace_id if parent is not None else new_id()
        parent_id = (
            parent.span_id if parent is not None and parent.trace_id == trace_id else ""
        )
        ctx = SpanContext(trace_id, new_id())
        token = _current.set(ctx)
        t0 = time.perf_counter()
        try:
            yield ctx
        finally:
            t1 = time.perf_counter()
            _current.reset(token)
            self._record(
                Span(
                    name=name,
                    trace_id=trace_id,
                    span_id=ctx.span_id,
                    parent_id=parent_id,
                    node=node,
                    start_s=t0 - self._epoch,
                    dur_s=t1 - t0,
                    tid=threading.get_ident() & 0xFFFFFFFF,
                    args={k: v for k, v in args.items() if v is not None},
                )
            )

    @contextlib.contextmanager
    def recv_span(
        self, name: str, node: str, wire: str, **args: Any
    ) -> Iterator[None]:
        """Receiver-side span parented onto the sender's wire context.

        No-op (and records nothing) when ``wire`` is empty — untraced
        traffic like heartbeats must not churn the buffer.
        """
        if not wire:
            yield
            return
        with attach_wire(wire):
            with self.span(name, node=node, **args):
                yield

    def _record(self, span: Span) -> None:
        with self._lock:
            if len(self._spans) == self._spans.maxlen:
                self.dropped += 1
                _SPANS_DROPPED.inc()
            self._spans.append(span)

    def spans(self) -> List[Span]:
        with self._lock:
            return list(self._spans)

    def reset(self) -> None:
        with self._lock:
            self._spans.clear()
            self.dropped = 0

    # --- export -------------------------------------------------------------

    def export_chrome_trace(self) -> Dict[str, Any]:
        """Chrome trace-event JSON (the ``{"traceEvents": [...]}`` object
        form). Nodes map to process rows via ``process_name`` metadata
        events; every span is a complete ("X") event with trace/span ids in
        ``args`` so Perfetto queries can join cross-node spans on trace id.

        Events are sorted by ``(ts, pid, tid, name)`` so identical span sets
        always export byte-identically, and the top-level ``metadata`` block
        carries the wall-clock epoch anchor (``wall_epoch_s``: wall seconds
        at span time 0, recomputed at export) — the key that lets
        :mod:`p2pfl_tpu_torch.telemetry.critical_path` merge traces exported by
        DIFFERENT processes onto one timeline.
        """
        spans = self.spans()
        pids: Dict[str, int] = {}
        events: List[Dict[str, Any]] = []
        for s in spans:
            pid = pids.setdefault(s.node or "process", len(pids) + 1)
            events.append(
                {
                    "name": s.name,
                    "cat": "p2pfl_tpu",
                    "ph": "X",
                    "ts": round(s.start_s * 1e6, 1),
                    "dur": round(s.dur_s * 1e6, 1),
                    "pid": pid,
                    "tid": s.tid,
                    "args": {
                        **s.args,
                        "trace_id": s.trace_id,
                        "span_id": s.span_id,
                        "parent_id": s.parent_id,
                    },
                }
            )
        events.sort(key=lambda e: (e["ts"], e["pid"], e["tid"], e["name"]))
        meta = [
            {
                "name": "process_name",
                "ph": "M",
                "pid": pid,
                "args": {"name": node},
            }
            for node, pid in pids.items()
        ]
        return {
            "traceEvents": meta + events,
            "displayTimeUnit": "ms",
            "metadata": {
                "wall_epoch_s": self.wall_epoch(),
                "wall_epoch_at_init_s": self._epoch_wall_at_init,
                "exported_at_s": time.time(),
                "ts_unit": "us since tracer epoch (monotonic)",
            },
        }


#: The process-wide tracer every subsystem records spans into.
TRACER = Tracer()
