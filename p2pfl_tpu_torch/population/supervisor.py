"""EngineSupervisor — preemption-proof driving of the fused engines
(counterpart of ``p2pfl_tpu/population/supervisor.py``, over the port's
sync and async population engines on one card).

The wire path survives crashes and partitions through the durable recovery
plane (NodeJournal, quorum park); the fused engines only survived *planned*
checkpoints. On shared accelerator fleets preemption is the dominant
failure mode (Papaya, arxiv 2111.04877, treats restart-tolerance as table
stakes), so
this module wraps both engines' chunk-launch loops with the missing half:

* **write-ahead journaling** — :meth:`EngineSupervisor.run` drives the
  engine one chunk at a time and journals on the crash-safe
  :class:`~p2pfl_tpu_torch.management.checkpoint.FLCheckpointer` every
  ``SUPERVISOR_JOURNAL_EVERY`` chunks, plus on every devobs trip and on
  SIGTERM (the preemption signal real pods deliver) — the same atomic
  temp+rename+commit-marker protocol the wire journal uses;
* **self-healing resume** — a failed chunk (injected host fault, a CUDA
  out-of-memory error, a chunk that failed with the state part-written,
  devobs trip in abort mode) rolls back to the last journal (the engines
  update their state in place, so a failed chunk's state is never reused)
  and replays the seeded cohort/window
  stream from its absolute cursor. The streams are pure functions of the
  cursor, so a successful retry is bit-exact by construction. Retries are
  bounded (``SUPERVISOR_MAX_RETRIES``) with exponential backoff;
* **graceful degradation** — when retries at the current shape are
  exhausted, ``SUPERVISOR_DEGRADE`` climbs down a ladder: shrink the
  chunk (``rounds_per_call``/``windows_per_call``) toward 1, then halve
  the cohort K within the original plan's ``min_size`` floor (an engine
  rebuild — K is fixed at construction), before PARKING with state
  readable from the journal, mirroring the wire plane's quorum-park;
* **host-fault chaos** — a seeded
  :meth:`~p2pfl_tpu_torch.chaos.plane.ChaosPlane.plan_host_faults` trace
  (kill-at-chunk, OOM-at-chunk, SIGTERM-at-window, slow-host) is executed
  by the supervisor's own injector at chunk boundaries, so preemption
  drills are deterministic and replayable like every other chaos trace.

Every supervisor action is simultaneously a ledger membership event
(excluded from parity's trajectory compare by construction), a
``p2pfl_supervisor_*`` metric, a flight-recorder event, and — through
:meth:`EngineSupervisor.snapshot` — a fed_top column.
"""

from __future__ import annotations

import signal
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

from p2pfl_tpu_torch.chaos.plane import CHAOS, HOST_FAULT_KINDS, HostFaultEvent
from p2pfl_tpu_torch.config import Settings
from p2pfl_tpu_torch.telemetry import REGISTRY
from p2pfl_tpu_torch.telemetry import bundle as bundle_mod
from p2pfl_tpu_torch.telemetry.flight_recorder import FlightRecorder
from p2pfl_tpu_torch.telemetry.ledger import LEDGERS

import logging

log = logging.getLogger("p2pfl_tpu_torch")

_JOURNALS = REGISTRY.counter(
    "p2pfl_supervisor_journals_total",
    "Write-ahead engine journals written by the supervisor, by trigger "
    "(initial | cadence | trip | sigterm | defensive | park)",
    labels=("node", "trigger"),
)
_RESTARTS = REGISTRY.counter(
    "p2pfl_supervisor_restarts_total",
    "Engine restarts (rebuild + journal rollback) the supervisor performed, "
    "by failure kind (kill | oom | sigterm | runtime | trip)",
    labels=("node", "kind"),
)
_RETRIES = REGISTRY.counter(
    "p2pfl_supervisor_retries_total",
    "Chunk retries after a rollback (each retry replays the seeded stream "
    "from the journaled absolute cursor)",
    labels=("node",),
)
_DEGRADES = REGISTRY.counter(
    "p2pfl_supervisor_degrade_steps_total",
    "Degradation-ladder steps taken after retry exhaustion, by action "
    "(chunks | cohort)",
    labels=("node", "action"),
)
_PARKS = REGISTRY.counter(
    "p2pfl_supervisor_parks_total",
    "Supervised runs parked with state readable after the degrade ladder "
    "was exhausted",
    labels=("node",),
)


def _is_oom(exc: BaseException) -> bool:
    """A real out-of-memory failure: ``torch.cuda.OutOfMemoryError`` raised
    by the chunk or anywhere in its cause chain (the engines wrap a failed
    chunk), or the JAX package's ``RESOURCE_EXHAUSTED`` message. Nothing
    else counts as ``oom``."""
    import torch

    seen = set()
    while exc is not None and id(exc) not in seen:
        seen.add(id(exc))
        if isinstance(exc, torch.cuda.OutOfMemoryError) or "RESOURCE_EXHAUSTED" in str(exc):
            return True
        exc = exc.__cause__ or exc.__context__
    return False


def _free_device_cache() -> None:
    """Hand the CUDA allocator's cached blocks back before the rebuild (a
    no-op without a card)."""
    import gc

    import torch

    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


@dataclass
class SupervisorReport:
    """What one supervised run did — every counter here is deterministic
    under replay (no wall-clock content except ``wall_s``/``journal_s``,
    which replay comparisons must ignore)."""

    completed: int  # absolute cursor (rounds | windows) at exit
    chunks: int  # successful chunk launches
    journals: int
    journal_s: float
    restarts: Dict[str, int]
    retries: int
    degrade_steps: Tuple[Tuple[str, str], ...]
    parked: bool
    park_reason: Optional[str]
    wall_s: float
    chunk_final: int
    cohort_final: int
    faults_executed: Tuple[HostFaultEvent, ...]
    #: ordered, timestamp-free action log — the replay-identity surface
    #: soak checks compare (same seed + same fault plan => same tuple).
    events: Tuple[str, ...] = ()
    #: per-chunk engine results, in execution order.
    results: List[Any] = field(default_factory=list)
    #: the federation-wide run id this supervised run executed under —
    #: joins the report to every other artifact in its evidence bundle.
    run_id: str = ""

    @property
    def total_restarts(self) -> int:
        return sum(self.restarts.values())


class _InjectedFault(RuntimeError):
    """An injected host fault (carries the trace event's kind)."""

    def __init__(self, kind: str, message: str) -> None:
        super().__init__(message)
        self.kind = kind


class EngineSupervisor:
    """Drive a fused engine chunk-by-chunk with journaling, self-healing
    resume, bounded retry/backoff, a degrade ladder, and deterministic
    host-fault drills.

    ``factory`` builds the engine: called with no arguments initially, and
    with ``cohort_fraction=f, cohort_min=k`` keyword overrides when the
    cohort rung of the degrade ladder rebuilds at a halved K — a factory
    that forwards its kwargs to :class:`PopulationEngine` /
    :class:`AsyncPopulationEngine` gets the full ladder for free. The
    supervisor owns the engine it built (``close()`` via kill faults,
    rebuild on degrade); read the live one through :attr:`engine`.

    ``checkpointer`` must journal every step (``save_interval=1``) — an
    off-interval journal would silently widen the rollback window.
    """

    def __init__(
        self,
        factory: Callable[..., Any],
        checkpointer,
        *,
        node: str = "supervisor",
        journal_every: Optional[int] = None,
        max_retries: Optional[int] = None,
        backoff_s: Optional[float] = None,
        degrade: Optional[str] = None,
        faults: Tuple[HostFaultEvent, ...] = (),
        sleep: Callable[[float], None] = time.sleep,
        run_id: Optional[str] = None,
    ) -> None:
        self._factory = factory
        self._ck = checkpointer
        self._node = str(node)
        self.journal_every = int(
            journal_every if journal_every is not None
            else Settings.SUPERVISOR_JOURNAL_EVERY
        )
        self.max_retries = int(
            max_retries if max_retries is not None else Settings.SUPERVISOR_MAX_RETRIES
        )
        self.backoff_s = float(
            backoff_s if backoff_s is not None else Settings.SUPERVISOR_BACKOFF_S
        )
        self.degrade = str(
            degrade if degrade is not None else Settings.SUPERVISOR_DEGRADE
        )
        if self.degrade not in ("off", "chunks", "cohort"):
            raise ValueError(
                f"degrade must be off|chunks|cohort, got {self.degrade!r}"
            )
        for ev in faults:
            if ev.kind not in HOST_FAULT_KINDS:
                raise ValueError(
                    f"fault kind must be one of {HOST_FAULT_KINDS}, got {ev.kind!r}"
                )
        self._faults: Dict[int, HostFaultEvent] = {}
        for ev in faults:
            if ev.when in self._faults:
                raise ValueError(
                    f"two host faults scheduled at chunk {ev.when} — "
                    "plan_host_faults draws without replacement; merge traces"
                )
            self._faults[int(ev.when)] = ev
        self._sleep = sleep
        self._rec = FlightRecorder(self._node)
        self.engine: Any = None
        self._sigterm = threading.Event()
        self._cohort_overrides: Dict[str, Any] = {}
        self._run_id = run_id
        # report accumulators (reset per run())
        self._events: List[str] = []
        self._journals = 0
        self._journal_s = 0.0
        self._restarts: Dict[str, int] = {}
        self._retries = 0
        self._degrade_steps: List[Tuple[str, str]] = []
        self._fired: List[HostFaultEvent] = []

    # --- engine plumbing ------------------------------------------------------

    def _build(self) -> Any:
        self.engine = self._factory(**self._cohort_overrides)
        return self.engine

    @property
    def _is_async(self) -> bool:
        return hasattr(self.engine, "completed_windows")

    @property
    def cursor(self) -> int:
        """Absolute progress cursor: completed windows (async) or rounds."""
        if self.engine is None:
            return 0
        return int(
            self.engine.completed_windows
            if self._is_async
            else self.engine.completed_rounds
        )

    def _engine_closed(self) -> bool:
        return bool(getattr(self.engine, "_closed", False)) or bool(
            getattr(getattr(self.engine, "sim", None), "_closed", False)
        )

    def _state_lost(self) -> bool:
        """True when a chunk failed and the engine dropped its part-written
        state."""
        if self._is_async:
            return self.engine.history is None
        return self.engine.sim.params_stack is None

    def _launch(self, n: int, epochs: int, eval_every: int, warmup: bool):
        kw: Dict[str, Any] = {"epochs": epochs, "eval_every": eval_every}
        if warmup:
            kw["warmup"] = True
        if self._is_async:
            kw["windows_per_call"] = n
        else:
            kw["rounds_per_call"] = n
        return self.engine.run(n, **kw)

    # --- observability --------------------------------------------------------

    def _emit(self, event: str, **fields: Any) -> None:
        LEDGERS.emit(self._node, "membership", event=event, **fields)
        self._rec.record(event, **fields)

    def _log_event(self, tag: str) -> None:
        self._events.append(tag)

    def _journal(self, trigger: str) -> None:
        """Write-ahead journal at the current cursor (atomic; fsynced)."""
        t0 = time.monotonic()
        self.engine.save_to(self._ck)
        self._ck.wait()
        dt = time.monotonic() - t0
        self._journals += 1
        self._journal_s += dt
        _JOURNALS.labels(self._node, trigger).inc()
        self._emit(
            "supervisor_journal", trigger=trigger, step=self.cursor,
            wall_s=round(dt, 4),
        )
        self._log_event(f"journal:{trigger}@{self.cursor}")

    def _restart(self, kind: str) -> None:
        """Heal the engine: rebuild when closed, roll back to the last
        journal, leaving the absolute cursor at the journaled step so the
        next launch replays the seeded stream bit-exactly."""
        rebuilt = False
        if self.engine is None or self._engine_closed():
            self._build()
            rebuilt = True
        if rebuilt or self._state_lost():
            # A fresh or state-dropped engine restores from the journal; a
            # parked-intact engine (abort-mode trip) keeps its live state.
            self.engine.load_from(self._ck)
        self._restarts[kind] = self._restarts.get(kind, 0) + 1
        _RESTARTS.labels(self._node, kind).inc()
        self._emit("supervisor_restart", failure=kind, step=self.cursor)
        self._log_event(f"restart:{kind}@{self.cursor}")

    # --- host-fault injector --------------------------------------------------

    def _inject(self, ev: HostFaultEvent) -> None:
        """Execute one trace event at this chunk boundary (first attempt
        only — the event is consumed so a retry does not re-die)."""
        self._fired.append(ev)
        CHAOS.host_fault(self._node, ev.kind)
        self._rec.record("host_fault", fault=ev.kind, chunk=ev.when)
        self._log_event(f"fault:{ev.kind}@{ev.when}")
        if ev.kind == "kill":
            # The host dies: the engine object is gone with it.
            self.engine.close()
            raise _InjectedFault("kill", f"injected host kill at chunk {ev.when}")
        if ev.kind == "oom":
            # The chunk OOMs with its state part-written: the engines drop
            # it, exactly as after any failed chunk.
            if self._is_async:
                self.engine.history = self.engine.opt_stack = None
            else:
                self.engine.sim.params_stack = None
                self.engine.sim.opt_stack = None
            raise _InjectedFault(
                "oom", f"injected OOM at chunk {ev.when}: RESOURCE_EXHAUSTED"
            )
        if ev.kind == "sigterm":
            # Preemption notice: journal now, then simulate the process
            # death + restart (rebuild from the journal just written). A
            # drill never signals the process itself.
            self._journal("sigterm")
            self.engine.close()
            self._restart("sigterm")
            return
        if ev.kind == "slow":
            # Straggling host: take a defensive journal — if the slowness
            # becomes a preemption the rollback window is already minimal.
            self._journal("defensive")
            return
        raise ValueError(f"unknown host-fault kind {ev.kind!r}")

    # --- SIGTERM (real preemption) --------------------------------------------

    def _on_sigterm(self, signum, frame) -> None:  # pragma: no cover - signal
        # Journaling from signal context could re-enter the checkpointer under an
        # in-flight chunk launch; set the flag and journal at the boundary.
        self._sigterm.set()
        self._rec.record("sigterm_received")

    # --- degrade ladder -------------------------------------------------------

    def _degrade_step(self) -> Optional[str]:
        """Climb one rung down; returns the action taken or None to park."""
        if self.degrade == "off":
            return None
        if self._chunk > 1:
            self._chunk = max(1, self._chunk // 2)
            detail = f"chunk->{self._chunk}"
            self._degrade_steps.append(("chunks", detail))
            _DEGRADES.labels(self._node, "chunks").inc()
            self._emit("supervisor_degrade", action="chunks", detail=detail,
                       step=self.cursor)
            self._log_event(f"degrade:chunks:{self._chunk}@{self.cursor}")
            return "chunks"
        if self.degrade == "cohort":
            k = int(self.engine.cohort_k)
            new_k = max(self._k_floor, k // 2)
            if new_k < k:
                self._cohort_overrides = {
                    "cohort_fraction": new_k / float(self.engine.num_nodes),
                    "cohort_min": new_k,
                }
                detail = f"cohort_k {k}->{new_k}"
                self.engine.close()
                self._build()
                self.engine.load_from(self._ck)
                self._degrade_steps.append(("cohort", detail))
                _DEGRADES.labels(self._node, "cohort").inc()
                self._emit("supervisor_degrade", action="cohort", detail=detail,
                           step=self.cursor)
                self._log_event(f"degrade:cohort:{new_k}@{self.cursor}")
                return "cohort"
        return None

    def _park(self, reason: str) -> None:
        """Stop making progress, state readable: the journal holds the last
        good step and the engine (when intact) keeps its live state — the
        quorum-park semantic, host-fault flavored."""
        try:
            if not self._engine_closed() and not self._state_lost():
                self._journal("park")
        except Exception:  # noqa: BLE001 — parking must not raise
            log.warning("supervisor: park journal failed", exc_info=True)
        _PARKS.labels(self._node).inc()
        self._emit("supervisor_park", reason=reason, step=self.cursor)
        self._log_event(f"park:{reason}@{self.cursor}")
        self._rec.dump("supervisor_park")
        # A park IS an incident: capture the whole evidence story (a
        # trip-kind park is the supervised flavor of a devobs abort).
        bundle_mod.write_bundle(
            "supervisor_park",
            context={"node": self._node, "reason": reason, "step": self.cursor},
        )

    # --- the loop -------------------------------------------------------------

    def run(
        self,
        total: int,
        epochs: int = 1,
        eval_every: int = 1,
        chunk: int = 1,
        warmup: bool = False,
    ) -> SupervisorReport:
        """Run ``total`` rounds (sync engine) or windows (async) under
        supervision, ``chunk`` at a time. Returns a
        :class:`SupervisorReport`; the live engine stays on :attr:`engine`
        for result extraction (``gather_params``, ``snapshot``)."""
        total = int(total)
        self._chunk = max(1, min(int(chunk), max(1, total)))
        self._events = []
        self._journals, self._journal_s = 0, 0.0
        self._restarts, self._retries = {}, 0
        self._degrade_steps, self._fired = [], []
        results: List[Any] = []
        parked, park_reason = False, None
        t0 = time.monotonic()
        # Join this supervised run to the ambient run context (explicit
        # ctor run_id wins; otherwise first-established/LEDGERS id, else
        # mint) — the report and every park bundle carry it.
        bundle_mod.establish_run(run_id=self._run_id, name=self._node)

        if self.engine is None:
            self._build()
        self._k_floor = int(self.engine.plan.min_size)
        start = self.cursor
        # Write-ahead: the rollback target must exist before the first
        # chunk can fail.
        self._journal("initial")

        prev_handler = None
        try:
            prev_handler = signal.signal(signal.SIGTERM, self._on_sigterm)
        except ValueError:  # non-main thread: drills still work via traces
            prev_handler = None

        chunk_index = 0  # fault-free chunk ordinal (fault trace domain)
        attempts = 0  # failures on the CURRENT chunk since last success
        since_journal = 0
        first_launch = True
        try:
            while self.cursor < start + total:
                if self._sigterm.is_set():
                    self._sigterm.clear()
                    self._journal("sigterm")
                    self._restart("sigterm")
                n = min(self._chunk, start + total - self.cursor)
                try:
                    ev = self._faults.pop(chunk_index, None)
                    if ev is not None:
                        self._inject(ev)
                    res = self._launch(
                        n, epochs, eval_every, warmup and first_launch
                    )
                    first_launch = False
                except Exception as exc:  # noqa: BLE001 — heal or park
                    kind = (
                        exc.kind if isinstance(exc, _InjectedFault)
                        else "trip" if "devobs tripwire" in str(exc)
                        else "oom" if _is_oom(exc)
                        else "runtime"
                    )
                    if kind == "oom":
                        _free_device_cache()
                    attempts += 1
                    if attempts > self.max_retries:
                        action = self._degrade_step()
                        if action is None:
                            parked, park_reason = True, kind
                            self._park(kind)
                            break
                        attempts = 0
                    if kind == "trip" and not self._state_lost():
                        # Abort-mode trip: state is parked-intact at the
                        # trip cursor — journal it before going again.
                        self._journal("trip")
                    self._restart(kind)
                    self._retries += 1
                    _RETRIES.labels(self._node).inc()
                    self._emit(
                        "supervisor_retry", failure=kind, attempt=attempts,
                        step=self.cursor,
                    )
                    self._log_event(f"retry:{kind}:{attempts}@{self.cursor}")
                    if self.backoff_s > 0.0:
                        self._sleep(self.backoff_s * (2 ** max(0, attempts - 1)))
                    continue
                attempts = 0
                chunk_index += 1
                since_journal += 1
                results.append(res)
                tripped = getattr(res, "tripped", None)
                if tripped is not None:
                    # Park-mode trip: the engine stopped launching; journal
                    # the parked state and park the supervised run too.
                    self._journal("trip")
                    parked, park_reason = True, f"trip:{tripped.get('kind')}"
                    self._park(park_reason)
                    break
                if since_journal >= self.journal_every:
                    self._journal("cadence")
                    since_journal = 0
        finally:
            if prev_handler is not None:
                try:
                    signal.signal(signal.SIGTERM, prev_handler)
                except ValueError:
                    pass

        if not parked and since_journal:
            self._journal("cadence")
        report = SupervisorReport(
            completed=self.cursor,
            chunks=chunk_index,
            journals=self._journals,
            journal_s=self._journal_s,
            restarts=dict(self._restarts),
            retries=self._retries,
            degrade_steps=tuple(self._degrade_steps),
            parked=parked,
            park_reason=park_reason,
            wall_s=time.monotonic() - t0,
            chunk_final=self._chunk,
            cohort_final=int(self.engine.cohort_k),
            faults_executed=tuple(self._fired),
            events=tuple(self._events),
            results=results,
            run_id=bundle_mod.current_run_id(),
        )
        self.last_report = report
        return report

    # --- fed_top surface ------------------------------------------------------

    def snapshot(
        self,
        result: Any,
        epochs: int = 1,
        top_n: int = 16,
        path: Optional[str] = None,
    ) -> Dict[str, Any]:
        """The engine's population snapshot with the supervisor's RESTARTS /
        DEGRADE columns grafted onto every peer entry plus a doc-level
        ``supervisor`` section (fed_top's banner)."""
        from p2pfl_tpu_torch.telemetry.observatory import write_snapshot_doc

        snap = self.engine.snapshot(result, epochs=epochs, top_n=top_n)
        report = getattr(self, "last_report", None)
        restarts = report.total_restarts if report is not None else 0
        degrade = len(report.degrade_steps) if report is not None else 0
        for entry in snap.get("peers", {}).values():
            entry["restarts"] = restarts
            entry["degrade"] = degrade
        snap["supervisor"] = {
            "node": self._node,
            "run_id": report.run_id if report is not None else "",
            "restarts": restarts,
            "degrade_steps": degrade,
            "retries": report.retries if report is not None else 0,
            "journals": report.journals if report is not None else 0,
            "parked": bool(report.parked) if report is not None else False,
        }
        if path is not None:
            write_snapshot_doc(path, snap)
        return snap

    def close(self) -> None:
        if self.engine is not None and not self._engine_closed():
            self.engine.close()

    def __enter__(self) -> "EngineSupervisor":
        return self

    def __exit__(self, *exc: Any) -> None:
        self.close()


__all__ = ["EngineSupervisor", "SupervisorReport"]
