"""Profiling: host cProfile, on-device ``torch.profiler`` traces, and the
continuous performance-profiling plane (counterpart of
``p2pfl_tpu/management/profiler.py``).

The round is a long sequence of eager launches (tens of thousands for the
flash LM), so a host profile shows where the Python goes and a device trace
shows what the card ran: :func:`profile_run` captures both, the trace as
Chrome trace-event JSON (Perfetto / chrome://tracing).

Continuous profiling: instead of a one-shot wrapper the operator opts into,
the running system captures its own evidence —

* :func:`device_trace_window` — a bounded, never-raising
  ``torch.profiler`` window any subsystem can wrap around one unit of work;
  ``capture_once`` labels make it safe to leave enabled
  (``MeshSimulation.run(profile_dir=...)`` wraps its leading timed chunks).
* :func:`device_memory_watermark` — the allocator's in-use and peak bytes
  (``torch.cuda.memory_stats`` on a card; a TTL-cached sweep of live
  tensors on the CPU), stamped on every chunk by the device observatory.
* :func:`perf_section` — the structured ``perf`` block a bench JSON embeds:
  compile / first-fit events, steady-state step timings, the caller's cost
  analysis (the port counts the FLOPs and bytes a run executes,
  :mod:`p2pfl_tpu_torch.ops.cost`) and the device-trace paths captured this
  process.
"""

from __future__ import annotations

import contextlib
import cProfile
import gc
import logging
import pathlib
import sys
import threading
import time
import uuid
from typing import Any, Dict, Iterator, List, Optional

log = logging.getLogger("p2pfl_tpu_torch")

#: Schema version stamped into every perf section; perf_diff refuses to
#: compare sections with different versions.
PERF_SCHEMA_VERSION = 1

#: File name of the Chrome trace a capture writes into its directory.
TRACE_FILE = "trace.json"

# Device-trace windows captured by THIS process (paths), surfaced by
# perf_section so bench JSONs can point at their own evidence.
_captured_traces: List[str] = []
_captured_labels: set = set()
_capture_lock = threading.Lock()


def _profiler() -> Any:
    """A ``torch.profiler.profile`` of the host and, where a card is
    visible, of the card. Raises while another profiler session is open in
    the process: a nested session's stop would end the outer one."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    if getattr(torch.autograd.profiler, "_is_profiler_enabled", False):
        raise RuntimeError("another torch.profiler session is open in this process")
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    return profile(activities=activities)


@contextlib.contextmanager
def profile_run(
    host_dir: Optional[str] = None,
    device_trace_dir: Optional[str] = None,
    label: str = "run",
) -> Iterator[dict]:
    """Profile the enclosed block.

    Args:
        host_dir: if set, write a cProfile ``.pstat`` of the host Python
            under this directory (the reference's capability).
        device_trace_dir: if set, run the block under ``torch.profiler``
            and write its Chrome trace to ``<device_trace_dir>/<label>/trace.json``.
        label: filename stem for the host profile and the trace's directory.

    Yields a dict filled in on exit: ``elapsed_s`` plus the artifact paths
    that were written (``host_profile``, ``device_trace``).
    """
    info: dict = {}
    prof = cProfile.Profile() if host_dir is not None else None
    trace = None
    if device_trace_dir is not None:
        out = pathlib.Path(device_trace_dir) / label
        out.mkdir(parents=True, exist_ok=True)
        trace = _profiler()
        trace.start()
    t0 = time.monotonic()
    if prof is not None:
        prof.enable()
    try:
        try:
            yield info
        finally:
            # Stamp and stop the host profiler before the trace is written:
            # serializing a long round's events takes seconds and is
            # neither run time nor hot-path frames.
            info["elapsed_s"] = round(time.monotonic() - t0, 4)
            if prof is not None:
                prof.disable()
            if trace is not None:
                _sync()
                trace.stop()
                path = str(pathlib.Path(device_trace_dir) / label / TRACE_FILE)
                trace.export_chrome_trace(path)
                info["device_trace"] = path
    finally:
        if prof is not None:
            out = pathlib.Path(host_dir)
            out.mkdir(parents=True, exist_ok=True)
            path = out / f"{label}-{uuid.uuid4().hex}.pstat"
            prof.dump_stats(str(path))
            info["host_profile"] = str(path)
            print(f"host profile written to {path}", file=sys.stderr)


def _sync() -> None:
    """Wait for the card's queued work, so a trace closes after it ran."""
    import torch

    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


# --- continuous profiling -----------------------------------------------------


@contextlib.contextmanager
def device_trace_window(
    trace_dir: Optional[str],
    label: str = "window",
    capture_once: bool = True,
) -> Iterator[Optional[str]]:
    """Capture a windowed ``torch.profiler`` trace around the block, written
    as Chrome trace-event JSON to ``<trace_dir>/<label>/trace.json``.

    Built to be LEFT ENABLED in production paths: a falsy ``trace_dir``
    makes it a no-op, ``capture_once`` (default) captures only the first
    window per ``label`` per process (a fit wrapped every round costs one
    trace, not hundreds), and any profiler failure (another profiler
    already open, an export error) is logged and swallowed — a broken trace
    backend must never break the round it was observing.

    Yields the trace directory when capturing, else ``None``.
    """
    if not trace_dir:
        yield None
        return
    with _capture_lock:
        if capture_once and label in _captured_labels:
            yield None
            return
        _captured_labels.add(label)
    out = pathlib.Path(trace_dir) / label
    try:
        out.mkdir(parents=True, exist_ok=True)
        prof = _profiler()
        prof.start()
    except Exception:  # noqa: BLE001 — observation must not break the work
        log.exception("device trace window %r failed to start", label)
        yield None
        return
    try:
        yield str(out)
    finally:
        try:
            _sync()
            prof.stop()
            prof.export_chrome_trace(str(out / TRACE_FILE))
            with _capture_lock:
                _captured_traces.append(str(out))
        except Exception:  # noqa: BLE001
            log.exception("device trace window %r failed to stop", label)


def captured_device_traces() -> List[str]:
    """Paths of device-trace windows captured by this process so far."""
    with _capture_lock:
        return list(_captured_traces)


# (monotonic stamp, byte sum) of the last live-tensor sweep; None = never.
_live_sum_cache: Optional[tuple] = None


def live_arrays_bytes(ttl_s: Optional[float] = None) -> float:
    """Bytes of the storages of every live tensor, cached for
    ``Settings.DEVOBS_MEM_TTL_S`` (override with ``ttl_s``; 0 = resweep).

    The sweep walks the garbage collector's objects (a storage shared by
    several views counts once), O(live objects): every beat-path caller
    shares one sweep per TTL. Never raises.
    """
    global _live_sum_cache
    try:
        import torch

        if ttl_s is None:
            from p2pfl_tpu_torch.config import Settings

            ttl_s = float(Settings.DEVOBS_MEM_TTL_S)
        now = time.monotonic()
        cached = _live_sum_cache
        if cached is not None and ttl_s > 0 and now - cached[0] <= ttl_s:
            return cached[1]
        seen: Dict[tuple, int] = {}
        for obj in gc.get_objects():
            # type(), not isinstance(): a lazy module object's __class__ may warn.
            if issubclass(type(obj), torch.Tensor) and obj.layout == torch.strided and not obj.is_meta:
                storage = obj.untyped_storage()
                seen[(str(obj.device), storage.data_ptr())] = storage.nbytes()
        val = float(sum(seen.values()))
        _live_sum_cache = (now, val)
        return val
    except Exception:  # noqa: BLE001 — observation must not raise
        return 0.0


def device_memory_watermark() -> Dict[str, float]:
    """``{"bytes_in_use", "peak_bytes_in_use"}`` of the current card, best
    effort.

    The CUDA caching allocator's ``allocated_bytes.all.current`` / ``.peak``
    (``torch.cuda.memory_stats``) once the process has used a card, else
    the TTL-cached live-tensor sum (the CPU: in-use only — the peak then
    equals in-use). Never raises; all-zero when nothing can be read. The
    device observatory stamps this around every timed chunk (flight-recorder
    chunk events)."""
    try:
        import torch

        if torch.cuda.is_available() and torch.cuda.is_initialized():
            stats = torch.cuda.memory_stats()
            in_use = float(stats.get("allocated_bytes.all.current", 0) or 0)
            if in_use:
                peak = float(stats.get("allocated_bytes.all.peak", 0) or 0)
                return {"bytes_in_use": in_use, "peak_bytes_in_use": max(in_use, peak)}
        live = live_arrays_bytes()
        return {"bytes_in_use": live, "peak_bytes_in_use": live}
    except Exception:  # noqa: BLE001
        return {"bytes_in_use": 0.0, "peak_bytes_in_use": 0.0}


def _gauge_by_node(registry: Any, name: str) -> Dict[str, float]:
    """Counter/gauge family -> {node label: value} (empty when absent)."""
    fam = registry.get(name)
    out: Dict[str, float] = {}
    if fam is None:
        return out
    for labels, child in fam.samples():
        out[labels.get("node", "")] = float(child.value)
    return out


def perf_section(
    registry: Any = None,
    cost: Optional[Dict[str, float]] = None,
    extra: Optional[Dict[str, Any]] = None,
) -> Dict[str, Any]:
    """The structured ``perf`` block a bench JSON embeds, in the JAX
    package's shape (``scripts/perf_diff.py`` compares two of them).

    Pulls compile/step telemetry out of the metrics registry (per-node
    first-compile seconds, recompile counts, steady-state step time /
    steps-per-second), attaches the caller's cost analysis under
    ``xla_cost`` (the JAX package's key; in the port the counted
    ``flops`` / ``bytes_accessed`` of ``MeshSimulation.round_cost_analysis``
    or ``TorchLearner.cost_analysis``) and the device-trace windows
    captured by this process.
    """
    if registry is None:
        from p2pfl_tpu_torch.telemetry import REGISTRY as registry  # noqa: N811

    compile_s = _gauge_by_node(registry, "p2pfl_learner_jit_compile_seconds")
    recompiles = _gauge_by_node(registry, "p2pfl_learner_recompiles_total")
    recompile_s = _gauge_by_node(registry, "p2pfl_learner_recompile_seconds")
    step_s = _gauge_by_node(registry, "p2pfl_learner_step_seconds")
    steps_per_s = _gauge_by_node(registry, "p2pfl_learner_steps_per_second")
    section: Dict[str, Any] = {
        "schema_version": PERF_SCHEMA_VERSION,
        "compile": {
            "first_compile_s": {k: round(v, 4) for k, v in compile_s.items()},
            "recompiles_total": {k: int(v) for k, v in recompiles.items()},
            "last_recompile_s": {k: round(v, 4) for k, v in recompile_s.items()},
        },
        "steady_state": {
            "step_s": {k: round(v, 6) for k, v in step_s.items()},
            "steps_per_s": {k: round(v, 2) for k, v in steps_per_s.items()},
        },
        "xla_cost": cost,
        "device_traces": captured_device_traces(),
    }
    if extra:
        section.update(extra)
    return section
