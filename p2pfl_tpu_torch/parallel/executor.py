"""Nodes-mode learner executor — the actor-pool equivalent for real nodes.

Capability parity with the reference's Ray simulation stack for *protocol
mode* (p2pfl/learning/frameworks/simulation/actor_pool.py:69-357 SuperActorPool,
virtual_learner.py:31-141 VirtualNodeLearner): when many `Node` objects live
in one process, every `learner.fit()` must not run inline on its stage
thread — 50-100 concurrent fits would thrash the host and a single raising
learner takes its workflow down with no isolation. Instead, fit/eval jobs
are submitted to a shared capacity-bounded executor:

* **capacity control** — at most ``max_workers`` learner jobs execute at
  once (reference pool sizing: simulation/utils.py:33-96); excess jobs
  queue, bounding per-round wall-clock at ``ceil(K / capacity) * fit_time``,
* **crash isolation** — a job that raises only fails its own future; the
  worker thread survives and keeps serving other nodes (reference flags and
  respawns crashed Ray actors, actor_pool.py:228-262),
* **addr -> future bookkeeping** — one outstanding job per node address,
  matching the reference's `_addr_to_future` map (actor_pool.py:125-137),
* **device placement** — optionally pin jobs round-robin onto CUDA devices
  (``torch.cuda.device``: the job's current device, where its default
  allocations land), the analogue of Ray's per-actor GPU fraction; threads
  suffice because CUDA launches return at once and torch releases the GIL
  in its kernels.

The reference's `interrupt_fit` raises NotImplementedError for virtual
learners (virtual_learner.py:106-109); here it forwards to the wrapped
learner and takes effect between epochs — an upgrade.

The port's copy of ``p2pfl_tpu/parallel/executor.py``. ``devices`` names
CUDA devices (``"cuda:0"`` or a ``torch.device``; a CPU device pins
nothing), cycled over job by job.
"""

from __future__ import annotations

import itertools
import threading
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Dict, List, Optional, Sequence

import torch

from p2pfl_tpu_torch.config import Settings
from p2pfl_tpu_torch.learning.learner import Learner
from p2pfl_tpu_torch.models.model_handle import ModelHandle


class LearnerExecutor:
    """Capacity-bounded fit/eval executor shared by in-process nodes."""

    _default: Optional["LearnerExecutor"] = None
    _default_lock = threading.Lock()

    def __init__(
        self,
        max_workers: Optional[int] = None,
        devices: Optional[Sequence[Any]] = None,
    ) -> None:
        if max_workers is None:
            max_workers = Settings.EXECUTOR_MAX_WORKERS
        self.max_workers = int(max_workers)
        self.devices = list(devices) if devices else []
        self._device_cycle = itertools.cycle(self.devices) if self.devices else None
        self._pool = ThreadPoolExecutor(
            max_workers=self.max_workers, thread_name_prefix="learner-exec"
        )
        self._lock = threading.Lock()
        self._addr_to_future: Dict[str, Future] = {}
        self._active = 0
        self._peak_active = 0
        self._jobs_done = 0
        self._jobs_failed = 0
        self._closed = False

    # --- default (process-shared) instance -----------------------------------

    @classmethod
    def get_default(cls) -> "LearnerExecutor":
        """Process-wide shared executor (reference SuperActorPool singleton,
        actor_pool.py:85-96); created lazily on first node."""
        with cls._default_lock:
            if cls._default is None or cls._default._closed:
                cls._default = cls()
            return cls._default

    @classmethod
    def reset_default(cls) -> None:
        with cls._default_lock:
            if cls._default is not None:
                cls._default.shutdown(wait=False)
                cls._default = None

    # --- submission ----------------------------------------------------------

    def _run(self, kind: str, learner: Learner) -> Any:
        device = next(self._device_cycle) if self._device_cycle else None
        with self._lock:
            self._active += 1
            self._peak_active = max(self._peak_active, self._active)
        try:
            if device is not None and torch.device(device).type == "cuda":
                with torch.cuda.device(device):
                    return learner.fit() if kind == "fit" else learner.evaluate()
            return learner.fit() if kind == "fit" else learner.evaluate()
        except BaseException:
            with self._lock:
                self._jobs_failed += 1
            raise
        finally:
            with self._lock:
                self._active -= 1
                self._jobs_done += 1

    def submit(self, kind: str, addr: str, learner: Learner) -> Future:
        """Queue a fit/eval job for ``addr``; one outstanding job per addr."""
        if kind not in ("fit", "evaluate"):
            raise ValueError(f"unknown job kind {kind!r}")
        if self._closed:
            raise RuntimeError("executor is shut down")
        future = self._pool.submit(self._run, kind, learner)
        with self._lock:
            self._addr_to_future[addr] = future
        return future

    def get_result(self, addr: str, timeout: Optional[float] = None) -> Any:
        """Block for ``addr``'s outstanding job result; re-raises the job's
        exception (crash isolation: only this caller sees it)."""
        with self._lock:
            future = self._addr_to_future.get(addr)
        if future is None:
            raise KeyError(f"no outstanding job for {addr}")
        try:
            return future.result(timeout=timeout)
        finally:
            with self._lock:
                if self._addr_to_future.get(addr) is future:
                    del self._addr_to_future[addr]

    # --- introspection / lifecycle -------------------------------------------

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {
                "max_workers": self.max_workers,
                "active": self._active,
                "peak_active": self._peak_active,
                "jobs_done": self._jobs_done,
                "jobs_failed": self._jobs_failed,
            }

    def shutdown(self, wait: bool = True) -> None:
        self._closed = True
        self._pool.shutdown(wait=wait, cancel_futures=True)


class VirtualNodeLearner(Learner):
    """Learner decorator shipping fit/eval to a :class:`LearnerExecutor`
    (reference virtual_learner.py:31-141). All state accessors delegate to
    the wrapped learner; only fit/evaluate change execution venue."""

    def __init__(
        self,
        learner: Learner,
        executor: Optional[LearnerExecutor] = None,
        addr: Optional[str] = None,
    ) -> None:
        self.learner = learner
        self.executor = executor if executor is not None else LearnerExecutor.get_default()
        self._addr = addr if addr is not None else learner._self_addr

    # --- delegation ----------------------------------------------------------

    def set_model(self, model: ModelHandle) -> None:
        self.learner.set_model(model)

    def get_model(self) -> ModelHandle:
        return self.learner.get_model()

    def set_data(self, data: Any) -> None:
        self.learner.set_data(data)

    def get_data(self) -> Any:
        return self.learner.get_data()

    def set_addr(self, addr: str) -> None:
        self._addr = addr
        self.learner.set_addr(addr)

    def set_epochs(self, epochs: int) -> None:
        self.learner.set_epochs(epochs)

    @property
    def epochs(self) -> int:  # type: ignore[override]
        return self.learner.epochs

    @epochs.setter
    def epochs(self, value: int) -> None:
        self.learner.epochs = value

    @property
    def metric_reporter(self):  # type: ignore[override]
        return self.learner.metric_reporter

    @metric_reporter.setter
    def metric_reporter(self, fn) -> None:
        self.learner.metric_reporter = fn

    def get_framework(self) -> str:
        return self.learner.get_framework()

    def __getattr__(self, name: str) -> Any:
        # Fall through for learner-specific attributes (e.g. `_scaffold`,
        # `callbacks`) so wrapping stays transparent to stages and tests.
        if name == "learner":  # guard: not yet assigned during __init__
            raise AttributeError(name)
        return getattr(self.learner, name)

    # --- execution venue ------------------------------------------------------

    def fit(self) -> ModelHandle:
        # Hold our own future: concurrent jobs for the same addr (e.g. a
        # metrics probe racing a fit) must not cross-wire results through
        # the shared addr map.
        future = self.executor.submit("fit", self._addr, self.learner)
        return future.result(timeout=Settings.AGGREGATION_TIMEOUT)

    def evaluate(self) -> Dict[str, float]:
        future = self.executor.submit("evaluate", self._addr, self.learner)
        return future.result(timeout=Settings.AGGREGATION_TIMEOUT)

    def interrupt_fit(self) -> None:
        # Forward to the wrapped learner: takes effect between epochs
        # (NotImplementedError in the reference, virtual_learner.py:106-109).
        self.learner.interrupt_fit()
