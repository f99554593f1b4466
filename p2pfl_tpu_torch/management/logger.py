"""Framework logger: python-logging + metric routing, async by default.

Capability parity with the reference logger stack (management/logger/
logger.py:87-454 and the decorator chain in logger/__init__.py:28-35,
including AsyncLogger, decorators/async_logger.py:29-70). Instead of a
decorator tower, one logger object owns pluggable sinks: stdout/file
handlers, the two-level metric store, an optional web telemetry pusher, and
per-node resource monitors. A process-wide singleton instance is exposed as
``logger``.

Async: hot-path log calls (gossip ticks, heartbeats, stage transitions)
only enqueue a record into a ``QueueHandler``; a ``QueueListener`` thread
runs the real handlers, so the gossip/heartbeat threads never block on
stdout or file IO. ``flush()`` drains the queue (registered atexit).

The port's copy of ``p2pfl_tpu/management/logger.py``.
"""

from __future__ import annotations

import atexit
import datetime
import logging
import logging.handlers
import os
import queue
import threading
from typing import Dict, Optional

from p2pfl_tpu_torch.config import Settings
from p2pfl_tpu_torch.experiment import Experiment
from p2pfl_tpu_torch.management.metric_storage import GlobalMetricStorage, LocalMetricStorage
from p2pfl_tpu_torch.utils.singleton import SingletonMeta


class P2pflTpuLogger(metaclass=SingletonMeta):
    def __init__(self) -> None:
        self._log = logging.getLogger("p2pfl_tpu_torch")
        self._log.setLevel(getattr(logging, Settings.LOG_LEVEL, logging.INFO))
        # Async sink: the logger carries ONE QueueHandler; the listener
        # thread owns the real handlers (reference async_logger.py:29-70).
        for h in list(self._log.handlers):
            self._log.removeHandler(h)
        self._queue: "queue.SimpleQueue[logging.LogRecord]" = queue.SimpleQueue()
        self._log.addHandler(logging.handlers.QueueHandler(self._queue))
        stream = logging.StreamHandler()
        stream.setFormatter(
            logging.Formatter("[%(asctime)s] [%(levelname)s] %(message)s", "%H:%M:%S")
        )
        self._listener = logging.handlers.QueueListener(
            self._queue, stream, respect_handler_level=True
        )
        self._listener.start()
        atexit.register(self.flush)
        self._file_handler: Optional[logging.Handler] = None
        self.local_metrics = LocalMetricStorage()
        self.global_metrics = GlobalMetricStorage()
        self._nodes: Dict[str, Optional[Experiment]] = {}
        self._lock = threading.Lock()
        self._web_services = None
        self._monitors: Dict[str, object] = {}

    # --- plain logging ------------------------------------------------------

    def set_level(self, level: str) -> None:
        self._log.setLevel(getattr(logging, level, logging.INFO))

    def enable_file_logging(self, log_dir: Optional[str] = None) -> str:
        """Per-run log file under Settings.LOG_DIR (reference
        decorators/file_logger.py:30-56). The file handler joins the async
        listener, not the logger — writes never block the hot path."""
        log_dir = log_dir or Settings.LOG_DIR
        os.makedirs(log_dir, exist_ok=True)
        path = os.path.join(
            log_dir, f"p2pfl_tpu_torch-{datetime.datetime.now():%Y%m%d-%H%M%S}.log"
        )
        handlers = [h for h in self._listener.handlers if h is not self._file_handler]
        if self._file_handler is not None:
            self._file_handler.close()
        self._file_handler = logging.FileHandler(path)
        self._file_handler.setFormatter(
            logging.Formatter("[%(asctime)s] [%(levelname)s] %(message)s")
        )
        self._listener.handlers = tuple(handlers) + (self._file_handler,)
        return path

    def flush(self) -> None:
        """Drain the async queue so every enqueued record has been handled
        (stop processes the backlog, then the listener is restarted)."""
        listener = getattr(self, "_listener", None)
        if listener is None or listener._thread is None:
            return
        listener.stop()
        listener.start()

    def debug(self, node: str, msg: str) -> None:
        self._log.debug("(%s) %s", node, msg)

    def info(self, node: str, msg: str) -> None:
        self._log.info("(%s) %s", node, msg)

    def warning(self, node: str, msg: str) -> None:
        self._log.warning("(%s) %s", node, msg)

    def error(self, node: str, msg: str) -> None:
        self._log.error("(%s) %s", node, msg)

    # --- telemetry sinks ----------------------------------------------------

    def connect_web(self, url: str, key: str) -> None:
        """Attach the REST telemetry sink (reference decorators/
        web_logger.py:93-196)."""
        from p2pfl_tpu_torch.management.web_services import WebServices

        self._web_services = WebServices(url, key)

    # --- node lifecycle (reference logger.py:306-454) -----------------------

    def register_node(self, node: str, simulation: bool = False) -> None:
        with self._lock:
            self._nodes[node] = None
        if self._web_services is not None:
            self._web_services.register_node(node)
        if Settings.RESOURCE_MONITOR_PERIOD > 0:
            from p2pfl_tpu_torch.management.node_monitor import NodeMonitor

            mon = NodeMonitor(node, self.log_system_metric)
            self._monitors[node] = mon
            mon.start()

    def unregister_node(self, node: str) -> None:
        with self._lock:
            self._nodes.pop(node, None)
        mon = self._monitors.pop(node, None)
        if mon is not None:
            mon.stop()  # type: ignore[attr-defined]

    def experiment_started(self, node: str, experiment: Experiment) -> None:
        with self._lock:
            self._nodes[node] = experiment
        self.info(node, f"experiment started: {experiment}")

    def experiment_finished(self, node: str) -> None:
        with self._lock:
            self._nodes[node] = None
        self.info(node, "experiment finished")

    def round_finished_info(self, node: str, round: int) -> None:
        self.info(node, f"round {round} finished")

    # --- metrics (reference logger.py:266-305 routing) ----------------------

    def log_metric(
        self,
        node: str,
        metric: str,
        value: float,
        step: Optional[int] = None,
        round: Optional[int] = None,
    ) -> None:
        with self._lock:
            exp = self._nodes.get(node)
        exp_name = exp.exp_name if exp is not None else "default"
        if round is None:
            round = exp.round if exp is not None else 0
        if step is None:
            # round-wise -> global storage
            self.global_metrics.add(exp_name, node, metric, value, round or 0)
            if self._web_services is not None:
                self._web_services.send_global_metric(node, exp_name, metric, value, round or 0)
        else:
            self.local_metrics.add(exp_name, round or 0, node, metric, value, step)
            if self._web_services is not None:
                self._web_services.send_local_metric(
                    node, exp_name, metric, value, round or 0, step
                )

    def log_system_metric(self, node: str, metric: str, value: float) -> None:
        if self._web_services is not None:
            self._web_services.send_system_metric(node, metric, value)

    def get_local_logs(self):
        return self.local_metrics.get_all()

    def get_global_logs(self):
        return self.global_metrics.get_all()

    @classmethod
    def reset(cls) -> None:
        """Drop the singleton (tests)."""
        inst = SingletonMeta._instances.get(cls)
        if inst is not None:
            for mon in list(inst._monitors.values()):
                try:
                    mon.stop()  # type: ignore[attr-defined]
                except Exception:
                    pass
            try:
                inst._listener.stop()
                atexit.unregister(inst.flush)
            except Exception:
                pass
        SingletonMeta.reset(cls)


def get_logger() -> P2pflTpuLogger:
    return P2pflTpuLogger()


logger = get_logger()
