"""Resource monitor thread (reference management/node_monitor.py:31-86):
psutil cpu%, ram%, net MBps reported each RESOURCE_MONITOR_PERIOD.

Without psutil the monitor is inert: ``available`` is False so callers and
tests can tell monitoring is off, and the first ``start()`` logs a one-time
warning instead of silently doing nothing.

The port's copy of ``p2pfl_tpu/management/node_monitor.py``.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Callable, Optional

try:
    import psutil
except ImportError:  # pragma: no cover
    psutil = None

from p2pfl_tpu_torch.config import Settings

log = logging.getLogger("p2pfl_tpu_torch")


class NodeMonitor:
    #: False when psutil is missing — no system metrics will be reported.
    available: bool = psutil is not None

    _warned_unavailable = False  # process-wide: warn once, not per node

    def __init__(self, node_addr: str, report_fn: Callable[[str, str, float], None]) -> None:
        self._node = node_addr
        self._report = report_fn
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> None:
        if psutil is None:
            if not NodeMonitor._warned_unavailable:
                NodeMonitor._warned_unavailable = True
                log.warning(
                    "psutil is not installed — system resource monitoring "
                    "(cpu/ram/net gauges) is disabled for this process"
                )
            return
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._run, name=f"monitor-{self._node}", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=1.0)
            self._thread = None

    def _run(self) -> None:
        last_net = psutil.net_io_counters()
        last_t = time.time()
        while not self._stop.wait(Settings.RESOURCE_MONITOR_PERIOD):
            try:
                self._report(self._node, "cpu_percent", psutil.cpu_percent(interval=None))
                self._report(self._node, "ram_percent", psutil.virtual_memory().percent)
                net = psutil.net_io_counters()
                now = time.time()
                dt = max(now - last_t, 1e-6)
                self._report(
                    self._node, "net_in_mbps", (net.bytes_recv - last_net.bytes_recv) / dt / 1e6
                )
                self._report(
                    self._node, "net_out_mbps", (net.bytes_sent - last_net.bytes_sent) / dt / 1e6
                )
                last_net, last_t = net, now
            except Exception:
                pass
