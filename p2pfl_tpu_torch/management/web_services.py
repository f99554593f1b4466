"""REST telemetry client.

Parity with reference management/p2pfl_web_services.py:58-268 (POST /node,
/node-log, /node-metric/local, /node-metric/global, /node-metric/system).
Uses stdlib urllib (no extra deps); failures are swallowed — telemetry can
never take a node down.

Failure handling: a *recoverable* breaker, not the old permanently-sticky
``_broken`` flag (one transient POST failure used to disable web telemetry
for the process lifetime). After ``fail_threshold`` consecutive failures the
breaker opens for an exponentially growing window (``backoff_base`` up to
``backoff_max``); once the window expires the next call re-probes, and a
single re-probe failure re-opens the window doubled. Every suppressed or
failed POST is counted in the telemetry registry
(``p2pfl_web_telemetry_drops_total``), so operators can see how much web
telemetry was lost and why.

The port's copy of ``p2pfl_tpu/management/web_services.py``.
"""

from __future__ import annotations

import json
import logging
import threading
import time
import urllib.request
from typing import Any, Dict

from p2pfl_tpu_torch.telemetry import REGISTRY

log = logging.getLogger("p2pfl_tpu_torch")

_DROPS = REGISTRY.counter(
    "p2pfl_web_telemetry_drops_total",
    "Web telemetry POSTs lost, by reason (post_failed | breaker_open)",
    labels=("reason",),
)


class WebServices:
    def __init__(
        self,
        url: str,
        key: str,
        timeout: float = 5.0,
        fail_threshold: int = 3,
        backoff_base: float = 1.0,
        backoff_max: float = 300.0,
    ) -> None:
        self._url = url.rstrip("/")
        self._key = key
        self._timeout = timeout
        self._fail_threshold = max(1, int(fail_threshold))
        self._backoff_base = float(backoff_base)
        self._backoff_max = float(backoff_max)
        self._lock = threading.Lock()
        self._consecutive_failures = 0
        self._breaker_trips = 0  # consecutive open->reprobe->fail cycles
        self._blocked_until = 0.0  # monotonic deadline of the open window

    @property
    def broken(self) -> bool:
        """True while the breaker window is open (calls are dropped)."""
        with self._lock:
            return time.monotonic() < self._blocked_until

    def _post(self, path: str, body: Dict[str, Any]) -> None:
        with self._lock:
            if time.monotonic() < self._blocked_until:
                _DROPS.labels("breaker_open").inc()
                return
        try:
            req = urllib.request.Request(
                self._url + path,
                data=json.dumps(body).encode(),
                headers={"Content-Type": "application/json", "x-api-key": self._key},
                method="POST",
            )
            with urllib.request.urlopen(req, timeout=self._timeout):
                pass
        except Exception as exc:
            self._record_failure(exc)
        else:
            with self._lock:
                self._consecutive_failures = 0
                self._breaker_trips = 0

    def _record_failure(self, exc: Exception) -> None:
        _DROPS.labels("post_failed").inc()
        with self._lock:
            self._consecutive_failures += 1
            # After the first trip a single failed re-probe re-opens the
            # window — re-probing is one attempt, not a fresh threshold.
            threshold = 1 if self._breaker_trips else self._fail_threshold
            if self._consecutive_failures < threshold:
                return
            self._breaker_trips += 1
            self._consecutive_failures = 0
            backoff = min(
                self._backoff_base * (2 ** (self._breaker_trips - 1)),
                self._backoff_max,
            )
            self._blocked_until = time.monotonic() + backoff
        log.warning(
            "web telemetry paused for %.1fs after failure: %s", backoff, exc
        )

    def register_node(self, node: str) -> None:
        self._post("/node", {"address": node})

    def unregister_node(self, node: str) -> None:
        self._post("/node-remove", {"address": node})

    def send_log(self, node: str, level: str, message: str) -> None:
        self._post("/node-log", {"address": node, "level": level, "message": message})

    def send_local_metric(
        self, node: str, exp: str, metric: str, value: float, round: int, step: int
    ) -> None:
        self._post(
            "/node-metric/local",
            {"address": node, "experiment": exp, "metric": metric, "value": value,
             "round": round, "step": step},
        )

    def send_global_metric(
        self, node: str, exp: str, metric: str, value: float, round: int
    ) -> None:
        self._post(
            "/node-metric/global",
            {"address": node, "experiment": exp, "metric": metric, "value": value, "round": round},
        )

    def send_system_metric(self, node: str, metric: str, value: float) -> None:
        self._post("/node-metric/system", {"address": node, "metric": metric, "value": value})
