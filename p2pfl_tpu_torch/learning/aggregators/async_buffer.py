"""Buffered asynchronous aggregation with staleness weighting (counterpart of
``p2pfl_tpu/learning/aggregators/async_buffer.py``).

The sync stage machine is bulk-synchronous: a round blocks on a vote barrier
and an aggregation deadline, so one slow committee member sets fleet p99.
This module is the async alternative in the Papaya / FedBuff style (arxiv
2111.04877, which extends the JIT-aggregation idea of arxiv 2208.09740 the
stall patience already uses): contributions are folded into a per-window
buffer AS THEY ARRIVE, each tagged with the window it trained against, and
the window closes as soon as a fill target is met (or a timeout expires) —
stragglers contribute LATE instead of being waited on or abandoned.

Weighting: a contribution that trained against window ``w - l`` (lag ``l``)
is weighted ``num_samples * staleness_weight(l)`` with the polynomial decay
``(1 + l) ** -alpha`` (Papaya §4's ``1/sqrt(1+l)`` is ``alpha = 0.5``, the
default). At ``l = 0`` the weight is exactly ``num_samples`` — a window whose
contributions are all fresh aggregates BIT-EXACTLY like
:class:`~p2pfl_tpu_torch.learning.aggregators.fedavg.FedAvg` (same
reduction, same weights).

Robust-rule interop: when the node runs a non-linear aggregation rule
(Krum/TrimmedMean/...), the window aggregate delegates to that rule over the
buffered models — the rules see individual contributions exactly as they do
on the sync path, so the Byzantine defense plane carries over unchanged.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional, Tuple

import torch

from p2pfl_tpu_torch.config import Settings
from p2pfl_tpu_torch.models.model_handle import ModelHandle
from p2pfl_tpu_torch.learning.aggregators.fedavg import sample_weights
from p2pfl_tpu_torch.ops import aggregation as agg_ops
from p2pfl_tpu_torch.telemetry import REGISTRY
from p2pfl_tpu_torch.telemetry.ledger import LEDGERS

_FOLDED = REGISTRY.counter(
    "p2pfl_async_contributions_total",
    "Contributions folded into the async buffer, by freshness "
    "(self | fresh: zero lag | stale: positive lag)",
    labels=("node", "kind"),
)
_DROPPED = REGISTRY.counter(
    "p2pfl_async_dropped_total",
    "Async contributions rejected before folding, by reason",
    labels=("node", "reason"),
)
_STALENESS = REGISTRY.gauge(
    "p2pfl_async_staleness",
    "Mean window lag of the contributions aggregated in the last window",
    labels=("node",),
)
_WINDOWS = REGISTRY.counter(
    "p2pfl_async_windows_total",
    "Async aggregation windows completed",
    labels=("node",),
)
_WINDOW_FILL = REGISTRY.gauge(
    "p2pfl_async_window_fill",
    "Distinct contributors aggregated in the last window",
    labels=("node",),
)
_WINDOW_CLOSE = REGISTRY.counter(
    "p2pfl_async_window_close_total",
    "Async windows closed, by reason (fill: target met; shrink: a live-"
    "shrunk target met after membership loss; timeout: deadline expired)",
    labels=("node", "reason"),
)


def staleness_discount(lag, alpha) -> torch.Tensor:
    """THE staleness formula: ``(1 + max(lag, 0)) ** -alpha`` in float32, for
    scalars or arrays. Exactly ``1.0`` at ``lag = 0`` for every alpha (so a
    fresh window aggregates as plain FedAvg) and identically ``1.0`` for
    ``alpha = 0`` (discount disabled)."""
    lag_f = torch.clamp(torch.as_tensor(lag, dtype=torch.float32), min=0.0)
    return (1.0 + lag_f) ** (-torch.tensor(float(alpha), dtype=torch.float32))


def staleness_weight(lag: int, alpha: Optional[float] = None) -> float:
    """Host-scalar convenience wrapper over :func:`staleness_discount`
    (Settings-defaulted alpha, int lag). Monotonically non-increasing in
    ``lag``; exactly ``1.0`` at ``lag = 0`` — see the pure function for
    the bit-exactness contract.
    """
    a = Settings.ASYNC_STALENESS_ALPHA if alpha is None else float(alpha)
    return float(staleness_discount(max(0, int(lag)), a))


class AsyncBufferedAggregator:
    """Per-node contribution buffer for one async experiment.

    Thread-safety: ``fold`` runs on transport threads, ``wait_window`` /
    ``drain`` on the scheduler thread; one lock guards the buffer, an Event
    wakes the window wait on every fold and on membership changes
    (:meth:`notify` — the death callbacks' re-evaluation hook).
    """

    def __init__(self, addr: str, rule: Optional[Callable[[List[ModelHandle]], ModelHandle]] = None) -> None:
        self.addr = addr
        #: non-None => window aggregation delegates to this robust rule
        #: (``rule(models) -> ModelHandle``); None => staleness-weighted
        #: FedAvg through the jitted kernel.
        self.rule = rule
        self._lock = threading.Lock()
        #: sender -> (model, lag-at-fold) — newest contribution per sender
        #: wins, so a sender that produced twice within one window is counted
        #: once (its fresher model).
        self._buffer: Dict[str, Tuple[ModelHandle, int]] = {}
        self._window = 0
        self._event = threading.Event()
        #: every sender folded at least once this experiment (the bench /
        #: async-check "joiner contributed within N windows" probe).
        self.seen_contributors: Dict[str, int] = {}  # sender -> first window
        self._last_mean_lag = 0.0
        #: exact lags of every contribution aggregated (bounded).
        self.lag_log: deque = deque(maxlen=4096)
        #: why the last window closed ("fill" | "shrink" | "timeout") and
        #: how full it was — stamped onto the window_close marker span so
        #: the critical-path analyzer can break windows down by reason.
        self.last_close_reason = ""
        self.last_fill = 0

    # --- window lifecycle ----------------------------------------------------

    @property
    def window(self) -> int:
        with self._lock:
            return self._window

    def open_window(self, window: int) -> None:
        """Advance the window counter. The buffer is NOT cleared: anything
        that arrived after the previous drain belongs to this window."""
        with self._lock:
            self._window = int(window)
        self._event.set()  # re-evaluate any in-flight wait against the new index

    def notify(self) -> None:
        """Wake the window wait to re-evaluate its fill target (membership
        changed — a peer died or joined)."""
        self._event.set()

    # --- feeding -------------------------------------------------------------

    def fold(self, model: ModelHandle, origin_window: int, sender: str) -> bool:
        """Buffer one contribution that trained against ``origin_window``.

        Lag is clamped at 0 (a faster peer's future-window contribution is
        simply fresh). Contributions beyond ``ASYNC_MAX_STALENESS`` are
        dropped and counted. Returns True when buffered.
        """
        with self._lock:
            lag = max(0, self._window - int(origin_window))
            if Settings.ASYNC_MAX_STALENESS and lag > Settings.ASYNC_MAX_STALENESS:
                _DROPPED.labels(self.addr, "stale_limit").inc()
                return False
            self._buffer[sender] = (model, lag)
            self.seen_contributors.setdefault(sender, self._window)
            window_now = self._window
        if sender == self.addr:
            kind = "self"
        else:
            kind = "fresh" if lag == 0 else "stale"
        _FOLDED.labels(self.addr, kind).inc()
        # Trajectory ledger: the async fold is the window's contribution
        # event, lag included (the sync path's analogue lives in
        # Aggregator.add_model with lag pinned to 0).
        LEDGERS.emit(
            self.addr, "contribution_folded", round=window_now,
            sender=sender, lag=int(lag), num_samples=model.get_num_samples(),
        )
        self._event.set()
        return True

    def drop(self, sender: str, reason: str) -> None:
        """Count a pre-fold rejection (suspect gating, no-experiment...)."""
        _DROPPED.labels(self.addr, reason).inc()

    def fill(self) -> int:
        with self._lock:
            return len(self._buffer)

    # --- consuming -----------------------------------------------------------

    def wait_window(
        self,
        target_fn: Callable[[], int],
        timeout: Optional[float] = None,
        early_stop_fn: Optional[Callable[[], bool]] = None,
    ) -> Optional[ModelHandle]:
        """Block until the buffer holds ``target_fn()`` distinct contributors
        or ``timeout`` expires, then drain and aggregate.

        ``target_fn`` is re-evaluated on every wake (fold / death callback /
        :meth:`notify`), so the target SHRINKS live as peers die — the
        all-trainers-dead window completes with the own contribution alone
        instead of sleeping out the timeout.
        """
        timeout = Settings.ASYNC_WINDOW_TIMEOUT if timeout is None else timeout
        deadline = time.monotonic() + timeout
        initial_target = max(1, int(target_fn()))
        while True:
            if early_stop_fn is not None and early_stop_fn():
                return None
            target = max(1, int(target_fn()))
            with self._lock:
                have = len(self._buffer)
            if have > 0 and have >= target:
                # Close-reason attribution: a target met only because it
                # SHRANK below its window-open value is a membership story,
                # not a throughput one — the window report separates them.
                self.last_close_reason = (
                    "shrink" if target < initial_target and have < initial_target
                    else "fill"
                )
                break
            if have > 0 and time.monotonic() >= deadline:
                self.last_close_reason = "timeout"
                break
            # have == 0 past the deadline: keep a short grace loop (the own
            # contribution is still being produced) rather than raising.
            self._event.clear()
            self._event.wait(timeout=0.25)
        _WINDOW_CLOSE.labels(self.addr, self.last_close_reason).inc()
        return self._aggregate_drained()

    def _aggregate_drained(self) -> ModelHandle:
        with self._lock:
            drained = list(self._buffer.values())
            self._buffer.clear()
        if not drained:
            raise RuntimeError("async window drained empty")
        models = [m for m, _ in drained]
        lags = [lag for _, lag in drained]
        self._last_mean_lag = sum(lags) / len(lags)
        self.last_fill = len(models)
        _STALENESS.labels(self.addr).set(self._last_mean_lag)
        _WINDOW_FILL.labels(self.addr).set(len(models))
        _WINDOWS.labels(self.addr).inc()
        # Per-contribution lags (the JAX package also feeds them to its
        # staleness sketch, which waits for the port's telemetry/sketches.py).
        for lag in lags:
            self.lag_log.append(int(lag))
        if self.rule is not None:
            return self.rule(models)
        return self.aggregate_weighted(models, lags)

    @property
    def last_mean_lag(self) -> float:
        return self._last_mean_lag

    @staticmethod
    def aggregate_weighted(
        models: List[ModelHandle], lags: List[int], alpha: Optional[float] = None
    ) -> ModelHandle:
        """Staleness-weighted FedAvg over ``models``.

        Weights are ``num_samples * staleness_discount(lag, alpha)`` computed
        as a float32 product; at all-zero lag this is float for float the
        reduction of :meth:`FedAvg.aggregate` (the discount is exactly 1.0,
        weights reduce to the plain sample counts), hence bit-exact.
        """
        a = Settings.ASYNC_STALENESS_ALPHA if alpha is None else float(alpha)
        stacked = agg_ops.tree_stack([m.params for m in models])
        weights = sample_weights(models) * staleness_discount([int(l) for l in lags], a).to(models[0].device)
        out = agg_ops.fedavg(stacked, weights)
        contributors: List[str] = []
        for m in models:
            contributors.extend(m.contributors)
        total = sum(m.get_num_samples() for m in models)
        return models[0].build_copy(
            params=out, contributors=sorted(set(contributors)), num_samples=total
        )

    def clear(self) -> None:
        with self._lock:
            self._buffer.clear()
        self._event.set()


__all__ = ["AsyncBufferedAggregator", "staleness_discount", "staleness_weight"]
