"""Streaming cohort scheduler — trace-driven arrivals for async windows
(counterpart of ``p2pfl_tpu/population/arrivals.py``: host-only numpy and
blake2b, so every schedule equals the JAX package's exactly).

The sync population engine compiles a ``[rounds, K]`` committee schedule:
every round solicits a cohort and BLOCKS on all of it. This module is the
async replacement: a *streaming* scheduler in the Papaya / FedBuff mold
(arxiv 2111.04877) where window ``w`` solicits a trace-scaled slice of the
blake2b cohort stream, each solicited vnode draws a seeded arrival delay
from its device speed tier, and the contribution FOLDS in the window it
arrives in — with the exact ``w - origin`` lag the staleness discount
(:func:`~p2pfl_tpu_torch.learning.aggregators.async_buffer.staleness_discount`)
will weight it by. JIT-aggregation stall patience (arxiv 2208.09740) is the
backpressure rule: solicitation pauses while the pending queue is deeper
than ``stall_patience * K`` so a flash crowd cannot grow staleness without
bound.

Everything here is a pure function of ``(plan, names, speeds)``:

* the cohort stream is the same ``blake2b(seed:window:name)`` ranking the
  sync scheduler uses (:mod:`p2pfl_tpu_torch.population.cohort`), so at zero
  delay the async window program IS the sync round program, member for
  member and key for key;
* arrival delays hash in an independent ``arrive:`` domain, scaled by the
  vnode's speed tier — a tier-1 device always lands in its origin window,
  a tier-5 device lands 0-4 windows late;
* trace intensities (uniform / diurnal / regional / flash) are functions
  of the ABSOLUTE window index, so a resumed engine re-streams the
  identical schedule from window 0 and discards the pre-cursor prefix —
  the same cursor semantics as ``PopulationEngine``'s committee replay.

The compiled :class:`WindowSchedule` is consumed twice: the fused engine
(:mod:`p2pfl_tpu_torch.population.async_engine`) walks its arrays window by
window, and the wire-replay parity arm drives the real
:class:`~p2pfl_tpu_torch.learning.aggregators.async_buffer.AsyncBufferedAggregator`
through the same fold stream — which is what lets ``parity_diff`` gate the
two backends hash-for-hash.
"""

from __future__ import annotations

import hashlib
import math
from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

import numpy as np

from p2pfl_tpu_torch.config import Settings
from p2pfl_tpu_torch.population.cohort import CohortPlan, cohort_size

#: window-close codes the fused engine emits (integers, not strings).
CLOSE_FILL = 0
CLOSE_TIMEOUT = 1
CLOSE_STALL = 2
CLOSE_REASONS = {CLOSE_FILL: "fill", CLOSE_TIMEOUT: "timeout", CLOSE_STALL: "stall"}

TRACES = ("uniform", "diurnal", "regional", "flash")


def trace_intensity(
    trace: str,
    window: int,
    period: Optional[int] = None,
    flash_mult: Optional[float] = None,
) -> float:
    """Relative arrival intensity in ``(0, 1]`` at an ABSOLUTE window index.

    ``1.0`` means "solicit the full cohort K"; lower values solicit a
    proportional slice. Periodic by construction (no run-horizon input), so
    the stream is resume-safe at any cursor.

    * ``uniform`` — constant 1.0;
    * ``diurnal`` — sinusoid over ``period`` windows, trough 0.1, peak 1.0;
    * ``regional`` — three phase-shifted diurnal waves at 0.5/0.3/0.2
      population weight (staggered time zones: never fully dark, never
      fully peaked);
    * ``flash`` — quiet baseline ``1/flash_mult`` with a ``flash_mult``-fold
      spike to 1.0 over the first fifth of every period (the 10x flash
      crowd at the defaults).
    """
    p = int(Settings.ARRIVAL_TRACE_PERIOD if period is None else period)
    if trace == "uniform":
        return 1.0
    if trace == "diurnal":
        return 0.55 + 0.45 * math.sin(2.0 * math.pi * (window % p) / p)
    if trace == "regional":
        out = 0.0
        for weight, phase in ((0.5, 0.0), (0.3, 1.0 / 3.0), (0.2, 2.0 / 3.0)):
            out += weight * (
                0.55 + 0.45 * math.sin(2.0 * math.pi * ((window % p) / p + phase))
            )
        return out
    if trace == "flash":
        mult = float(
            Settings.ARRIVAL_FLASH_MULT if flash_mult is None else flash_mult
        )
        spike = max(1, p // 5)
        return 1.0 if (window % p) < spike else 1.0 / mult
    raise ValueError(f"unknown arrival trace {trace!r} (want one of {TRACES})")


def arrival_delay(seed: int, origin_window: int, name: str, speed: float) -> int:
    """Seeded per-(window, vnode) arrival delay in WINDOWS.

    ``int(speed * u)`` with ``u ~ U[0, 1)`` drawn from the independent
    ``arrive:`` blake2b domain — a tier-1.0 device is always fresh
    (delay 0), a tier-``s`` device is up to ``ceil(s) - 1`` windows late.
    Same hash-domain trick as the ``churn:`` availability trace: delay and
    cohort rank never correlate.
    """
    if speed <= 1.0:
        return 0
    h = hashlib.blake2b(
        f"arrive:{int(seed)}:{int(origin_window)}:{name}".encode(), digest_size=8
    )
    u = int.from_bytes(h.digest(), "big") / float(1 << 64)
    return int(float(speed) * u)


@dataclass(frozen=True)
class AsyncWindowPlan:
    """A fully-seeded async window policy: cohort sampler + arrival model +
    close rules. One plan describes both backends' window stream (the fused
    engine and the wire replay), the way :class:`CohortPlan` describes both
    backends' sync cohorts. ``None`` async fields inherit the
    ``ASYNCPOP_*`` knobs at construction."""

    seed: int
    fraction: float
    min_size: int = 1
    churn_rate: float = 0.0
    names: Optional[tuple] = field(default=None)
    trace: str = "uniform"
    period: Optional[int] = None
    flash_mult: Optional[float] = None
    fill_fraction: Optional[float] = None
    timeout_ticks: Optional[int] = None
    stall_patience: Optional[int] = None
    max_lag: Optional[int] = None

    def __post_init__(self) -> None:
        if self.trace not in TRACES:
            raise ValueError(
                f"unknown arrival trace {self.trace!r} (want one of {TRACES})"
            )

    @property
    def cohort_plan(self) -> CohortPlan:
        return CohortPlan(
            seed=self.seed,
            fraction=self.fraction,
            min_size=self.min_size,
            churn_rate=self.churn_rate,
            names=self.names,
        )

    def resolved(self) -> Tuple[float, int, int, int]:
        """(fill_fraction, timeout_ticks, stall_patience, max_lag) with
        ``None`` fields resolved against the current Settings."""
        return (
            float(
                Settings.ASYNCPOP_FILL_FRACTION
                if self.fill_fraction is None
                else self.fill_fraction
            ),
            int(
                Settings.ASYNCPOP_TIMEOUT_TICKS
                if self.timeout_ticks is None
                else self.timeout_ticks
            ),
            int(
                Settings.ASYNCPOP_STALL_PATIENCE
                if self.stall_patience is None
                else self.stall_patience
            ),
            int(Settings.ASYNCPOP_MAX_LAG if self.max_lag is None else self.max_lag),
        )

    def intensity(self, window: int) -> float:
        return trace_intensity(self.trace, window, self.period, self.flash_mult)


@dataclass(frozen=True)
class WindowSchedule:
    """The compiled fold stream for ``windows`` windows — fixed-shape
    ``[W, K]`` / ``[W]`` arrays. The present slots of a window are a prefix
    of its row (slot ``s`` is the ``s``-th fold).

    Slot semantics: window ``w`` folds the contributions in slots where
    ``present[w]`` is True; ``members[w, s]`` trained against the global of
    window ``origin[w, s]`` and folds with lag ``lag[w, s]``; ``rank[w, s]``
    is the member's position in its origin window's SORTED cohort — the
    slot rank both backends derive the member's RNG key from (the sync
    committee-rank convention, so zero-lag windows reuse the sync keys
    bit-for-bit). Absent slots are zeroed and must be masked by
    ``present``.
    """

    start_window: int
    cohort_k: int
    members: np.ndarray  #: [W, K] int32 node indices (0 where absent)
    present: np.ndarray  #: [W, K] bool fold mask
    origin: np.ndarray  #: [W, K] int32 absolute origin window
    lag: np.ndarray  #: [W, K] int32 fold-window lag (== w_abs - origin)
    rank: np.ndarray  #: [W, K] int32 rank in the origin cohort
    target: np.ndarray  #: [W] int32 trace-driven fill target (>= 1)
    solicited: np.ndarray  #: [W] int32 how many vnodes window w solicited
    queue_depth: np.ndarray  #: [W] int32 pending undelivered AFTER window w
    dropped: np.ndarray  #: [W] int32 stale contributions dropped at window w

    @property
    def windows(self) -> int:
        return int(self.members.shape[0])

    def fill(self) -> np.ndarray:
        """Realized per-window fold count ``[W]`` (present-slot sum)."""
        return self.present.sum(axis=1).astype(np.int32)


def compile_window_schedule(
    plan: AsyncWindowPlan,
    node_names: Sequence[str],
    windows: int,
    start_window: int = 0,
    speeds: Optional[np.ndarray] = None,
) -> WindowSchedule:
    """Stream the arrival process and compile ``windows`` fold rows starting
    at the ABSOLUTE cursor ``start_window``.

    The stream is a pure function of ``(plan, names, speeds)``: resuming at
    a cursor re-streams from window 0 and keeps only the requested rows, so
    chunked driving, checkpoint resume, and one long call compile the
    identical schedule (asserted by tests/test_asyncpop.py).

    Per window ``w`` the scheduler:

    1. solicits the ``round(K * intensity(w))`` lowest-ranked members of
       the blake2b cohort for ``w`` that have no contribution still in
       flight (one pending contribution per vnode — the wire buffer's
       newest-per-sender dedup, enforced at solicitation time), unless the
       pending queue is deeper than ``stall_patience * K`` (backpressure:
       solicitation pauses, the queue drains);
    2. draws each solicited member's arrival window from its speed tier;
    3. folds the (up to) K oldest pending contributions that have arrived,
       oldest-arrival first — contributions older than ``max_lag`` are
       dropped and counted, exactly like the wire buffer's
       ``ASYNC_MAX_STALENESS`` gate.
    """
    if windows < 0 or start_window < 0:
        raise ValueError(
            f"windows={windows} and start_window={start_window} must be >= 0"
        )
    names = [str(n) for n in node_names]
    n = len(names)
    index = {nm: i for i, nm in enumerate(names)}
    if speeds is None:
        speed_of = np.ones(n, np.float32)
    else:
        speed_of = np.asarray(speeds, np.float32)
        if speed_of.shape != (n,):
            raise ValueError(
                f"speeds has shape {speed_of.shape}, expected ({n},)"
            )
    fill_fraction, _timeout, stall_patience, max_lag = plan.resolved()
    cohort = plan.cohort_plan
    k = cohort_size(n, plan.fraction, plan.min_size)

    w_count = int(windows)
    end = start_window + w_count
    members = np.zeros((w_count, k), np.int32)
    present = np.zeros((w_count, k), bool)
    origin = np.zeros((w_count, k), np.int32)
    lag = np.zeros((w_count, k), np.int32)
    rank = np.zeros((w_count, k), np.int32)
    target = np.ones(w_count, np.int32)
    solicited = np.zeros(w_count, np.int32)
    queue_depth = np.zeros(w_count, np.int32)
    dropped = np.zeros(w_count, np.int32)

    #: (arrival_window, origin_window, node_idx, cohort_rank) — kept sorted
    #: by the fold order key so slot assignment is deterministic.
    pending: List[Tuple[int, int, int, int]] = []
    in_flight: set = set()

    for w in range(end):
        row = w - start_window
        # 1. solicit (backpressure-gated).
        n_solicit = 0
        if len(pending) <= stall_patience * k:
            full = cohort.cohort(w, names)  # sorted; rank == list position
            n_solicit = max(1, min(len(full), int(round(k * plan.intensity(w)))))
            took = 0
            for r, nm in enumerate(full):
                if took >= n_solicit:
                    break
                i = index[nm]
                if i in in_flight:
                    continue
                took += 1
                d = arrival_delay(plan.seed, w, nm, float(speed_of[i]))
                pending.append((w + d, w, i, r))
                in_flight.add(i)
            n_solicit = took
        # 2. fold the K oldest arrived; drop past-max-lag stragglers.
        pending.sort()
        folded = 0
        dropped_here = 0
        keep: List[Tuple[int, int, int, int]] = []
        for entry in pending:
            arr, org, i, r = entry
            if arr > w:
                keep.append(entry)
                continue
            this_lag = w - org
            if this_lag > max_lag:
                dropped_here += 1
                in_flight.discard(i)
                continue
            if folded >= k:
                keep.append(entry)
                continue
            if row >= 0:
                members[row, folded] = i
                present[row, folded] = True
                origin[row, folded] = org
                lag[row, folded] = this_lag
                rank[row, folded] = r
            folded += 1
            in_flight.discard(i)
        pending = keep
        if row >= 0:
            solicited[row] = n_solicit
            target[row] = max(1, int(round(fill_fraction * max(1, n_solicit))))
            queue_depth[row] = len(pending)
            dropped[row] = dropped_here

    return WindowSchedule(
        start_window=int(start_window),
        cohort_k=int(k),
        members=members,
        present=present,
        origin=origin,
        lag=lag,
        rank=rank,
        target=target,
        solicited=solicited,
        queue_depth=queue_depth,
        dropped=dropped,
    )


__all__ = [
    "CLOSE_FILL",
    "CLOSE_REASONS",
    "CLOSE_STALL",
    "CLOSE_TIMEOUT",
    "AsyncWindowPlan",
    "WindowSchedule",
    "arrival_delay",
    "compile_window_schedule",
    "trace_intensity",
]
