"""Seeded, order-independent cohort sampling (counterpart of
``p2pfl_tpu/population/cohort.py``: the sampler, the committee schedule and
the ambient plan of the wire schedulers; no tensors, blake2b on the host, so
its outputs equal the JAX package's exactly).

    score(name) = blake2b(f"{seed}:{round}:{name}")
    cohort(round) = the k lowest-scoring eligible names, returned sorted

The sampler is a pure function of ``(seed, round, name)``: order-independent,
reshuffled every round, and deterministic under a hash-derived churn trace
applied before ranking.
"""

from __future__ import annotations

import hashlib
import threading
from dataclasses import dataclass, field
from typing import Callable, List, Optional, Sequence

import numpy as np

from p2pfl_tpu_torch.config import Settings


def cohort_score(seed: int, round_idx: int, name: str) -> int:
    """Per-(round, node) ranking score: the first 8 bytes of
    ``blake2b(seed:round:name)`` as an unsigned integer."""
    h = hashlib.blake2b(f"{int(seed)}:{int(round_idx)}:{name}".encode(), digest_size=8)
    return int.from_bytes(h.digest(), "big")


def cohort_size(n: int, fraction: float, min_size: int = 1) -> int:
    """Cohort size for an ``n``-name pool: ``max(min_size, round(f*n))``
    clamped to ``[1, n]``."""
    k = max(int(min_size), int(round(float(fraction) * n)))
    return max(1, min(k, n))


def availability_down(seed: int, round_idx: int, name: str, churn_rate: float) -> bool:
    """Hash-derived churn trace: is ``name`` down in ``round_idx``? An
    independent hash domain (``churn:`` prefix) keeps availability and
    ranking uncorrelated."""
    if churn_rate <= 0.0:
        return False
    h = hashlib.blake2b(f"churn:{int(seed)}:{int(round_idx)}:{name}".encode(), digest_size=8)
    v = int.from_bytes(h.digest(), "big") / float(1 << 64)
    return v < float(churn_rate)


def cohort_for_round(
    seed: int,
    round_idx: int,
    names: Sequence[str],
    fraction: float,
    min_size: int = 1,
    available: Optional[Callable[[str], bool]] = None,
) -> List[str]:
    """The round's cohort: the k lowest-scoring available names, sorted.
    ``k`` comes from the full name-set size; churn may shrink the cohort to
    the available pool."""
    pool = [n for n in names if available is None or available(n)]
    k = min(cohort_size(len(names), fraction, min_size), len(pool))
    ranked = sorted(pool, key=lambda n: (cohort_score(seed, round_idx, n), n))
    return sorted(ranked[:k])


@dataclass(frozen=True)
class CohortPlan:
    """A fully-seeded cohort policy: sampler config + churn trace."""

    seed: int
    fraction: float
    min_size: int = 1
    churn_rate: float = 0.0
    #: optional explicit full-population name set the cohort is drawn from
    names: Optional[tuple] = field(default=None)

    def available(self, round_idx: int, name: str) -> bool:
        return not availability_down(self.seed, round_idx, name, self.churn_rate)

    def cohort(self, round_idx: int, candidates: Sequence[str]) -> List[str]:
        names = list(self.names) if self.names is not None else list(candidates)
        return cohort_for_round(
            self.seed, round_idx, names, self.fraction, self.min_size,
            available=lambda n: self.available(round_idx, n),
        )


def committee_schedule(
    plan: CohortPlan,
    node_names: Sequence[str],
    rounds: int,
    start_round: int = 0,
) -> np.ndarray:
    """The plan as a ``[rounds, K]`` int32 committee schedule (node indices,
    sorted per round) for ``MeshSimulation.run``. K must be the same in every
    round: a churn draw that leaves fewer than K nodes raises."""
    names = [str(n) for n in node_names]
    index = {n: i for i, n in enumerate(names)}
    k = cohort_size(len(names), plan.fraction, plan.min_size)
    sched = np.empty((rounds, k), np.int32)
    for ri in range(rounds):
        r = start_round + ri
        cohort = plan.cohort(r, names)
        if len(cohort) != k:
            raise ValueError(
                f"round {r}: churn left {len(cohort)} available nodes for a "
                f"K={k} cohort — lower POP_CHURN_RATE or the cohort fraction "
                "(the fused scan needs a static committee shape)"
            )
        sched[ri] = [index[n] for n in cohort]
    return sched


# --- ambient plan for the wire schedulers -------------------------------------

_PLAN_LOCK = threading.Lock()
_ACTIVE_PLAN: Optional[CohortPlan] = None


def install_plan(plan: CohortPlan) -> None:
    """Make ``plan`` ambient for every wire node in this process (one plan
    for the whole federation: per-node plans would let two nodes disagree
    about the cohort)."""
    global _ACTIVE_PLAN
    with _PLAN_LOCK:
        _ACTIVE_PLAN = plan


def clear_plan() -> None:
    global _ACTIVE_PLAN
    with _PLAN_LOCK:
        _ACTIVE_PLAN = None


def active_plan() -> Optional[CohortPlan]:
    """The effective plan: an installed one wins; otherwise the
    ``POP_COHORT_*`` settings when enabled; otherwise None (sampling off)."""
    with _PLAN_LOCK:
        if _ACTIVE_PLAN is not None:
            return _ACTIVE_PLAN
    if Settings.POP_COHORT_ENABLED:
        return CohortPlan(
            seed=Settings.POP_COHORT_SEED,
            fraction=Settings.POP_COHORT_FRACTION,
            min_size=Settings.POP_COHORT_MIN,
            churn_rate=Settings.POP_CHURN_RATE,
        )
    return None


def wire_cohort_filter(round_idx: int, candidates: Sequence[str]) -> List[str]:
    """A wire scheduler's candidates filtered to the round's cohort (the
    input, as a list, when sampling is off): computed over the plan's pinned
    names when it has them, else over the candidates, so every node that
    sees the same round derives the same cohort."""
    plan = active_plan()
    if plan is None:
        return list(candidates)
    cohort = set(plan.cohort(round_idx, sorted(candidates)))
    return [c for c in candidates if c in cohort]
