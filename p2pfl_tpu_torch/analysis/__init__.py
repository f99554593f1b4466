"""Correctness analysis plane.

Five interacting planes (gossip, chaos, Byzantine, observatory, async
windows) share 50+ threading primitives across the tree, and every past
concurrency bug (the PR 3 contributor-list race, the PR 4 post-aggregation
overwrite window) was found by hand after it bit a bench. Production FL
stacks (Papaya, arxiv 2111.04877) treat concurrency and wire-compat
invariants as machine-checked; this package is that check, pointed at the
port's own tree (``python scripts/torch_analyze.py --baseline
analysis_baseline_torch.json``).

Static checkers (AST-based, :mod:`p2pfl_tpu_torch.analysis.checkers`):

* **C1 lock-order** — the lock-acquisition-order graph from nested
  ``with <lock>`` scopes (plus one-hop call-under-lock resolution); a cycle
  is a potential deadlock, a ``with`` re-entry of a non-reentrant ``Lock``
  is a guaranteed one.
* **C2 blocking-under-lock** — transport sends, broadcasts, ``time.sleep``,
  thread joins, event waits and aggregation waits executed while a lock is
  held: the classic way one slow peer stalls every thread in the process.
* **C3 unguarded-shared-write** — attributes assigned from daemon-thread /
  command-handler entry points without a guarding lock (and without an
  explicit ``# unguarded-ok:`` annotation).
* **C4 jit-purity** — side-effecting calls (``time.*``, ``random``,
  ``np.random``, metrics, logging, ``print``) inside functions handed to
  torch's tracing and capture entry points (``torch.compile``,
  ``torch.jit.script`` / ``trace``, ``torch.cuda.graph`` /
  ``make_graphed_callables``): they run at trace or capture time only, so
  the metric/log silently freezes after compilation or capture.
* **C5 drift** — ``P2PFL_TPU_*`` env reads that bypass ``config.py``'s
  validated fail-fast path, metric names used in code but absent from
  docs AND tests, and command names sent but never registered (or command
  classes defined but never wired into the dispatcher both transports
  share).

Runtime sentinel (:mod:`p2pfl_tpu_torch.analysis.runtime`): an opt-in
instrumented-lock wrapper that records the ACTUAL acquisition graph during
multi-node chaos tests and asserts it acyclic
(``scripts/torch_race_check.py``) — the
dynamic complement to C1's lexical approximation.

Suppressions live in ``analysis_baseline_torch.json`` (every entry carries
a written reason); ``scripts/torch_analyze.py`` exits 0 clean / 1 new finding /
2 stale suppression.
"""

from p2pfl_tpu_torch.analysis.baseline import Baseline, compare
from p2pfl_tpu_torch.analysis.checkers import ALL_CHECKERS, run_checkers
from p2pfl_tpu_torch.analysis.core import Finding, ProjectIndex
from p2pfl_tpu_torch.analysis.runtime import SENTINEL, LockOrderSentinel

__all__ = [
    "ALL_CHECKERS",
    "Baseline",
    "Finding",
    "LockOrderSentinel",
    "ProjectIndex",
    "SENTINEL",
    "compare",
    "run_checkers",
]
