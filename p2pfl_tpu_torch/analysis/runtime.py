"""Runtime lock-order sentinel.

C1 approximates the acquisition graph lexically; this module records the
REAL one. While :meth:`LockOrderSentinel.patched` is active, every lock
built through ``threading.Lock`` / ``threading.RLock`` is wrapped in an
:class:`InstrumentedLock` that pushes/pops a thread-local held stack and
records a directed edge ``A -> B`` whenever B is acquired with A held.
After a multi-node chaos round, :meth:`assert_acyclic` proves no two code
paths ever disagreed on lock order — or names the cycle with the creation
sites of every lock in it.

Locks are grouped into lockdep-style CLASSES by creation site
(``file:lineno``): the three per-node ``Gossiper._pending_lock`` instances
of a 3-node federation are one class, so an A->B order on node 1 and B->A
on node 2 still forms a reportable cycle. Same-class nested acquisition is
treated as reentrant rather than an edge — instance-level self-deadlock of
a plain ``Lock`` is C1's (static) job, where instances are distinguishable.

Opt-in and test-scoped by design: the wrapper costs one dict update per
acquisition, and patching constructors process-wide also wraps library
locks (logging, executors, torch's own) — which is exactly what you
want in a race hunt and never in production. ``scripts/torch_race_check.py``
runs a 3-node chaos round of port Nodes under the sentinel plus a
deliberate-inversion negative control.

The sentinel's own bookkeeping uses ``_thread.allocate_lock`` directly so
it is immune to its own patching (and can never deadlock with the locks it
watches).
"""

from __future__ import annotations

import _thread
import contextlib
import threading
from typing import Dict, Iterator, List, Optional, Tuple


def _creation_site(skip_module: str) -> str:
    """'relpath:lineno' of the first stack frame outside this module."""
    import sys

    frame = sys._getframe(2)
    while frame is not None and frame.f_code.co_filename.endswith(skip_module):
        frame = frame.f_back
    if frame is None:
        return "<unknown>"
    fname = frame.f_code.co_filename
    for marker in ("/p2pfl_tpu_torch/", "/tests/", "/scripts/"):
        i = fname.rfind(marker)
        if i >= 0:
            fname = fname[i + 1:]
            break
    return f"{fname}:{frame.f_lineno}"


class LockOrderSentinel:
    """Process-wide acquisition-graph recorder (one instance: SENTINEL)."""

    def __init__(self) -> None:
        self._meta = _thread.allocate_lock()
        self._tls = threading.local()
        # (held, acquired) -> (count, held thread-site of first observation)
        self._edges: Dict[Tuple[str, str], int] = {}
        self._locks_seen = 0

    # --- recording (called by InstrumentedLock) ------------------------------

    def _held_stack(self) -> List[str]:
        stack = getattr(self._tls, "stack", None)
        if stack is None:
            stack = self._tls.stack = []
        return stack

    def notify_created(self) -> None:
        with self._meta:
            self._locks_seen += 1

    def notify_acquired(self, name: str) -> None:
        stack = self._held_stack()
        if stack:
            with self._meta:
                for held in stack:
                    if held != name:
                        self._edges[(held, name)] = (
                            self._edges.get((held, name), 0) + 1
                        )
        stack.append(name)

    def notify_released(self, name: str) -> None:
        stack = self._held_stack()
        for i in range(len(stack) - 1, -1, -1):
            if stack[i] == name:
                del stack[i]
                return

    # --- inspection ----------------------------------------------------------

    def reset(self) -> None:
        with self._meta:
            self._edges.clear()
            self._locks_seen = 0

    def edges(self) -> Dict[Tuple[str, str], int]:
        with self._meta:
            return dict(self._edges)

    def stats(self) -> Dict[str, int]:
        with self._meta:
            return {"locks": self._locks_seen, "edges": len(self._edges)}

    def find_cycle(self) -> Optional[List[str]]:
        """A lock-order cycle in the recorded graph, or None."""
        graph: Dict[str, List[str]] = {}
        for a, b in self.edges():
            graph.setdefault(a, []).append(b)
        WHITE, GRAY, BLACK = 0, 1, 2
        color: Dict[str, int] = {}
        parent: Dict[str, str] = {}

        def dfs(node: str) -> Optional[List[str]]:
            color[node] = GRAY
            for nxt in sorted(graph.get(node, ())):
                c = color.get(nxt, WHITE)
                if c == GRAY:
                    cyc = [nxt, node]
                    cur = node
                    while cur != nxt:
                        cur = parent[cur]
                        cyc.append(cur)
                    cyc.reverse()
                    return cyc
                if c == WHITE:
                    parent[nxt] = node
                    got = dfs(nxt)
                    if got:
                        return got
            color[node] = BLACK
            return None

        for start in sorted(graph):
            if color.get(start, WHITE) == WHITE:
                got = dfs(start)
                if got:
                    return got
        return None

    def assert_acyclic(self) -> None:
        cyc = self.find_cycle()
        if cyc is not None:
            raise AssertionError(
                "lock-order cycle observed at runtime (potential deadlock): "
                + " -> ".join(cyc)
            )

    # --- instrumentation -----------------------------------------------------

    @contextlib.contextmanager
    def patched(self, reset: bool = True) -> Iterator["LockOrderSentinel"]:
        """Wrap ``threading.Lock``/``threading.RLock`` so every lock created
        in the block is instrumented. Locks outlive the block — recording
        continues until the process drops them — but constructor patching is
        strictly scoped."""
        if reset:
            self.reset()
        orig_lock, orig_rlock = threading.Lock, threading.RLock
        sentinel = self

        def make_lock() -> "InstrumentedLock":
            return InstrumentedLock(orig_lock(), sentinel, reentrant=False)

        def make_rlock() -> "InstrumentedLock":
            return InstrumentedLock(orig_rlock(), sentinel, reentrant=True)

        threading.Lock = make_lock  # type: ignore[assignment]
        threading.RLock = make_rlock  # type: ignore[assignment]
        try:
            yield self
        finally:
            threading.Lock = orig_lock  # type: ignore[assignment]
            threading.RLock = orig_rlock  # type: ignore[assignment]


class InstrumentedLock:
    """Lock wrapper feeding the sentinel. Duck-compatible with the stdlib
    lock protocol INCLUDING the private Condition hooks (``_is_owned`` /
    ``_release_save`` / ``_acquire_restore``), so ``threading.Condition``
    and ``threading.Event`` built on wrapped locks keep working — and the
    held-stack stays truthful across a ``Condition.wait`` (which releases
    the lock while blocked)."""

    __slots__ = ("_inner", "_sentinel", "_reentrant", "_name", "_depth")

    def __init__(
        self,
        inner,
        sentinel: LockOrderSentinel,
        reentrant: bool,
        name: Optional[str] = None,
    ) -> None:
        self._inner = inner
        self._sentinel = sentinel
        self._reentrant = reentrant
        self._name = name or _creation_site("analysis/runtime.py")
        self._depth = 0  # only meaningful for reentrant locks (owner-guarded)
        sentinel.notify_created()

    @property
    def name(self) -> str:
        return self._name

    # --- lock protocol -------------------------------------------------------

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        got = self._inner.acquire(blocking, timeout)
        if got:
            if self._reentrant and self._depth > 0:
                self._depth += 1  # reentrant re-acquire: no new edge
            else:
                self._sentinel.notify_acquired(self._name)
                if self._reentrant:
                    self._depth = 1
        return got

    def release(self) -> None:
        if self._reentrant and self._depth > 1:
            self._depth -= 1
            self._inner.release()
            return
        self._depth = 0
        self._inner.release()
        self._sentinel.notify_released(self._name)

    def __enter__(self) -> bool:
        return self.acquire()

    def __exit__(self, *exc) -> None:
        self.release()

    def locked(self) -> bool:
        return self._inner.locked() if hasattr(self._inner, "locked") else False

    # --- Condition integration ----------------------------------------------

    def _is_owned(self) -> bool:
        if hasattr(self._inner, "_is_owned"):
            return self._inner._is_owned()
        # plain lock: Condition's fallback probe
        if self._inner.acquire(False):
            self._inner.release()
            return False
        return True

    def _release_save(self):
        depth, self._depth = self._depth, 0
        if hasattr(self._inner, "_release_save"):
            state = self._inner._release_save()
        else:
            self._inner.release()
            state = None
        self._sentinel.notify_released(self._name)
        return (state, depth)

    def _acquire_restore(self, saved) -> None:
        state, depth = saved
        if hasattr(self._inner, "_acquire_restore"):
            self._inner._acquire_restore(state)
        else:
            self._inner.acquire()
        self._sentinel.notify_acquired(self._name)
        self._depth = depth

    def _at_fork_reinit(self) -> None:
        if hasattr(self._inner, "_at_fork_reinit"):
            self._inner._at_fork_reinit()
        self._depth = 0

    def __repr__(self) -> str:
        return f"InstrumentedLock({self._name}, reentrant={self._reentrant})"


#: process-wide sentinel consumed by scripts/torch_race_check.py and tests.
SENTINEL = LockOrderSentinel()
