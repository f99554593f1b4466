"""The five static checkers (C1-C5).

All of them are heuristic by design: they over-approximate (a flagged site
is *potentially* wrong) and the suppression channels — an inline
``# unguarded-ok: reason`` annotation for C3, the committed
``analysis_baseline_torch.json`` for everything else — exist precisely so
that a human writes down WHY a finding is safe instead of the knowledge
living in one reviewer's head. A checker that finds nothing new on a clean
tree and flags the seeded-defect fixtures (tests/analysis_fixtures/, and
tests/torch_analysis_fixtures/ for C4) is doing its job.
"""

from __future__ import annotations

import ast
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence, Set, Tuple

from p2pfl_tpu_torch.analysis.core import (
    Finding,
    FuncInfo,
    Module,
    ProjectIndex,
    dotted_name,
    has_inline_waiver,
)

# ---------------------------------------------------------------------------
# shared: lexical with-lock scope walker
# ---------------------------------------------------------------------------


class _ScopeWalker:
    """Walk one function's statements tracking which locks are held
    lexically. Nested function definitions are NOT entered with held state
    (their bodies execute later, not under the lock); checkers that need
    them (C4) walk separately."""

    def __init__(self, index: ProjectIndex, mod: Module, info: FuncInfo) -> None:
        self.index = index
        self.mod = mod
        self.info = info
        self.held: List[Tuple[str, int]] = []  # (lock_id, acquire line)
        self.on_acquire: Optional[Callable[[str, int], None]] = None
        self.on_call: Optional[Callable[[ast.Call], None]] = None
        self.on_store: Optional[Callable[[ast.AST, int], None]] = None

    def walk(self) -> None:
        body = getattr(self.info.node, "body", [])
        for stmt in body:
            self._stmt(stmt)

    # --- statements ---------------------------------------------------------

    def _stmt(self, node: ast.AST) -> None:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
            return  # executes later, not under the current lock scope
        if isinstance(node, (ast.With, ast.AsyncWith)):
            acquired = 0
            for item in node.items:
                lid = self.index.resolve_lock_expr(
                    item.context_expr, self.info.class_name, self.info.path
                )
                if lid:
                    if self.on_acquire:
                        self.on_acquire(lid, node.lineno)
                    self.held.append((lid, node.lineno))
                    acquired += 1
                else:
                    self._expr(item.context_expr)
            for stmt in node.body:
                self._stmt(stmt)
            for _ in range(acquired):
                self.held.pop()
            return
        # expressions nested in any other statement
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
                continue
            if isinstance(child, ast.stmt):
                self._stmt(child)
            else:
                self._expr(child)
        if isinstance(node, (ast.Assign, ast.AugAssign)) and self.on_store:
            self.on_store(node, node.lineno)

    def _expr(self, node: ast.AST) -> None:
        for n in ast.walk(node):
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
                continue
            if isinstance(n, ast.Call) and self.on_call:
                self.on_call(n)


# ---------------------------------------------------------------------------
# C1 — lock acquisition order
# ---------------------------------------------------------------------------


def check_lock_order(index: ProjectIndex, root: Path) -> List[Finding]:
    """Build the lock-order graph (lexical nesting + one-hop call-under-lock)
    and report cycles, plus guaranteed self-deadlocks: re-entering a
    non-reentrant ``Lock`` either lexically or through a same-class call."""
    findings: List[Finding] = []
    # edge: (A, B) -> (path, line, via) — acquire B while holding A
    edges: Dict[Tuple[str, str], Tuple[str, int, str]] = {}

    for info in index.funcs.values():
        mod = index.module_for(info.path)
        if mod is None:
            continue
        walker = _ScopeWalker(index, mod, info)

        def on_acquire(lid: str, line: int, info=info, walker=walker) -> None:
            for held_id, _ in walker.held:
                if held_id == lid:
                    if index.lock_kind(lid) == "Lock":
                        findings.append(
                            Finding(
                                "C1",
                                f"C1:self-deadlock:{info.qualname}:{lid}",
                                info.path,
                                line,
                                f"{info.qualname} re-enters non-reentrant "
                                f"{lid} it already holds — guaranteed deadlock",
                            )
                        )
                    continue
                edges.setdefault(
                    (held_id, lid), (info.path, line, info.qualname)
                )

        def on_call(call: ast.Call, info=info, walker=walker) -> None:
            if not walker.held:
                return
            for callee in index.resolve_callees(call, info.class_name, info.path):
                if callee.qualname == info.qualname:
                    continue
                for lid in callee.acquires:
                    for held_id, _ in walker.held:
                        if held_id == lid:
                            if index.lock_kind(lid) == "Lock":
                                findings.append(
                                    Finding(
                                        "C1",
                                        f"C1:self-deadlock:{info.qualname}:"
                                        f"{callee.name}:{lid}",
                                        info.path,
                                        call.lineno,
                                        f"{info.qualname} holds non-reentrant "
                                        f"{lid} and calls {callee.qualname} "
                                        "which re-acquires it — guaranteed "
                                        "deadlock",
                                    )
                                )
                            continue
                        edges.setdefault(
                            (held_id, lid),
                            (info.path, call.lineno, f"{info.qualname} -> {callee.name}"),
                        )

        walker.on_acquire = on_acquire
        walker.on_call = on_call
        walker.walk()

    findings.extend(_cycles_to_findings(edges))
    return findings


def _cycles_to_findings(
    edges: Dict[Tuple[str, str], Tuple[str, int, str]]
) -> List[Finding]:
    graph: Dict[str, Set[str]] = {}
    for a, b in edges:
        graph.setdefault(a, set()).add(b)
    seen_cycles: Set[Tuple[str, ...]] = set()
    findings: List[Finding] = []

    def dfs(node: str, stack: List[str], on_stack: Set[str]) -> None:
        for nxt in sorted(graph.get(node, ())):
            if nxt in on_stack:
                cyc = stack[stack.index(nxt):] + [nxt]
                core = tuple(cyc[:-1])
                k = min(range(len(core)), key=lambda i: core[i])
                canon = core[k:] + core[:k]
                if canon in seen_cycles:
                    continue
                seen_cycles.add(canon)
                path, line, via = edges[(cyc[-2], cyc[-1])]
                findings.append(
                    Finding(
                        "C1",
                        "C1:cycle:" + "->".join(canon),
                        path,
                        line,
                        "lock-order cycle (potential deadlock): "
                        + " -> ".join(canon + (canon[0],))
                        + f" (closing edge via {via})",
                    )
                )
            elif nxt in graph and nxt not in visited_global:
                stack.append(nxt)
                on_stack.add(nxt)
                dfs(nxt, stack, on_stack)
                on_stack.discard(nxt)
                stack.pop()

    visited_global: Set[str] = set()
    for start in sorted(graph):
        dfs(start, [start], {start})
        visited_global.add(start)
    return findings


# ---------------------------------------------------------------------------
# C2 — blocking calls while a lock is held
# ---------------------------------------------------------------------------

#: leaf method names that block on the network / other threads when invoked
#: on the federation's objects.
_BLOCKING_LEAVES = {
    "send",
    "_safe_send",
    "_transport_send",
    "broadcast",
    "deliver",
    "gossip_weights",
    "wait_and_get_aggregation",
}
_BLOCKING_DOTTED = {"time.sleep", "subprocess.run", "subprocess.check_output", "subprocess.call"}


def _receiver_chain(call: ast.Call) -> str:
    name = dotted_name(call.func)
    return name or ""


def check_blocking_under_lock(index: ProjectIndex, root: Path) -> List[Finding]:
    findings: List[Finding] = []
    for info in index.funcs.values():
        mod = index.module_for(info.path)
        if mod is None:
            continue
        walker = _ScopeWalker(index, mod, info)

        def on_call(call: ast.Call, info=info, walker=walker, mod=mod) -> None:
            if not walker.held:
                return
            label = _blocking_label(call, walker, index)
            if label is None:
                return
            if has_inline_waiver(mod, call.lineno, "blocking-ok:"):
                return
            lock_id = walker.held[-1][0]
            findings.append(
                Finding(
                    "C2",
                    f"C2:{info.qualname}:{label}:{lock_id}",
                    info.path,
                    call.lineno,
                    f"{info.qualname} calls blocking {label} while holding "
                    f"{lock_id} — every thread contending that lock stalls "
                    "behind the slow/network operation",
                )
            )

        walker.on_call = on_call
        walker.walk()
    return findings


def _blocking_label(
    call: ast.Call, walker: _ScopeWalker, index: ProjectIndex
) -> Optional[str]:
    chain = _receiver_chain(call)
    if chain in _BLOCKING_DOTTED:
        return chain
    if not isinstance(call.func, ast.Attribute):
        if isinstance(call.func, ast.Name) and call.func.id == "sleep":
            return "sleep"
        return None
    leaf = call.func.attr
    if leaf in _BLOCKING_LEAVES:
        return chain or leaf
    recv = dotted_name(call.func.value) or ""
    if leaf == "join":
        # str.join is everywhere; only thread-ish receivers block.
        low = recv.lower()
        if any(t in low for t in ("thread", "proc", "worker", "executor")):
            return f"{recv}.join"
        return None
    if leaf == "wait":
        # Condition.wait ON a held lock is the correct idiom (it releases);
        # waiting on anything ELSE while holding a lock is the bug.
        lid = index.resolve_lock_expr(call.func.value, walker.info.class_name, walker.info.path)
        if lid and index.lock_kind(lid) == "Condition" and any(
            h == lid for h, _ in walker.held
        ):
            return None
        return f"{recv}.wait"
    if leaf == "result":
        low = recv.lower()
        if "fut" in low:
            return f"{recv}.result"
    return None


# ---------------------------------------------------------------------------
# C3 — unguarded shared-attribute writes from thread entry points
# ---------------------------------------------------------------------------


def _thread_entry_funcs(index: ProjectIndex) -> Dict[str, str]:
    """qualname -> why it's an entry point. Covers ``Thread(target=...)``,
    ``executor.submit(fn, ...)``, and ``execute`` methods of Command
    subclasses (transport-thread command handlers)."""
    entries: Dict[str, str] = {}
    for info in index.funcs.values():
        for node in ast.walk(info.node):
            if not isinstance(node, ast.Call):
                continue
            fname = dotted_name(node.func) or ""
            target: Optional[ast.AST] = None
            why = ""
            if fname.rsplit(".", 1)[-1] == "Thread":
                for kw in node.keywords:
                    if kw.arg == "target":
                        target, why = kw.value, "Thread(target=...)"
            elif fname.endswith(".submit") and node.args:
                target, why = node.args[0], "executor.submit"
            if target is None:
                continue
            for callee in _resolve_func_ref(index, target, info):
                entries.setdefault(callee.qualname, why)
    for cls, methods in index.classes.items():
        bases = index.class_bases.get(cls, [])
        is_cmd = cls.endswith("Command") or any(
            b.rsplit(".", 1)[-1] == "Command" for b in bases
        )
        if is_cmd and "execute" in methods:
            entries.setdefault(
                methods["execute"].qualname, "command handler (transport thread)"
            )
    return entries


def _resolve_func_ref(
    index: ProjectIndex, ref: ast.AST, info: FuncInfo
) -> List[FuncInfo]:
    if isinstance(ref, ast.Attribute):
        name = ref.attr
        if isinstance(ref.value, ast.Name) and ref.value.id == "self" and info.class_name:
            own = index.classes.get(info.class_name, {}).get(name)
            if own:
                return [own]
        cands = [c for c in index.funcs_by_name.get(name, []) if c.class_name]
        return cands if len(cands) == 1 else []
    if isinstance(ref, ast.Name):
        cands = [
            c
            for c in index.funcs_by_name.get(ref.id, [])
            if c.path == info.path and c.class_name is None
        ]
        return cands if len(cands) == 1 else []
    return []


def check_unguarded_writes(index: ProjectIndex, root: Path) -> List[Finding]:
    # attr name -> count of functions that assign it (shared-state filter)
    writers: Dict[str, Set[str]] = {}
    for info in index.funcs.values():
        for node in ast.walk(info.node):
            if isinstance(node, (ast.Assign, ast.AugAssign)):
                targets = (
                    node.targets if isinstance(node, ast.Assign) else [node.target]
                )
                for t in targets:
                    if isinstance(t, ast.Attribute):
                        writers.setdefault(t.attr, set()).add(info.qualname)

    entries = _thread_entry_funcs(index)
    findings: List[Finding] = []
    for qual, why in sorted(entries.items()):
        info = index.funcs.get(qual)
        if info is None:
            continue
        mod = index.module_for(info.path)
        if mod is None:
            continue
        # locals constructed fresh in this function are thread-private
        fresh: Set[str] = set()
        for node in ast.walk(info.node):
            if isinstance(node, ast.Assign) and isinstance(node.value, ast.Call):
                for t in node.targets:
                    if isinstance(t, ast.Name):
                        fresh.add(t.id)
        walker = _ScopeWalker(index, mod, info)

        def on_store(
            node: ast.AST, line: int, info=info, walker=walker, mod=mod, fresh=fresh, why=why
        ) -> None:
            if walker.held:
                return
            targets = (
                node.targets if isinstance(node, ast.Assign) else [node.target]  # type: ignore[attr-defined]
            )
            for t in targets:
                if not isinstance(t, ast.Attribute):
                    continue
                root_name = t
                while isinstance(root_name, ast.Attribute):
                    root_name = root_name.value
                if not isinstance(root_name, ast.Name):
                    continue
                if root_name.id in fresh:
                    continue  # object constructed by this thread — private
                if len(writers.get(t.attr, ())) < 2:
                    continue  # not demonstrably shared state
                if has_inline_waiver(mod, line, "unguarded-ok:"):
                    continue
                findings.append(
                    Finding(
                        "C3",
                        f"C3:{info.qualname}:{t.attr}",
                        info.path,
                        line,
                        f"{info.qualname} ({why}) writes shared attribute "
                        f".{t.attr} without holding a lock — annotate "
                        "'# unguarded-ok: <reason>' if the write is safe",
                    )
                )

        walker.on_store = on_store
        walker.walk()
    return findings


# ---------------------------------------------------------------------------
# C4 — jit purity
# ---------------------------------------------------------------------------

#: torch's tracing and capture entry points, as dotted-name suffixes: a
#: function handed to one runs its Python body at trace / capture time only.
_JIT_WRAPPERS = (
    "torch.compile",
    "jit.script",
    "jit.trace",
    "cuda.make_graphed_callables",
)
#: capture context managers: calls inside ``with torch.cuda.graph(g):`` run
#: once, while the graph is captured, and never on replay.
_CAPTURE_CONTEXTS = ("cuda.graph",)
_IMPURE_ROOTS = {"time", "random", "logging", "log", "logger", "REGISTRY", "SKETCHES", "TRACER"}
_IMPURE_PREFIXES = ("np.random.", "numpy.random.")
_IMPURE_LEAVES = {"inc", "observe"}  # metric mutations via .labels(...).inc()


def _wrapper_name(name: Optional[str], suffixes: Tuple[str, ...]) -> bool:
    return bool(name) and any(name == s or name.endswith("." + s) for s in suffixes)


def _is_jit_wrapper(expr: ast.AST) -> bool:
    """True for torch.compile / torch.jit.script / torch.jit.trace /
    torch.cuda.make_graphed_callables, called or bare, and
    partial(torch.compile, ...)."""
    if _wrapper_name(dotted_name(expr), _JIT_WRAPPERS):
        return True
    if isinstance(expr, ast.Call):
        cname = dotted_name(expr.func)
        if cname and cname.rsplit(".", 1)[-1] == "partial" and expr.args:
            return _is_jit_wrapper(expr.args[0])
        # torch.compile(mode=...) used as a decorator factory
        return _is_jit_wrapper(expr.func)
    return False


def _jitted_funcs(index: ProjectIndex) -> Dict[str, str]:
    """qualname -> how it gets traced or captured."""
    out: Dict[str, str] = {}
    for info in index.funcs.values():
        for dec in getattr(info.node, "decorator_list", []):
            if _is_jit_wrapper(dec):
                out[info.qualname] = "decorator"
    for mod in index.modules:
        for node in ast.walk(mod.tree):
            refs: List[Tuple[ast.AST, str]] = []
            if isinstance(node, ast.Call):
                # call sites: torch.compile(F) / torch.jit.trace(F, x) / ...
                cname = dotted_name(node.func)
                if _wrapper_name(cname, _JIT_WRAPPERS) and node.args:
                    refs.append((node.args[0], f"passed to {cname}"))
            elif isinstance(node, (ast.With, ast.AsyncWith)):
                # with torch.cuda.graph(g): F(...) — F runs at capture time
                for item in node.items:
                    ctx = item.context_expr
                    cname = dotted_name(ctx.func) if isinstance(ctx, ast.Call) else None
                    if not _wrapper_name(cname, _CAPTURE_CONTEXTS):
                        continue
                    for stmt in node.body:
                        for sub in ast.walk(stmt):
                            if isinstance(sub, ast.Call):
                                refs.append((sub.func, f"captured under {cname}"))
            for ref, how in refs:
                refname = None
                if isinstance(ref, ast.Name):
                    refname = ref.id
                elif isinstance(ref, ast.Attribute):
                    refname = ref.attr
                if refname is None:
                    continue
                for cand in index.funcs_by_name.get(refname, []):
                    if cand.path == mod.rel:
                        out.setdefault(cand.qualname, how)
    return out


def check_jit_purity(index: ProjectIndex, root: Path) -> List[Finding]:
    findings: List[Finding] = []
    for qual, how in sorted(_jitted_funcs(index).items()):
        info = index.funcs[qual]
        mod = index.module_for(info.path)
        for node in ast.walk(info.node):
            if not isinstance(node, ast.Call):
                continue
            label = _impure_label(node)
            if label is None:
                continue
            if mod is not None and has_inline_waiver(mod, node.lineno, "jit-impure-ok:"):
                continue
            findings.append(
                Finding(
                    "C4",
                    f"C4:{info.qualname}:{label}",
                    info.path,
                    node.lineno,
                    f"{info.qualname} (traced via {how}) calls side-effecting "
                    f"{label}: it executes at trace or capture time only and "
                    "silently freezes after compilation or capture",
                )
            )
    return findings


def _impure_label(call: ast.Call) -> Optional[str]:
    if isinstance(call.func, ast.Name) and call.func.id == "print":
        return "print"
    chain = dotted_name(call.func)
    if chain:
        root = chain.split(".", 1)[0]
        if root in _IMPURE_ROOTS:
            return chain
        if chain.startswith(_IMPURE_PREFIXES):
            return chain
    if isinstance(call.func, ast.Attribute) and call.func.attr in _IMPURE_LEAVES:
        # _METRIC.labels(...).inc() — receiver is a Call, chain is None
        if isinstance(call.func.value, ast.Call):
            inner = dotted_name(call.func.value.func) or ""
            if inner.endswith(".labels") or inner == "labels":
                return f"{inner}().{call.func.attr}"
    return None


# ---------------------------------------------------------------------------
# C5 — drift: env reads, metric names, command registration
# ---------------------------------------------------------------------------


def check_drift(index: ProjectIndex, root: Path) -> List[Finding]:
    findings: List[Finding] = []
    findings.extend(_drift_env_reads(index))
    findings.extend(_drift_metrics(index, root))
    findings.extend(_drift_commands(index))
    return findings


def _drift_env_reads(index: ProjectIndex) -> List[Finding]:
    """P2PFL_TPU_* env reads outside config.py bypass the validated
    fail-fast path — a typo'd value then explodes mid-round on a transport
    thread instead of at import."""
    out: List[Finding] = []
    for mod in index.modules:
        if mod.rel.endswith("config.py"):
            continue
        for node in ast.walk(mod.tree):
            var: Optional[str] = None
            if isinstance(node, ast.Subscript):
                base = dotted_name(node.value)
                if base in ("os.environ",) and isinstance(node.slice, ast.Constant):
                    v = node.slice.value
                    if isinstance(v, str) and v.startswith("P2PFL_TPU_"):
                        var = v
            elif isinstance(node, ast.Call):
                cname = dotted_name(node.func)
                if cname in ("os.environ.get", "os.getenv", "environ.get", "getenv"):
                    if node.args and isinstance(node.args[0], ast.Constant):
                        v = node.args[0].value
                        if isinstance(v, str) and v.startswith("P2PFL_TPU_"):
                            var = v
            if var is not None:
                out.append(
                    Finding(
                        "C5",
                        f"C5:env:{mod.rel}:{var}",
                        mod.rel,
                        node.lineno,
                        f"direct read of {var} bypasses config.py's validated "
                        "fail-fast env layer — add a Settings field instead",
                    )
                )
    return out


_METRIC_FACTORIES = {"counter", "gauge", "histogram"}


def _drift_metrics(index: ProjectIndex, root: Path) -> List[Finding]:
    """Metric names emitted in code must appear in docs OR tests — an
    undocumented, untested series silently renames/vanishes on refactor and
    every dashboard watching it flatlines."""
    names: Dict[str, Tuple[str, int]] = {}
    for mod in index.modules:
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Call):
                continue
            cname = dotted_name(node.func) or ""
            if cname.rsplit(".", 1)[-1] not in _METRIC_FACTORIES:
                continue
            if not cname.startswith(("REGISTRY.", "registry.")):
                continue
            if node.args and isinstance(node.args[0], ast.Constant):
                v = node.args[0].value
                if isinstance(v, str) and v.startswith("p2pfl_"):
                    names.setdefault(v, (mod.rel, node.lineno))
    if not names:
        return []
    corpus = _reference_corpus(root)
    out: List[Finding] = []
    for name, (rel, line) in sorted(names.items()):
        if name in corpus:
            continue
        out.append(
            Finding(
                "C5",
                f"C5:metric:{name}",
                rel,
                line,
                f"metric {name} is emitted but appears in neither docs/ nor "
                "tests/ — document it (docs/components/) or assert it in a "
                "test before a refactor silently drops the series",
            )
        )
    return out


def _reference_corpus(root: Path) -> str:
    """Concatenated docs + tests text used for metric-name presence."""
    chunks: List[str] = []
    for pattern, base in (("*.md", root), ("**/*.md", root / "docs"), ("**/*.py", root / "tests")):
        if not base.exists():
            continue
        for p in sorted(base.glob(pattern)):
            if {"analysis_fixtures", "torch_analysis_fixtures"} & set(p.parts):
                continue  # seeded-defect fixtures must not self-document
            try:
                chunks.append(p.read_text(encoding="utf-8", errors="replace"))
            except OSError:
                continue
    return "\n".join(chunks)


def _drift_commands(index: ProjectIndex) -> List[Finding]:
    """Command names sent must be handled and vice versa. Dispatch is shared
    by both transports (CommandDispatcher behind CommunicationProtocol), so
    one registration covers gRPC and in-memory — but a command class that is
    never instantiated, or a name sent with no definition, is dead wire
    surface either way."""
    # class name -> (cmd name, rel, line); includes nested classes
    defined: Dict[str, Tuple[str, str, int]] = {}
    consts: Dict[Tuple[str, str], str] = {}
    for mod in index.modules:
        for node in ast.walk(mod.tree):
            if isinstance(node, ast.Assign) and isinstance(node.value, ast.Constant):
                v = node.value.value
                if isinstance(v, str):
                    for t in node.targets:
                        if isinstance(t, ast.Name):
                            consts[(mod.rel, t.id)] = v
    for mod in index.modules:
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.ClassDef):
                continue
            bases = [dotted_name(b) or "" for b in node.bases]
            if not (
                node.name.endswith("Command")
                or any(b.rsplit(".", 1)[-1] == "Command" for b in bases)
            ):
                continue
            for item in node.body:
                if (
                    isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef))
                    and item.name == "get_name"
                ):
                    for stmt in ast.walk(item):
                        if isinstance(stmt, ast.Return) and stmt.value is not None:
                            if isinstance(stmt.value, ast.Constant) and isinstance(
                                stmt.value.value, str
                            ):
                                defined[node.name] = (
                                    stmt.value.value, mod.rel, node.lineno,
                                )
                            elif isinstance(stmt.value, ast.Name):
                                v = consts.get((mod.rel, stmt.value.id))
                                if v:
                                    defined[node.name] = (v, mod.rel, node.lineno)
    defined_names = {v[0] for v in defined.values()}

    instantiated: Set[str] = set()
    sent: Dict[str, Tuple[str, int]] = {}
    for mod in index.modules:
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Call):
                continue
            cname = dotted_name(node.func) or ""
            leaf = cname.rsplit(".", 1)[-1]
            if leaf in defined:
                instantiated.add(leaf)
            if leaf in ("build_msg", "build_weights") and node.args:
                first = node.args[0]
                if isinstance(first, ast.Constant) and isinstance(first.value, str):
                    sent.setdefault(first.value, (mod.rel, node.lineno))
                elif isinstance(first, ast.Call):
                    gname = dotted_name(first.func) or ""
                    if gname.endswith(".get_name"):
                        cls = gname.rsplit(".", 2)[-2]
                        if cls in defined:
                            sent.setdefault(defined[cls][0], (mod.rel, node.lineno))

    out: List[Finding] = []
    for cls, (cmd, rel, line) in sorted(defined.items()):
        if cls not in instantiated:
            out.append(
                Finding(
                    "C5",
                    f"C5:cmd-unregistered:{cmd}",
                    rel,
                    line,
                    f"command class {cls} (name {cmd!r}) is defined but never "
                    "instantiated/registered on the dispatcher — inbound "
                    f"{cmd!r} frames would be dropped as unknown on both "
                    "transports",
                )
            )
    for cmd, (rel, line) in sorted(sent.items()):
        if cmd not in defined_names:
            out.append(
                Finding(
                    "C5",
                    f"C5:cmd-unhandled:{cmd}",
                    rel,
                    line,
                    f"command {cmd!r} is sent (build_msg/build_weights) but no "
                    "Command class defines it — receivers on either transport "
                    "drop it as unknown",
                )
            )
    return out


# ---------------------------------------------------------------------------
# entry point
# ---------------------------------------------------------------------------

ALL_CHECKERS: Dict[str, Callable[[ProjectIndex, Path], List[Finding]]] = {
    "C1": check_lock_order,
    "C2": check_blocking_under_lock,
    "C3": check_unguarded_writes,
    "C4": check_jit_purity,
    "C5": check_drift,
}


def run_checkers(
    root: Path,
    subdirs: Sequence[str] = ("p2pfl_tpu_torch",),
    checks: Optional[Sequence[str]] = None,
) -> List[Finding]:
    index = ProjectIndex(root, subdirs)
    findings: List[Finding] = []
    for name in checks or sorted(ALL_CHECKERS):
        findings.extend(ALL_CHECKERS[name](index, root))
    findings.sort(key=lambda f: (f.path, f.line, f.key))
    return findings
