"""Shared AST machinery for the static checkers.

The interesting problem is LOCK IDENTITY: ``with self._lock:`` appears in a
dozen classes and must not conflate ``Gossiper._pending_lock`` with
``Aggregator._lock``. A definition pass collects every attribute/name
assigned from a ``threading.Lock()`` / ``RLock()`` / ``Condition()`` /
``Semaphore()`` call, keyed by the defining class (or module); acquisition
sites then resolve ``self.X`` against the enclosing class first, fall back
to a unique cross-class match, and keep honestly-ambiguous names as ``?.X``
so a checker can choose to skip them.

Everything here is pure stdlib ``ast`` — the analysis must run in CI without
importing the package under analysis (imports pull in torch)."""

from __future__ import annotations

import ast
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, Iterator, List, Optional, Sequence, Set, Tuple

#: threading factories whose result is a lock-like primitive worth ordering.
LOCK_FACTORIES = {"Lock", "RLock", "Condition", "Semaphore", "BoundedSemaphore"}

#: directories never scanned (generated code, caches).
SKIP_PARTS = {"__pycache__", ".git"}
SKIP_FILES = {"node_pb2.py"}  # generated protobuf


@dataclass(frozen=True)
class Finding:
    """One checker hit.

    ``key`` is the stable suppression identity: checker + file + scope +
    detail, deliberately WITHOUT line numbers so refactors that move code
    don't churn the baseline."""

    checker: str  # "C1".."C5"
    key: str
    path: str  # repo-relative
    line: int
    message: str

    def render(self) -> str:
        return f"[{self.checker}] {self.path}:{self.line}: {self.message}"


@dataclass
class LockDef:
    """One lock primitive definition site."""

    lock_id: str  # "ClassName.attr" or "module:<relpath>.NAME"
    kind: str  # Lock | RLock | Condition | Semaphore | BoundedSemaphore
    path: str
    line: int


@dataclass
class FuncInfo:
    """One function/method with what the lock checkers need."""

    qualname: str  # "relpath::Class.method" or "relpath::func"
    name: str
    class_name: Optional[str]
    path: str
    node: ast.AST  # FunctionDef | AsyncFunctionDef
    #: lock ids acquired lexically anywhere in the body (with-statements).
    acquires: Set[str] = field(default_factory=set)


class Module:
    def __init__(self, path: Path, rel: str) -> None:
        self.path = path
        self.rel = rel
        self.source = path.read_text(encoding="utf-8", errors="replace")
        self.tree = ast.parse(self.source, filename=rel)
        self.lines = self.source.splitlines()

    def line_text(self, lineno: int) -> str:
        if 1 <= lineno <= len(self.lines):
            return self.lines[lineno - 1]
        return ""


def iter_py_files(root: Path, subdirs: Sequence[str]) -> Iterator[Tuple[Path, str]]:
    for sub in subdirs:
        base = root / sub
        if base.is_file():
            yield base, str(base.relative_to(root))
            continue
        for p in sorted(base.rglob("*.py")):
            if any(part in SKIP_PARTS for part in p.parts) or p.name in SKIP_FILES:
                continue
            yield p, str(p.relative_to(root))


def _call_name(node: ast.AST) -> Optional[str]:
    """'threading.Lock' for threading.Lock(...), 'Lock' for Lock(...)."""
    if not isinstance(node, ast.Call):
        return None
    return dotted_name(node.func)


def dotted_name(node: ast.AST) -> Optional[str]:
    """'a.b.c' for an attribute chain of plain names; None otherwise."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def _lock_factory_kind(call: ast.AST) -> Optional[str]:
    name = _call_name(call)
    if name is None:
        return None
    leaf = name.rsplit(".", 1)[-1]
    if leaf in LOCK_FACTORIES and (
        "." not in name or name.startswith("threading.") or name.endswith(f".{leaf}")
    ):
        # Accept threading.Lock(), Lock(), mp.RLock() — anything whose leaf
        # is a known factory. InstrumentedLock etc. (analysis.runtime) is
        # deliberately excluded: wrapping is a runtime concern.
        return leaf
    return None


class ProjectIndex:
    """Cross-module index: lock definitions, classes, functions, Thread
    entry points, Command classes — built once, consumed by every checker."""

    def __init__(self, root: Path, subdirs: Sequence[str] = ("p2pfl_tpu_torch",)) -> None:
        self.root = root
        self.modules: List[Module] = []
        for path, rel in iter_py_files(root, subdirs):
            try:
                self.modules.append(Module(path, rel))
            except (SyntaxError, OSError):
                continue
        # lock attr name -> [LockDef] (across classes; for unique-match fallback)
        self.locks_by_attr: Dict[str, List[LockDef]] = {}
        # (class_name, attr) -> LockDef
        self.locks_by_class: Dict[Tuple[str, str], LockDef] = {}
        # module-level: (rel, name) -> LockDef
        self.locks_module: Dict[Tuple[str, str], LockDef] = {}
        # lock_id -> LockDef
        self.lock_defs: Dict[str, LockDef] = {}
        # method/function name -> [FuncInfo]
        self.funcs_by_name: Dict[str, List[FuncInfo]] = {}
        # qualname -> FuncInfo
        self.funcs: Dict[str, FuncInfo] = {}
        # class name -> {method name -> FuncInfo}
        self.classes: Dict[str, Dict[str, FuncInfo]] = {}
        # class name -> list of base-class dotted names
        self.class_bases: Dict[str, List[str]] = {}
        self._build()

    # --- construction -------------------------------------------------------

    def _build(self) -> None:
        for mod in self.modules:
            self._index_module(mod)
        for info in self.funcs.values():
            info.acquires = self._lexical_acquires(info)

    def _index_module(self, mod: Module) -> None:
        for node in mod.tree.body:
            if isinstance(node, ast.ClassDef):
                self._index_class(mod, node)
            elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self._add_func(mod, node, None)
            elif isinstance(node, ast.Assign):
                kind = _lock_factory_kind(node.value)
                if kind:
                    for tgt in node.targets:
                        if isinstance(tgt, ast.Name):
                            d = LockDef(
                                f"module:{mod.rel}.{tgt.id}", kind, mod.rel, node.lineno
                            )
                            self.locks_module[(mod.rel, tgt.id)] = d
                            self.lock_defs[d.lock_id] = d
                            self.locks_by_attr.setdefault(tgt.id, []).append(d)

    def _index_class(self, mod: Module, cls: ast.ClassDef) -> None:
        methods = self.classes.setdefault(cls.name, {})
        self.class_bases[cls.name] = [
            b for b in (dotted_name(base) for base in cls.bases) if b
        ]
        for node in cls.body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                info = self._add_func(mod, node, cls.name)
                methods[node.name] = info
                # lock definitions: self.X = threading.Lock() anywhere in a
                # method (typically __init__)
                for stmt in ast.walk(node):
                    if isinstance(stmt, ast.Assign):
                        kind = _lock_factory_kind(stmt.value)
                        if not kind:
                            continue
                        for tgt in stmt.targets:
                            if (
                                isinstance(tgt, ast.Attribute)
                                and isinstance(tgt.value, ast.Name)
                                and tgt.value.id == "self"
                            ):
                                d = LockDef(
                                    f"{cls.name}.{tgt.attr}", kind, mod.rel, stmt.lineno
                                )
                                self.locks_by_class[(cls.name, tgt.attr)] = d
                                self.lock_defs[d.lock_id] = d
                                self.locks_by_attr.setdefault(tgt.attr, []).append(d)

    def _add_func(
        self, mod: Module, node: ast.AST, class_name: Optional[str]
    ) -> FuncInfo:
        name = node.name  # type: ignore[attr-defined]
        qual = f"{mod.rel}::{class_name + '.' if class_name else ''}{name}"
        info = FuncInfo(qual, name, class_name, mod.rel, node)
        self.funcs[qual] = info
        self.funcs_by_name.setdefault(name, []).append(info)
        return info

    # --- lock resolution ----------------------------------------------------

    def resolve_lock_expr(
        self, expr: ast.AST, class_name: Optional[str], rel: str
    ) -> Optional[str]:
        """Lock id for a with-item context expression, or None if it isn't a
        lock. ``with foo():`` (Call) is never a lock acquisition — context
        managers like ``Settings.overridden()`` / tracer spans pass through
        here constantly."""
        if isinstance(expr, ast.Call):
            return None
        if isinstance(expr, ast.Attribute):
            attr = expr.attr
            if isinstance(expr.value, ast.Name) and expr.value.id == "self" and class_name:
                hit = self.locks_by_class.get((class_name, attr))
                if hit:
                    return hit.lock_id
                # inherited lock: single definition anywhere wins
            defs = self.locks_by_attr.get(attr, [])
            if len(defs) == 1:
                return defs[0].lock_id
            if defs:
                return f"?.{attr}"  # ambiguous: same attr name, many classes
            if "lock" in attr.lower():
                return f"?.{attr}"  # looks like a lock we never saw defined
            return None
        if isinstance(expr, ast.Name):
            hit = self.locks_module.get((rel, expr.id))
            if hit:
                return hit.lock_id
            defs = self.locks_by_attr.get(expr.id, [])
            if len(defs) == 1:
                return defs[0].lock_id
            if "lock" in expr.id.lower():
                return f"?.{expr.id}"
            return None
        return None

    def lock_kind(self, lock_id: str) -> Optional[str]:
        d = self.lock_defs.get(lock_id)
        return d.kind if d else None

    def _lexical_acquires(self, info: FuncInfo) -> Set[str]:
        out: Set[str] = set()
        for node in ast.walk(info.node):
            if isinstance(node, (ast.With, ast.AsyncWith)):
                for item in node.items:
                    lid = self.resolve_lock_expr(
                        item.context_expr, info.class_name, info.path
                    )
                    if lid:
                        out.add(lid)
        return out

    # --- callee resolution (one hop) ----------------------------------------

    def resolve_callees(
        self, call: ast.Call, class_name: Optional[str], rel: str
    ) -> List[FuncInfo]:
        """Best-effort in-tree targets of a call: ``self.m()`` prefers the
        enclosing class (then a unique cross-class match), ``obj.m()`` needs
        a unique cross-class match, bare ``f()`` a same-module function."""
        fn = call.func
        if isinstance(fn, ast.Attribute):
            name = fn.attr
            if isinstance(fn.value, ast.Name) and fn.value.id == "self" and class_name:
                own = self.classes.get(class_name, {}).get(name)
                if own:
                    return [own]
                # may be inherited — unique global match is good enough
            candidates = self.funcs_by_name.get(name, [])
            methods = [c for c in candidates if c.class_name]
            if len(methods) == 1:
                return methods
            return []
        if isinstance(fn, ast.Name):
            candidates = [
                c
                for c in self.funcs_by_name.get(fn.id, [])
                if c.path == rel and c.class_name is None
            ]
            return candidates if len(candidates) == 1 else []
        return []

    def module_for(self, rel: str) -> Optional[Module]:
        for m in self.modules:
            if m.rel == rel:
                return m
        return None


def has_inline_waiver(mod: Module, lineno: int, tag: str) -> bool:
    """True when the source line (or the line above) carries an explicit
    ``# <tag>: reason`` annotation — the in-code suppression channel for
    findings that are understood and safe (the baseline file is for the
    rest)."""
    for ln in (lineno, lineno - 1):
        if tag in mod.line_text(ln):
            return True
    return False
