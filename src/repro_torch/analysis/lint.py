"""Repo-wide closed-form linter (AST, no imports of the linted code).

Three rule families over ``src/repro_torch/core/`` (the modules holding
closed forms and trace-pipeline stages; a ``distributed/`` package joins
the roots when it exists):

``form-builtin-min`` / ``form-builtin-max`` / ``form-math-ceil``
    Inside a *closed form* — any function passed as ``MovementSpec``'s
    ``form`` argument, plus module-local helpers it (transitively) calls —
    Python's ``min``/``max``/``math.ceil`` are forbidden: they coerce
    array operands to scalars, silently breaking the broadcasting contract
    every sweep relies on.  Forms must use ``terms.minimum`` /
    ``terms.ceil`` / ``np.maximum``.

``trace-lexsort`` / ``trace-edge-list``
    The amortized trace engine's invariant, as a check: trace-path
    modules (``core/trace.py`` and everything under ``distributed/``)
    must not call ``np.lexsort`` (the amortized engine's composite-key
    sort replaced it; the one legacy overflow fallback carries a pragma),
    and ``distributed/`` stages must not construct ``GraphTrace(...)``
    directly — edge-list-free construction goes through
    ``GraphTrace.from_factorization``.

``movement-vocab``
    Every ``MovementSpec(...)`` call site must pass its hierarchy and role
    as *string literals* drawn from the declared vocabularies
    (``terms`` hierarchy classes, ``dataflow.MOVEMENT_ROLES``).  The
    runtime validates roles at construction but hierarchies only on first
    evaluation — the linter catches a typo'd hierarchy before any
    evaluation runs.

A violation on a line containing ``# lint: allow-<rule>`` is suppressed;
every suppression is a recorded decision greppable by rule name.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass
from pathlib import Path
from typing import Iterable, Optional, Sequence

__all__ = [
    "LintViolation",
    "lint_source",
    "lint_paths",
    "default_lint_roots",
    "VALID_HIERARCHIES",
    "VALID_ROLES",
]

#: Kept in sync with repro_torch.core.terms / repro_torch.core.dataflow
#: (asserted in tests/test_torch_analysis.py so the vocabularies cannot
#: silently diverge).
VALID_HIERARCHIES = ("L2-L1", "L1-L2", "L2*-L1", "L1-L2*", "L1-L1")
VALID_ROLES = ("vertex_in", "vertex_out", "edges", "weights", "compute",
               "interphase", "other")

_FORBIDDEN_BUILTINS = {"min": "form-builtin-min", "max": "form-builtin-max"}


@dataclass(frozen=True)
class LintViolation:
    path: str
    line: int
    rule: str
    message: str

    def __str__(self) -> str:
        return f"{self.path}:{self.line}: [{self.rule}] {self.message}"

    def as_dict(self) -> dict:
        return {"path": self.path, "line": self.line, "rule": self.rule,
                "message": self.message}


def default_lint_roots() -> tuple[Path, ...]:
    """``src/repro_torch/core`` and ``src/repro_torch/distributed`` of this
    checkout."""
    pkg = Path(__file__).resolve().parents[1]
    return (pkg / "core", pkg / "distributed")


def _is_trace_path(path: str) -> bool:
    p = path.replace("\\", "/")
    return "/distributed/" in p or p.endswith("distributed") \
        or p.endswith("trace.py")


def _is_distributed(path: str) -> bool:
    return "/distributed/" in path.replace("\\", "/")


class _ModuleIndex(ast.NodeVisitor):
    """Module-level function defs, math import aliases, MovementSpec calls."""

    def __init__(self) -> None:
        self.functions: dict[str, ast.FunctionDef] = {}
        self.math_aliases: set[str] = set()        # names bound to math
        self.math_ceil_aliases: set[str] = set()   # names bound to math.ceil
        self.movementspec_calls: list[ast.Call] = []

    def visit_Import(self, node: ast.Import) -> None:
        for a in node.names:
            if a.name == "math":
                self.math_aliases.add(a.asname or "math")

    def visit_ImportFrom(self, node: ast.ImportFrom) -> None:
        if node.module == "math":
            for a in node.names:
                if a.name == "ceil":
                    self.math_ceil_aliases.add(a.asname or "ceil")

    def visit_FunctionDef(self, node: ast.FunctionDef) -> None:
        self.functions.setdefault(node.name, node)
        self.generic_visit(node)

    visit_AsyncFunctionDef = visit_FunctionDef

    def visit_Call(self, node: ast.Call) -> None:
        name = None
        if isinstance(node.func, ast.Name):
            name = node.func.id
        elif isinstance(node.func, ast.Attribute):
            name = node.func.attr
        if name == "MovementSpec":
            self.movementspec_calls.append(node)
        self.generic_visit(node)


def _form_argument(call: ast.Call) -> Optional[ast.expr]:
    """The ``form`` argument of a MovementSpec(...) call, if present."""
    if len(call.args) >= 3:
        return call.args[2]
    for kw in call.keywords:
        if kw.arg == "form":
            return kw.value
    return None


def _positional_or_kw(call: ast.Call, index: int,
                      kw_name: str) -> Optional[ast.expr]:
    if len(call.args) > index:
        return call.args[index]
    for kw in call.keywords:
        if kw.arg == kw_name:
            return kw.value
    return None


def _reachable_forms(index: _ModuleIndex) -> dict[str, ast.FunctionDef]:
    """Form functions + transitively-called module-local helpers."""
    seeds = []
    for call in index.movementspec_calls:
        arg = _form_argument(call)
        if isinstance(arg, ast.Name) and arg.id in index.functions:
            seeds.append(arg.id)
    reachable: dict[str, ast.FunctionDef] = {}
    stack = list(seeds)
    while stack:
        name = stack.pop()
        if name in reachable:
            continue
        fn = index.functions.get(name)
        if fn is None:
            continue
        reachable[name] = fn
        for node in ast.walk(fn):
            if isinstance(node, ast.Call) and isinstance(node.func, ast.Name):
                if node.func.id in index.functions:
                    stack.append(node.func.id)
    return reachable


def _suppressed(source_lines: Sequence[str], line: int, rule: str) -> bool:
    if 1 <= line <= len(source_lines):
        return f"# lint: allow-{rule}" in source_lines[line - 1]
    return False


def lint_source(source: str, path: str = "<string>") -> list[LintViolation]:
    """Lint one module's source text; returns violations (pragmas applied)."""
    tree = ast.parse(source, filename=path)
    lines = source.splitlines()
    index = _ModuleIndex()
    index.visit(tree)
    out: list[LintViolation] = []

    def add(line: int, rule: str, message: str) -> None:
        if not _suppressed(lines, line, rule):
            out.append(LintViolation(path, line, rule, message))

    # Rule family 1: builtins inside closed forms.
    for fname, fn in sorted(_reachable_forms(index).items()):
        for node in ast.walk(fn):
            if not isinstance(node, ast.Call):
                continue
            if isinstance(node.func, ast.Name):
                rule = _FORBIDDEN_BUILTINS.get(node.func.id)
                if rule is not None:
                    add(node.lineno, rule,
                        f"builtin {node.func.id}() inside closed form "
                        f"{fname}() collapses array sweeps to scalars; "
                        f"use terms.{'minimum' if node.func.id == 'min' else 'maximum/np.maximum'}")
                if node.func.id in index.math_ceil_aliases:
                    add(node.lineno, "form-math-ceil",
                        f"math.ceil inside closed form {fname}() breaks "
                        "broadcasting; use terms.ceil")
            elif isinstance(node.func, ast.Attribute):
                base = node.func.value
                if (isinstance(base, ast.Name)
                        and base.id in index.math_aliases
                        and node.func.attr == "ceil"):
                    add(node.lineno, "form-math-ceil",
                        f"math.ceil inside closed form {fname}() breaks "
                        "broadcasting; use terms.ceil")

    # Rule family 2: trace-path invariants.
    if _is_trace_path(path):
        for node in ast.walk(tree):
            if (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr == "lexsort"):
                add(node.lineno, "trace-lexsort",
                    "np.lexsort in a trace path — the composite-key sort "
                    "(GraphTrace._pair_factorization) replaced it "
                    "(DESIGN.md §13/§14)")
        if _is_distributed(path):
            for node in ast.walk(tree):
                if not isinstance(node, ast.Call):
                    continue
                callee = node.func
                name = (callee.id if isinstance(callee, ast.Name)
                        else callee.attr if isinstance(callee, ast.Attribute)
                        else None)
                if name == "GraphTrace":
                    add(node.lineno, "trace-edge-list",
                        "direct GraphTrace(...) construction materializes "
                        "an edge list; distributed stages must use "
                        "GraphTrace.from_factorization (DESIGN.md §14)")

    # Rule family 3: MovementSpec vocabularies, statically.
    for call in index.movementspec_calls:
        hier = _positional_or_kw(call, 1, "hierarchy")
        role = _positional_or_kw(call, 3, "role")
        if hier is not None:
            if not (isinstance(hier, ast.Constant)
                    and isinstance(hier.value, str)):
                add(call.lineno, "movement-vocab",
                    "MovementSpec hierarchy must be a string literal from "
                    f"the declared vocabulary {VALID_HIERARCHIES}")
            elif hier.value not in VALID_HIERARCHIES:
                add(call.lineno, "movement-vocab",
                    f"unknown hierarchy {hier.value!r}; declared vocabulary "
                    f"is {VALID_HIERARCHIES}")
        if role is not None:
            if not (isinstance(role, ast.Constant)
                    and isinstance(role.value, str)):
                add(call.lineno, "movement-vocab",
                    "MovementSpec role must be a string literal from "
                    f"the declared vocabulary {VALID_ROLES}")
            elif role.value not in VALID_ROLES:
                add(call.lineno, "movement-vocab",
                    f"unknown role {role.value!r}; declared vocabulary "
                    f"is {VALID_ROLES}")
    return out


def lint_paths(roots: Optional[Iterable[Path]] = None
               ) -> list[LintViolation]:
    """Lint every ``*.py`` under the given roots (default: the repo's
    closed-form and trace-path packages)."""
    roots = tuple(Path(r) for r in (roots or default_lint_roots()))
    out: list[LintViolation] = []
    for root in roots:
        files = sorted(root.rglob("*.py")) if root.is_dir() else [root]
        for f in files:
            out.extend(lint_source(f.read_text(), str(f)))
    return out
