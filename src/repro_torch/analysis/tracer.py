"""Symbolic tracer: evaluate ``MovementSpec.form`` with tracer values.

One tracer pass evaluates a closed form exactly as the shared engine does —
same Python code path, same numpy calls — but with :class:`SymbolicValue`
operands that carry, instead of numbers:

* a **unit** (:mod:`repro_torch.analysis.units`) seeded from the Table II
  declarations in :mod:`repro_torch.core.notation`,
* the set of **symbols** (``graph.N``, ``hw.sigma``, ...) that reached the
  value through arithmetic — the provenance record, and
* an **interval bound** ``[lo, hi]`` propagated from the declared operating
  envelope, from which the float64-exactness audit flags any intermediate
  that can exceed 2^53 (the integer-exact range).

Dispatch mechanics: numpy ufuncs (``np.ceil``, ``np.minimum``,
``np.maximum``, arithmetic) reach the tracer through ``__array_ufunc__``
and array functions (``np.where``, ``np.ones_like``) through
``__array_function__`` — both protocols fire for *any* operand defining
them, no ndarray subclassing needed.  The one numpy entry point exempt from
both protocols is ``np.asarray`` (the ``_f64`` helper every closed form
opens with), so :func:`tracing_numpy` patches it for the duration of a
form call to pass tracers through unchanged; the patch is scoped by a
module lock and restored in ``finally``.

Unit violations do not abort the trace: the offending op is recorded as a
:class:`UnitIssue` and evaluation continues with a declared recovery unit,
so one pass yields *all* of a movement's errors plus its full provenance.
Only data-dependent Python control flow (``if tracer:``, ``float(tracer)``)
aborts, because no sound single-path trace exists for it.
"""

from __future__ import annotations

import dataclasses
import math
import threading
from contextlib import contextmanager
from dataclasses import dataclass, field

import numpy as np

from ..core.notation import unit_declarations_for
from .units import BITS, DIMENSIONLESS, Unit, unit_from_tag

__all__ = [
    "FLOAT64_EXACT_MAX",
    "UnitIssue",
    "OverflowRecord",
    "TraceAbort",
    "TraceContext",
    "SymbolicValue",
    "tracing_numpy",
    "traced_record",
    "trace_form",
]

#: Largest magnitude at which every integer is exactly representable in
#: float64 (2^53).  Intermediates whose interval bound exceeds this lose
#: integer exactness — the paper's ceil-of-ratio algebra silently degrades.
FLOAT64_EXACT_MAX = float(2 ** 53)

_TRACE_LOCK = threading.RLock()


class TraceAbort(RuntimeError):
    """A closed form performed an operation no single-path trace covers
    (data-dependent Python branching / scalar coercion of a tracer)."""


@dataclass(frozen=True)
class UnitIssue:
    """One unit-algebra violation inside a traced closed form."""

    movement: str
    op: str
    detail: str

    def __str__(self) -> str:
        return f"{self.movement}: {self.op}: {self.detail}"


@dataclass(frozen=True)
class OverflowRecord:
    """An intermediate whose envelope bound exceeds the 2^53 exact range."""

    movement: str
    op: str
    symbols: tuple[str, ...]
    bound: float

    def __str__(self) -> str:
        return (f"{self.movement}: {self.op} over {', '.join(self.symbols)} "
                f"reaches {self.bound:.4g} > 2^53")


@dataclass
class TraceContext:
    """Mutable collector shared by every tracer of one movement pass."""

    movement: str = "<form>"
    issues: list = field(default_factory=list)
    overflows: list = field(default_factory=list)
    minimum_calls: int = 0

    def issue(self, op: str, detail: str) -> None:
        self.issues.append(UnitIssue(self.movement, op, detail))

    def overflow(self, op: str, symbols: frozenset, bound: float) -> None:
        self.overflows.append(OverflowRecord(
            self.movement, op, tuple(sorted(symbols)), bound))


def _mul_bound(a: float, b: float) -> float:
    """inf * 0 -> 0 convention (an exactly-zero factor kills the product)."""
    if a == 0.0 or b == 0.0:
        return 0.0
    return a * b


def _interval_mul(alo, ahi, blo, bhi):
    c = (_mul_bound(alo, blo), _mul_bound(alo, bhi),
         _mul_bound(ahi, blo), _mul_bound(ahi, bhi))
    return min(c), max(c)


def _interval_div(alo, ahi, blo, bhi):
    if blo <= 0.0 <= bhi:
        return -math.inf, math.inf
    c = (alo / blo, alo / bhi, ahi / blo, ahi / bhi)
    return min(c), max(c)


class SymbolicValue:
    """A traced operand: unit x provenance symbols x interval bound."""

    __slots__ = ("ctx", "unit", "symbols", "lo", "hi", "nominal")

    def __init__(self, ctx: TraceContext, unit: Unit, symbols: frozenset,
                 lo: float, hi: float, nominal: str = "") -> None:
        self.ctx = ctx
        self.unit = unit
        self.symbols = symbols
        self.lo = float(lo)
        self.hi = float(hi)
        self.nominal = nominal

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        syms = ",".join(sorted(self.symbols)) or "const"
        return (f"SymbolicValue({syms}: {self.unit}, "
                f"[{self.lo:.4g}, {self.hi:.4g}])")

    # -- helpers -----------------------------------------------------------
    def _make(self, unit: Unit, symbols: frozenset, lo: float, hi: float,
              op: str) -> "SymbolicValue":
        out = SymbolicValue(self.ctx, unit, symbols, lo, hi)
        if math.isfinite(out.hi) and out.hi > FLOAT64_EXACT_MAX:
            self.ctx.overflow(op, symbols, out.hi)
        return out

    def _coerce(self, x) -> "SymbolicValue":
        """Lift a plain numeric operand to a dimensionless constant."""
        if isinstance(x, SymbolicValue):
            return x
        arr = np.asarray(x, dtype=np.float64)
        lo = float(arr.min()) if arr.size else 0.0
        hi = float(arr.max()) if arr.size else 0.0
        return SymbolicValue(self.ctx, DIMENSIONLESS, frozenset(), lo, hi)

    def _same_unit(self, other: "SymbolicValue", op: str) -> Unit:
        """Units must agree for +/-/min/max/where; record and recover."""
        if other.unit != self.unit:
            self.ctx.issue(op, f"operands carry mismatched units "
                               f"{self.unit} vs {other.unit} "
                               f"(symbols {sorted(self.symbols | other.symbols)})")
        return self.unit

    # -- the op table ------------------------------------------------------
    def _binop(self, other, op: str):
        other = self._coerce(other)
        syms = self.symbols | other.symbols
        if op == "multiply":
            lo, hi = _interval_mul(self.lo, self.hi, other.lo, other.hi)
            return self._make(self.unit * other.unit, syms, lo, hi, op)
        if op in ("divide", "true_divide"):
            lo, hi = _interval_div(self.lo, self.hi, other.lo, other.hi)
            return self._make(self.unit / other.unit, syms, lo, hi, op)
        if op == "add":
            unit = self._same_unit(other, op)
            return self._make(unit, syms, self.lo + other.lo,
                              self.hi + other.hi, op)
        if op == "subtract":
            unit = self._same_unit(other, op)
            return self._make(unit, syms, self.lo - other.hi,
                              self.hi - other.lo, op)
        if op == "minimum":
            self.ctx.minimum_calls += 1
            unit = self._same_unit(other, op)
            return self._make(unit, syms, min(self.lo, other.lo),
                              min(self.hi, other.hi), op)
        if op == "maximum":
            unit = self._same_unit(other, op)
            return self._make(unit, syms, max(self.lo, other.lo),
                              max(self.hi, other.hi), op)
        if op in ("greater", "greater_equal", "less", "less_equal",
                  "equal", "not_equal"):
            self._same_unit(other, op)
            return self._make(DIMENSIONLESS, syms, 0.0, 1.0, op)
        raise AssertionError(f"unhandled binop {op}")  # pragma: no cover

    def _rounding(self, op: str):
        if not self.unit.is_dimensionless:
            self.ctx.issue(op, f"applied to a non-dimensionless quantity "
                               f"({self.unit}; symbols "
                               f"{sorted(self.symbols)}) — ceil/floor are "
                               f"occupancy-ratio operators")
        fn = math.ceil if op == "ceil" else math.floor
        lo = fn(self.lo) if math.isfinite(self.lo) else self.lo
        hi = fn(self.hi) if math.isfinite(self.hi) else self.hi
        return self._make(DIMENSIONLESS, self.symbols, lo, hi, op)

    # -- numpy protocol ----------------------------------------------------
    _UFUNC_BINOPS = {
        np.add: "add", np.subtract: "subtract", np.multiply: "multiply",
        np.divide: "divide", np.true_divide: "true_divide",
        np.minimum: "minimum", np.maximum: "maximum",
        np.greater: "greater", np.greater_equal: "greater_equal",
        np.less: "less", np.less_equal: "less_equal",
        np.equal: "equal", np.not_equal: "not_equal",
    }

    def __array_ufunc__(self, ufunc, method, *inputs, **kwargs):
        if method != "__call__" or kwargs.get("out") is not None:
            self.ctx.issue(getattr(ufunc, "__name__", str(ufunc)),
                           f"unsupported ufunc method {method!r} in a "
                           "closed form")
            return self._conservative(inputs)
        name = self._UFUNC_BINOPS.get(ufunc)
        if name is not None:
            a = self._coerce(inputs[0])
            return a._binop(inputs[1], name)
        if ufunc is np.ceil or ufunc is np.floor:
            return self._coerce(inputs[0])._rounding(ufunc.__name__)
        if ufunc is np.negative:
            a = self._coerce(inputs[0])
            return a._make(a.unit, a.symbols, -a.hi, -a.lo, "negative")
        if ufunc is np.positive:
            return self._coerce(inputs[0])
        self.ctx.issue(ufunc.__name__, "ufunc not in the closed-form "
                                       "vocabulary (terms.ceil / "
                                       "terms.minimum / broadcasting "
                                       "arithmetic)")
        return self._conservative(inputs)

    def __array_function__(self, func, types, args, kwargs):
        if func is np.where and len(args) == 3:
            cond = self._coerce(args[0])
            a, b = self._coerce(args[1]), self._coerce(args[2])
            unit = a._same_unit(b, "where")
            syms = cond.symbols | a.symbols | b.symbols
            return self._make(unit, syms, min(a.lo, b.lo),
                              max(a.hi, b.hi), "where")
        if func is np.ones_like:
            return SymbolicValue(self.ctx, DIMENSIONLESS, frozenset(),
                                 1.0, 1.0)
        if func is np.zeros_like:
            return SymbolicValue(self.ctx, DIMENSIONLESS, frozenset(),
                                 0.0, 0.0)
        self.ctx.issue(getattr(func, "__name__", str(func)),
                       "array function not in the closed-form vocabulary")
        flat = [a for a in args if isinstance(a, SymbolicValue)]
        return self._conservative(flat)

    def _conservative(self, inputs) -> "SymbolicValue":
        syms = frozenset().union(*(i.symbols for i in inputs
                                   if isinstance(i, SymbolicValue)))
        return SymbolicValue(self.ctx, DIMENSIONLESS, syms,
                             -math.inf, math.inf)

    # -- Python operators --------------------------------------------------
    def __add__(self, o): return self._binop(o, "add")
    def __radd__(self, o): return self._coerce(o)._binop(self, "add")
    def __sub__(self, o): return self._binop(o, "subtract")
    def __rsub__(self, o): return self._coerce(o)._binop(self, "subtract")
    def __mul__(self, o): return self._binop(o, "multiply")
    def __rmul__(self, o): return self._coerce(o)._binop(self, "multiply")
    def __truediv__(self, o): return self._binop(o, "divide")
    def __rtruediv__(self, o): return self._coerce(o)._binop(self, "divide")
    def __neg__(self): return self._make(self.unit, self.symbols,
                                         -self.hi, -self.lo, "negative")
    def __lt__(self, o): return self._binop(o, "less")
    def __le__(self, o): return self._binop(o, "less_equal")
    def __gt__(self, o): return self._binop(o, "greater")
    def __ge__(self, o): return self._binop(o, "greater_equal")

    def __pow__(self, k):
        if not isinstance(k, (int, float)) or k != int(k) or k < 0:
            self.ctx.issue("power", f"non-integer exponent {k!r}")
            return self._conservative((self,))
        k = int(k)
        lo, hi = self.lo, self.hi
        for _ in range(k - 1):
            lo, hi = _interval_mul(lo, hi, self.lo, self.hi)
        if k == 0:
            lo = hi = 1.0
        return self._make(self.unit ** k, self.symbols, lo, hi, "power")

    # -- soundness guards --------------------------------------------------
    def __bool__(self):
        raise TraceAbort(
            f"{self.ctx.movement}: data-dependent Python branch on "
            f"{sorted(self.symbols)} — closed forms must stay "
            "branch-free (use np.where / terms.minimum)")

    def __float__(self):
        raise TraceAbort(
            f"{self.ctx.movement}: scalar coercion of a traced value "
            f"({sorted(self.symbols)}) — the form would lose broadcasting")

    __int__ = __float__
    __index__ = __float__


@contextmanager
def tracing_numpy():
    """Patch ``np.asarray`` to pass :class:`SymbolicValue` through.

    The ``_f64`` helpers every closed form opens with call
    ``np.asarray(x, dtype=np.float64)``, which neither ``__array_ufunc__``
    nor ``__array_function__`` can intercept.  Scoped by the module trace
    lock; everything else reaches the tracer via the numpy protocols.
    """
    with _TRACE_LOCK:
        orig = np.asarray

        def _asarray(a, *args, **kwargs):
            if isinstance(a, SymbolicValue):
                return a
            return orig(a, *args, **kwargs)

        np.asarray = _asarray
        try:
            yield
        finally:
            np.asarray = orig


def traced_record(record, role: str, ctx: TraceContext, *,
                  overrides=None):
    """A copy of a parameter record whose fields are seeded tracers.

    ``role`` prefixes the provenance symbols (``graph.N`` / ``hw.sigma``).
    Fields declared without an envelope (``lo``/``hi`` None) are pinned to
    the record's own value — a point interval at the published design
    point.  ``overrides`` maps field names to ``(lo, hi)`` pairs that
    replace the declared envelope (the CLI's --max-edges family).
    ``None``-valued fields (EnGN's ``B_star`` default) are left in place
    so the record's own fallback properties keep working.
    """
    decls = unit_declarations_for(record)
    overrides = overrides or {}
    updates = {}
    for f in dataclasses.fields(record):
        value = getattr(record, f.name)
        if value is None:
            continue
        decl = decls[f.name]
        point = float(np.asarray(value, dtype=np.float64))
        lo = point if decl.lo is None else float(decl.lo)
        hi = point if decl.hi is None else float(decl.hi)
        if f.name in overrides:
            lo, hi = (float(x) for x in overrides[f.name])
        updates[f.name] = SymbolicValue(
            ctx, unit_from_tag(decl.unit),
            frozenset({f"{role}.{f.name}"}), lo, hi, nominal=decl.unit)
    return dataclasses.replace(record, **updates)


def trace_form(form, traced_graph, traced_hw, ctx: TraceContext,
               movement: str = "<form>"):
    """Run one closed form under the tracer; returns (bits, iterations).

    Either result may come back as a plain constant (a degenerate form);
    both are coerced to tracers so the audit can interrogate them
    uniformly.  Unit issues accumulate in ``ctx``; only unsound traces
    (:class:`TraceAbort`) raise.
    """
    ctx.movement = movement
    with tracing_numpy():
        bits, iters = form(traced_graph, traced_hw)
    anchor = SymbolicValue(ctx, DIMENSIONLESS, frozenset(), 0.0, 0.0)
    if not isinstance(bits, SymbolicValue):
        bits = anchor._coerce(bits)
    if not isinstance(iters, SymbolicValue):
        iters = anchor._coerce(iters)
    return bits, iters
