"""Compile expression ASTs into row-evaluation closures.

Reference parity: the typed expression interpreter (src/engine/expression.rs)
+ RowwiseEvaluator (internals/graph_runner/expression_evaluator.py:201).
A compiled expression is `fn(key, rows) -> value` where `rows` is a tuple of
row-tuples, one per aligned input table. Vectorized (numpy/XLA) evaluation
of eligible expressions lives in engine/vectorize.py and shares this AST.
"""

from __future__ import annotations

from typing import Any, Callable, Sequence

import numpy as np

from pathway_tpu_torch.internals import dtype as dt
from pathway_tpu_torch.internals import expression as expr_mod
from pathway_tpu_torch.internals.errors import ERROR, ErrorValue
from pathway_tpu_torch.internals.expression import (
    ApplyExpression,
    AsyncApplyExpression,
    BinaryOpExpression,
    CastExpression,
    CoalesceExpression,
    ColumnConstExpression,
    ColumnExpression,
    ColumnReference,
    ConvertExpression,
    DeclareTypeExpression,
    FillErrorExpression,
    GetExpression,
    IdReference,
    IfElseExpression,
    IsNoneExpression,
    IsNotNoneExpression,
    MakeTupleExpression,
    MethodCallExpression,
    PointerExpression,
    ReducerExpression,
    RequireExpression,
    ThisMarker,
    UnaryOpExpression,
    UnwrapExpression,
    _BIN_OPS,
)
from pathway_tpu_torch.internals.json import Json
from pathway_tpu_torch.internals.keys import Key, key_for_values


class Resolver:
    """Maps a ColumnReference to (input_index, column_index).

    tables: aligned input tables (index 0 = primary / `pw.this`).
    For join contexts, `left_table`/`right_table` map pw.left / pw.right.
    """

    def __init__(
        self,
        tables: Sequence[Any],
        left_table: Any = None,
        right_table: Any = None,
        reducer_slots: dict[int, int] | None = None,
        reducer_input: int = 0,
    ):
        self.tables = list(tables)
        self.left_table = left_table
        self.right_table = right_table
        self.reducer_slots = reducer_slots or {}
        self.reducer_input = reducer_input

    def table_of(self, ref: ColumnReference) -> Any:
        tab = ref.table
        if isinstance(tab, ThisMarker):
            side = tab._side
            if side == "left":
                if self.left_table is None:
                    raise ValueError("pw.left used outside of a join")
                return self.left_table
            if side == "right":
                if self.right_table is None:
                    raise ValueError("pw.right used outside of a join")
                return self.right_table
            return self.tables[0]
        return tab

    def resolve(self, ref: ColumnReference) -> tuple[int, int | None]:
        """Returns (input_idx, col_idx); col_idx None means the key itself."""
        table = self.table_of(ref)
        if isinstance(ref, IdReference) or ref.name == "id":
            idx = self._input_index(table)
            return (idx, None)
        idx = self._input_index(table)
        names = self.tables[idx]._column_names()
        try:
            col = names.index(ref.name)
        except ValueError:
            raise KeyError(
                f"column {ref.name!r} not found in table with columns {names}"
            ) from None
        return (idx, col)

    def _input_index(self, table: Any) -> int:
        for i, t in enumerate(self.tables):
            if t is table:
                return i
        # Tables sharing a universe may substitute for each other only if
        # registered; the lowering registers every referenced table.
        raise KeyError(f"table {table!r} is not an input of this context")


CompiledFn = Callable[[Key, tuple], Any]


def compile_expression(expr: ColumnExpression, resolver: Resolver) -> CompiledFn:
    """Build fn(key, rows) -> value."""

    def rec(e: ColumnExpression) -> CompiledFn:
        if type(e).__name__ == "_SlotRef":  # injected by lowering
            ii, ci = e.input_idx, e.col_idx  # type: ignore[attr-defined]
            return lambda key, rows: rows[ii][ci]
        if isinstance(e, ColumnConstExpression):
            v = e._value
            if isinstance(v, (dict, list)):
                v = Json(v)
            return lambda key, rows: v
        if isinstance(e, IdReference):
            idx, _ = resolver.resolve(e)
            return lambda key, rows: key
        if isinstance(e, ColumnReference):
            idx, col = resolver.resolve(e)
            if col is None:
                return lambda key, rows: key
            return lambda key, rows: rows[idx][col]
        if isinstance(e, ReducerExpression):
            slot = resolver.reducer_slots.get(id(e))
            if slot is None:
                raise ValueError("reducer used outside of reduce()")
            ridx = resolver.reducer_input
            return lambda key, rows: rows[ridx][slot]
        if isinstance(e, BinaryOpExpression):
            lf, rf = rec(e._left), rec(e._right)
            op = _BIN_OPS[e._op]
            opname = e._op
            if opname == "/":
                def run_div(key, rows):
                    a, b = lf(key, rows), rf(key, rows)
                    if isinstance(a, ErrorValue) or isinstance(b, ErrorValue):
                        return ERROR
                    if isinstance(a, int) and isinstance(b, int):
                        return a / b
                    return a / b
                return run_div
            if opname in ("==", "!="):
                def run_eq(key, rows, _neq=(opname == "!=")):
                    a, b = lf(key, rows), rf(key, rows)
                    if isinstance(a, ErrorValue) or isinstance(b, ErrorValue):
                        return ERROR
                    res = _value_eq(a, b)
                    return (not res) if _neq else res
                return run_eq

            def run_bin(key, rows):
                a, b = lf(key, rows), rf(key, rows)
                if isinstance(a, ErrorValue) or isinstance(b, ErrorValue):
                    return ERROR
                return op(a, b)
            return run_bin
        if isinstance(e, UnaryOpExpression):
            f = rec(e._expr)
            if e._op == "-":
                return lambda key, rows: _guard_err(f(key, rows), lambda v: -v)
            if e._op == "~":
                def run_not(key, rows):
                    v = f(key, rows)
                    if isinstance(v, ErrorValue):
                        return ERROR
                    if isinstance(v, (bool, np.bool_)):
                        return not v
                    return ~v
                return run_not
            if e._op == "abs":
                return lambda key, rows: _guard_err(f(key, rows), abs)
            raise NotImplementedError(e._op)
        if isinstance(e, IsNoneExpression):
            f = rec(e._expr)
            return lambda key, rows: f(key, rows) is None
        if isinstance(e, IsNotNoneExpression):
            f = rec(e._expr)
            return lambda key, rows: f(key, rows) is not None
        if isinstance(e, IfElseExpression):
            cf, tf, ef = rec(e._if), rec(e._then), rec(e._else)

            def run_ifelse(key, rows):
                c = cf(key, rows)
                if isinstance(c, ErrorValue):
                    return ERROR
                return tf(key, rows) if c else ef(key, rows)

            return run_ifelse
        if isinstance(e, CoalesceExpression):
            fns = [rec(a) for a in e._args]

            def run_coalesce(key, rows):
                for f in fns:
                    v = f(key, rows)
                    if v is not None and not isinstance(v, ErrorValue):
                        return v
                return None

            return run_coalesce
        if isinstance(e, RequireExpression):
            vf = rec(e._val)
            fns = [rec(a) for a in e._args]

            def run_require(key, rows):
                for f in fns:
                    if f(key, rows) is None:
                        return None
                return vf(key, rows)

            return run_require
        if isinstance(e, AsyncApplyExpression):
            # compiled synchronously here only when reached outside the
            # dedicated async lowering (e.g. inside iterate)
            return _compile_apply(e, resolver, rec)
        if isinstance(e, ApplyExpression):
            return _compile_apply(e, resolver, rec)
        if isinstance(e, (CastExpression, ConvertExpression)):
            f = rec(e._expr)
            target = e._target
            unwrap = getattr(e, "_unwrap", False)
            caster = _make_caster(target, isinstance(e, ConvertExpression))

            def run_cast(key, rows):
                v = f(key, rows)
                if isinstance(v, ErrorValue):
                    return ERROR
                if v is None:
                    if unwrap:
                        return ERROR
                    return None
                try:
                    return caster(v)
                except (ValueError, TypeError):
                    return ERROR

            return run_cast
        if isinstance(e, DeclareTypeExpression):
            return rec(e._expr)
        if isinstance(e, PointerExpression):
            fns = [rec(a) for a in e._args]
            inst_f = rec(e._instance) if e._instance is not None else None

            def run_pointer(key, rows):
                vals = [f(key, rows) for f in fns]
                if any(isinstance(v, ErrorValue) for v in vals):
                    return ERROR
                if e._optional and any(v is None for v in vals):
                    return None
                base = key_for_values(*vals)
                if inst_f is not None:
                    inst = inst_f(key, rows)
                    return base.with_shard_of(key_for_values(inst))
                return base

            return run_pointer
        if isinstance(e, MakeTupleExpression):
            fns = [rec(a) for a in e._args]
            return lambda key, rows: tuple(f(key, rows) for f in fns)
        if isinstance(e, GetExpression):
            of, inf = rec(e._obj), rec(e._index)
            df = rec(e._default) if e._default is not None else None
            check = e._check_if_exists

            def run_get(key, rows):
                obj = of(key, rows)
                idx = inf(key, rows)
                if isinstance(obj, ErrorValue) or isinstance(idx, ErrorValue):
                    return ERROR
                try:
                    if isinstance(obj, Json):
                        return obj[idx]
                    return obj[idx]
                except (KeyError, IndexError, TypeError):
                    if check:
                        return df(key, rows) if df is not None else None
                    return ERROR

            return run_get
        if isinstance(e, MethodCallExpression):
            fns = [rec(a) for a in e._args]
            fn = e._fn

            def run_method(key, rows):
                vals = [f(key, rows) for f in fns]
                if any(isinstance(v, ErrorValue) for v in vals):
                    return ERROR
                if vals and vals[0] is None:
                    return None
                return fn(*vals)

            return run_method
        if isinstance(e, UnwrapExpression):
            f = rec(e._expr)

            def run_unwrap(key, rows):
                v = f(key, rows)
                if v is None:
                    raise ValueError("unwrap() received None")
                return v

            return run_unwrap
        if isinstance(e, FillErrorExpression):
            f, rf = rec(e._expr), rec(e._replacement)

            def run_fill(key, rows):
                try:
                    v = f(key, rows)
                except Exception:  # noqa: BLE001
                    return rf(key, rows)
                if isinstance(v, ErrorValue):
                    return rf(key, rows)
                return v

            return run_fill
        raise NotImplementedError(f"cannot compile {type(e).__name__}")

    return rec(expr)


def _compile_apply(e: ApplyExpression, resolver: Resolver, rec) -> CompiledFn:
    arg_fns = [rec(a) for a in e._args]
    kw_fns = {k: rec(v) for k, v in e._kwargs.items()}
    fn = e._fn
    propagate_none = e._propagate_none

    def run_apply(key, rows):
        args = [f(key, rows) for f in arg_fns]
        kwargs = {k: f(key, rows) for k, f in kw_fns.items()}
        if any(isinstance(a, ErrorValue) for a in args) or any(
            isinstance(v, ErrorValue) for v in kwargs.values()
        ):
            return ERROR
        if propagate_none and (
            any(a is None for a in args) or any(v is None for v in kwargs.values())
        ):
            return None
        return fn(*args, **kwargs)

    return run_apply


def _make_caster(target: dt.DType, convert: bool) -> Callable[[Any], Any]:
    if target == dt.INT:
        if convert:
            def to_int(v: Any) -> int:
                if isinstance(v, Json):
                    r = v.as_int()
                    if r is None:
                        raise ValueError(f"Json {v!r} is not an int")
                    return r
                return int(v)
            return to_int
        return lambda v: int(v)
    if target == dt.FLOAT:
        if convert:
            def to_float(v: Any) -> float:
                if isinstance(v, Json):
                    r = v.as_float()
                    if r is None:
                        raise ValueError(f"Json {v!r} is not a float")
                    return r
                return float(v)
            return to_float
        return lambda v: float(v)
    if target == dt.STR:
        if convert:
            def to_str(v: Any) -> str:
                if isinstance(v, Json):
                    r = v.as_str()
                    if r is None:
                        raise ValueError(f"Json {v!r} is not a str")
                    return r
                return str(v)
            return to_str
        return lambda v: str(v)
    if target == dt.BOOL:
        if convert:
            def to_bool(v: Any) -> bool:
                if isinstance(v, Json):
                    r = v.as_bool()
                    if r is None:
                        raise ValueError(f"Json {v!r} is not a bool")
                    return r
                return bool(v)
            return to_bool
        return lambda v: bool(v)
    if isinstance(target, dt.Optional):
        return _make_caster(target.wrapped, convert)
    return lambda v: v


def _value_eq(a: Any, b: Any) -> bool:
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        return bool(np.array_equal(a, b))
    return a == b


def _guard_err(v: Any, f: Callable[[Any], Any]) -> Any:
    if isinstance(v, ErrorValue):
        return ERROR
    return f(v)


def collect_reducers(exprs: Sequence[ColumnExpression]) -> list[ReducerExpression]:
    """All distinct ReducerExpressions in the given expression trees."""
    out: list[ReducerExpression] = []
    seen: set[int] = set()

    def rec(e: ColumnExpression) -> None:
        if id(e) in seen:
            return
        seen.add(id(e))
        if isinstance(e, ReducerExpression):
            out.append(e)
            return  # don't descend into reducer args here
        for s in e._sub_expressions():
            rec(s)

    for e in exprs:
        rec(e)
    return out


def referenced_tables(exprs: Sequence[ColumnExpression]) -> list[Any]:
    """Distinct concrete tables referenced (ThisMarkers excluded)."""
    out: list[Any] = []
    for e in exprs:
        for ref in e._column_references():
            tab = ref.table
            if not isinstance(tab, ThisMarker) and all(tab is not t for t in out):
                out.append(tab)
    return out
