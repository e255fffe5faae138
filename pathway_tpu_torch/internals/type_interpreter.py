"""Expression type inference (reference: internals/type_interpreter.py).

Walks the AST with a schema resolver; produces the output DType, applying
INT->FLOAT coercion and Optional propagation. Intentionally forgiving:
unknown constructs infer ANY rather than failing — strictness can tighten
per-op over time.
"""

from __future__ import annotations

from typing import Any, Callable

from pathway_tpu_torch.internals import dtype as dt
from pathway_tpu_torch.internals import expression as ex


_ARITH = {"+", "-", "*", "/", "//", "%", "**"}
_CMP = {"==", "!=", "<", "<=", ">", ">="}
_BOOLOPS = {"&", "|", "^"}


def infer_dtype(
    expr: ex.ColumnExpression,
    ref_dtype: Callable[[ex.ColumnReference], dt.DType],
) -> dt.DType:
    def rec(e: ex.ColumnExpression) -> dt.DType:
        if isinstance(e, ex.ColumnConstExpression):
            return dt.dtype_of_value(e._value)
        if isinstance(e, ex.IdReference):
            # resolvers may declare a specific id pointer type
            # (Table.update_id_type); default to the generic pointer
            try:
                return ref_dtype(e)
            except Exception:  # noqa: BLE001
                return dt.ANY_POINTER
        if isinstance(e, ex.ColumnReference):
            try:
                return ref_dtype(e)
            except KeyError:
                return dt.ANY
        if isinstance(e, ex.ReducerExpression):
            arg_dtypes = [rec(a) for a in e._args]
            try:
                return e._reducer.result_dtype(arg_dtypes)
            except Exception:  # noqa: BLE001
                return dt.ANY
        if isinstance(e, ex.BinaryOpExpression):
            lt, rt = rec(e._left), rec(e._right)
            op = e._op
            if op in _CMP:
                return dt.BOOL
            if op in _BOOLOPS:
                if lt == dt.BOOL and rt == dt.BOOL:
                    return dt.BOOL
                return dt.types_lca(lt, rt)
            if op == "@":
                return dt.ANY_ARRAY
            lt_u, rt_u = dt.unoptionalize(lt), dt.unoptionalize(rt)
            if op == "/":
                if lt_u in (dt.INT, dt.FLOAT) and rt_u in (dt.INT, dt.FLOAT):
                    return dt.FLOAT
            if op == "+" and lt_u == dt.STR:
                return dt.STR
            if op == "*" and {lt_u, rt_u} == {dt.STR, dt.INT}:
                return dt.STR
            if lt_u == dt.DATE_TIME_NAIVE or lt_u == dt.DATE_TIME_UTC:
                if op == "-" and rt_u == lt_u:
                    return dt.DURATION
                if op in ("+", "-") and rt_u == dt.DURATION:
                    return lt_u
            if lt_u == dt.DURATION:
                if op in ("+", "-") and rt_u == dt.DURATION:
                    return dt.DURATION
                if op == "+" and rt_u in (dt.DATE_TIME_NAIVE, dt.DATE_TIME_UTC):
                    return rt_u
                if op in ("*",) and rt_u == dt.INT:
                    return dt.DURATION
                if op == "/" and rt_u == dt.DURATION:
                    return dt.FLOAT
                if op == "//" and rt_u == dt.DURATION:
                    return dt.INT
            if lt_u in (dt.INT, dt.FLOAT) and rt_u in (dt.INT, dt.FLOAT):
                base = dt.FLOAT if dt.FLOAT in (lt_u, rt_u) else dt.INT
                return base
            if isinstance(lt_u, dt.Array) or isinstance(rt_u, dt.Array):
                return dt.ANY_ARRAY
            return dt.types_lca(lt, rt)
        if isinstance(e, ex.UnaryOpExpression):
            if e._op == "~":
                return dt.BOOL
            return rec(e._expr)
        if isinstance(e, (ex.IsNoneExpression, ex.IsNotNoneExpression)):
            return dt.BOOL
        if isinstance(e, ex.IfElseExpression):
            return dt.types_lca(rec(e._then), rec(e._else))
        if isinstance(e, ex.CoalesceExpression):
            out: dt.DType | None = None
            for a in e._args:
                t = rec(a)
                out = t if out is None else dt.types_lca(out, t)
            # coalesce strips Optionality if the last arg is non-optional
            if out is not None and e._args and not isinstance(rec(e._args[-1]), (dt._NoneDType, dt.Optional)):
                return dt.unoptionalize(out)
            return out or dt.ANY
        if isinstance(e, ex.RequireExpression):
            return dt.Optional(rec(e._val))
        if isinstance(e, ex.ApplyExpression):
            return e._return_type
        if isinstance(e, (ex.CastExpression, ex.ConvertExpression)):
            t = e._target
            if getattr(e, "_unwrap", False):
                return dt.unoptionalize(t)
            inner = rec(e._expr)
            if isinstance(inner, dt.Optional) and isinstance(e, ex.CastExpression):
                return dt.Optional(t)
            return t
        if isinstance(e, ex.DeclareTypeExpression):
            return e._target
        if isinstance(e, ex.PointerExpression):
            base: dt.DType = dt.ANY_POINTER
            return dt.Optional(base) if e._optional else base
        if isinstance(e, ex.MakeTupleExpression):
            return dt.Tuple(*[rec(a) for a in e._args])
        if isinstance(e, ex.GetExpression):
            obj_t = dt.unoptionalize(rec(e._obj))
            if obj_t == dt.JSON:
                return dt.JSON
            if isinstance(obj_t, dt.List):
                return obj_t.wrapped if not e._check_if_exists else dt.Optional(obj_t.wrapped)
            if isinstance(obj_t, dt.Tuple):
                idx = e._index
                if isinstance(idx, ex.ColumnConstExpression) and isinstance(idx._value, int):
                    i = idx._value
                    if 0 <= i < len(obj_t.args):
                        return obj_t.args[i]
                    if -len(obj_t.args) <= i < 0:
                        return obj_t.args[i]
            return dt.ANY
        if isinstance(e, ex.MethodCallExpression):
            if e._return_type is not None:
                rt = e._return_type
            else:
                rt = rec(e._args[0]) if e._args else dt.ANY
            arg0 = rec(e._args[0]) if e._args else dt.ANY
            if isinstance(arg0, dt.Optional) and not isinstance(rt, dt.Optional):
                return dt.Optional(rt)
            return rt
        if isinstance(e, ex.UnwrapExpression):
            return dt.unoptionalize(rec(e._expr))
        if isinstance(e, ex.FillErrorExpression):
            return dt.types_lca(rec(e._expr), rec(e._replacement))
        return dt.ANY

    return rec(expr)
