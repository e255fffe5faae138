"""Top-level expression helpers + pw.iterate (reference: internals/common.py)."""

from __future__ import annotations

import typing
from typing import Any, Callable, Iterable

from pathway_tpu_torch.internals import dtype as dt
from pathway_tpu_torch.internals import expression as ex
from pathway_tpu_torch.internals import schema as sch
from pathway_tpu_torch.internals import universe as univ
from pathway_tpu_torch.internals.table import OpSpec, Table


def _fn_return_type(fn: Callable) -> Any:
    try:
        hints = typing.get_type_hints(fn)
    except Exception:  # noqa: BLE001
        hints = getattr(fn, "__annotations__", {}) or {}
    return hints.get("return", Any)


def apply(fn: Callable, *args: Any, **kwargs: Any) -> ex.ApplyExpression:
    return ex.ApplyExpression(fn, _fn_return_type(fn), *args, **kwargs)


def apply_with_type(fn: Callable, ret_type: Any, *args: Any, **kwargs: Any) -> ex.ApplyExpression:
    return ex.ApplyExpression(fn, ret_type, *args, **kwargs)


def apply_async(fn: Callable, *args: Any, **kwargs: Any) -> ex.AsyncApplyExpression:
    return ex.AsyncApplyExpression(fn, _fn_return_type(fn), *args, **kwargs)


def cast(target_type: Any, expr: Any) -> ex.CastExpression:
    return ex.CastExpression(target_type, ex.wrap_arg(expr))


def declare_type(target_type: Any, expr: Any) -> ex.DeclareTypeExpression:
    return ex.DeclareTypeExpression(target_type, ex.wrap_arg(expr))


def coalesce(*args: Any) -> ex.CoalesceExpression:
    return ex.CoalesceExpression(*args)


def require(val: Any, *args: Any) -> ex.RequireExpression:
    return ex.RequireExpression(val, *args)


def if_else(if_clause: Any, then_clause: Any, else_clause: Any) -> ex.IfElseExpression:
    return ex.IfElseExpression(if_clause, then_clause, else_clause)


def make_tuple(*args: Any) -> ex.MakeTupleExpression:
    return ex.MakeTupleExpression(*args)


def unwrap(expr: Any) -> ex.UnwrapExpression:
    return ex.UnwrapExpression(expr)


def fill_error(expr: Any, replacement: Any) -> ex.FillErrorExpression:
    return ex.FillErrorExpression(expr, replacement)


def assert_table_has_schema(
    table: Table,
    schema: sch.SchemaMetaclass,
    *,
    allow_superset: bool = True,
    ignore_primary_keys: bool = True,
) -> None:
    table_dtypes = {n: c.dtype for n, c in table.schema.__columns__.items()}
    for name, col in schema.__columns__.items():
        if name not in table_dtypes:
            raise AssertionError(f"table is missing column {name!r}")
        if not dt.is_subtype(table_dtypes[name], col.dtype) and not dt.is_subtype(
            col.dtype, table_dtypes[name]
        ):
            raise AssertionError(
                f"column {name!r}: {table_dtypes[name]!r} incompatible with {col.dtype!r}"
            )
    if not allow_superset and set(table_dtypes) != set(schema.__columns__):
        raise AssertionError("table has extra columns")


class _IterateSpec:
    """Shared descriptor for one pw.iterate call."""

    def __init__(
        self,
        inputs: dict[str, Table],
        results: dict[str, Table],
        iterated_names: list[str],
        iteration_limit: int | None,
    ):
        self.inputs = inputs
        self.results = results
        self.iterated_names = iterated_names
        self.iteration_limit = iteration_limit


def iterate(
    func: Callable[..., Any], iteration_limit: int | None = None, **kwargs: Table
) -> Any:
    """Fixpoint iteration (reference: internals/common.py:39 pw.iterate).

    `func` receives placeholder tables and returns a dict (or namedtuple /
    dataclass) of result tables; results whose names match inputs feed back
    until convergence.
    """
    placeholders: dict[str, Table] = {}
    for name, t in kwargs.items():
        if not isinstance(t, Table):
            raise TypeError(f"iterate inputs must be Tables, got {name}={t!r}")
        spec = OpSpec("iterate_placeholder", [], name=name)
        placeholders[name] = Table(spec, t.schema, univ.Universe())
    raw = func(**placeholders)
    if isinstance(raw, dict):
        results = dict(raw)
    elif hasattr(raw, "_asdict"):
        results = dict(raw._asdict())
    elif isinstance(raw, Table):
        # single table result: feed back under the single input name
        if len(kwargs) != 1:
            raise TypeError("single-table iterate requires exactly one input table")
        results = {next(iter(kwargs)): raw}
    else:
        results = dict(vars(raw))
    iterated_names = [n for n in results if n in kwargs]
    it_spec = _IterateSpec(dict(kwargs), results, iterated_names, iteration_limit)

    out: dict[str, Table] = {}
    for name, t in results.items():
        spec = OpSpec("iterate_output", list(kwargs.values()), iterate=it_spec, name=name)
        out[name] = Table(spec, t.schema, univ.Universe())
    if len(out) == 1:
        return next(iter(out.values()))
    import collections

    Result = collections.namedtuple("IterateResult", list(out))  # type: ignore[misc]
    return Result(**out)


def table_transformer(fn: Callable | None = None, **kwargs: Any) -> Callable:
    """Decorator marking a Table -> Table transformer (type-checked passthrough)."""

    def wrap(f: Callable) -> Callable:
        return f

    if fn is not None:
        return wrap(fn)
    return wrap
