"""Column utilities (reference: stdlib/utils/col.py — unpack_col :60,
unpack_col_dict :143, multiapply_all_rows :211, apply_all_rows :276,
groupby_reduce_majority :326, flatten_column :16)."""

from __future__ import annotations

from typing import Any, Callable, Sequence

import pathway_tpu_torch.internals.expression as ex
from pathway_tpu_torch.internals import dtype as dt
from pathway_tpu_torch.internals.common import apply, apply_with_type
from pathway_tpu_torch.internals.json import Json
from pathway_tpu_torch.internals.table import Table


def unpack_col(
    column: ex.ColumnReference, *unpacked_columns: Any, schema: Any = None
) -> Table:
    """Unpack a tuple column into separate columns."""
    table: Table = column.table
    if schema is not None:
        names = list(schema.__columns__)
    else:
        names = [
            c.name if isinstance(c, ex.ColumnReference) else str(c)
            for c in unpacked_columns
        ]
    kwargs = {name: column[i] for i, name in enumerate(names)}
    return table.select(**kwargs)


def unpack_col_dict(column: ex.ColumnReference, schema: Any) -> Table:
    """Extract typed columns from a Json-object column (reference:
    col.py:143): each schema field reads `column[field]`, coerced to the
    declared dtype; missing fields yield None for Optional columns."""
    table: Table = column.table

    def getter(name: str, want: dt.DType) -> Callable[[Any], Any]:
        base = dt.unoptionalize(want)

        optional = isinstance(want, dt.Optional)

        def get(cell: Any) -> Any:
            obj = cell.value if isinstance(cell, Json) else cell
            v = obj.get(name) if isinstance(obj, dict) else None
            if v is None:
                if not optional:
                    # missing required field: poison the cell (ERROR +
                    # error log) instead of smuggling None past the
                    # declared non-Optional dtype
                    raise KeyError(
                        f"unpack_col_dict: required field {name!r} "
                        "missing from Json object"
                    )
                return None
            if isinstance(v, (dict, list)):
                return Json(v)
            if base == dt.FLOAT and isinstance(v, int):
                return float(v)
            if base == dt.STR and not isinstance(v, str):
                return str(v)
            return v

        return get

    return table.select(
        **{
            n: apply_with_type(
                getter(n, c.dtype), c.dtype.typehint(), column
            )
            for n, c in schema.__columns__.items()
        }
    )


def flatten_column(
    column: ex.ColumnReference, origin_id: str = "origin_id"
) -> Table:
    """One output row per element of the sequence column, carrying the
    ORIGIN row's id (reference: col.py:16)."""
    table: Table = column.table
    tmp = table.select(**{column.name: column})
    return tmp.flatten(tmp[column.name], origin_id=origin_id)


def multiapply_all_rows(
    *cols: ex.ColumnReference,
    fun: Callable[..., Sequence[Sequence]],
    result_col_names: list,
) -> Table:
    """Apply `fun` to the FULL contents of the columns at once, producing
    one output column per name in `result_col_names`, re-aligned to the
    original row ids (reference: col.py:211). Meant for infrequent,
    whole-table transforms (normalization, global ranking)."""
    assert cols, "multiapply_all_rows needs at least one column"
    table: Table = cols[0].table
    import pathway_tpu_torch.internals.reducers as red

    tmp = table.select(
        _pw_iac=apply(lambda *a: tuple(a), table.id, *cols)
    )
    reduced = tmp.reduce(_pw_all=red.sorted_tuple(tmp._pw_iac))

    def fun_wrapped(ids_and_cols: Any) -> tuple:
        ids, *colvals = zip(*ids_and_cols)
        res = fun(*[list(c) for c in colvals])
        for out_col in res:
            if len(out_col) != len(ids):
                raise ValueError(
                    "multiapply_all_rows: fun returned "
                    f"{len(out_col)} rows for {len(ids)} input rows — "
                    "outputs must align with the input one-to-one"
                )
        return tuple(zip(ids, *res))

    applied = reduced.select(_pw_res=apply(fun_wrapped, reduced._pw_all))
    flat = applied.flatten(applied._pw_res)
    names = [
        c.name if isinstance(c, ex.ColumnReference) else str(c)
        for c in result_col_names
    ]
    out = unpack_col(flat._pw_res, "_pw_idd", *names)
    out = out.with_id(out._pw_idd).without("_pw_idd")
    return out.with_universe_of(table)


def apply_all_rows(
    *cols: ex.ColumnReference,
    fun: Callable[..., Sequence],
    result_col_name: Any,
) -> Table:
    """Single-output-column form of multiapply_all_rows (reference:
    col.py:276)."""

    def fun_wrapped(*colvals: Any) -> tuple:
        return (fun(*colvals),)

    return multiapply_all_rows(
        *cols, fun=fun_wrapped, result_col_names=[result_col_name]
    )


def groupby_reduce_majority(
    column: ex.ColumnReference, value_column: ex.ColumnReference
) -> Table:
    """The most frequent value of value_column per group (reference:
    col.py:326)."""
    import pathway_tpu_torch.internals.reducers as red

    table: Table = column.table
    counted = table.groupby(column, value_column).reduce(
        column, value_column, cnt=red.count()
    )
    best = counted.groupby(counted[column.name]).reduce(
        counted[column.name],
        _pw_best=red.argmax(counted["cnt"]),
    )
    # argmax yields the winning ROW's id; look the value up through it
    return best.select(
        best[column.name],
        majority=counted.ix(best._pw_best, context=best)[value_column.name],
    )
