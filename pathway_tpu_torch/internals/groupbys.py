"""GroupedTable.reduce (reference: internals/groupbys.py:1)."""

from __future__ import annotations

from typing import Any

from pathway_tpu_torch.internals import dtype as dt
from pathway_tpu_torch.internals import schema as sch
from pathway_tpu_torch.internals import universe as univ
from pathway_tpu_torch.internals.expression import (
    ColumnExpression,
    ColumnReference,
    IdReference,
    ReducerExpression,
    ThisMarker,
    ThisSplat,
    wrap_arg,
)
from pathway_tpu_torch.internals.expression_compiler import collect_reducers
from pathway_tpu_torch.internals.table import OpSpec, Table
from pathway_tpu_torch.internals.type_interpreter import infer_dtype


class GroupedTable:
    def __init__(
        self,
        table: Table,
        gb_exprs: list[ColumnExpression],
        instance: Any = None,
        sort_by: Any = None,
    ):
        self._table = table
        self._gb_exprs = gb_exprs
        self._instance = wrap_arg(instance) if instance is not None else None
        self._sort_by = sort_by

    def reduce(self, *args: Any, **kwargs: Any) -> Table:
        table = self._table
        exprs: dict[str, ColumnExpression] = {}
        for arg in args:
            if isinstance(arg, ThisSplat):
                # *pw.this in reduce => all groupby columns
                for e in self._gb_exprs:
                    if isinstance(e, ColumnReference):
                        exprs[e.name] = e
            elif isinstance(arg, ColumnReference):
                if isinstance(arg.table, ThisMarker):
                    arg = ColumnReference(table, arg.name)
                exprs[arg.name] = arg
            else:
                raise TypeError(f"positional reduce() args must be references: {arg!r}")
        for name, e in kwargs.items():
            exprs[name] = wrap_arg(e)

        # normalize groupby exprs (pw.this -> table)
        gb_exprs: list[ColumnExpression] = []
        for e in self._gb_exprs:
            if isinstance(e, ColumnReference) and isinstance(e.table, ThisMarker):
                e = ColumnReference(table, e.name)
            gb_exprs.append(e)
        if self._instance is not None:
            inst = self._instance
            if isinstance(inst, ColumnReference) and isinstance(inst.table, ThisMarker):
                inst = ColumnReference(table, inst.name)
            if not any(_expr_matches(inst, g) for g in gb_exprs):
                gb_exprs.append(inst)

        reducer_exprs = collect_reducers(list(exprs.values()))

        def ref_dtype(ref: ColumnReference) -> dt.DType:
            tab = ref.table
            if isinstance(tab, ThisMarker):
                tab = table
            if isinstance(ref, IdReference) or ref.name == "id":
                return dt.ANY_POINTER
            if isinstance(tab, Table):
                return tab._dtype_of(ref.name)
            raise KeyError(ref.name)

        columns = {
            name: sch.ColumnSchema(name=name, dtype=infer_dtype(e, ref_dtype))
            for name, e in exprs.items()
        }
        schema = sch.schema_from_columns(columns)
        spec = OpSpec(
            "groupby",
            [table],
            gb_exprs=gb_exprs,
            out_exprs=exprs,
            reducer_exprs=reducer_exprs,
            sort_by=self._sort_by,
        )
        return Table(spec, schema, univ.Universe())

    def windowby_param(self) -> Any:
        return None


def _expr_matches(a: ColumnExpression, b: ColumnExpression) -> bool:
    if isinstance(a, ColumnReference) and isinstance(b, ColumnReference):
        return a.table is b.table and a.name == b.name
    return a is b
