"""TableSlice: a reorderable, renamable collection of column references
(reference: internals/table_slice.py). Created by `Table.slice`; usable
anywhere select/with_columns accept columns.

>>> import pathway_tpu_torch as pw
>>> t1 = pw.debug.table_from_markdown('''
... age | owner | pet
... 10  | Alice | dog
... 9   | Bob   | dog
... ''')
>>> t1.slice.without("age").with_suffix("_col")
TableSlice({'owner_col': <table>.owner, 'pet_col': <table>.pet})
"""

from __future__ import annotations

from typing import Any, Iterable

from pathway_tpu_torch.internals.expression import ColumnReference


class TableSlice:
    _mapping: dict[str, ColumnReference]
    _table: Any

    def __init__(self, mapping: dict[str, ColumnReference], table: Any):
        self._mapping = dict(mapping)
        self._table = table

    def __iter__(self) -> Iterable[ColumnReference]:
        # renamed entries yield refs carrying their OUTPUT name, so
        # `t.select(*slice.with_suffix(...))` lands the new names even
        # though * unpacks before select sees the slice
        for name, ref in self._mapping.items():
            if ref.name != name:
                ref = ColumnReference(ref.table, ref.name)
                ref._out_name = name
            yield ref

    def __len__(self) -> int:
        return len(self._mapping)

    def __repr__(self) -> str:
        cols = ", ".join(f"{k!r}: <table>.{v.name}" for k, v in self._mapping.items())
        return "TableSlice({" + cols + "})"

    def keys(self):
        return self._mapping.keys()

    def items(self):
        return self._mapping.items()

    def _name_of(self, arg: str | ColumnReference) -> str:
        if isinstance(arg, ColumnReference):
            if arg.table is not self._table:
                raise ValueError(
                    "TableSlice expects columns of its own table"
                )
            return arg.name
        return arg

    def __getitem__(self, arg):
        if isinstance(arg, (list, tuple)):
            names = [self._name_of(a) for a in arg]
            return TableSlice(
                {n: self._mapping[n] for n in names}, self._table
            )
        return self._mapping[self._name_of(arg)]

    def __getattr__(self, name: str) -> ColumnReference:
        mapping = self.__dict__.get("_mapping")
        if mapping is not None and name in mapping:
            return mapping[name]
        raise AttributeError(name)

    def without(self, *cols: str | ColumnReference) -> "TableSlice":
        drop = {self._name_of(c) for c in cols}
        unknown = drop - set(self._mapping)
        if unknown:
            raise KeyError(f"columns {sorted(unknown)} not in the slice")
        return TableSlice(
            {k: v for k, v in self._mapping.items() if k not in drop},
            self._table,
        )

    def rename(self, mapping: dict[str | ColumnReference, str]) -> "TableSlice":
        renames = {self._name_of(k): v for k, v in mapping.items()}
        unknown = set(renames) - set(self._mapping)
        if unknown:
            raise KeyError(f"columns {sorted(unknown)} not in the slice")
        return TableSlice(
            {renames.get(k, k): v for k, v in self._mapping.items()},
            self._table,
        )

    def with_prefix(self, prefix: str) -> "TableSlice":
        return TableSlice(
            {prefix + k: v for k, v in self._mapping.items()}, self._table
        )

    def with_suffix(self, suffix: str) -> "TableSlice":
        return TableSlice(
            {k + suffix: v for k, v in self._mapping.items()}, self._table
        )

    @property
    def slice(self) -> "TableSlice":
        return self

    def ix_ref(self, *args: Any, **kwargs: Any) -> "TableSlice":
        # look up through ORIGINAL column names; keep this slice's
        # (possibly renamed) output names
        target = self._table.ix_ref(*args, **kwargs)
        return TableSlice(
            {
                name: ColumnReference(target, ref.name)
                for name, ref in self._mapping.items()
            },
            target,
        )
