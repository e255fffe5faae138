"""Table: the declarative dataflow DSL.

Reference: python/pathway/internals/table.py (select :382, filter :490,
groupby :942, reduce :1025, deduplicate :1064, ix :1164, concat :1334,
update_cells :1439, update_rows :1524, with_columns :1613, with_id_from
:1690, rename :1763-1920, flatten :2089, sort :2157, pointer_from :2371,
difference/intersect/restrict :739-837).

A Table is (spec, schema, universe). Specs form the graph IR; nothing
computes until a run lowers the IR onto the engine
(internals/lowering.py).
"""

from __future__ import annotations

import itertools
import os
from typing import Any, Callable, Iterable, Mapping

from pathway_tpu_torch.internals import dtype as dt
from pathway_tpu_torch.internals import expression as ex
from pathway_tpu_torch.internals import schema as sch
from pathway_tpu_torch.internals import universe as univ
from pathway_tpu_torch.internals.expression import (
    ColumnExpression,
    ColumnReference,
    IdReference,
    ThisMarker,
    ThisSplat,
    wrap_arg,
)
from pathway_tpu_torch.internals.type_interpreter import infer_dtype

_spec_ids = itertools.count()


class OpSpec:
    """One node of the graph IR."""

    def __init__(self, kind: str, inputs: list["Table"], **params: Any):
        self.id = next(_spec_ids)
        self.kind = kind
        self.inputs = inputs
        self.params = params
        # user-frame trace: where in USER code this operator was created
        # (reference: internals/trace.py:140 trace_user_frame) — surfaces
        # in runtime error messages so failures point at pipeline code
        self.trace = _user_frame()

    def __repr__(self) -> str:
        return f"OpSpec#{self.id}({self.kind})"


def _user_frame() -> str | None:
    """First stack frame outside pathway_tpu_torch — the user call site."""
    import sys

    frame = sys._getframe(2) if hasattr(sys, "_getframe") else None
    try:
        while frame is not None:
            fname = frame.f_code.co_filename
            if f"pathway_tpu_torch{os.sep}" not in fname and "importlib" not in fname:
                return f"{fname}:{frame.f_lineno} in {frame.f_code.co_name}"
            frame = frame.f_back
    except Exception:  # noqa: BLE001 — tracing must never break building
        return None
    return None


class JoinMode:
    INNER = "inner"
    LEFT = "left"
    RIGHT = "right"
    OUTER = "outer"


class Table:
    """A (keyed) live table."""

    def __init__(
        self,
        spec: OpSpec,
        schema: sch.SchemaMetaclass,
        universe: univ.Universe,
        debug_name: str | None = None,
    ):
        self._spec = spec
        self._schema = schema
        self._universe = universe
        self._debug_name = debug_name
        self._id_dtype = dt.ANY_POINTER

    # ------------------------------------------------------------ columns

    @property
    def schema(self) -> sch.SchemaMetaclass:
        return self._schema

    @property
    def id(self) -> ColumnReference:
        return IdReference(self)

    def _column_names(self) -> list[str]:
        return list(self._schema.__columns__)

    def column_names(self) -> list[str]:
        return self._column_names()

    def live(self) -> Any:
        """Start a live-updating view of this table on a background run
        (reference: interactive.py LiveTable :130)."""
        from pathway_tpu_torch.internals.interactive import LiveTable

        return LiveTable(self)

    def keys(self) -> list[str]:
        return self._column_names()

    @property
    def slice(self):
        """A reorderable/renamable view of this table's columns
        (reference: table.py:468 + table_slice.py).

        Example:

        >>> import pathway_tpu_torch as pw
        >>> t = pw.debug.table_from_markdown('''
        ... age | owner
        ... 10  | Alice
        ... ''')
        >>> pw.debug.compute_and_print(
        ...     t.select(*t.slice.without("age").with_suffix("_x")),
        ...     include_id=False)
        owner_x
        Alice
        """
        from pathway_tpu_torch.internals.table_slice import TableSlice

        return TableSlice(
            {n: ColumnReference(self, n) for n in self._column_names()}, self
        )

    @staticmethod
    def from_columns(*args: ColumnReference, **kwargs: ColumnReference) -> "Table":
        """Build a table from same-universe columns, positionally (keeping
        their names) or renamed via kwargs (reference: table.py:265)."""
        cols: dict[str, ColumnReference] = {}
        for a in args:
            if not isinstance(a, ColumnReference):
                raise TypeError("from_columns takes column references")
            cols[a.name] = a
        for name, a in kwargs.items():
            if not isinstance(a, ColumnReference):
                raise TypeError("from_columns takes column references")
            cols[name] = a
        if not cols:
            raise ValueError("from_columns needs at least one column")
        first = next(iter(cols.values()))
        base = first.table
        if not isinstance(base, Table):
            raise TypeError("from_columns needs concrete table columns")
        solver = univ.get_solver()
        for ref in cols.values():
            tab = ref.table
            if not isinstance(tab, Table):
                raise TypeError("from_columns needs concrete table columns")
            if tab._universe is not base._universe and not solver.are_equal(
                tab._universe, base._universe
            ):
                raise ValueError(
                    "from_columns requires all columns to share one "
                    "universe (same row id set); got columns from "
                    "unrelated tables"
                )
        return base.select(**cols)

    # ------------------------------------------------ type-level updates

    def update_types(self, **kwargs: Any) -> "Table":
        """Overrides column dtypes in the schema; no runtime effect
        (reference: table.py:1980). Other column properties (primary key,
        defaults, append-only) are preserved."""
        for name in kwargs:
            if name not in self._schema.__columns__:
                raise ValueError(
                    "Table.update_types() argument name has to be an "
                    f"existing table column name; got {name!r}"
                )
        schema = self._schema.with_types(**kwargs)
        return Table(
            OpSpec("rowwise", [self], exprs={
                n: ColumnReference(self, n) for n in schema.__columns__
            }),
            schema,
            self._universe,
        )

    def update_id_type(self, id_type: Any, *, id_append_only: bool | None = None) -> "Table":
        """Declares the id column's pointer type; observable through
        eval_type(table.id). `id_append_only` is accepted for signature
        parity and recorded, but append-only ids carry no engine-level
        meaning here."""
        out = self.copy()
        out._id_dtype = dt.wrap(id_type)
        out._id_append_only = id_append_only
        return out

    def cast_to_types(self, **kwargs: Any) -> "Table":
        """Casts columns to the given types AT RUNTIME (reference:
        table.py:2011)."""
        from pathway_tpu_torch.internals.common import cast

        for name in kwargs:
            if name not in self._schema.__columns__:
                raise ValueError(
                    "Table.cast_to_types() argument name has to be an "
                    f"existing table column name; got {name!r}"
                )
        return self.with_columns(
            **{k: cast(v, self[k]) for k, v in kwargs.items()}
        )

    def typehints(self) -> Mapping[str, Any]:
        """Column name -> Python type hint (reference: table.py:2530)."""
        return {
            n: c.dtype.typehint() for n, c in self._schema.__columns__.items()
        }

    def eval_type(self, expression: Any) -> Any:
        """The Python type hint an expression would have on this table."""
        e = wrap_arg(expression)

        def ref_dtype(ref: ColumnReference) -> dt.DType:
            tab = ref.table
            if isinstance(tab, _TableAsMarker):
                tab = tab.table  # splat marker wraps a concrete table
            elif isinstance(tab, ThisMarker):
                tab = self
            if isinstance(ref, IdReference) or ref.name == "id":
                return getattr(tab, "_id_dtype", dt.ANY_POINTER)
            return tab._dtype_of(ref.name)

        return infer_dtype(e, ref_dtype).typehint()

    def __getattr__(self, name: str) -> ColumnReference:
        if name.startswith("__"):
            raise AttributeError(name)
        schema = self.__dict__.get("_schema")
        if schema is not None and name in schema.__columns__:
            return ColumnReference(self, name)
        raise AttributeError(
            f"table has no column {name!r}; columns: "
            f"{list(schema.__columns__) if schema is not None else []}"
        )

    def __getitem__(self, arg: Any) -> Any:
        if isinstance(arg, (list, tuple)):
            return [self[a] for a in arg]
        if isinstance(arg, ColumnReference):
            arg = arg.name
        if arg == "id":
            return IdReference(self)
        if arg not in self._schema.__columns__:
            raise KeyError(f"no column {arg!r} in {self._column_names()}")
        return ColumnReference(self, arg)

    def __iter__(self):
        yield ThisSplat(_TableAsMarker(self))

    def __repr__(self) -> str:
        cols = ", ".join(
            f"{n}: {c.dtype!r}" for n, c in self._schema.__columns__.items()
        )
        return f"<pw.Table ({cols})>"

    def _dtype_of(self, name: str) -> dt.DType:
        return self._schema.__columns__[name].dtype

    # --------------------------------------------------------- expression glue

    def _resolve_exprs(
        self, args: tuple, kwargs: Mapping[str, Any], allow_id: bool = True
    ) -> dict[str, ColumnExpression]:
        """Expand *args / **kwargs of select into an ordered name->expr map."""
        from pathway_tpu_torch.internals.table_slice import TableSlice

        out: dict[str, ColumnExpression] = {}
        for arg in args:
            if isinstance(arg, TableSlice):
                out.update(arg.items())  # slice names override ref names
            elif isinstance(arg, ThisSplat):
                target = arg.marker
                table = target if isinstance(target, Table) else self
                if isinstance(target, _TableAsMarker):
                    table = target.table
                for name in table._column_names():
                    if name not in arg.excluded:
                        out[name] = ColumnReference(table, name)
            elif isinstance(arg, ColumnReference):
                # _out_name: rename carried by a TableSlice entry
                out[getattr(arg, "_out_name", arg.name)] = arg
            elif isinstance(arg, str):
                out[arg] = ColumnReference(self, arg)
            else:
                raise TypeError(
                    f"positional select() arguments must be column references, got {arg!r}"
                )
        for name, expr in kwargs.items():
            if isinstance(expr, ThisMarker):
                raise TypeError("cannot use pw.this as a column value")
            out[name] = wrap_arg(expr)
        return out

    def _infer_schema(
        self, exprs: Mapping[str, ColumnExpression], extra_tables: Iterable["Table"] = ()
    ) -> sch.SchemaMetaclass:
        tables = [self, *extra_tables]

        def ref_dtype(ref: ColumnReference) -> dt.DType:
            tab = ref.table
            if isinstance(tab, ThisMarker):
                tab = self
            if isinstance(tab, _TableAsMarker):
                tab = tab.table
            if isinstance(ref, IdReference) or ref.name == "id":
                return dt.ANY_POINTER
            if isinstance(tab, Table):
                return tab._dtype_of(ref.name)
            raise KeyError(ref.name)

        columns = {
            name: sch.ColumnSchema(name=name, dtype=infer_dtype(e, ref_dtype))
            for name, e in exprs.items()
        }
        return sch.schema_from_columns(columns)

    # ------------------------------------------------------------- core ops

    def select(self, *args: Any, **kwargs: Any) -> "Table":
        """Project and compute columns, keeping the table's keys.

        Example:

        >>> import pathway_tpu_torch as pw
        >>> t = pw.debug.table_from_markdown('''
        ... owner | pet | age
        ... Alice | dog | 10
        ... Bob   | cat | 9
        ... Alice | cat | 8
        ... ''')
        >>> pw.debug.compute_and_print(
        ...     t.select(t.owner, double=t.age * 2), include_id=False)
        owner | double
        Bob   | 18
        Alice | 16
        Alice | 20
        """
        exprs = self._resolve_exprs(args, kwargs)
        schema = self._infer_schema(exprs)
        spec = OpSpec("rowwise", [self], exprs=exprs)
        return Table(spec, schema, self._universe)

    def __add__(self, other: "Table") -> "Table":
        """Column concatenation of same-universe tables (t1 + t2)."""
        if not isinstance(other, Table):
            return NotImplemented
        exprs = {n: ColumnReference(self, n) for n in self._column_names()}
        for n in other._column_names():
            exprs[n] = ColumnReference(other, n)
        schema = self._infer_schema(exprs, [other])
        return Table(OpSpec("rowwise", [self], exprs=exprs), schema, self._universe)

    def with_columns(self, *args: Any, **kwargs: Any) -> "Table":
        """All existing columns plus the given ones (overriding by name).

        Example:

        >>> import pathway_tpu_torch as pw
        >>> t = pw.debug.table_from_markdown(\'\'\'
        ... owner | age
        ... Alice | 10
        ... Bob   | 9
        ... \'\'\')
        >>> pw.debug.compute_and_print(
        ...     t.with_columns(senior=t.age >= 10), include_id=False)
        owner | age | senior
        Bob   | 9   | False
        Alice | 10  | True
        """
        base = {n: ColumnReference(self, n) for n in self._column_names()}
        new = self._resolve_exprs(args, kwargs)
        base.update(new)
        schema = self._infer_schema(base)
        return Table(OpSpec("rowwise", [self], exprs=base), schema, self._universe)

    def without(self, *columns: Any) -> "Table":
        drop = {c.name if isinstance(c, ColumnReference) else c for c in columns}
        exprs = {
            n: ColumnReference(self, n) for n in self._column_names() if n not in drop
        }
        schema = self._infer_schema(exprs)
        return Table(OpSpec("rowwise", [self], exprs=exprs), schema, self._universe)

    def rename_columns(self, **kwargs: Any) -> "Table":
        # new_name=old_ref
        mapping = {
            new: (old.name if isinstance(old, ColumnReference) else old)
            for new, old in kwargs.items()
        }
        renamed_from = set(mapping.values())
        exprs: dict[str, ColumnExpression] = {}
        for n in self._column_names():
            if n not in renamed_from:
                exprs[n] = ColumnReference(self, n)
        for new, old in mapping.items():
            exprs[new] = ColumnReference(self, old)
        schema = self._infer_schema(exprs)
        return Table(OpSpec("rowwise", [self], exprs=exprs), schema, self._universe)

    def rename_by_dict(self, names_mapping: Mapping[Any, str]) -> "Table":
        mapping = {
            (old.name if isinstance(old, ColumnReference) else old): new
            for old, new in names_mapping.items()
        }
        exprs: dict[str, ColumnExpression] = {}
        for n in self._column_names():
            exprs[mapping.get(n, n)] = ColumnReference(self, n)
        schema = self._infer_schema(exprs)
        return Table(OpSpec("rowwise", [self], exprs=exprs), schema, self._universe)

    def rename(self, names_mapping: Mapping[Any, str] | None = None, **kwargs: Any) -> "Table":
        if names_mapping is not None:
            return self.rename_by_dict(names_mapping)
        return self.rename_columns(**kwargs)

    def with_prefix(self, prefix: str) -> "Table":
        return self.rename_by_dict({n: prefix + n for n in self._column_names()})

    def with_suffix(self, suffix: str) -> "Table":
        return self.rename_by_dict({n: n + suffix for n in self._column_names()})

    def filter(self, filter_expression: ColumnExpression) -> "Table":
        """Keep the rows where the expression holds.

        Example:

        >>> import pathway_tpu_torch as pw
        >>> t = pw.debug.table_from_markdown(\'\'\'
        ... owner | age
        ... Alice | 10
        ... Bob   | 9
        ... Carol | 8
        ... \'\'\')
        >>> pw.debug.compute_and_print(t.filter(t.age >= 9), include_id=False)
        owner | age
        Bob   | 9
        Alice | 10
        """
        spec = OpSpec("filter", [self], cond=wrap_arg(filter_expression))
        out_universe = univ.Universe()
        univ.register_subset(out_universe, self._universe)
        return Table(spec, self._schema, out_universe)

    def split(self, split_expression: ColumnExpression) -> tuple["Table", "Table"]:
        pos = self.filter(split_expression)
        neg = self.filter(~wrap_arg(split_expression))
        return pos, neg

    def copy(self) -> "Table":
        return self.select(*self)

    # ------------------------------------------------------------ groupby

    def groupby(
        self,
        *args: Any,
        id: Any = None,  # noqa: A002
        instance: Any = None,
        sort_by: Any = None,
        _skip_errors: bool = True,
    ) -> "GroupedTable":
        """Group rows by the given expressions; reduce() aggregates.

        Example:

        >>> import pathway_tpu_torch as pw
        >>> t = pw.debug.table_from_markdown(\'\'\'
        ... owner | age
        ... Alice | 10
        ... Bob   | 9
        ... Alice | 8
        ... \'\'\')
        >>> pw.debug.compute_and_print(
        ...     t.groupby(t.owner).reduce(
        ...         t.owner,
        ...         pets=pw.reducers.count(),
        ...         oldest=pw.reducers.max(t.age)),
        ...     include_id=False)
        owner | pets | oldest
        Bob   | 1    | 9
        Alice | 2    | 10
        """
        from pathway_tpu_torch.internals.groupbys import GroupedTable

        gb_exprs: list[ColumnExpression] = []
        if id is not None:
            gb_exprs = [IdReference(self) if not isinstance(id, ColumnExpression) else id]
        else:
            for a in args:
                if isinstance(a, ColumnReference) and isinstance(a.table, ThisMarker):
                    a = ColumnReference(self, a.name)
                gb_exprs.append(wrap_arg(a))
        return GroupedTable(self, gb_exprs, instance=instance, sort_by=sort_by)

    def reduce(self, *args: Any, **kwargs: Any) -> "Table":
        return self.groupby().reduce(*args, **kwargs)

    def deduplicate(
        self,
        *,
        value: Any = None,
        instance: Any = None,
        acceptor: Callable[[Any, Any], bool] | None = None,
        persistent_id: str | None = None,
        name: str | None = None,
    ) -> "Table":
        """Keep one accepted row per instance; acceptor(new, old) decides
        whether a new candidate replaces the held one.

        Example:

        >>> import pathway_tpu_torch as pw
        >>> t = pw.debug.table_from_markdown(\'\'\'
        ... ticker | px
        ... AA     | 10
        ... AA     | 12
        ... BB     | 7
        ... \'\'\')
        >>> pw.debug.compute_and_print(
        ...     t.deduplicate(value=t.px, instance=t.ticker,
        ...                   acceptor=lambda new, old: new > old),
        ...     include_id=False)
        ticker | px
        AA     | 12
        BB     | 7
        """
        value_e = wrap_arg(value) if value is not None else IdReference(self)
        instance_e = wrap_arg(instance) if instance is not None else None
        # acceptor=None means keep-latest (always accept); the engine keeps
        # it as None so the token plane can fold whole waves vectorized
        # instead of calling a trivially-true Python acceptor per row
        spec = OpSpec(
            "deduplicate", [self], value=value_e, instance=instance_e, acceptor=acceptor
        )
        return Table(spec, self._schema, univ.Universe())

    # ------------------------------------------------------------- joins

    def join(
        self, other: "Table", *on: Any, id: Any = None, how: str = JoinMode.INNER,
        left_instance: Any = None, right_instance: Any = None,
    ) -> "JoinResult":
        """Equi-join on the given conditions; how: inner/left/right/outer.

        Example:

        >>> import pathway_tpu_torch as pw
        >>> people = pw.debug.table_from_markdown(\'\'\'
        ... name  | city
        ... Alice | Paris
        ... Bob   | Lyon
        ... \'\'\')
        >>> cities = pw.debug.table_from_markdown(\'\'\'
        ... city  | country
        ... Paris | France
        ... \'\'\')
        >>> pw.debug.compute_and_print(
        ...     people.join(cities, people.city == cities.city)
        ...           .select(people.name, cities.country),
        ...     include_id=False)
        name  | country
        Alice | France
        """
        from pathway_tpu_torch.internals.joins import JoinResult

        if (left_instance is None) != (right_instance is None):
            raise ValueError("left_instance and right_instance must be given together")
        if left_instance is not None:
            # instance co-location is an extra equality condition
            on = (*on, wrap_arg(left_instance) == wrap_arg(right_instance))
        return JoinResult(self, other, on, how, id)

    def join_inner(self, other: "Table", *on: Any, id: Any = None, **kw: Any) -> "JoinResult":
        return self.join(other, *on, id=id, how=JoinMode.INNER, **kw)

    def join_left(self, other: "Table", *on: Any, id: Any = None, **kw: Any) -> "JoinResult":
        return self.join(other, *on, id=id, how=JoinMode.LEFT, **kw)

    def join_right(self, other: "Table", *on: Any, id: Any = None, **kw: Any) -> "JoinResult":
        return self.join(other, *on, id=id, how=JoinMode.RIGHT, **kw)

    def join_outer(self, other: "Table", *on: Any, id: Any = None, **kw: Any) -> "JoinResult":
        return self.join(other, *on, id=id, how=JoinMode.OUTER, **kw)

    # -------------------------------------------------------- set/universe ops

    def concat(self, *others: "Table") -> "Table":
        """Union of DISJOINT tables (reference semantics): the key sets
        must be PROVABLY disjoint — difference results, or tables covered
        by pw.universes.promise_are_pairwise_disjoint — otherwise this
        raises at build time (overlapping keys would silently collapse).
        Use concat_reindex for arbitrary tables."""
        tables = [self, *[_align_columns(self, o) for o in others]]
        schema = _common_schema(tables)
        solver = univ.get_solver()
        for i, a in enumerate(tables):
            for b in tables[i + 1 :]:
                if not solver.are_disjoint(a._universe, b._universe):
                    raise ValueError(
                        "concat: cannot prove the tables' key sets are "
                        "disjoint; promise it with pw.universes."
                        "promise_are_pairwise_disjoint(...) or use "
                        "concat_reindex"
                    )
        spec = OpSpec("concat", tables, reindex=False)
        out = Table(spec, schema, univ.Universe())
        solver.register_as_union(
            out._universe, *[t._universe for t in tables]
        )
        return out

    def concat_reindex(self, *others: "Table") -> "Table":
        tables = [self, *[_align_columns(self, o) for o in others]]
        schema = _common_schema(tables)
        spec = OpSpec("concat", tables, reindex=True)
        return Table(spec, schema, univ.Universe())

    def update_rows(self, other: "Table") -> "Table":
        other = _align_columns(self, other)
        schema = _common_schema([self, other])
        spec = OpSpec("update_rows", [self, other])
        return Table(spec, schema, univ.Universe())

    def __lshift__(self, other: "Table") -> "Table":
        return self.update_cells(other)

    def update_cells(self, other: "Table") -> "Table":
        col_map: list[int | None] = []
        other_names = other._column_names()
        for i, n in enumerate(self._column_names()):
            col_map.append(other_names.index(n) if n in other_names else None)
        spec = OpSpec("update_cells", [self, other], col_map=col_map)
        return Table(spec, self._schema, self._universe)

    def intersect(self, *tables: "Table") -> "Table":
        spec = OpSpec("setop", [self, *tables], mode="intersect")
        out_universe = univ.Universe()
        univ.get_solver().register_as_intersection(
            out_universe, self._universe, *[t._universe for t in tables]
        )
        return Table(spec, self._schema, out_universe)

    def difference(self, other: "Table") -> "Table":
        spec = OpSpec("setop", [self, other], mode="difference")
        out_universe = univ.Universe()
        # result ⊆ self and provably disjoint from `other` — a later
        # concat with `other` is statically safe
        univ.get_solver().register_as_difference(
            out_universe, self._universe, other._universe
        )
        return Table(spec, self._schema, out_universe)

    def restrict(self, other: "Table") -> "Table":
        spec = OpSpec("setop", [self, other], mode="restrict")
        return Table(spec, self._schema, other._universe)

    def having(self, *indexers: ColumnReference) -> "Table":
        # keep rows whose id appears in every indexer expression's table keys
        spec = OpSpec("having", [self], indexers=list(indexers))
        out_universe = univ.Universe()
        univ.register_subset(out_universe, self._universe)
        return Table(spec, self._schema, out_universe)

    def with_universe_of(self, other: "Table") -> "Table":
        spec = OpSpec("with_universe_of", [self, other])
        return Table(spec, self._schema, other._universe)

    def _gradual_broadcast(
        self,
        threshold_table: "Table",
        lower: Any,
        value: Any,
        upper: Any,
    ) -> "Table":
        """Broadcast `value` from the (small) threshold table onto every
        row of this table as column `apx_value`, with hysteresis: the
        broadcast re-emits only when the new value leaves the
        [lower, upper] band of the currently-held one (reference:
        table.py _gradual_broadcast over operators/gradual_broadcast.rs —
        the louvain total-weight plumbing). Returns this table's columns
        plus `apx_value`."""
        spec = OpSpec(
            "gradual_broadcast",
            [self, threshold_table],
            lower=wrap_arg(lower),
            value=wrap_arg(value),
            upper=wrap_arg(upper),
        )
        columns = {
            "apx_value": sch.ColumnSchema(name="apx_value", dtype=dt.FLOAT)
        }
        bc = Table(
            spec, sch.schema_from_columns(columns), self._universe
        )
        return self + bc

    # ---------------------------------------------------------- reindexing

    def reindex(self, new_id: ColumnExpression) -> "Table":
        spec = OpSpec("reindex", [self], key_expr=wrap_arg(new_id))
        return Table(spec, self._schema, univ.Universe())

    def with_id(self, new_id: ColumnExpression) -> "Table":
        return self.reindex(new_id)

    def with_id_from(self, *args: Any, instance: Any = None) -> "Table":
        exprs = [wrap_arg(a) for a in args]
        spec = OpSpec(
            "reindex",
            [self],
            key_expr=ex.PointerExpression(self, *exprs, instance=instance),
        )
        return Table(spec, self._schema, univ.Universe())

    def pointer_from(self, *args: Any, optional: bool = False, instance: Any = None) -> ColumnExpression:
        return ex.PointerExpression(self, *args, optional=optional, instance=instance)

    def ix_ref(self, *args: Any, optional: bool = False, context: Any = None, instance: Any = None) -> "Table":
        return self.ix(
            ex.PointerExpression(self, *args, optional=optional, instance=instance),
            optional=optional,
            context=context,
        )

    def ix(self, expression: ColumnExpression, *, optional: bool = False, context: Any = None) -> "Table":
        from pathway_tpu_torch.internals.expression_compiler import referenced_tables

        if context is None:
            refs = referenced_tables([expression])
            refs = [t for t in refs if isinstance(t, Table)]
            if not refs and isinstance(expression, ex.PointerExpression):
                # constant-argument pointer_from carries no column refs;
                # its origin table IS the lookup context (without this,
                # context fell back to the TARGET table and the lookup
                # silently produced the wrong universe)
                origin = expression._table
                if isinstance(origin, Table):
                    refs = [origin]
            context_table = refs[0] if refs else self
        elif isinstance(context, Table):
            context_table = context
        else:
            context_table = self
        spec = OpSpec(
            "ix", [context_table, self], pointer=wrap_arg(expression), optional=optional
        )
        schema = self._schema
        if optional:
            columns = {
                n: sch.ColumnSchema(name=n, dtype=dt.Optional(c.dtype))
                for n, c in schema.__columns__.items()
            }
            schema = sch.schema_from_columns(columns)
        return Table(spec, schema, context_table._universe)

    # ----------------------------------------------------------- reshaping

    def flatten(self, *to_flatten: ColumnReference, origin_id: str | None = None) -> "Table":
        if len(to_flatten) != 1:
            raise NotImplementedError("flatten exactly one column")
        ref = to_flatten[0]
        if isinstance(ref.table, ThisMarker):
            ref = ColumnReference(self, ref.name)
        if origin_id is not None:
            # append the source row's id as a column, then flatten the
            # widened table (each flattened row carries its origin)
            widened = self.select(
                *[ColumnReference(self, n) for n in self._column_names()],
                **{origin_id: IdReference(self)},
            )
            return widened.flatten(widened[ref.name])
        inner = self._dtype_of(ref.name)
        if isinstance(inner, dt.List):
            flat_dt: dt.DType = inner.wrapped
        elif isinstance(inner, dt.Tuple):
            flat_dt = dt.ANY
            if inner.args:
                flat_dt = inner.args[0]
                for a in inner.args[1:]:
                    flat_dt = dt.types_lca(flat_dt, a)
        elif inner == dt.STR:
            flat_dt = dt.STR
        elif isinstance(inner, dt.Array):
            flat_dt = dt.Array(None, inner.wrapped) if (inner.dim or 2) > 1 else dt.wrap(inner.wrapped)
        else:
            flat_dt = dt.ANY
        columns = dict(self._schema.__columns__)
        columns[ref.name] = sch.ColumnSchema(name=ref.name, dtype=flat_dt)
        schema = sch.schema_from_columns(columns)
        spec = OpSpec("flatten", [self], column=ref.name)
        return Table(spec, schema, univ.Universe())

    def sort(self, key: ColumnExpression, instance: Any = None) -> "Table":
        key_e = wrap_arg(key)
        instance_e = wrap_arg(instance) if instance is not None else None
        spec = OpSpec("sort", [self], key=key_e, instance=instance_e)
        columns = {
            "prev": sch.ColumnSchema(name="prev", dtype=dt.Optional(dt.ANY_POINTER)),
            "next": sch.ColumnSchema(name="next", dtype=dt.Optional(dt.ANY_POINTER)),
        }
        return Table(spec, sch.schema_from_columns(columns), self._universe)

    # ------------------------------------------------------------ temporal

    def windowby(self, time_expr: Any, *, window: Any, instance: Any = None,
                 behavior: Any = None, **kwargs: Any) -> Any:
        """Assign rows to time windows; reduce() aggregates per window.

        Example:

        >>> import pathway_tpu_torch as pw
        >>> events = pw.debug.table_from_markdown('''
        ... t  | v
        ... 1  | 10
        ... 3  | 20
        ... 12 | 30
        ... ''')
        >>> pw.debug.compute_and_print(
        ...     events.windowby(
        ...         events.t, window=pw.temporal.tumbling(duration=10)
        ...     ).reduce(
        ...         start=pw.this._pw_window_start,
        ...         total=pw.reducers.sum(pw.this.v)),
        ...     include_id=False)
        start | total
        0     | 30
        10    | 30
        """
        from pathway_tpu_torch.stdlib.temporal import windowby as _windowby

        return _windowby(self, time_expr, window=window, instance=instance,
                         behavior=behavior, **kwargs)

    def inactivity_detection(self, *args: Any, **kwargs: Any) -> Any:
        from pathway_tpu_torch.stdlib.temporal import inactivity_detection as _f

        return _f(self, *args, **kwargs)

    def asof_join(self, other: "Table", *args: Any, **kwargs: Any) -> Any:
        from pathway_tpu_torch.stdlib.temporal import asof_join as _f

        return _f(self, other, *args, **kwargs)

    def asof_now_join(self, other: "Table", *args: Any, **kwargs: Any) -> Any:
        from pathway_tpu_torch.stdlib.temporal import asof_now_join as _f

        return _f(self, other, *args, **kwargs)

    def interval_join(self, other: "Table", *args: Any, **kwargs: Any) -> Any:
        from pathway_tpu_torch.stdlib.temporal import interval_join as _f

        return _f(self, other, *args, **kwargs)

    def window_join(self, other: "Table", *args: Any, **kwargs: Any) -> Any:
        from pathway_tpu_torch.stdlib.temporal import window_join as _f

        return _f(self, other, *args, **kwargs)

    def diff(self, timestamp: ColumnExpression, *values: ColumnReference) -> "Table":
        from pathway_tpu_torch.stdlib.ordered import diff as _diff

        return _diff(self, timestamp, *values)

    # --------------------------------------------------------- raw engine ops

    def _buffer(self, threshold: ColumnExpression, current: ColumnExpression) -> "Table":
        spec = OpSpec("buffer", [self], threshold=wrap_arg(threshold), current=wrap_arg(current))
        return Table(spec, self._schema, univ.Universe())

    def _forget(
        self, threshold: ColumnExpression, current: ColumnExpression,
        mark_forgetting_records: bool = False,
    ) -> "Table":
        spec = OpSpec("forget", [self], threshold=wrap_arg(threshold), current=wrap_arg(current))
        return Table(spec, self._schema, univ.Universe())

    def _freeze(self, threshold: ColumnExpression, current: ColumnExpression) -> "Table":
        spec = OpSpec("freeze", [self], threshold=wrap_arg(threshold), current=wrap_arg(current))
        return Table(spec, self._schema, univ.Universe())

    # ------------------------------------------------------------ errors

    def remove_errors(self) -> "Table":
        from pathway_tpu_torch.internals.errors import ErrorValue

        cond = ex.ApplyExpression(
            lambda *vals: not any(isinstance(v, ErrorValue) for v in vals),
            bool,
            *[ColumnReference(self, n) for n in self._column_names()],
        )
        return self.filter(cond)

    def await_futures(self) -> "Table":
        return self

    # ------------------------------------------------------------- output

    def to(self, sink: Any) -> None:
        from pathway_tpu_torch.internals.datasink import DataSink

        if isinstance(sink, DataSink):
            sink.consume(self)
        else:
            raise TypeError(f"cannot output to {sink!r}")

    def debug(self, name: str) -> "Table":
        self._debug_name = name
        return self

    # ------------------------------------------------------------ helpers

    @staticmethod
    def empty(**kwargs: Any) -> "Table":
        schema = sch.schema_from_types(**kwargs)
        spec = OpSpec("static", [], rows=[])
        return Table(spec, schema, univ.Universe())

    @staticmethod
    def from_rows(
        schema: sch.SchemaMetaclass, rows: list[tuple[Any, ...]] | None = None,
        keys: list[Any] | None = None, times: list[int] | None = None,
        diffs: list[int] | None = None,
    ) -> "Table":
        from pathway_tpu_torch.internals.keys import Key, key_for_values, sequential_key

        names = list(schema.__columns__)
        pk_cols = schema.primary_key_columns()
        data = []
        rows = rows or []
        for i, row in enumerate(rows):
            row = tuple(row)
            if keys is not None:
                key = keys[i] if isinstance(keys[i], Key) else key_for_values(keys[i])
            elif pk_cols:
                pk_vals = [row[names.index(c)] for c in pk_cols]
                key = key_for_values(*pk_vals)
            else:
                key = sequential_key()
            t = times[i] if times is not None else 0
            d = diffs[i] if diffs is not None else 1
            data.append((t, key, row, d))
        spec = OpSpec("static", [], rows=data)
        return Table(spec, schema, univ.Universe())


class _TableAsMarker(ThisMarker):
    """Adapter letting `*table` expand in select()."""

    def __init__(self, table: Table):
        super().__init__("this")
        object.__setattr__(self, "table", table)


def _align_columns(reference_table: Table, other: Table) -> Table:
    """Reorder `other`'s columns to match `reference_table` — concat /
    update_rows combine row tuples positionally."""
    ref_names = reference_table._column_names()
    if other._column_names() == ref_names:
        return other
    if set(other._column_names()) != set(ref_names):
        raise ValueError(
            f"column mismatch: {ref_names} vs {other._column_names()}"
        )
    return other.select(**{n: ColumnReference(other, n) for n in ref_names})


def _common_schema(tables: list[Table]) -> sch.SchemaMetaclass:
    names = tables[0]._column_names()
    for t in tables[1:]:
        if t._column_names() != names:
            if set(t._column_names()) != set(names):
                raise ValueError(
                    f"column mismatch in concat/update: {names} vs {t._column_names()}"
                )
    columns = {}
    for n in names:
        dtypes = [t._dtype_of(n) for t in tables]
        out = dtypes[0]
        for d in dtypes[1:]:
            out = dt.types_lca(out, d)
        columns[n] = sch.ColumnSchema(name=n, dtype=out)
    return sch.schema_from_columns(columns)
