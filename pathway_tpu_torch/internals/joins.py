"""Join DSL: JoinResult with select/reduce/filter
(reference: internals/joins.py:1, JoinResult)."""

from __future__ import annotations

from typing import Any, Mapping

from pathway_tpu_torch.internals import dtype as dt
from pathway_tpu_torch.internals import schema as sch
from pathway_tpu_torch.internals import universe as univ
from pathway_tpu_torch.internals.expression import (
    BinaryOpExpression,
    ColumnExpression,
    ColumnReference,
    IdReference,
    ThisMarker,
    ThisSplat,
    wrap_arg,
)
from pathway_tpu_torch.internals.table import JoinMode, OpSpec, Table
from pathway_tpu_torch.internals.type_interpreter import infer_dtype


class JoinResult:
    """Deferred join: holds both sides + equi-join conditions; `select` or
    `reduce` produce a Table."""

    def __init__(
        self,
        left: Table,
        right: Table,
        on: tuple,
        mode: str = JoinMode.INNER,
        id: Any = None,  # noqa: A002
    ):
        self._left = left
        self._right = right
        self._mode = mode
        self._id = id
        self._on: list[tuple[ColumnExpression, ColumnExpression]] = []
        for cond in on:
            lexpr, rexpr = self._split_condition(cond)
            self._on.append((lexpr, rexpr))

    def _split_condition(self, cond: Any) -> tuple[ColumnExpression, ColumnExpression]:
        if not isinstance(cond, BinaryOpExpression) or cond._op != "==":
            raise TypeError(f"join condition must be `lhs == rhs`, got {cond!r}")
        lexpr, rexpr = cond._left, cond._right
        lexpr = self._bind(lexpr)
        rexpr = self._bind(rexpr)
        l_side = self._side_of(lexpr)
        r_side = self._side_of(rexpr)
        if l_side == "right" or r_side == "left":
            lexpr, rexpr = rexpr, lexpr
        return lexpr, rexpr

    def _bind(self, e: ColumnExpression) -> ColumnExpression:
        """Resolve pw.left/pw.right markers to the actual tables."""
        if isinstance(e, ColumnReference) and isinstance(e.table, ThisMarker):
            side = e.table._side
            table = self._left if side in ("this", "left") else self._right
            if isinstance(e, IdReference):
                return IdReference(table)
            return ColumnReference(table, e.name)
        return e

    def _side_of(self, e: ColumnExpression) -> str:
        for ref in e._column_references():
            tab = ref.table
            if tab is self._left:
                return "left"
            if tab is self._right:
                return "right"
            if isinstance(tab, ThisMarker):
                if tab._side == "right":
                    return "right"
                return "left"
        return "left"

    def _id_mode(self) -> str:
        if self._id is None:
            return "hash"
        if isinstance(self._id, ColumnReference):
            tab = self._id.table
            if isinstance(tab, ThisMarker):
                return "left" if tab._side in ("left", "this") else "right"
            if tab is self._left:
                return "left"
            if tab is self._right:
                return "right"
        return "hash"

    def _resolve_select(
        self, args: tuple, kwargs: Mapping[str, Any]
    ) -> dict[str, ColumnExpression]:
        out: dict[str, ColumnExpression] = {}

        def bind_deep(e: ColumnExpression) -> ColumnExpression:
            # rebuild refs bound to left/right; other nodes traversed in place
            if isinstance(e, ColumnReference):
                return self._bind_select_ref(e)
            for name in vars(e):
                val = getattr(e, name)
                if isinstance(val, ColumnExpression):
                    setattr(e, name, bind_deep(val))
                elif isinstance(val, tuple) and any(
                    isinstance(v, ColumnExpression) for v in val
                ):
                    setattr(e, name, tuple(
                        bind_deep(v) if isinstance(v, ColumnExpression) else v for v in val
                    ))
                elif isinstance(val, dict) and any(
                    isinstance(v, ColumnExpression) for v in val.values()
                ):
                    setattr(e, name, {
                        k: bind_deep(v) if isinstance(v, ColumnExpression) else v
                        for k, v in val.items()
                    })
            return e

        for arg in args:
            if isinstance(arg, ThisSplat):
                side = arg.marker._side
                if side in ("this", "left"):
                    for n in self._left._column_names():
                        if n not in arg.excluded:
                            out[n] = ColumnReference(self._left, n)
                if side in ("this", "right"):
                    for n in self._right._column_names():
                        if n not in arg.excluded and n not in out:
                            out[n] = ColumnReference(self._right, n)
            elif isinstance(arg, ColumnReference):
                out[arg.name] = self._bind_select_ref(arg)
            else:
                raise TypeError(f"bad positional select arg: {arg!r}")
        for name, e in kwargs.items():
            out[name] = bind_deep(wrap_arg(e))
        return out

    def _bind_select_ref(self, ref: ColumnReference) -> ColumnReference:
        tab = ref.table
        if isinstance(tab, ThisMarker):
            side = tab._side
            if side == "right":
                table = self._right
            elif side == "left":
                table = self._left
            else:  # pw.this: search left then right
                if isinstance(ref, IdReference):
                    return _JoinIdRef(self)
                if ref.name in self._left._column_names():
                    table = self._left
                elif ref.name in self._right._column_names():
                    table = self._right
                else:
                    raise KeyError(f"column {ref.name!r} in neither join side")
            if isinstance(ref, IdReference):
                return IdReference(table)
            return ColumnReference(table, ref.name)
        return ref

    def select(self, *args: Any, **kwargs: Any) -> Table:
        exprs = self._resolve_select(args, kwargs)

        def ref_dtype(ref: ColumnReference) -> dt.DType:
            tab = ref.table
            if isinstance(ref, (IdReference, _JoinIdRef)) or ref.name == "id":
                return dt.ANY_POINTER
            if isinstance(tab, Table):
                base = tab._dtype_of(ref.name)
                if (self._mode in ("left", "outer") and tab is self._right) or (
                    self._mode in ("right", "outer") and tab is self._left
                ):
                    return dt.Optional(base)
                return base
            raise KeyError(ref.name)

        columns = {
            n: sch.ColumnSchema(name=n, dtype=infer_dtype(e, ref_dtype))
            for n, e in exprs.items()
        }
        schema = sch.schema_from_columns(columns)
        spec = OpSpec(
            "join",
            [self._left, self._right],
            on=self._on,
            mode=self._mode,
            id_mode=self._id_mode(),
            exprs=exprs,
        )
        out_universe = (
            self._left._universe if self._id_mode() == "left"
            else self._right._universe if self._id_mode() == "right"
            else univ.Universe()
        )
        return Table(spec, schema, out_universe)

    def groupby(self, *args: Any, **kwargs: Any) -> Any:
        full = self.select(
            *[ColumnReference(self._left, n) for n in self._left._column_names()],
            **{
                n: ColumnReference(self._right, n)
                for n in self._right._column_names()
                if n not in self._left._column_names()
            },
        )
        new_args = [
            ColumnReference(full, a.name) if isinstance(a, ColumnReference) else a
            for a in args
        ]
        return full.groupby(*new_args, **kwargs)

    def reduce(self, *args: Any, **kwargs: Any) -> Table:
        return self.groupby().reduce(*args, **kwargs)

    def filter(self, cond: ColumnExpression) -> Table:
        return self.select_all().filter(cond)

    def select_all(self) -> Table:
        return self.select(
            *[ColumnReference(self._left, n) for n in self._left._column_names()],
            **{
                n: ColumnReference(self._right, n)
                for n in self._right._column_names()
                if n not in self._left._column_names()
            },
        )


class _JoinIdRef(IdReference):
    """pw.this.id inside a join select: the joined row's own key."""

    def __init__(self, jr: JoinResult):
        super().__init__(jr)
