"""Column expression AST.

Reference: python/pathway/internals/expression.py:88-1140. Expressions are
built by the user DSL (`pw.this.x + 1`), type-checked by the type
interpreter, and compiled for evaluation by the engine: scalar closures on
the host path, vectorized numpy/XLA kernels on the numeric plane
(pathway_tpu_torch/engine/vectorize.py).
"""

from __future__ import annotations

import operator
from typing import TYPE_CHECKING, Any, Callable, Iterable

from pathway_tpu_torch.internals import dtype as dt

if TYPE_CHECKING:
    from pathway_tpu_torch.internals.table import Table


class ColumnExpression:
    """Base class of the expression AST."""

    _dtype: dt.DType | None = None

    # --- arithmetic ---
    def __add__(self, other: Any) -> "ColumnExpression":
        return BinaryOpExpression("+", self, wrap_arg(other))

    def __radd__(self, other: Any) -> "ColumnExpression":
        return BinaryOpExpression("+", wrap_arg(other), self)

    def __sub__(self, other: Any) -> "ColumnExpression":
        return BinaryOpExpression("-", self, wrap_arg(other))

    def __rsub__(self, other: Any) -> "ColumnExpression":
        return BinaryOpExpression("-", wrap_arg(other), self)

    def __mul__(self, other: Any) -> "ColumnExpression":
        return BinaryOpExpression("*", self, wrap_arg(other))

    def __rmul__(self, other: Any) -> "ColumnExpression":
        return BinaryOpExpression("*", wrap_arg(other), self)

    def __truediv__(self, other: Any) -> "ColumnExpression":
        return BinaryOpExpression("/", self, wrap_arg(other))

    def __rtruediv__(self, other: Any) -> "ColumnExpression":
        return BinaryOpExpression("/", wrap_arg(other), self)

    def __floordiv__(self, other: Any) -> "ColumnExpression":
        return BinaryOpExpression("//", self, wrap_arg(other))

    def __rfloordiv__(self, other: Any) -> "ColumnExpression":
        return BinaryOpExpression("//", wrap_arg(other), self)

    def __mod__(self, other: Any) -> "ColumnExpression":
        return BinaryOpExpression("%", self, wrap_arg(other))

    def __rmod__(self, other: Any) -> "ColumnExpression":
        return BinaryOpExpression("%", wrap_arg(other), self)

    def __pow__(self, other: Any) -> "ColumnExpression":
        return BinaryOpExpression("**", self, wrap_arg(other))

    def __rpow__(self, other: Any) -> "ColumnExpression":
        return BinaryOpExpression("**", wrap_arg(other), self)

    def __matmul__(self, other: Any) -> "ColumnExpression":
        return BinaryOpExpression("@", self, wrap_arg(other))

    def __rmatmul__(self, other: Any) -> "ColumnExpression":
        return BinaryOpExpression("@", wrap_arg(other), self)

    def __neg__(self) -> "ColumnExpression":
        return UnaryOpExpression("-", self)

    # --- comparison ---
    def __eq__(self, other: Any) -> "ColumnExpression":  # type: ignore[override]
        return BinaryOpExpression("==", self, wrap_arg(other))

    def __ne__(self, other: Any) -> "ColumnExpression":  # type: ignore[override]
        return BinaryOpExpression("!=", self, wrap_arg(other))

    def __lt__(self, other: Any) -> "ColumnExpression":
        return BinaryOpExpression("<", self, wrap_arg(other))

    def __le__(self, other: Any) -> "ColumnExpression":
        return BinaryOpExpression("<=", self, wrap_arg(other))

    def __gt__(self, other: Any) -> "ColumnExpression":
        return BinaryOpExpression(">", self, wrap_arg(other))

    def __ge__(self, other: Any) -> "ColumnExpression":
        return BinaryOpExpression(">=", self, wrap_arg(other))

    # --- boolean ---
    def __and__(self, other: Any) -> "ColumnExpression":
        return BinaryOpExpression("&", self, wrap_arg(other))

    def __rand__(self, other: Any) -> "ColumnExpression":
        return BinaryOpExpression("&", wrap_arg(other), self)

    def __or__(self, other: Any) -> "ColumnExpression":
        return BinaryOpExpression("|", self, wrap_arg(other))

    def __ror__(self, other: Any) -> "ColumnExpression":
        return BinaryOpExpression("|", wrap_arg(other), self)

    def __xor__(self, other: Any) -> "ColumnExpression":
        return BinaryOpExpression("^", self, wrap_arg(other))

    def __rxor__(self, other: Any) -> "ColumnExpression":
        return BinaryOpExpression("^", wrap_arg(other), self)

    def __invert__(self) -> "ColumnExpression":
        return UnaryOpExpression("~", self)

    def __abs__(self) -> "ColumnExpression":
        return UnaryOpExpression("abs", self)

    def __bool__(self) -> bool:
        raise RuntimeError(
            "ColumnExpression is not a boolean; use & | ~ instead of and/or/not"
        )

    def __hash__(self) -> int:
        return id(self)

    # --- methods ---
    def is_none(self) -> "ColumnExpression":
        return IsNoneExpression(self)

    def is_not_none(self) -> "ColumnExpression":
        return IsNotNoneExpression(self)

    def get(self, index: Any, default: Any = None) -> "ColumnExpression":
        return GetExpression(self, wrap_arg(index), wrap_arg(default), check_if_exists=True)

    def __getitem__(self, index: Any) -> "ColumnExpression":
        return GetExpression(self, wrap_arg(index), None, check_if_exists=False)

    def to_string(self) -> "ColumnExpression":
        return MethodCallExpression("to_string", self)

    def as_int(self, unwrap: bool = False) -> "ColumnExpression":
        return ConvertExpression(dt.INT, self, unwrap=unwrap)

    def as_float(self, unwrap: bool = False) -> "ColumnExpression":
        return ConvertExpression(dt.FLOAT, self, unwrap=unwrap)

    def as_str(self, unwrap: bool = False) -> "ColumnExpression":
        return ConvertExpression(dt.STR, self, unwrap=unwrap)

    def as_bool(self, unwrap: bool = False) -> "ColumnExpression":
        return ConvertExpression(dt.BOOL, self, unwrap=unwrap)

    @property
    def dt(self) -> Any:
        from pathway_tpu_torch.internals.expressions.date_time import DateTimeNamespace

        return DateTimeNamespace(self)

    @property
    def str(self) -> Any:
        from pathway_tpu_torch.internals.expressions.string import StringNamespace

        return StringNamespace(self)

    @property
    def num(self) -> Any:
        from pathway_tpu_torch.internals.expressions.numerical import NumericalNamespace

        return NumericalNamespace(self)

    def _sub_expressions(self) -> Iterable["ColumnExpression"]:
        return ()

    def _column_references(self) -> list["ColumnReference"]:
        out: list[ColumnReference] = []
        seen: set[int] = set()

        def rec(e: ColumnExpression) -> None:
            if id(e) in seen:
                return
            seen.add(id(e))
            if isinstance(e, ColumnReference):
                out.append(e)
            for s in e._sub_expressions():
                rec(s)

        rec(self)
        return out

    @property
    def name(self) -> str | None:
        return None


class ColumnConstExpression(ColumnExpression):
    def __init__(self, value: Any):
        self._value = value

    def __repr__(self) -> str:
        return repr(self._value)


class ColumnReference(ColumnExpression):
    """Reference to a column of a table: `table.colname` / `pw.this.colname`."""

    def __init__(self, table: "Table | ThisMarker", name: str):
        self._table = table
        self._name = name

    @property
    def table(self) -> Any:
        return self._table

    @property
    def name(self) -> str:
        return self._name

    def __repr__(self) -> str:
        tname = getattr(self._table, "_debug_name", None) or type(self._table).__name__
        return f"<{tname}>.{self._name}"

    def _to_internal(self) -> tuple[int, str]:
        return (id(self._table), self._name)


class IdReference(ColumnReference):
    def __init__(self, table: Any):
        super().__init__(table, "id")


class BinaryOpExpression(ColumnExpression):
    def __init__(self, op: str, left: ColumnExpression, right: ColumnExpression):
        self._op = op
        self._left = left
        self._right = right

    def _sub_expressions(self) -> Iterable[ColumnExpression]:
        return (self._left, self._right)

    def __repr__(self) -> str:
        return f"({self._left!r} {self._op} {self._right!r})"


class UnaryOpExpression(ColumnExpression):
    def __init__(self, op: str, expr: ColumnExpression):
        self._op = op
        self._expr = expr

    def _sub_expressions(self) -> Iterable[ColumnExpression]:
        return (self._expr,)


class IsNoneExpression(ColumnExpression):
    def __init__(self, expr: ColumnExpression):
        self._expr = expr

    def _sub_expressions(self) -> Iterable[ColumnExpression]:
        return (self._expr,)


class IsNotNoneExpression(ColumnExpression):
    def __init__(self, expr: ColumnExpression):
        self._expr = expr

    def _sub_expressions(self) -> Iterable[ColumnExpression]:
        return (self._expr,)


class ReducerExpression(ColumnExpression):
    """A reducer applied to grouped rows (reference: expression.py:707)."""

    def __init__(self, reducer: Any, *args: Any, **kwargs: Any):
        self._reducer = reducer
        self._args = tuple(wrap_arg(a) for a in args)
        self._kwargs = kwargs

    def _sub_expressions(self) -> Iterable[ColumnExpression]:
        return self._args

    def __repr__(self) -> str:
        return f"{self._reducer}({', '.join(map(repr, self._args))})"


class ApplyExpression(ColumnExpression):
    def __init__(
        self,
        fn: Callable,
        return_type: Any,
        *args: Any,
        propagate_none: bool = False,
        deterministic: bool = True,
        max_batch_size: int | None = None,
        **kwargs: Any,
    ):
        self._fn = fn
        self._return_type = dt.wrap(return_type) if return_type is not None else dt.ANY
        self._args = tuple(wrap_arg(a) for a in args)
        self._kwargs = {k: wrap_arg(v) for k, v in kwargs.items()}
        self._propagate_none = propagate_none
        self._deterministic = deterministic
        self._max_batch_size = max_batch_size

    def _sub_expressions(self) -> Iterable[ColumnExpression]:
        return tuple(self._args) + tuple(self._kwargs.values())


class AsyncApplyExpression(ApplyExpression):
    """Async UDF application — lowered to the async-apply engine op
    (reference: expression.py:791, dataflow.rs:1442)."""


class FullyAsyncApplyExpression(AsyncApplyExpression):
    """Fully decoupled async apply: results arrive at later engine times."""


class CastExpression(ColumnExpression):
    def __init__(self, target: Any, expr: ColumnExpression):
        self._target = dt.wrap(target)
        self._expr = expr

    def _sub_expressions(self) -> Iterable[ColumnExpression]:
        return (self._expr,)


class ConvertExpression(ColumnExpression):
    def __init__(self, target: dt.DType, expr: ColumnExpression, unwrap: bool = False):
        self._target = target
        self._expr = expr
        self._unwrap = unwrap

    def _sub_expressions(self) -> Iterable[ColumnExpression]:
        return (self._expr,)


class DeclareTypeExpression(ColumnExpression):
    def __init__(self, target: Any, expr: ColumnExpression):
        self._target = dt.wrap(target)
        self._expr = expr

    def _sub_expressions(self) -> Iterable[ColumnExpression]:
        return (self._expr,)


class CoalesceExpression(ColumnExpression):
    def __init__(self, *args: Any):
        self._args = tuple(wrap_arg(a) for a in args)

    def _sub_expressions(self) -> Iterable[ColumnExpression]:
        return self._args


class RequireExpression(ColumnExpression):
    def __init__(self, val: Any, *args: Any):
        self._val = wrap_arg(val)
        self._args = tuple(wrap_arg(a) for a in args)

    def _sub_expressions(self) -> Iterable[ColumnExpression]:
        return (self._val, *self._args)


class IfElseExpression(ColumnExpression):
    def __init__(self, if_: Any, then: Any, else_: Any):
        self._if = wrap_arg(if_)
        self._then = wrap_arg(then)
        self._else = wrap_arg(else_)

    def _sub_expressions(self) -> Iterable[ColumnExpression]:
        return (self._if, self._then, self._else)


class PointerExpression(ColumnExpression):
    """pointer_from: content-addressed key from values (expression.py:945)."""

    def __init__(self, table: Any, *args: Any, optional: bool = False, instance: Any = None):
        self._table = table
        self._args = tuple(wrap_arg(a) for a in args)
        self._optional = optional
        self._instance = wrap_arg(instance) if instance is not None else None

    def _sub_expressions(self) -> Iterable[ColumnExpression]:
        subs = list(self._args)
        if self._instance is not None:
            subs.append(self._instance)
        return subs


class MakeTupleExpression(ColumnExpression):
    def __init__(self, *args: Any):
        self._args = tuple(wrap_arg(a) for a in args)

    def _sub_expressions(self) -> Iterable[ColumnExpression]:
        return self._args


class GetExpression(ColumnExpression):
    def __init__(
        self,
        obj: ColumnExpression,
        index: ColumnExpression,
        default: ColumnExpression | None,
        check_if_exists: bool,
    ):
        self._obj = obj
        self._index = index
        self._default = default
        self._check_if_exists = check_if_exists

    def _sub_expressions(self) -> Iterable[ColumnExpression]:
        subs = [self._obj, self._index]
        if self._default is not None:
            subs.append(self._default)
        return subs


class MethodCallExpression(ColumnExpression):
    """A namespace method call (.dt.*/.str.*/.num.*), with the evaluation
    function attached directly (host scalar fn + optional vectorized fn)."""

    def __init__(
        self,
        method_name: str,
        *args: Any,
        fn: Callable | None = None,
        return_type: Any = None,
        vectorized_fn: Callable | None = None,
    ):
        self._method_name = method_name
        self._args = tuple(wrap_arg(a) for a in args)
        self._fn = fn
        self._return_type = dt.wrap(return_type) if return_type is not None else None
        self._vectorized_fn = vectorized_fn

    def _sub_expressions(self) -> Iterable[ColumnExpression]:
        return self._args


class UnwrapExpression(ColumnExpression):
    def __init__(self, expr: Any):
        self._expr = wrap_arg(expr)

    def _sub_expressions(self) -> Iterable[ColumnExpression]:
        return (self._expr,)


class FillErrorExpression(ColumnExpression):
    def __init__(self, expr: Any, replacement: Any):
        self._expr = wrap_arg(expr)
        self._replacement = wrap_arg(replacement)

    def _sub_expressions(self) -> Iterable[ColumnExpression]:
        return (self._expr, self._replacement)


class ThisMarker:
    """`pw.this` — deferred table reference resolved at select/filter time.

    Also covers pw.left / pw.right via the `_side` tag.
    """

    def __init__(self, side: str = "this"):
        object.__setattr__(self, "_side", side)

    def __getattr__(self, name: str) -> ColumnReference:
        if name.startswith("__") and name.endswith("__"):
            raise AttributeError(name)
        if name == "id":
            return IdReference(self)
        return ColumnReference(self, name)

    def __getitem__(self, name: Any) -> Any:
        if isinstance(name, (list, tuple)):
            return [self[n] for n in name]
        if isinstance(name, ColumnReference):
            name = name.name
        if name == "id":
            return IdReference(self)
        return ColumnReference(self, name)

    def without(self, *cols: Any) -> "ThisWithout":
        names = {c.name if isinstance(c, ColumnReference) else c for c in cols}
        return ThisWithout(self._side, names)

    def __repr__(self) -> str:
        return f"pw.{self._side}"

    def __iter__(self):
        # `*pw.this` expands to all columns at resolution time
        yield ThisSplat(self)


class ThisWithout(ThisMarker):
    def __init__(self, side: str, excluded: set[str]):
        super().__init__(side)
        object.__setattr__(self, "_excluded", excluded)

    def __iter__(self):
        yield ThisSplat(self, excluded=self._excluded)


class ThisSplat:
    """Marker for `*pw.this` argument expansion."""

    def __init__(self, marker: ThisMarker, excluded: set[str] | None = None):
        self.marker = marker
        self.excluded = excluded or set()


this = ThisMarker("this")
left = ThisMarker("left")
right = ThisMarker("right")


def wrap_arg(arg: Any) -> ColumnExpression:
    if isinstance(arg, ColumnExpression):
        return arg
    return ColumnConstExpression(arg)


def smart_name(expr: ColumnExpression) -> str | None:
    """Infer the output column name for auto-naming in select()."""
    if isinstance(expr, ColumnReference):
        return expr.name
    return None


_BIN_OPS: dict[str, Callable[[Any, Any], Any]] = {
    "+": operator.add, "-": operator.sub, "*": operator.mul,
    "/": operator.truediv, "//": operator.floordiv, "%": operator.mod,
    "**": operator.pow, "==": operator.eq, "!=": operator.ne,
    "<": operator.lt, "<=": operator.le, ">": operator.gt, ">=": operator.ge,
    "&": operator.and_, "|": operator.or_, "^": operator.xor,
    "@": operator.matmul,
}
