"""Row transformers: `@pw.transformer` class syntax.

Reference parity: internals/row_transformer.py:294 (`transformer`,
`ClassArg`, `input_attribute`, `output_attribute`, `method`) lowered there
through complex_columns. Here a transformer lowers to ONE engine operator
(engine/transformer.py RowTransformerNode) that keeps every member
table's rows arranged, evaluates output attributes lazily with
memoization — including cross-table and cross-row references through
`self.transformer.<table>[pointer].<attr>` — and tracks row-level read
dependencies so an input change recomputes only the rows whose values
could actually change.

Example::

    @pw.transformer
    class squares:
        class items(pw.ClassArg):
            value = pw.input_attribute()

            @pw.output_attribute
            def squared(self) -> int:
                return self.value * self.value

    result = squares(items=source).items   # columns: squared
"""

from __future__ import annotations

from typing import Any, Callable

from pathway_tpu_torch.internals import dtype as dt
from pathway_tpu_torch.internals import schema as sch
from pathway_tpu_torch.internals import universe as univ
from pathway_tpu_torch.internals.table import OpSpec, Table


class _InputAttribute:
    """Marker: the attribute is a column of the member's input table."""

    def __init__(self) -> None:
        self.name: str | None = None


class _OutputAttribute:
    """Marker: the attribute is computed by `fn(self)` per row."""

    def __init__(self, fn: Callable):
        self.fn = fn
        self.name = fn.__name__


def input_attribute(type: Any = None) -> Any:  # noqa: A002
    return _InputAttribute()


def output_attribute(fn: Callable | None = None, **kwargs: Any) -> Any:
    if fn is None:
        return lambda f: _OutputAttribute(f)
    return _OutputAttribute(fn)


def method(fn: Callable | None = None, **kwargs: Any) -> Any:
    raise NotImplementedError(
        "@pw.method (callable columns) is not supported; expose the "
        "computation as an @pw.output_attribute or a UDF instead"
    )


input_method = method


class ClassArg:
    """Base class for transformer member classes. Inside output
    attributes, `self` is a row handle: input/output attributes resolve
    per row, `self.id` is the row key, and `self.transformer.<table>`
    indexes sibling tables by pointer."""

    id: Any
    transformer: Any

    def pointer_from(self, *args: Any) -> Any:
        from pathway_tpu_torch.internals.keys import key_for_values

        return key_for_values(*args)


class _ClassMeta:
    """Parsed member class: ordered input/output attribute specs plus
    plain helper methods/attributes defined on the class body."""

    def __init__(self, name: str, cls: type):
        self.name = name
        self.cls = cls
        self.inputs: list[str] = []
        self.outputs: dict[str, Callable] = {}
        self.helpers: dict[str, Any] = {}
        for attr_name, attr in vars(cls).items():
            if isinstance(attr, _InputAttribute):
                attr.name = attr_name
                self.inputs.append(attr_name)
            elif isinstance(attr, _OutputAttribute):
                self.outputs[attr_name] = attr.fn
            elif not attr_name.startswith("__"):
                # plain methods/constants: available on row handles like
                # on a normal instance
                self.helpers[attr_name] = attr


class Transformer:
    def __init__(self, cls: type):
        self.name = cls.__name__
        self.classes: dict[str, _ClassMeta] = {}
        for name, member in vars(cls).items():
            if isinstance(member, type) and issubclass(member, ClassArg):
                self.classes[name] = _ClassMeta(name, member)
        if not self.classes:
            raise TypeError(
                f"@pw.transformer class {self.name!r} declares no "
                "pw.ClassArg member classes"
            )

    def __call__(self, **tables: Table) -> Any:
        missing = set(self.classes) - set(tables)
        if missing:
            raise TypeError(f"transformer {self.name}: missing tables {missing}")
        # validate input attributes exist on the supplied tables
        for name, meta in self.classes.items():
            cols = tables[name]._column_names()
            for a in meta.inputs:
                if a not in cols:
                    raise KeyError(
                        f"transformer {self.name}.{name}: input attribute "
                        f"{a!r} is not a column of the supplied table"
                    )
        spec = OpSpec(
            "row_transformer",
            [tables[name] for name in self.classes],
            transformer=self,
            table_names=list(self.classes),
        )
        out: dict[str, Table] = {}
        for name, meta in self.classes.items():
            out_schema = sch.schema_from_columns(
                {
                    a: sch.ColumnSchema(name=a, dtype=dt.ANY)
                    for a in meta.outputs
                }
            )
            out_spec = OpSpec(
                "row_transformer_output",
                [tables[name]],
                parent=spec,
                name=name,
            )
            out[name] = Table(out_spec, out_schema, univ.Universe())
        import collections

        Result = collections.namedtuple("TransformerResult", list(out))  # type: ignore[misc]
        return Result(**out)


def transformer(cls: type) -> Transformer:
    """Decorator turning a class of ClassArg members into a row
    transformer (reference row_transformer.py:294)."""
    return Transformer(cls)


__all__ = [
    "ClassArg",
    "Transformer",
    "transformer",
    "input_attribute",
    "output_attribute",
    "method",
    "input_method",
]
