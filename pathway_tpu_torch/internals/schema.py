"""Schema: typed column declarations for Tables.

Reference: python/pathway/internals/schema.py:1 (class-syntax schemas,
column_definition, schema_from_types/dict/pandas, schema unions).
"""

from __future__ import annotations

import typing
from dataclasses import dataclass, field
from typing import Any, Mapping

from pathway_tpu_torch.internals import dtype as dt


@dataclass
class ColumnDefinition:
    primary_key: bool = False
    default_value: Any = ...  # ... means no default
    dtype: Any = None
    name: str | None = None
    append_only: bool | None = None

    @property
    def has_default_value(self) -> bool:
        return self.default_value is not ...


def column_definition(
    *,
    primary_key: bool = False,
    default_value: Any = ...,
    dtype: Any = None,
    name: str | None = None,
    append_only: bool | None = None,
) -> Any:
    """Column declaration with properties (reference: schema.py column_definition)."""
    return ColumnDefinition(primary_key, default_value, dtype, name, append_only)


@dataclass(frozen=True)
class ColumnSchema:
    name: str
    dtype: dt.DType
    primary_key: bool = False
    default_value: Any = ...
    append_only: bool = False

    @property
    def has_default_value(self) -> bool:
        return self.default_value is not ...


class SchemaMetaclass(type):
    __columns__: dict[str, ColumnSchema]
    __append_only__: bool

    def __init__(cls, name: str, bases: tuple, namespace: dict, append_only: bool = False, **kwargs):
        super().__init__(name, bases, namespace)
        columns: dict[str, ColumnSchema] = {}
        for base in bases:
            if hasattr(base, "__columns__"):
                columns.update(base.__columns__)
        hints = {}
        for klass in reversed(cls.__mro__):
            hints.update(getattr(klass, "__annotations__", {}))
        localns = dict(namespace.get("__globals__", {}))
        for col_name, hint in hints.items():
            if col_name.startswith("__") or col_name == "_":
                continue
            if isinstance(hint, str):
                try:
                    hint = eval(hint, vars(typing) | _schema_eval_ns(), localns)  # noqa: S307
                except Exception:
                    hint = Any
            cdef = namespace.get(col_name)
            if isinstance(cdef, ColumnDefinition):
                dtype = dt.wrap(cdef.dtype) if cdef.dtype is not None else dt.wrap(hint)
                columns[cdef.name or col_name] = ColumnSchema(
                    name=cdef.name or col_name,
                    dtype=dtype,
                    primary_key=cdef.primary_key,
                    default_value=cdef.default_value,
                    append_only=bool(cdef.append_only) or append_only,
                )
            else:
                columns[col_name] = ColumnSchema(
                    name=col_name, dtype=dt.wrap(hint), append_only=append_only
                )
        cls.__columns__ = columns
        cls.__append_only__ = append_only

    def __or__(cls, other: "SchemaMetaclass") -> "SchemaMetaclass":
        columns = dict(cls.__columns__)
        for name, col in other.__columns__.items():
            if name in columns and columns[name].dtype != col.dtype:
                raise TypeError(
                    f"schema union: column {name!r} has conflicting types "
                    f"{columns[name].dtype!r} and {col.dtype!r}"
                )
            columns[name] = col
        return schema_from_columns(columns, name=f"{cls.__name__}|{other.__name__}")

    def columns(cls) -> Mapping[str, ColumnSchema]:
        return dict(cls.__columns__)

    def column_names(cls) -> list[str]:
        return list(cls.__columns__)

    def keys(cls) -> list[str]:
        return list(cls.__columns__)

    def typehints(cls) -> dict[str, Any]:
        return {n: c.dtype.typehint() for n, c in cls.__columns__.items()}

    def dtypes(cls) -> dict[str, dt.DType]:
        return {n: c.dtype for n, c in cls.__columns__.items()}

    def primary_key_columns(cls) -> list[str] | None:
        pks = [n for n, c in cls.__columns__.items() if c.primary_key]
        return pks or None

    def default_values(cls) -> dict[str, Any]:
        return {
            n: c.default_value for n, c in cls.__columns__.items() if c.has_default_value
        }

    def with_types(cls, **kwargs: Any) -> "SchemaMetaclass":
        columns = dict(cls.__columns__)
        for name, hint in kwargs.items():
            if name not in columns:
                raise ValueError(f"column {name!r} not present in schema")
            old = columns[name]
            columns[name] = ColumnSchema(
                name=name, dtype=dt.wrap(hint), primary_key=old.primary_key,
                default_value=old.default_value, append_only=old.append_only,
            )
        return schema_from_columns(columns, name=cls.__name__)

    def without(cls, *names: Any) -> "SchemaMetaclass":
        drop = {n if isinstance(n, str) else n.name for n in names}
        columns = {n: c for n, c in cls.__columns__.items() if n not in drop}
        return schema_from_columns(columns, name=cls.__name__)

    def get_dtype(cls, name: str) -> dt.DType:
        """Dtype of one column (reference: schema.py get_dtype)."""
        return cls.__columns__[name].dtype

    def has_default_value(cls, name: str) -> bool:
        return cls.__columns__[name].has_default_value

    def column_properties(cls, name: str) -> Any:
        """(dtype, append_only) of one column, reference-shaped."""
        from collections import namedtuple

        ColumnProperties = namedtuple("ColumnProperties", "dtype append_only")
        c = cls.__columns__[name]
        return ColumnProperties(dtype=c.dtype, append_only=c.append_only)

    @property
    def id_type(cls) -> Any:
        """Python type hint of the id column."""
        return getattr(cls, "__id_dtype__", dt.ANY_POINTER).typehint()

    def with_id_type(cls, id_type: Any, *, append_only: bool | None = None) -> "SchemaMetaclass":
        out = schema_from_columns(dict(cls.__columns__), name=cls.__name__)
        out.__id_dtype__ = dt.wrap(id_type)
        return out

    def assert_matches_schema(
        cls,
        other: "SchemaMetaclass",
        *,
        allow_superset: bool = True,
        ignore_primary_keys: bool = True,
        allow_subtype: bool = True,
    ) -> None:
        """Raises AssertionError unless this schema's columns match
        `other`'s (reference: schema.py:562). `allow_superset`: self may
        have extra columns; `allow_subtype`: dtypes may narrow."""
        mine = {n: c.dtype for n, c in cls.__columns__.items()}
        theirs = {n: c.dtype for n, c in other.__columns__.items()}
        missing = set(theirs) - set(mine)
        assert not missing, f"columns missing from schema: {sorted(missing)}"
        if not allow_superset:
            extra = set(mine) - set(theirs)
            assert not extra, f"unexpected extra columns: {sorted(extra)}"
        for n, want in theirs.items():
            got = mine[n]
            # dtype-level narrowing: got is a subtype of want when their
            # least common ancestor IS want (INT narrows FLOAT, T narrows
            # Optional[T], anything narrows ANY)
            ok = got == want
            if not ok and allow_subtype:
                try:
                    ok = dt.types_lca(got, want) == want
                except Exception:  # noqa: BLE001 — incomparable dtypes
                    ok = False
            assert ok, f"column {n!r}: dtype {got!r} does not match {want!r}"
        if not ignore_primary_keys:
            assert (cls.primary_key_columns() or []) == (
                other.primary_key_columns() or []
            ), "primary keys differ"

    def generate_class(
        cls, class_name: str | None = None, generate_imports: bool = False
    ) -> str:
        """Python source for an equivalent schema class (reference:
        schema.py:459) — persists inferred schemas as code."""
        name = class_name or (cls.__name__ if cls.__name__.isidentifier() else "MySchema")

        modules: set[str] = set()

        def hint_src(hint: Any) -> str:
            # plain classes qualify by module (numpy.ndarray etc.);
            # parameterized hints (Optional[int], list[str]) keep their
            # repr, which names the typing module when it needs it
            if isinstance(hint, type):
                if hint.__module__ in ("builtins", None):
                    return hint.__name__
                modules.add(hint.__module__.split(".")[0])
                return f"{hint.__module__}.{hint.__qualname__}"
            r = repr(hint)
            if r.startswith("typing."):
                modules.add("typing")
            return r

        body = []
        for n, c in cls.__columns__.items():
            hint_s = hint_src(c.dtype.typehint())
            opts = []
            if c.primary_key:
                opts.append("primary_key=True")
            if c.has_default_value:
                opts.append(f"default_value={c.default_value!r}")
            if opts:
                body.append(
                    f"    {n}: {hint_s} = pw.column_definition({', '.join(opts)})"
                )
            else:
                body.append(f"    {n}: {hint_s}")
        if not body:
            body = ["    pass"]
        lines = []
        if generate_imports:
            lines.append("import pathway_tpu_torch as pw")
            lines.extend(f"import {m}" for m in sorted(modules))
            lines.append("")
        lines.append(f"class {name}(pw.Schema):")
        lines.extend(body)
        return "\n".join(lines) + "\n"

    def generate_class_to_file(
        cls, path: str, class_name: str | None = None, generate_imports: bool = True
    ) -> None:
        with open(path, "w") as f:
            f.write(cls.generate_class(class_name, generate_imports))

    def update_properties(cls, **kwargs: Any) -> "SchemaMetaclass":
        return cls

    def __repr__(cls) -> str:
        cols = ", ".join(f"{n}: {c.dtype!r}" for n, c in cls.__columns__.items())
        return f"<Schema {cls.__name__}({cols})>"

    def __getitem__(cls, name: str) -> ColumnSchema:
        return cls.__columns__[name]


def _schema_eval_ns() -> dict[str, Any]:
    import numpy as np

    from pathway_tpu_torch.internals.datetime_types import DateTimeNaive, DateTimeUtc, Duration
    from pathway_tpu_torch.internals.json import Json

    return {
        "int": int, "float": float, "str": str, "bytes": bytes, "bool": bool,
        "np": np, "Json": Json, "DateTimeNaive": DateTimeNaive,
        "DateTimeUtc": DateTimeUtc, "Duration": Duration, "Any": Any,
    }


class Schema(metaclass=SchemaMetaclass):
    """Base class for user schemas:

    >>> class InputSchema(pw.Schema):
    ...     name: str
    ...     age: int
    """


def schema_from_columns(
    columns: Mapping[str, ColumnSchema], name: str = "Schema"
) -> SchemaMetaclass:
    cls = SchemaMetaclass(name, (Schema,), {})
    cls.__columns__ = dict(columns)
    return cls


def schema_from_types(_name: str = "Schema", **kwargs: Any) -> SchemaMetaclass:
    columns = {n: ColumnSchema(name=n, dtype=dt.wrap(t)) for n, t in kwargs.items()}
    return schema_from_columns(columns, name=_name)


def schema_from_dict(
    columns: Mapping[str, Any], name: str = "Schema"
) -> SchemaMetaclass:
    out: dict[str, ColumnSchema] = {}
    for n, spec in columns.items():
        if isinstance(spec, dict):
            out[n] = ColumnSchema(
                name=n,
                dtype=dt.wrap(spec.get("dtype", Any)),
                primary_key=spec.get("primary_key", False),
                default_value=spec.get("default_value", ...),
            )
        else:
            out[n] = ColumnSchema(name=n, dtype=dt.wrap(spec))
    return schema_from_columns(out, name=name)


_PANDAS_DTYPE_MAP = {
    "int64": int, "int32": int, "int16": int, "int8": int,
    "uint64": int, "uint32": int, "uint16": int, "uint8": int,
    "float64": float, "float32": float, "bool": bool, "object": Any,
    "string": str, "datetime64[ns]": None,
}


def schema_from_pandas(
    df: Any, *, id_from: list[str] | None = None, name: str = "Schema",
    exclude_columns: set[str] = frozenset(),  # type: ignore[assignment]
) -> SchemaMetaclass:
    columns: dict[str, ColumnSchema] = {}
    for col in df.columns:
        if col in exclude_columns:
            continue
        pd_dt = str(df[col].dtype)
        if pd_dt in _PANDAS_DTYPE_MAP:
            hint = _PANDAS_DTYPE_MAP[pd_dt]
            if hint is None:
                from pathway_tpu_torch.internals.datetime_types import DateTimeNaive

                hint = DateTimeNaive
        elif pd_dt.startswith("datetime64"):
            from pathway_tpu_torch.internals.datetime_types import DateTimeUtc

            hint = DateTimeUtc
        else:
            hint = Any
        if hint is Any and len(df) > 0:
            inferred = {type(v) for v in df[col] if v is not None}
            if len(inferred) == 1:
                t = inferred.pop()
                if t in (int, float, str, bool, bytes):
                    hint = t
        columns[str(col)] = ColumnSchema(
            name=str(col), dtype=dt.wrap(hint), primary_key=col in (id_from or [])
        )
    return schema_from_columns(columns, name=name)


class SchemaBuilderProxy:
    def __init__(self) -> None:
        self.cols: dict[str, Any] = {}


def schema_builder(
    columns: Mapping[str, ColumnDefinition | Any], *, name: str = "Schema",
    properties: Any = None,
) -> SchemaMetaclass:
    out: dict[str, ColumnSchema] = {}
    for n, cdef in columns.items():
        if isinstance(cdef, ColumnDefinition):
            out[n] = ColumnSchema(
                name=cdef.name or n,
                dtype=dt.wrap(cdef.dtype) if cdef.dtype is not None else dt.ANY,
                primary_key=cdef.primary_key,
                default_value=cdef.default_value,
            )
        else:
            out[n] = ColumnSchema(name=n, dtype=dt.wrap(cdef))
    return schema_from_columns(out, name=name)


def is_schema(obj: Any) -> bool:
    return isinstance(obj, SchemaMetaclass)
