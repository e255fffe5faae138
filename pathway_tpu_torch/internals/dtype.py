"""Data type lattice for the framework.

TPU-native re-design of the reference's type system
(reference: python/pathway/internals/dtype.py:1, src/engine/value.rs:207).
Types drive (a) schema validation, (b) expression type inference with
coercion, and (c) the numeric-plane decision: columns whose dtype maps to a
fixed-width machine type are eligible for columnar device storage and XLA
evaluation; everything else stays on the host path.
"""

from __future__ import annotations

import datetime
import typing
from abc import ABC, abstractmethod
from typing import Any, Optional as TOptional

import numpy as np


class DType(ABC):
    """Base of the dtype lattice."""

    _cache: dict[Any, DType] = {}

    @abstractmethod
    def typehint(self) -> Any: ...

    def is_value_compatible(self, value: Any) -> bool:
        raise NotImplementedError

    @property
    def numeric_np_dtype(self) -> TOptional[np.dtype]:
        """numpy dtype if this column can live on the numeric (XLA) plane."""
        return None

    def __repr__(self) -> str:
        return self.__class__.__name__.lstrip("_")

    def equivalent_to(self, other: DType) -> bool:
        return self == other


class _SimpleDType(DType):
    def __init__(self, wrapped: Any, name: str):
        self.wrapped = wrapped
        self.name = name

    def __repr__(self) -> str:
        return self.name

    def typehint(self) -> Any:
        return self.wrapped

    def is_value_compatible(self, value: Any) -> bool:
        if self.wrapped is float:
            return isinstance(value, (int, float, np.integer, np.floating)) and not isinstance(
                value, bool
            )
        if self.wrapped is int:
            return isinstance(value, (int, np.integer)) and not isinstance(value, bool)
        if self.wrapped is bool:
            return isinstance(value, (bool, np.bool_))
        return isinstance(value, self.wrapped)

    @property
    def numeric_np_dtype(self) -> TOptional[np.dtype]:
        if self.wrapped is int:
            return np.dtype(np.int64)
        if self.wrapped is float:
            return np.dtype(np.float64)
        if self.wrapped is bool:
            return np.dtype(np.bool_)
        return None


INT = _SimpleDType(int, "INT")
FLOAT = _SimpleDType(float, "FLOAT")
BOOL = _SimpleDType(bool, "BOOL")
STR = _SimpleDType(str, "STR")
BYTES = _SimpleDType(bytes, "BYTES")


class _NoneDType(DType):
    def typehint(self) -> Any:
        return None

    def is_value_compatible(self, value: Any) -> bool:
        return value is None


NONE = _NoneDType()


class _AnyDType(DType):
    def typehint(self) -> Any:
        return Any

    def is_value_compatible(self, value: Any) -> bool:
        return True


ANY = _AnyDType()


class _ErrorDType(DType):
    def typehint(self) -> Any:
        return Any

    def is_value_compatible(self, value: Any) -> bool:
        return True


ERROR = _ErrorDType()


class Pointer(DType):
    """Row-reference type; optionally parameterized by target schema."""

    def __init__(self, schema: Any = None):
        self.schema = schema

    def __repr__(self) -> str:
        if self.schema is None:
            return "POINTER"
        return f"Pointer[{getattr(self.schema, '__name__', self.schema)}]"

    def __eq__(self, other: Any) -> bool:
        return isinstance(other, Pointer)

    def __hash__(self) -> int:
        return hash("Pointer")

    def typehint(self) -> Any:
        return Pointer

    def is_value_compatible(self, value: Any) -> bool:
        from pathway_tpu_torch.internals.keys import Key

        return isinstance(value, Key)


ANY_POINTER = Pointer()


class Optional(DType):
    def __new__(cls, arg: DType):
        if isinstance(arg, (Optional, _AnyDType, _NoneDType)):
            return arg
        self = object.__new__(cls)
        self.wrapped = arg
        return self

    def __init__(self, arg: DType):
        self.wrapped = arg if not isinstance(arg, Optional) else arg.wrapped

    def __repr__(self) -> str:
        return f"Optional({self.wrapped!r})"

    def __eq__(self, other: Any) -> bool:
        return isinstance(other, Optional) and self.wrapped == other.wrapped

    def __hash__(self) -> int:
        return hash(("Optional", self.wrapped))

    def typehint(self) -> Any:
        return TOptional[self.wrapped.typehint()]

    def is_value_compatible(self, value: Any) -> bool:
        return value is None or self.wrapped.is_value_compatible(value)


class Tuple(DType):
    def __init__(self, *args: DType):
        self.args = tuple(args)

    def __repr__(self) -> str:
        return f"Tuple({', '.join(map(repr, self.args))})"

    def __eq__(self, other: Any) -> bool:
        return isinstance(other, Tuple) and self.args == other.args

    def __hash__(self) -> int:
        return hash(("Tuple", self.args))

    def typehint(self) -> Any:
        return tuple

    def is_value_compatible(self, value: Any) -> bool:
        return isinstance(value, tuple)


ANY_TUPLE = Tuple(ANY)


class List(DType):
    def __init__(self, arg: DType = ANY):
        self.wrapped = arg

    def __repr__(self) -> str:
        return f"List({self.wrapped!r})"

    def __eq__(self, other: Any) -> bool:
        return isinstance(other, List) and self.wrapped == other.wrapped

    def __hash__(self) -> int:
        return hash(("List", self.wrapped))

    def typehint(self) -> Any:
        return tuple

    def is_value_compatible(self, value: Any) -> bool:
        return isinstance(value, (tuple, list))


class Array(DType):
    """N-dim numeric array column. dim=None means unknown rank.

    On the TPU plane, fixed-shape Array columns pack into a single
    (n_rows, *shape) device buffer (e.g. embedding columns).
    """

    def __init__(self, dim: int | None = None, wrapped: Any = float, shape: tuple | None = None):
        self.dim = dim
        self.wrapped = wrapped
        self.shape = shape

    def __repr__(self) -> str:
        return f"Array({self.dim}, {self.wrapped})"

    def __eq__(self, other: Any) -> bool:
        return (
            isinstance(other, Array)
            and self.dim == other.dim
            and self.wrapped == other.wrapped
        )

    def __hash__(self) -> int:
        return hash(("Array", self.dim, str(self.wrapped)))

    def typehint(self) -> Any:
        return np.ndarray

    def is_value_compatible(self, value: Any) -> bool:
        return isinstance(value, np.ndarray)

    @property
    def numeric_np_dtype(self) -> TOptional[np.dtype]:
        try:
            return np.dtype(self.wrapped)
        except TypeError:
            return np.dtype(np.float64)


ANY_ARRAY = Array()


class _JsonDType(DType):
    def typehint(self) -> Any:
        from pathway_tpu_torch.internals import json as pw_json

        return pw_json.Json

    def is_value_compatible(self, value: Any) -> bool:
        from pathway_tpu_torch.internals import json as pw_json

        return isinstance(value, (pw_json.Json, dict, list, str, int, float, bool)) or value is None


JSON = _JsonDType()


class _DateTimeNaive(DType):
    def typehint(self) -> Any:
        from pathway_tpu_torch.internals.datetime_types import DateTimeNaive

        return DateTimeNaive

    def is_value_compatible(self, value: Any) -> bool:
        from pathway_tpu_torch.internals.datetime_types import DateTimeNaive

        return isinstance(value, DateTimeNaive)

    @property
    def numeric_np_dtype(self) -> TOptional[np.dtype]:
        return np.dtype(np.int64)


class _DateTimeUtc(DType):
    def typehint(self) -> Any:
        from pathway_tpu_torch.internals.datetime_types import DateTimeUtc

        return DateTimeUtc

    def is_value_compatible(self, value: Any) -> bool:
        from pathway_tpu_torch.internals.datetime_types import DateTimeUtc

        return isinstance(value, DateTimeUtc)

    @property
    def numeric_np_dtype(self) -> TOptional[np.dtype]:
        return np.dtype(np.int64)


class _Duration(DType):
    def typehint(self) -> Any:
        from pathway_tpu_torch.internals.datetime_types import Duration

        return Duration

    def is_value_compatible(self, value: Any) -> bool:
        from pathway_tpu_torch.internals.datetime_types import Duration

        return isinstance(value, Duration)

    @property
    def numeric_np_dtype(self) -> TOptional[np.dtype]:
        return np.dtype(np.int64)


DATE_TIME_NAIVE = _DateTimeNaive()
DATE_TIME_UTC = _DateTimeUtc()
DURATION = _Duration()


class Callable(DType):
    def __init__(self, arg_types: Any = ..., return_type: DType = ANY):
        self.arg_types = arg_types
        self.return_type = return_type

    def typehint(self) -> Any:
        return typing.Callable

    def is_value_compatible(self, value: Any) -> bool:
        return callable(value)

    def __eq__(self, other: Any) -> bool:
        return isinstance(other, Callable)

    def __hash__(self) -> int:
        return hash("Callable")


class PyObjectWrapper(DType):
    """Opaque Python object column (reference: src/engine/value.rs:207 PyObjectWrapper)."""

    def __init__(self, wrapped: Any = object):
        self.wrapped = wrapped

    def typehint(self) -> Any:
        return object

    def is_value_compatible(self, value: Any) -> bool:
        return True

    def __eq__(self, other: Any) -> bool:
        return isinstance(other, PyObjectWrapper)

    def __hash__(self) -> int:
        return hash("PyObjectWrapper")


ANY_PY_OBJECT = PyObjectWrapper()

_FROM_HINT: dict[Any, DType] = {
    int: INT,
    float: FLOAT,
    bool: BOOL,
    str: STR,
    bytes: BYTES,
    type(None): NONE,
    None: NONE,
    Any: ANY,
    np.ndarray: ANY_ARRAY,
    tuple: ANY_TUPLE,
    list: List(ANY),
    dict: JSON,
    datetime.datetime: DATE_TIME_NAIVE,
    datetime.timedelta: DURATION,
}


def wrap(input_type: Any) -> DType:
    """Convert a Python type hint (or DType) to a DType."""
    if isinstance(input_type, DType):
        return input_type
    if input_type in _FROM_HINT:
        return _FROM_HINT[input_type]

    from pathway_tpu_torch.internals import json as pw_json
    from pathway_tpu_torch.internals.datetime_types import DateTimeNaive, DateTimeUtc, Duration
    from pathway_tpu_torch.internals.keys import Key

    if input_type is pw_json.Json:
        return JSON
    if input_type is DateTimeNaive:
        return DATE_TIME_NAIVE
    if input_type is DateTimeUtc:
        return DATE_TIME_UTC
    if input_type is Duration:
        return DURATION
    if input_type is Key or input_type is Pointer:
        return ANY_POINTER
    if isinstance(input_type, type):
        from pathway_tpu_torch.internals.schema import Schema

        if issubclass(input_type, Schema):
            return Pointer(input_type)

    import types as _types

    origin = typing.get_origin(input_type)
    args = typing.get_args(input_type)
    # PEP 604 unions (`str | None`) have origin types.UnionType, not
    # typing.Union — both must wrap to Optional/union dtypes, or every
    # modern-syntax schema silently degrades to ANY
    if origin is typing.Union or origin is _types.UnionType:
        non_none = [a for a in args if a is not type(None)]
        if len(non_none) == len(args):
            return ANY
        if len(non_none) == 1:
            return Optional(wrap(non_none[0]))
        return ANY
    if origin in (tuple,):
        if len(args) == 2 and args[1] is Ellipsis:
            return List(wrap(args[0]))
        return Tuple(*[wrap(a) for a in args])
    if origin in (list,):
        return List(wrap(args[0]) if args else ANY)
    if origin is np.ndarray:
        # np.ndarray[dims, np.dtype[x]]
        wrapped: Any = float
        if len(args) == 2:
            dt_args = typing.get_args(args[1])
            if dt_args:
                wrapped = dt_args[0]
        return Array(None, wrapped)
    if origin is not None and origin is typing.Callable:
        return Callable()
    if input_type is Ellipsis:
        return ANY
    return ANY


def dtype_of_value(value: Any) -> DType:
    from pathway_tpu_torch.internals import json as pw_json
    from pathway_tpu_torch.internals.datetime_types import DateTimeNaive, DateTimeUtc, Duration
    from pathway_tpu_torch.internals.errors import ErrorValue
    from pathway_tpu_torch.internals.keys import Key

    if value is None:
        return NONE
    if isinstance(value, ErrorValue):
        return ERROR
    if isinstance(value, (bool, np.bool_)):
        return BOOL
    if isinstance(value, (int, np.integer)):
        return INT
    if isinstance(value, (float, np.floating)):
        return FLOAT
    if isinstance(value, str):
        return STR
    if isinstance(value, bytes):
        return BYTES
    if isinstance(value, Key):
        return ANY_POINTER
    if isinstance(value, DateTimeUtc):
        return DATE_TIME_UTC
    if isinstance(value, DateTimeNaive):
        return DATE_TIME_NAIVE
    if isinstance(value, Duration):
        return DURATION
    if isinstance(value, np.ndarray):
        return Array(value.ndim, value.dtype.type, value.shape)
    if isinstance(value, tuple):
        return Tuple(*[dtype_of_value(v) for v in value])
    if isinstance(value, pw_json.Json):
        return JSON
    if callable(value):
        return Callable()
    return ANY


def types_lca(a: DType, b: DType, raising: bool = False) -> DType:
    """Least common ancestor in the lattice, with INT<:FLOAT coercion."""
    if a == b:
        return a
    if a is ERROR or b is ERROR:
        return a if b is ERROR else b
    if a is NONE:
        return Optional(b)
    if b is NONE:
        return Optional(a)
    if isinstance(a, Optional) or isinstance(b, Optional):
        aw = a.wrapped if isinstance(a, Optional) else a
        bw = b.wrapped if isinstance(b, Optional) else b
        inner = types_lca(aw, bw, raising=raising)
        return Optional(inner)
    if {a, b} == {INT, FLOAT}:
        return FLOAT
    if isinstance(a, Pointer) and isinstance(b, Pointer):
        return ANY_POINTER
    if isinstance(a, Array) and isinstance(b, Array):
        return Array(a.dim if a.dim == b.dim else None, a.wrapped)
    if isinstance(a, Tuple) and isinstance(b, Tuple):
        if len(a.args) == len(b.args):
            return Tuple(*[types_lca(x, y) for x, y in zip(a.args, b.args)])
        return ANY_TUPLE
    if raising:
        raise TypeError(f"cannot find common type of {a!r} and {b!r}")
    return ANY


def is_subtype(sub: DType, sup: DType) -> bool:
    if sup is ANY or sub == sup:
        return True
    if sub is ERROR:
        return True
    if isinstance(sup, Optional):
        if sub is NONE:
            return True
        inner = sub.wrapped if isinstance(sub, Optional) else sub
        return is_subtype(inner, sup.wrapped)
    if sub is INT and sup is FLOAT:
        return True
    if isinstance(sub, Pointer) and isinstance(sup, Pointer):
        return True
    if isinstance(sub, Array) and isinstance(sup, Array):
        return sup.dim is None or sub.dim == sup.dim
    if isinstance(sub, Tuple) and sup == ANY_TUPLE:
        return True
    if isinstance(sub, Tuple) and isinstance(sup, Tuple):
        return len(sub.args) == len(sup.args) and all(
            is_subtype(x, y) for x, y in zip(sub.args, sup.args)
        )
    if isinstance(sub, List) and isinstance(sup, List):
        return is_subtype(sub.wrapped, sup.wrapped)
    return False


def unoptionalize(dtype: DType) -> DType:
    return dtype.wrapped if isinstance(dtype, Optional) else dtype


def normalize_dtype(dtype: Any) -> DType:
    return wrap(dtype)
