"""PyObjectWrapper: carry an arbitrary Python object through the engine
as a value (reference: api.py wrap_py_object / PyObjectWrapper dtype).

The wrapped object flows like any scalar: it groups/joins by identity of
its serialized form, persists via the codec's explicit escape, and comes
back out of `materialize`/subscribe unchanged. An optional serializer
(`dumps`/`loads` protocol, e.g. `pickle` or a module with those two
functions) controls the durable form.
"""

from __future__ import annotations

import pickle
from typing import Any


class PyObjectWrapper:
    __slots__ = ("value", "_serializer")

    def __init__(self, value: Any, *, serializer: Any = None):
        self.value = value
        self._serializer = serializer

    def __repr__(self) -> str:
        return f"pw.PyObjectWrapper({self.value!r})"

    def __eq__(self, other: Any) -> bool:
        return isinstance(other, PyObjectWrapper) and other.value == self.value

    def __hash__(self) -> int:
        try:
            return hash(("PyObjectWrapper", self.value))
        except TypeError:
            return hash(("PyObjectWrapper", id(type(self.value))))

    # pickle protocol: route through the chosen serializer so the durable
    # form is what the user asked for
    def __reduce__(self):
        ser = self._serializer
        if ser is not None:
            return (_rebuild_wrapped, (ser.dumps(self.value), ser))
        return (_rebuild_plain, (pickle.dumps(self.value, protocol=4),))


def _rebuild_plain(data: bytes) -> PyObjectWrapper:
    return PyObjectWrapper(pickle.loads(data))  # noqa: S301


def _rebuild_wrapped(data: bytes, serializer: Any) -> PyObjectWrapper:
    return PyObjectWrapper(serializer.loads(data), serializer=serializer)


def wrap_py_object(value: Any, *, serializer: Any = None) -> PyObjectWrapper:
    return PyObjectWrapper(value, serializer=serializer)
