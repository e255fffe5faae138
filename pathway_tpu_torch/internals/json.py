"""pw.Json — JSON value wrapper (reference: python/pathway/internals/json.py:1)."""

from __future__ import annotations

import json as _json
from typing import Any, Iterator


class Json:
    """Immutable wrapper around a parsed JSON value."""

    NULL: "Json"

    __slots__ = ("_value",)

    def __init__(self, value: Any = None):
        if isinstance(value, Json):
            value = value._value
        self._value = value

    @property
    def value(self) -> Any:
        return self._value

    def __repr__(self) -> str:
        return f"pw.Json({self._value!r})"

    def __str__(self) -> str:
        return Json.dumps(self._value)

    def __eq__(self, other: Any) -> bool:
        if isinstance(other, Json):
            return self._value == other._value
        return self._value == other

    def __hash__(self) -> int:
        return hash(Json.dumps(self._value))

    def __getitem__(self, key: Any) -> "Json":
        v = self._value
        if isinstance(key, Json):
            key = key._value
        try:
            return Json(v[key])
        except (KeyError, IndexError, TypeError):
            raise KeyError(key)

    def get(self, key: Any, default: Any = None) -> Any:
        try:
            return self[key]
        except KeyError:
            return Json(default) if not isinstance(default, Json) else default

    def __iter__(self) -> Iterator["Json"]:
        if isinstance(self._value, dict):
            return (Json(k) for k in self._value)
        if isinstance(self._value, (list, tuple)):
            return (Json(v) for v in self._value)
        raise TypeError(f"pw.Json {self._value!r} is not iterable")

    def __len__(self) -> int:
        return len(self._value)

    def __bool__(self) -> bool:
        return bool(self._value)

    # --- conversions (API parity with reference .as_* methods) ---
    def as_int(self) -> int | None:
        if isinstance(self._value, bool):
            return None
        return self._value if isinstance(self._value, int) else None

    def as_float(self) -> float | None:
        if isinstance(self._value, (int, float)) and not isinstance(self._value, bool):
            return float(self._value)
        return None

    def as_str(self) -> str | None:
        return self._value if isinstance(self._value, str) else None

    def as_bool(self) -> bool | None:
        return self._value if isinstance(self._value, bool) else None

    def as_list(self) -> list | None:
        return self._value if isinstance(self._value, list) else None

    def as_dict(self) -> dict | None:
        return self._value if isinstance(self._value, dict) else None

    @staticmethod
    def parse(s: str | bytes) -> "Json":
        return Json(_json.loads(s))

    @staticmethod
    def dumps(value: Any, **kwargs: Any) -> str:
        return _json.dumps(value, sort_keys=True, separators=(",", ":"), default=_default, **kwargs)


def _default(obj: Any) -> Any:
    if isinstance(obj, Json):
        return obj.value
    import numpy as np

    if isinstance(obj, np.ndarray):
        return obj.tolist()
    if isinstance(obj, (np.integer,)):
        return int(obj)
    if isinstance(obj, (np.floating,)):
        return float(obj)
    from pathway_tpu_torch.internals.keys import Key

    if isinstance(obj, Key):
        return str(obj)
    return str(obj)


Json.NULL = Json(None)
