"""Error poison values and the global error log.

Reference: src/engine/value.rs `Value::Error` + python/pathway/internals/errors.py.
An expression that fails per-row yields ERROR instead of aborting the run
(unless terminate_on_error); errors propagate through downstream expressions
and can be filtered via `remove_errors` / inspected via `global_error_log()`.
"""

from __future__ import annotations

from typing import Any


class ErrorValue:
    """Singleton-ish poison value carried in rows."""

    __slots__ = ("message",)

    def __init__(self, message: str = ""):
        self.message = message

    def __repr__(self) -> str:
        return "Error"

    def __eq__(self, other: Any) -> bool:
        return isinstance(other, ErrorValue)

    def __hash__(self) -> int:
        return hash("pathway-error")

    def __bool__(self) -> bool:
        raise TypeError("cannot convert Error value to bool")


ERROR = ErrorValue()


def is_error(value: Any) -> bool:
    return isinstance(value, ErrorValue)


class ErrorLog:
    """Collects (message,) rows during a run; exposed as a table."""

    def __init__(self) -> None:
        self.entries: list[str] = []

    def log(self, message: str) -> None:
        self.entries.append(message)


_global_error_log = ErrorLog()


def global_error_log() -> ErrorLog:
    return _global_error_log
