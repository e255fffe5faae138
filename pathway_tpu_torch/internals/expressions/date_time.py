"""`.dt` expression namespace (reference: internals/expressions/date_time.py).

Operates on DateTimeNaive/DateTimeUtc/Duration (ns-int backed), so most
methods are integer math — the vectorized path maps them onto int64 device
columns.
"""

from __future__ import annotations

from typing import Any

from pathway_tpu_torch.internals import dtype as dt
from pathway_tpu_torch.internals.datetime_types import (
    DateTimeNaive,
    DateTimeUtc,
    Duration,
    _to_duration,
)
from pathway_tpu_torch.internals.expression import ColumnExpression, MethodCallExpression, wrap_arg


def _m(name: str, expr: ColumnExpression, *args: Any, fn: Any, rt: Any):
    return MethodCallExpression(f"dt.{name}", expr, *args, fn=fn, return_type=rt)


def _utc_to_wall_ns(utc_ns: int, tz_name: str) -> int:
    """UTC instant (ns) -> local wall-clock ns in tz_name. Offsets are
    whole minutes, so sub-second precision carries through exactly."""
    from datetime import datetime, timezone
    from zoneinfo import ZoneInfo

    sec, rem = divmod(utc_ns, 1_000_000_000)
    local = datetime.fromtimestamp(sec, timezone.utc).astimezone(ZoneInfo(tz_name))
    offset = int(local.utcoffset().total_seconds())  # type: ignore[union-attr]
    return (sec + offset) * 1_000_000_000 + rem


def _wall_to_utc_ns(wall_ns: int, tz_name: str) -> int:
    """Local wall-clock ns in tz_name -> UTC instant ns (ambiguous DST
    times resolve to the pre-transition offset, like fold=0)."""
    from datetime import datetime, timezone
    from zoneinfo import ZoneInfo

    sec, rem = divmod(wall_ns, 1_000_000_000)
    naive = datetime.fromtimestamp(sec, timezone.utc).replace(tzinfo=None)
    local = naive.replace(tzinfo=ZoneInfo(tz_name))
    offset = int(local.utcoffset().total_seconds())  # type: ignore[union-attr]
    return (sec - offset) * 1_000_000_000 + rem


class DateTimeNamespace:
    def __init__(self, expr: ColumnExpression):
        self._expr = expr

    # field accessors
    def nanosecond(self):
        return _m("nanosecond", self._expr, fn=lambda x: x.nanosecond(), rt=dt.INT)

    def microsecond(self):
        return _m("microsecond", self._expr, fn=lambda x: x.microsecond(), rt=dt.INT)

    def millisecond(self):
        return _m("millisecond", self._expr, fn=lambda x: x.millisecond(), rt=dt.INT)

    def second(self):
        return _m("second", self._expr, fn=lambda x: x.second(), rt=dt.INT)

    def minute(self):
        return _m("minute", self._expr, fn=lambda x: x.minute(), rt=dt.INT)

    def hour(self):
        return _m("hour", self._expr, fn=lambda x: x.hour(), rt=dt.INT)

    def day(self):
        return _m("day", self._expr, fn=lambda x: x.day(), rt=dt.INT)

    def month(self):
        return _m("month", self._expr, fn=lambda x: x.month(), rt=dt.INT)

    def year(self):
        return _m("year", self._expr, fn=lambda x: x.year(), rt=dt.INT)

    def weekday(self):
        return _m("weekday", self._expr, fn=lambda x: x.weekday(), rt=dt.INT)

    def timestamp(self, unit: str = "ns"):
        return _m("timestamp", self._expr, fn=lambda x: x.timestamp(unit),
                  rt=dt.INT if unit == "ns" else dt.FLOAT)

    # parsing / formatting
    def strptime(self, fmt: Any = None, contains_timezone: bool = False):
        cls = DateTimeUtc if contains_timezone else DateTimeNaive

        def f(s, fmt_):
            return cls(s, fmt=fmt_)

        return _m("strptime", self._expr, wrap_arg(fmt), fn=f,
                  rt=dt.DATE_TIME_UTC if contains_timezone else dt.DATE_TIME_NAIVE)

    def strftime(self, fmt: Any):
        return _m("strftime", self._expr, wrap_arg(fmt),
                  fn=lambda x, fmt_: x.strftime(fmt_), rt=dt.STR)

    def to_naive(self, timezone: str = "UTC"):
        def f(x):
            if isinstance(x, DateTimeUtc):
                return DateTimeNaive(ns=x.timestamp_ns())
            return x
        return _m("to_naive", self._expr, fn=f, rt=dt.DATE_TIME_NAIVE)

    def to_utc(self, from_timezone: str = "UTC"):
        def f(x):
            if isinstance(x, DateTimeNaive):
                return DateTimeUtc(ns=_wall_to_utc_ns(x.timestamp_ns(), from_timezone))
            return x
        return _m("to_utc", self._expr, fn=f, rt=dt.DATE_TIME_UTC)

    def to_naive_in_timezone(self, timezone: str):
        """UTC instant -> wall-clock time in `timezone` (reference
        date_time.py to_naive_in_timezone)."""
        return _m(
            "to_naive_in_timezone", self._expr,
            fn=lambda x: DateTimeNaive(ns=_utc_to_wall_ns(x.timestamp_ns(), timezone)),
            rt=dt.DATE_TIME_NAIVE,
        )

    def add_duration_in_timezone(self, duration: Any, timezone: str):
        """Wall-clock addition: +24h across a DST switch lands on the same
        local hour (reference date_time.py add_duration_in_timezone)."""
        def f(x, d):
            wall = _utc_to_wall_ns(x.timestamp_ns(), timezone)
            return DateTimeUtc(
                ns=_wall_to_utc_ns(wall + _to_duration(d).nanoseconds(), timezone)
            )

        return _m("add_duration_in_timezone", self._expr, wrap_arg(duration),
                  fn=f, rt=dt.DATE_TIME_UTC)

    def subtract_duration_in_timezone(self, duration: Any, timezone: str):
        def f(x, d):
            wall = _utc_to_wall_ns(x.timestamp_ns(), timezone)
            return DateTimeUtc(
                ns=_wall_to_utc_ns(wall - _to_duration(d).nanoseconds(), timezone)
            )

        return _m("subtract_duration_in_timezone", self._expr, wrap_arg(duration),
                  fn=f, rt=dt.DATE_TIME_UTC)

    def subtract_date_time_in_timezone(self, other: Any, timezone: str):
        """Difference measured on the wall clock of `timezone` (reference
        date_time.py subtract_date_time_in_timezone)."""
        def f(x, y):
            a = _utc_to_wall_ns(x.timestamp_ns(), timezone)
            b = _utc_to_wall_ns(y.timestamp_ns(), timezone)
            return Duration(ns=a - b)

        return _m("subtract_date_time_in_timezone", self._expr, wrap_arg(other),
                  fn=f, rt=dt.DURATION)

    def round(self, duration: Any):
        return _m("round", self._expr, wrap_arg(duration),
                  fn=lambda x, d: x.round(_to_duration(d)), rt=None)

    def floor(self, duration: Any):
        return _m("floor", self._expr, wrap_arg(duration),
                  fn=lambda x, d: x.floor(_to_duration(d)), rt=None)

    def from_timestamp(self, unit: str = "s"):
        mult = {"s": 1_000_000_000, "ms": 1_000_000, "us": 1_000, "ns": 1}[unit]
        return _m("from_timestamp", self._expr,
                  fn=lambda x: DateTimeNaive(ns=int(x * mult)), rt=dt.DATE_TIME_NAIVE)

    def utc_from_timestamp(self, unit: str = "s"):
        mult = {"s": 1_000_000_000, "ms": 1_000_000, "us": 1_000, "ns": 1}[unit]
        return _m("utc_from_timestamp", self._expr,
                  fn=lambda x: DateTimeUtc(ns=int(x * mult)), rt=dt.DATE_TIME_UTC)

    # duration accessors
    def nanoseconds(self):
        return _m("nanoseconds", self._expr, fn=lambda d: d.nanoseconds(), rt=dt.INT)

    def microseconds(self):
        return _m("microseconds", self._expr, fn=lambda d: d.microseconds(), rt=dt.INT)

    def milliseconds(self):
        return _m("milliseconds", self._expr, fn=lambda d: d.milliseconds(), rt=dt.INT)

    def seconds(self):
        return _m("seconds", self._expr, fn=lambda d: d.seconds(), rt=dt.INT)

    def minutes(self):
        return _m("minutes", self._expr, fn=lambda d: d.minutes(), rt=dt.INT)

    def hours(self):
        return _m("hours", self._expr, fn=lambda d: d.hours(), rt=dt.INT)

    def days(self):
        return _m("days", self._expr, fn=lambda d: d.days(), rt=dt.INT)

    def weeks(self):
        return _m("weeks", self._expr, fn=lambda d: d.weeks(), rt=dt.INT)
