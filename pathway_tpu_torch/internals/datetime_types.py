"""Engine time types: DateTimeNaive, DateTimeUtc, Duration.

Reference: src/engine/time.rs (chrono-backed). Here: nanosecond-precision
int64 epochs — the same fixed-width representation the numeric plane uses,
so datetime columns pack into int64 device buffers and window-id computation
can run as XLA integer math.
"""

from __future__ import annotations

import datetime as _dt
import re
from typing import Any, Union

import numpy as np

NS = 1
US = 1_000
MS = 1_000_000
SEC = 1_000_000_000
MIN = 60 * SEC
HOUR = 60 * MIN
DAY = 24 * HOUR
WEEK = 7 * DAY

# chrono-style format codes -> python strftime (subset; %3f/%6f/%9f fractional)
_CHRONO_TO_PY = {
    "%Y": "%Y", "%m": "%m", "%d": "%d", "%H": "%H", "%M": "%M", "%S": "%S",
    "%y": "%y", "%b": "%b", "%B": "%B", "%a": "%a", "%A": "%A", "%j": "%j",
    "%z": "%z", "%Z": "%Z", "%p": "%p", "%I": "%I", "%T": "%H:%M:%S",
    "%F": "%Y-%m-%d",
}


class Duration:
    """Signed nanosecond duration."""

    __slots__ = ("_ns",)

    def __init__(
        self,
        value: Union[int, float, _dt.timedelta, "Duration", None] = None,
        *,
        weeks: float = 0, days: float = 0, hours: float = 0, minutes: float = 0,
        seconds: float = 0, milliseconds: float = 0, microseconds: float = 0,
        nanoseconds: int = 0,
    ):
        if isinstance(value, Duration):
            ns = value._ns
        elif isinstance(value, _dt.timedelta):
            ns = int(value.total_seconds() * SEC)
        elif isinstance(value, (int, np.integer)):
            ns = int(value)
        elif isinstance(value, float):
            ns = int(value)
        elif value is None:
            ns = 0
        else:
            raise TypeError(f"cannot make Duration from {value!r}")
        ns += int(weeks * WEEK + days * DAY + hours * HOUR + minutes * MIN
                  + seconds * SEC + milliseconds * MS + microseconds * US + nanoseconds)
        self._ns = ns

    def nanoseconds(self) -> int:
        return self._ns

    def microseconds(self) -> int:
        return self._ns // US

    def milliseconds(self) -> int:
        return self._ns // MS

    def seconds(self) -> int:
        return self._ns // SEC

    def minutes(self) -> int:
        return self._ns // MIN

    def hours(self) -> int:
        return self._ns // HOUR

    def days(self) -> int:
        return self._ns // DAY

    def weeks(self) -> int:
        return self._ns // WEEK

    def to_timedelta(self) -> _dt.timedelta:
        return _dt.timedelta(microseconds=self._ns / 1000)

    def __repr__(self) -> str:
        return f"Duration({self.to_timedelta()!s})"

    def __eq__(self, o: Any) -> bool:
        return isinstance(o, Duration) and self._ns == o._ns

    def __hash__(self) -> int:
        return hash(("Duration", self._ns))

    def __lt__(self, o: "Duration") -> bool:
        return self._ns < _dur_ns(o)

    def __le__(self, o: "Duration") -> bool:
        return self._ns <= _dur_ns(o)

    def __gt__(self, o: "Duration") -> bool:
        return self._ns > _dur_ns(o)

    def __ge__(self, o: "Duration") -> bool:
        return self._ns >= _dur_ns(o)

    def __add__(self, o: Any):
        if isinstance(o, (Duration, _dt.timedelta)):
            return Duration(self._ns + _dur_ns(o))
        if isinstance(o, (DateTimeNaive, DateTimeUtc)):
            return o + self
        return NotImplemented

    __radd__ = __add__

    def __sub__(self, o: Any):
        if isinstance(o, (Duration, _dt.timedelta)):
            return Duration(self._ns - _dur_ns(o))
        return NotImplemented

    def __rsub__(self, o: Any):
        if isinstance(o, (Duration, _dt.timedelta)):
            return Duration(_dur_ns(o) - self._ns)
        return NotImplemented

    def __neg__(self) -> "Duration":
        return Duration(-self._ns)

    def __mul__(self, o: Any):
        if isinstance(o, (int, float, np.integer, np.floating)):
            return Duration(int(self._ns * o))
        return NotImplemented

    __rmul__ = __mul__

    def __truediv__(self, o: Any):
        if isinstance(o, (Duration, _dt.timedelta)):
            return self._ns / _dur_ns(o)
        if isinstance(o, (int, float)):
            return Duration(int(self._ns / o))
        return NotImplemented

    def __floordiv__(self, o: Any):
        if isinstance(o, (Duration, _dt.timedelta)):
            return self._ns // _dur_ns(o)
        return NotImplemented

    def __mod__(self, o: Any):
        if isinstance(o, (Duration, _dt.timedelta)):
            return Duration(self._ns % _dur_ns(o))
        return NotImplemented


def _dur_ns(d: Any) -> int:
    if isinstance(d, Duration):
        return d._ns
    if isinstance(d, _dt.timedelta):
        return int(d.total_seconds() * SEC)
    raise TypeError(f"expected Duration, got {d!r}")


class _DateTimeBase:
    __slots__ = ("_ns",)
    _utc: bool = False

    def __init__(self, value: Any = None, fmt: str | None = None, *, ns: int | None = None):
        if ns is not None:
            self._ns = int(ns)
            return
        if isinstance(value, _DateTimeBase):
            self._ns = value._ns
        elif isinstance(value, (int, np.integer)):
            self._ns = int(value)
        elif isinstance(value, _dt.datetime):
            self._ns = _datetime_to_ns(value, self._utc)
        elif isinstance(value, str):
            self._ns = _parse_datetime(value, fmt, self._utc)
        elif isinstance(value, np.datetime64):
            self._ns = int(value.astype("datetime64[ns]").astype(np.int64))
        else:
            raise TypeError(f"cannot make datetime from {value!r}")

    def timestamp_ns(self) -> int:
        return self._ns

    def timestamp(self, unit: str = "ns") -> int | float:
        div = {"ns": NS, "us": US, "ms": MS, "s": SEC}[unit]
        return self._ns / div if div != 1 else self._ns

    def to_datetime(self) -> _dt.datetime:
        tz = _dt.timezone.utc if self._utc else None
        return _dt.datetime.fromtimestamp(self._ns / SEC, tz=tz)

    def _fields(self) -> _dt.datetime:
        if self._utc:
            return _dt.datetime.fromtimestamp(self._ns / SEC, tz=_dt.timezone.utc)
        return _dt.datetime.fromtimestamp(
            self._ns // SEC, tz=_dt.timezone.utc
        ).replace(tzinfo=None)

    def nanosecond(self) -> int:
        return self._ns % US

    def microsecond(self) -> int:
        return (self._ns % SEC) // US

    def millisecond(self) -> int:
        return (self._ns % SEC) // MS

    def second(self) -> int:
        return self._fields().second

    def minute(self) -> int:
        return self._fields().minute

    def hour(self) -> int:
        return self._fields().hour

    def day(self) -> int:
        return self._fields().day

    def month(self) -> int:
        return self._fields().month

    def year(self) -> int:
        return self._fields().year

    def weekday(self) -> int:
        return self._fields().weekday()

    def strftime(self, fmt: str) -> str:
        return _format_datetime(self._ns, fmt, self._utc)

    def round(self, duration: "Duration | str") -> "Any":
        d = _to_duration(duration)._ns
        half = d // 2
        return type(self)(ns=((self._ns + half) // d) * d)

    def floor(self, duration: "Duration | str") -> "Any":
        d = _to_duration(duration)._ns
        return type(self)(ns=(self._ns // d) * d)

    def __repr__(self) -> str:
        return f"{type(self).__name__}({self.strftime('%Y-%m-%dT%H:%M:%S.%9f')})"

    def __eq__(self, o: Any) -> bool:
        return type(o) is type(self) and self._ns == o._ns

    def __hash__(self) -> int:
        return hash((type(self).__name__, self._ns))

    def __lt__(self, o: Any) -> bool:
        return self._ns < o._ns

    def __le__(self, o: Any) -> bool:
        return self._ns <= o._ns

    def __gt__(self, o: Any) -> bool:
        return self._ns > o._ns

    def __ge__(self, o: Any) -> bool:
        return self._ns >= o._ns

    def __add__(self, o: Any):
        if isinstance(o, (Duration, _dt.timedelta)):
            return type(self)(ns=self._ns + _dur_ns(o))
        return NotImplemented

    def __sub__(self, o: Any):
        if isinstance(o, (Duration, _dt.timedelta)):
            return type(self)(ns=self._ns - _dur_ns(o))
        if type(o) is type(self):
            return Duration(self._ns - o._ns)
        return NotImplemented


class DateTimeNaive(_DateTimeBase):
    """Timezone-naive datetime, ns precision."""

    _utc = False


class DateTimeUtc(_DateTimeBase):
    """UTC datetime, ns precision."""

    _utc = True


def _datetime_to_ns(value: _dt.datetime, utc: bool) -> int:
    if value.tzinfo is not None:
        return int(value.timestamp() * SEC) + value.microsecond % 1 * 1000
    if utc:
        value = value.replace(tzinfo=_dt.timezone.utc)
        return int(value.timestamp()) * SEC + value.microsecond * 1000
    epoch = _dt.datetime(1970, 1, 1)
    delta = value - epoch
    return int(delta.days) * DAY + delta.seconds * SEC + delta.microseconds * 1000


_FRAC_RE = re.compile(r"%([369])f")
_ISO_FRAC_RE = re.compile(r"\.(\d+)")


def _parse_datetime(s: str, fmt: str | None, utc: bool) -> int:
    frac_ns = 0
    if fmt is None:
        # ISO-8601
        m = _ISO_FRAC_RE.search(s)
        if m:
            digits = m.group(1)[:9].ljust(9, "0")
            frac_ns = int(digits)
            s = s[: m.start()] + s[m.end():]
        try:
            dt = _dt.datetime.fromisoformat(s.replace("Z", "+00:00"))
        except ValueError:
            dt = _dt.datetime.strptime(s, "%Y-%m-%d")
        return _datetime_to_ns(dt, utc) + frac_ns

    pyfmt = fmt
    m = _FRAC_RE.search(pyfmt)
    n_frac = 0
    if m:
        n_frac = int(m.group(1))
        # grab the fractional digits manually: replace with %f then fix
        pyfmt = _FRAC_RE.sub("%f", pyfmt)
    try:
        dt = _dt.datetime.strptime(s, pyfmt)
    except ValueError as e:
        raise ValueError(f"cannot parse {s!r} with format {fmt!r}: {e}") from None
    ns = _datetime_to_ns(dt.replace(microsecond=0), utc)
    if "%f" in pyfmt:
        if n_frac in (3, 6, 9):
            # strptime scaled to microseconds already
            ns += dt.microsecond * 1000
        else:
            ns += dt.microsecond * 1000
    return ns


def _format_datetime(ns: int, fmt: str, utc: bool) -> str:
    dt = _dt.datetime.fromtimestamp(ns // SEC, tz=_dt.timezone.utc)
    if not utc:
        dt = dt.replace(tzinfo=None)
    sub_ns = ns % SEC

    def frac_repl(m: re.Match) -> str:
        n = int(m.group(1))
        return f"{sub_ns:09d}"[:n]

    fmt = _FRAC_RE.sub(frac_repl, fmt)
    fmt = fmt.replace("%f", f"{sub_ns // 1000:06d}")
    return dt.strftime(fmt)


_DUR_STR_RE = re.compile(r"^\s*(\d+)\s*(ns|us|ms|s|m|min|h|d|w)\s*$")
_DUR_UNITS = {"ns": NS, "us": US, "ms": MS, "s": SEC, "m": MIN, "min": MIN,
              "h": HOUR, "d": DAY, "w": WEEK}


def _to_duration(d: Any) -> Duration:
    if isinstance(d, Duration):
        return d
    if isinstance(d, _dt.timedelta):
        return Duration(d)
    if isinstance(d, str):
        m = _DUR_STR_RE.match(d)
        if not m:
            raise ValueError(f"cannot parse duration {d!r}")
        return Duration(int(m.group(1)) * _DUR_UNITS[m.group(2)])
    if isinstance(d, (int, np.integer)):
        return Duration(int(d))
    raise TypeError(f"cannot convert {d!r} to Duration")
