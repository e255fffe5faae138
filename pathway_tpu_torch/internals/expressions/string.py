"""`.str` expression namespace (reference: internals/expressions/string.py)."""

from __future__ import annotations

from typing import Any

from pathway_tpu_torch.internals import dtype as dt
from pathway_tpu_torch.internals.expression import ColumnExpression, MethodCallExpression, wrap_arg


def _m(name: str, expr: ColumnExpression, *args: Any, fn: Any, rt: Any) -> MethodCallExpression:
    return MethodCallExpression(f"str.{name}", expr, *args, fn=fn, return_type=rt)


class StringNamespace:
    def __init__(self, expr: ColumnExpression):
        self._expr = expr

    def lower(self):
        return _m("lower", self._expr, fn=lambda s: s.lower(), rt=dt.STR)

    def upper(self):
        return _m("upper", self._expr, fn=lambda s: s.upper(), rt=dt.STR)

    def reversed(self):
        return _m("reversed", self._expr, fn=lambda s: s[::-1], rt=dt.STR)

    def strip(self, chars=None):
        return _m("strip", self._expr, wrap_arg(chars), fn=lambda s, c: s.strip(c), rt=dt.STR)

    def removeprefix(self, prefix):
        return _m("removeprefix", self._expr, wrap_arg(prefix),
                  fn=lambda s, p: s.removeprefix(p), rt=dt.STR)

    def removesuffix(self, suffix):
        return _m("removesuffix", self._expr, wrap_arg(suffix),
                  fn=lambda s, p: s.removesuffix(p), rt=dt.STR)

    def lstrip(self, chars=None):
        return _m("lstrip", self._expr, wrap_arg(chars), fn=lambda s, c: s.lstrip(c), rt=dt.STR)

    def rstrip(self, chars=None):
        return _m("rstrip", self._expr, wrap_arg(chars), fn=lambda s, c: s.rstrip(c), rt=dt.STR)

    def len(self):
        return _m("len", self._expr, fn=lambda s: len(s), rt=dt.INT)

    def startswith(self, prefix):
        return _m("startswith", self._expr, wrap_arg(prefix), fn=lambda s, p: s.startswith(p), rt=dt.BOOL)

    def endswith(self, suffix):
        return _m("endswith", self._expr, wrap_arg(suffix), fn=lambda s, p: s.endswith(p), rt=dt.BOOL)

    def count(self, sub, start=None, end=None):
        return _m(
            "count", self._expr, wrap_arg(sub), wrap_arg(start), wrap_arg(end),
            fn=lambda s, x, a, b: s.count(x, a, b), rt=dt.INT,
        )

    def find(self, sub, start=None, end=None):
        return _m(
            "find", self._expr, wrap_arg(sub), wrap_arg(start), wrap_arg(end),
            fn=lambda s, x, a, b: s.find(x, a, b), rt=dt.INT,
        )

    def rfind(self, sub, start=None, end=None):
        return _m(
            "rfind", self._expr, wrap_arg(sub), wrap_arg(start), wrap_arg(end),
            fn=lambda s, x, a, b: s.rfind(x, a, b), rt=dt.INT,
        )

    def index(self, sub):
        return _m("index", self._expr, wrap_arg(sub), fn=lambda s, x: s.index(x), rt=dt.INT)

    def replace(self, old, new, count=-1):
        return _m(
            "replace", self._expr, wrap_arg(old), wrap_arg(new), wrap_arg(count),
            fn=lambda s, o, n, c: s.replace(o, n, c), rt=dt.STR,
        )

    def split(self, sep=None, maxsplit=-1):
        return _m(
            "split", self._expr, wrap_arg(sep), wrap_arg(maxsplit),
            fn=lambda s, sep_, m: tuple(s.split(sep_, m)), rt=dt.List(dt.STR),
        )

    def title(self):
        return _m("title", self._expr, fn=lambda s: s.title(), rt=dt.STR)

    def capitalize(self):
        return _m("capitalize", self._expr, fn=lambda s: s.capitalize(), rt=dt.STR)

    def casefold(self):
        return _m("casefold", self._expr, fn=lambda s: s.casefold(), rt=dt.STR)

    def swapcase(self):
        return _m("swapcase", self._expr, fn=lambda s: s.swapcase(), rt=dt.STR)

    def ljust(self, width, fillchar=" "):
        return _m("ljust", self._expr, wrap_arg(width), wrap_arg(fillchar),
                  fn=lambda s, w, f: s.ljust(w, f), rt=dt.STR)

    def rjust(self, width, fillchar=" "):
        return _m("rjust", self._expr, wrap_arg(width), wrap_arg(fillchar),
                  fn=lambda s, w, f: s.rjust(w, f), rt=dt.STR)

    def zfill(self, width):
        return _m("zfill", self._expr, wrap_arg(width), fn=lambda s, w: s.zfill(w), rt=dt.STR)

    def slice(self, start, end):
        return _m("slice", self._expr, wrap_arg(start), wrap_arg(end),
                  fn=lambda s, a, b: s[a:b], rt=dt.STR)

    def parse_int(self, optional: bool = False):
        def f(s):
            try:
                return int(s)
            except (ValueError, TypeError):
                if optional:
                    return None
                raise
        return _m("parse_int", self._expr, fn=f,
                  rt=dt.Optional(dt.INT) if optional else dt.INT)

    def parse_float(self, optional: bool = False):
        def f(s):
            try:
                return float(s)
            except (ValueError, TypeError):
                if optional:
                    return None
                raise
        return _m("parse_float", self._expr, fn=f,
                  rt=dt.Optional(dt.FLOAT) if optional else dt.FLOAT)

    def parse_bool(self, true_values=("on", "true", "yes", "1"),
                   false_values=("off", "false", "no", "0"), optional: bool = False):
        tv = {str(v).lower() for v in true_values}
        fv = {str(v).lower() for v in false_values}

        def f(s):
            ls = s.lower()
            if ls in tv:
                return True
            if ls in fv:
                return False
            if optional:
                return None
            raise ValueError(f"cannot parse {s!r} as bool")
        return _m("parse_bool", self._expr, fn=f,
                  rt=dt.Optional(dt.BOOL) if optional else dt.BOOL)

    def to_bytes(self, encoding: str = "utf-8"):
        return _m("to_bytes", self._expr, fn=lambda s: s.encode(encoding), rt=dt.BYTES)

    def contains(self, sub):
        return _m("contains", self._expr, wrap_arg(sub), fn=lambda s, x: x in s, rt=dt.BOOL)
