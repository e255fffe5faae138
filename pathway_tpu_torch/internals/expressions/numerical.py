"""`.num` expression namespace (reference: internals/expressions/numerical.py)."""

from __future__ import annotations

import math
from typing import Any

import numpy as np

from pathway_tpu_torch.internals import dtype as dt
from pathway_tpu_torch.internals.expression import ColumnExpression, MethodCallExpression, wrap_arg


def _m(name: str, expr: ColumnExpression, *args: Any, fn: Any, rt: Any, vfn: Any = None):
    return MethodCallExpression(f"num.{name}", expr, *args, fn=fn, return_type=rt,
                                vectorized_fn=vfn)


class NumericalNamespace:
    def __init__(self, expr: ColumnExpression):
        self._expr = expr

    def abs(self):
        return _m("abs", self._expr, fn=abs, rt=None, vfn=np.abs)

    def round(self, decimals: Any = 0):
        return _m("round", self._expr, wrap_arg(decimals),
                  fn=lambda x, d: round(x, d), rt=None)

    def fill_na(self, default_value: Any):
        def f(x, d):
            if x is None:
                return d
            if isinstance(x, float) and math.isnan(x):
                return d
            return x
        return _m("fill_na", self._expr, wrap_arg(default_value), fn=f, rt=None)

    def sqrt(self):
        return _m("sqrt", self._expr, fn=math.sqrt, rt=dt.FLOAT, vfn=np.sqrt)

    def exp(self):
        return _m("exp", self._expr, fn=math.exp, rt=dt.FLOAT, vfn=np.exp)

    def log(self, base: Any = math.e):
        return _m("log", self._expr, wrap_arg(base), fn=math.log, rt=dt.FLOAT)

    def floor(self):
        return _m("floor", self._expr, fn=math.floor, rt=dt.INT, vfn=np.floor)

    def ceil(self):
        return _m("ceil", self._expr, fn=math.ceil, rt=dt.INT, vfn=np.ceil)

    def sin(self):
        return _m("sin", self._expr, fn=math.sin, rt=dt.FLOAT, vfn=np.sin)

    def cos(self):
        return _m("cos", self._expr, fn=math.cos, rt=dt.FLOAT, vfn=np.cos)

    def tanh(self):
        return _m("tanh", self._expr, fn=math.tanh, rt=dt.FLOAT, vfn=np.tanh)
