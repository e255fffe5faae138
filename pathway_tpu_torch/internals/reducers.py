"""Reducers: aggregation functions for groupby/reduce.

Reference: src/engine/reduce.rs:22 (Reducer enum) +
python/pathway/internals/reducers.py. Each reducer is described by a small
algebra: invertible reducers (sum/count) update incrementally under
retraction; non-invertible ones (min/max/unique/...) recompute from the
group's maintained value multiset. `np_sum`/`np_max` style array reducers
accumulate on the numeric plane.
"""

from __future__ import annotations

import builtins

from typing import Any, Callable

import numpy as np

from pathway_tpu_torch.internals import dtype as dt
from pathway_tpu_torch.internals.expression import (
    ColumnExpression,
    ReducerExpression,
    wrap_arg,
)


class Reducer:
    """Engine-level reducer descriptor."""

    name: str = "reducer"
    invertible: bool = False
    n_args: int = 1

    def neutral(self) -> Any:
        return None

    def add(self, acc: Any, values: tuple, count: int) -> Any:
        raise NotImplementedError

    def extract(self, acc: Any) -> Any:
        return acc

    def from_multiset(self, entries: list[tuple[tuple, int]]) -> Any:
        """Recompute from [(values_tuple, count), ...]; used when not invertible."""
        acc = self.neutral()
        for values, count in entries:
            acc = self.add(acc, values, count)
        return self.extract(acc)

    def result_dtype(self, arg_dtypes: list[dt.DType]) -> dt.DType:
        return arg_dtypes[0] if arg_dtypes else dt.ANY


class CountReducer(Reducer):
    name = "count"
    invertible = True
    n_args = 0

    def neutral(self) -> int:
        return 0

    def add(self, acc: int, values: tuple, count: int) -> int:
        return acc + count

    def result_dtype(self, arg_dtypes):
        return dt.INT


class SumReducer(Reducer):
    name = "sum"
    invertible = True

    def neutral(self):
        return None

    def add(self, acc, values, count):
        v = values[0]
        if isinstance(v, np.ndarray):
            term = v * count
        else:
            term = v * count
        return term if acc is None else acc + term

    def result_dtype(self, arg_dtypes):
        return arg_dtypes[0]


class AvgReducer(Reducer):
    name = "avg"
    invertible = True

    def neutral(self):
        return (0.0, 0)

    def add(self, acc, values, count):
        s, n = acc
        return (s + values[0] * count, n + count)

    def extract(self, acc):
        s, n = acc
        return s / n if n else None

    def result_dtype(self, arg_dtypes):
        return dt.FLOAT


class MinReducer(Reducer):
    name = "min"

    def from_multiset(self, entries):
        vals = [v[0] for v, c in entries if c > 0]
        return builtins.min(vals) if vals else None


class MaxReducer(Reducer):
    name = "max"

    def from_multiset(self, entries):
        vals = [v[0] for v, c in entries if c > 0]
        return builtins.max(vals) if vals else None


class ArgMinReducer(Reducer):
    name = "argmin"
    n_args = 2

    def from_multiset(self, entries):
        best = None
        for (v, arg), c in ((e[0], e[1]) for e in entries):
            if c <= 0:
                continue
            if best is None or (v, arg) < best:
                best = (v, arg)
        return best[1] if best else None

    def result_dtype(self, arg_dtypes):
        return arg_dtypes[1] if len(arg_dtypes) > 1 else dt.ANY_POINTER


class ArgMaxReducer(Reducer):
    name = "argmax"
    n_args = 2

    def from_multiset(self, entries):
        best = None
        for (v, arg), c in ((e[0], e[1]) for e in entries):
            if c <= 0:
                continue
            if best is None or v > best[0] or (v == best[0] and arg < best[1]):
                best = (v, arg)
        return best[1] if best else None

    def result_dtype(self, arg_dtypes):
        return arg_dtypes[1] if len(arg_dtypes) > 1 else dt.ANY_POINTER


class UniqueReducer(Reducer):
    name = "unique"

    def from_multiset(self, entries):
        vals = {v[0] for v, c in entries if c > 0}
        if len(vals) != 1:
            from pathway_tpu_torch.internals.errors import ERROR

            return ERROR
        return vals.pop()


class AnyReducer(Reducer):
    name = "any"

    def from_multiset(self, entries):
        for v, c in entries:
            if c > 0:
                return v[0]
        return None


class SortedTupleReducer(Reducer):
    name = "sorted_tuple"

    def __init__(self, skip_nones: bool = False):
        self.skip_nones = skip_nones

    def from_multiset(self, entries):
        out = []
        for v, c in entries:
            if c > 0 and not (self.skip_nones and v[0] is None):
                out.extend([v[0]] * c)
        try:
            return builtins.tuple(sorted(out))
        except TypeError:
            return builtins.tuple(sorted(out, key=repr))

    def result_dtype(self, arg_dtypes):
        return dt.List(arg_dtypes[0] if arg_dtypes else dt.ANY)


class TupleReducer(Reducer):
    """Collect values ordered by (instance/time-of-insert) — we order by key."""

    name = "tuple"
    n_args = 2  # (value, sort_key)

    def __init__(self, skip_nones: bool = False):
        self.skip_nones = skip_nones

    def from_multiset(self, entries):
        out = []
        for v, c in entries:
            if c > 0 and not (self.skip_nones and v[0] is None):
                out.extend([(v[1], v[0])] * c)
        out.sort(key=lambda p: _sort_key(p[0]))
        return builtins.tuple(v for _, v in out)

    def result_dtype(self, arg_dtypes):
        return dt.List(arg_dtypes[0] if arg_dtypes else dt.ANY)


def _sort_key(v: Any):
    try:
        hash(v)
    except TypeError:
        return (2, repr(v))
    if isinstance(v, (int, float, bool, np.integer, np.floating)):
        return (0, float(v))
    return (1, repr(v))


class NdarrayReducer(Reducer):
    name = "ndarray"
    n_args = 2  # (value, sort_key)

    def __init__(self, skip_nones: bool = False):
        self.skip_nones = skip_nones

    def from_multiset(self, entries):
        out = []
        for v, c in entries:
            if c > 0 and not (self.skip_nones and v[0] is None):
                out.extend([(v[1], v[0])] * c)
        out.sort(key=lambda p: _sort_key(p[0]))
        return np.array([v for _, v in out])

    def result_dtype(self, arg_dtypes):
        return dt.ANY_ARRAY


class EarliestReducer(Reducer):
    """Value from the row with the smallest processing time (reduce.rs Earliest)."""

    name = "earliest"
    n_args = 2  # (value, engine_time)

    def from_multiset(self, entries):
        best = None
        for (v, t), c in ((e[0], e[1]) for e in entries):
            if c > 0 and (best is None or t < best[0]):
                best = (t, v)
        return best[1] if best else None


class LatestReducer(Reducer):
    name = "latest"
    n_args = 2

    def from_multiset(self, entries):
        best = None
        for (v, t), c in ((e[0], e[1]) for e in entries):
            if c > 0 and (best is None or t >= best[0]):
                best = (t, v)
        return best[1] if best else None


class StatefulReducer(Reducer):
    """User combine_fn folded over batches in time order
    (reference: operators/stateful_reduce.rs:20)."""

    name = "stateful"

    def __init__(self, combine_fn: Callable):
        self.combine_fn = combine_fn

    def result_dtype(self, arg_dtypes):
        return dt.ANY


# ---------------------------------------------------------------- public API


def count(*args: Any) -> ReducerExpression:
    return ReducerExpression(CountReducer(), *args)


def sum(expr: Any) -> ReducerExpression:  # noqa: A001
    return ReducerExpression(SumReducer(), expr)


def avg(expr: Any) -> ReducerExpression:
    return ReducerExpression(AvgReducer(), expr)


def int_sum(expr: Any) -> ReducerExpression:
    """Deprecated alias of sum (reference: reducers.py:611)."""
    import warnings

    warnings.warn(
        "reducers.int_sum is deprecated, use reducers.sum instead",
        DeprecationWarning,
        stacklevel=2,
    )
    return sum(expr)


def npsum(expr: Any) -> ReducerExpression:
    """Deprecated alias of sum for ndarray columns (reference:
    reducers.py:547)."""
    import warnings

    warnings.warn(
        "reducers.npsum is deprecated, use reducers.sum instead",
        DeprecationWarning,
        stacklevel=2,
    )
    return sum(expr)


def min(expr: Any) -> ReducerExpression:  # noqa: A001
    return ReducerExpression(MinReducer(), expr)


def max(expr: Any) -> ReducerExpression:  # noqa: A001
    return ReducerExpression(MaxReducer(), expr)


def argmin(expr: Any) -> ReducerExpression:
    from pathway_tpu_torch.internals.expression import IdReference, this

    return ReducerExpression(ArgMinReducer(), expr, IdReference(this))


def argmax(expr: Any) -> ReducerExpression:
    from pathway_tpu_torch.internals.expression import IdReference, this

    return ReducerExpression(ArgMaxReducer(), expr, IdReference(this))


def unique(expr: Any) -> ReducerExpression:
    return ReducerExpression(UniqueReducer(), expr)


def any(expr: Any) -> ReducerExpression:  # noqa: A001
    return ReducerExpression(AnyReducer(), expr)


def sorted_tuple(expr: Any, *, skip_nones: bool = False) -> ReducerExpression:
    return ReducerExpression(SortedTupleReducer(skip_nones), expr)


def tuple(expr: Any, *, skip_nones: bool = False) -> ReducerExpression:  # noqa: A001
    from pathway_tpu_torch.internals.expression import IdReference, this

    return ReducerExpression(TupleReducer(skip_nones), expr, IdReference(this))


def ndarray(expr: Any, *, skip_nones: bool = False) -> ReducerExpression:
    from pathway_tpu_torch.internals.expression import IdReference, this

    return ReducerExpression(NdarrayReducer(skip_nones), expr, IdReference(this))


def earliest(expr: Any) -> ReducerExpression:
    return ReducerExpression(EarliestReducer(), expr, _EngineTimeMarker())


def latest(expr: Any) -> ReducerExpression:
    return ReducerExpression(LatestReducer(), expr, _EngineTimeMarker())


class _EngineTimeMarker(ColumnExpression):
    """Placeholder expression resolved to the engine processing time."""


def udf_reducer(reducer_cls: Any):
    """Decorator form for custom accumulator reducers — see custom_reducers."""
    from pathway_tpu_torch.internals.custom_reducers import make_udf_reducer

    return make_udf_reducer(reducer_cls)


def stateful_many(combine_fn: Callable) -> Callable:
    def reducer_factory(*args: Any) -> ReducerExpression:
        return ReducerExpression(StatefulReducer(combine_fn), *args)

    return reducer_factory


def stateful_single(combine_fn: Callable) -> Callable:
    """Wrap a per-row stateful fn into stateful_many (reference: custom_reducers.py:108)."""

    def combine_many(state: Any, rows: list[tuple[list[Any], int]]) -> Any:
        for row, cnt in rows:
            if cnt <= 0:
                raise ValueError("stateful_single does not support retractions")
            for _ in range(cnt):
                state = combine_fn(state, *row)
        return state

    return stateful_many(combine_many)
