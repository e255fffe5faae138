"""Windows: tumbling / sliding / session / intervals_over + windowby.

Reference: stdlib/temporal/_window.py (session :595, sliding :660,
tumbling :737, intervals_over :795, windowby :865). Windows lower to: a
rowwise window-id assignment (+ flatten for overlapping windows), optional
behavior ops (engine buffer/forget/freeze), then a groupby on
(_pw_window, _pw_instance).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import pathway_tpu_torch.internals.reducers as red
from pathway_tpu_torch.internals import dtype as dt
from pathway_tpu_torch.internals import expression as ex
from pathway_tpu_torch.internals.common import apply_with_type, if_else
from pathway_tpu_torch.internals.expression import ColumnExpression, wrap_arg
from pathway_tpu_torch.internals.groupbys import GroupedTable
from pathway_tpu_torch.internals.table import Table
from pathway_tpu_torch.stdlib.temporal.temporal_behavior import (
    CommonBehavior,
    ExactlyOnceBehavior,
)


def _num(v: Any) -> Any:
    """Window arithmetic works for both numeric and datetime/duration cols."""
    return v


class Window:
    def assign(
        self,
        table: Table,
        time_expr: ColumnExpression,
        extra: dict | None = None,
    ) -> Table:
        """Return table with added columns: _pw_window_start,
        _pw_window_end, _pw_shard_time (original time), plus any `extra`
        columns — folded into the SAME select where possible, so the
        whole window assignment is one row-build pass over the wave."""
        raise NotImplementedError


@dataclass
class TumblingWindow(Window):
    duration: Any
    origin: Any = None
    offset: Any = None

    def assign(
        self,
        table: Table,
        time_expr: ColumnExpression,
        extra: dict | None = None,
    ) -> Table:
        duration = self.duration
        origin = self.origin if self.origin is not None else self.offset

        if isinstance(duration, (int, float)) and (
            origin is None or isinstance(origin, (int, float))
        ):
            # numeric times: pure expression arithmetic — vectorizable,
            # no tuple column, so rows stay token-resident through the
            # window assignment and the behavior buffer. _pw_window is
            # the window START (it uniquely identifies a tumbling window
            # for a fixed duration; window_join applies one window to
            # both sides, so equality semantics are unchanged). All four
            # columns (plus extras) build in ONE select: repeating the
            # start expression costs two vector subtracts, where a second
            # select would re-build every row in the wave.
            delta = (
                time_expr % duration
                if origin is None
                else (time_expr - origin) % duration
            )
            return table.with_columns(
                _pw_time=time_expr,
                _pw_window_start=time_expr - delta,
                _pw_window=time_expr - delta,
                _pw_window_end=time_expr - delta + duration,
                **(extra or {}),
            )

        def win(t: Any) -> Any:
            o = origin
            if o is None:
                o = t - t if not hasattr(t, "timestamp_ns") else type(t)(ns=0)
            k = (t - o) // duration
            return o + k * duration

        t2 = table.with_columns(
            _pw_window_start=apply_with_type(win, dt.ANY, time_expr),
            _pw_time=time_expr,
            **(extra or {}),
        )
        return t2.with_columns(
            _pw_window=ex.this._pw_window_start,
            _pw_window_end=ex.this._pw_window_start + duration,
        )


def tumbling(duration: Any, origin: Any = None, offset: Any = None) -> TumblingWindow:
    return TumblingWindow(duration, origin, offset)


@dataclass
class SlidingWindow(Window):
    hop: Any
    duration: Any = None
    ratio: int | None = None
    origin: Any = None
    offset: Any = None

    def assign(
        self,
        table: Table,
        time_expr: ColumnExpression,
        extra: dict | None = None,
    ) -> Table:
        hop = self.hop
        duration = self.duration if self.duration is not None else self.ratio * hop
        origin = self.origin if self.origin is not None else self.offset

        def windows(t: Any) -> tuple:
            o = origin
            if o is None:
                o = t - t if not hasattr(t, "timestamp_ns") else type(t)(ns=0)
            # all window starts s with s <= t < s + duration, s = o + k*hop
            first_k = (t - o - duration) // hop + 1
            out = []
            k = first_k
            while True:
                start = o + k * hop
                if start > t:
                    break
                if t < start + duration:
                    out.append((start, start + duration))
                k += 1
            return tuple(out)

        expanded = table.with_columns(
            _pw_windows=apply_with_type(windows, tuple, time_expr),
            _pw_time=time_expr,
            **(extra or {}),
        ).flatten(ex.this._pw_windows)
        return expanded.with_columns(
            _pw_window=ex.this._pw_windows,
            _pw_window_start=ex.this._pw_windows[0],
            _pw_window_end=ex.this._pw_windows[1],
        ).without("_pw_windows")


def sliding(
    hop: Any, duration: Any = None, ratio: int | None = None,
    origin: Any = None, offset: Any = None,
) -> SlidingWindow:
    return SlidingWindow(hop, duration, ratio, origin, offset)


@dataclass
class SessionWindow(Window):
    predicate: Any = None
    max_gap: Any = None

    def assign(self, table: Table, time_expr: ColumnExpression) -> Table:
        # windows form per-instance; assignment happens inside windowby
        raise RuntimeError("session windows are assigned within windowby")


def session(predicate: Any = None, max_gap: Any = None) -> SessionWindow:
    if (predicate is None) == (max_gap is None):
        raise ValueError("session(): provide exactly one of predicate / max_gap")
    return SessionWindow(predicate, max_gap)


@dataclass
class IntervalsOverWindow(Window):
    at: Any
    lower_bound: Any
    upper_bound: Any
    is_outer: bool = True


def intervals_over(
    *, at: Any, lower_bound: Any, upper_bound: Any, is_outer: bool = True
) -> IntervalsOverWindow:
    """Windows at each time t of `at` over [t+lower_bound, t+upper_bound].
    is_outer=True (the reference default) emits EVERY `at` point's window;
    empty ones carry a single all-None data row, so e.g. sorted_tuple
    reduces to (None,) (reference: _window.py:795 intervals_over)."""
    return IntervalsOverWindow(at, lower_bound, upper_bound, is_outer)


class WindowedTable:
    """Result of windowby: behaves like a GroupedTable whose grouping is
    (_pw_window, _pw_instance); reduce() exposes pw.this._pw_window_start
    etc."""

    def __init__(self, expanded: Table, instance_given: bool):
        self._expanded = expanded
        self._instance_given = instance_given

    def reduce(self, *args: Any, **kwargs: Any) -> Table:
        t = self._expanded
        gb_cols = [t._pw_window, t._pw_window_start, t._pw_window_end]
        if "_pw_window_location" in t._column_names():
            gb_cols.append(t._pw_window_location)  # intervals_over probes
        if self._instance_given:
            gb_cols.append(t._pw_instance)
        grouped = t.groupby(*gb_cols)
        # rewrite pw.this._pw_* references to the expanded table
        bound_kwargs = {}
        for name, e in kwargs.items():
            bound_kwargs[name] = _bind_this(wrap_arg(e), t)
        bound_args = []
        for a in args:
            if isinstance(a, ex.ColumnReference):
                if isinstance(a.table, ex.ThisMarker):
                    a = ex.ColumnReference(t, a.name)
            bound_args.append(a)
        return grouped.reduce(*bound_args, **bound_kwargs)


def _bind_this(e: ex.ColumnExpression, table: Table) -> ex.ColumnExpression:
    if isinstance(e, ex.ColumnReference) and isinstance(e.table, ex.ThisMarker):
        if isinstance(e, ex.IdReference):
            return ex.IdReference(table)
        return ex.ColumnReference(table, e.name)
    for name, val in list(vars(e).items()):
        if isinstance(val, ex.ColumnExpression):
            setattr(e, name, _bind_this(val, table))
        elif isinstance(val, tuple) and any(isinstance(v, ex.ColumnExpression) for v in val):
            setattr(e, name, tuple(
                _bind_this(v, table) if isinstance(v, ex.ColumnExpression) else v
                for v in val
            ))
    return e


def _assign_sessions(times_and_keys: tuple, max_gap: Any, predicate: Any) -> tuple:
    """Given sorted ((t, key), ...) produce ((key, start, end), ...)."""
    out = []
    cur: list[tuple] = []
    prev_t = None
    for (t, key) in times_and_keys:
        if prev_t is not None:
            joinable = (
                predicate(prev_t, t) if predicate is not None else (t - prev_t) < max_gap
            )
        else:
            joinable = True
        if not joinable and cur:
            start, end = cur[0][0], cur[-1][0]
            for (ct, ck) in cur:
                out.append((ck, start, end))
            cur = []
        cur.append((t, key))
        prev_t = t
    if cur:
        start, end = cur[0][0], cur[-1][0]
        for (ct, ck) in cur:
            out.append((ck, start, end))
    return tuple(out)


def windowby(
    table: Table,
    time_expr: ColumnExpression,
    *,
    window: Window,
    instance: Any = None,
    behavior: Any = None,
    shard: Any = None,
) -> WindowedTable:
    if instance is None and shard is not None:
        instance = shard
    time_expr = _bind_this(wrap_arg(time_expr), table)
    if instance is not None:
        instance = _bind_this(wrap_arg(instance), table)

    if isinstance(window, SessionWindow):
        expanded = _windowby_session(table, time_expr, window, instance)
    elif isinstance(window, IntervalsOverWindow):
        expanded = _windowby_intervals_over(table, time_expr, window, instance)
    else:
        # _pw_instance folds into the window-assign select: one row-build
        # pass for the whole assignment instead of a second full-wave map
        expanded = window.assign(
            table, time_expr,
            extra={"_pw_instance": instance if instance is not None else 0},
        )

    # Behavior operator ORDER mirrors the reference exactly
    # (reference _window.py:395-415): the cutoff FREEZE sits UPSTREAM of
    # the buffer so its watermark advances with every arriving row —
    # downstream of the buffer it would only see released rows, lag
    # behind, and let late window updates through (breaking
    # exactly-once). After the buffer, event times clamp to the release
    # time so the post-buffer forget's watermark tracks releases.
    if isinstance(behavior, ExactlyOnceBehavior):
        # reference: common_behavior(duration + shift, shift, True)
        shift = behavior.shift
        thr = (
            ex.this._pw_window_end
            if shift is None
            else ex.this._pw_window_end + shift
        )
        expanded = expanded._freeze(
            _bind_this(thr, expanded), ex.ColumnReference(expanded, "_pw_time")
        )
        thr = (
            ex.this._pw_window_end
            if shift is None
            else ex.this._pw_window_end + shift
        )
        expanded = expanded._buffer(
            _bind_this(thr, expanded), ex.ColumnReference(expanded, "_pw_time")
        )
    elif isinstance(behavior, CommonBehavior):
        if behavior.cutoff is not None:
            expanded = expanded._freeze(
                ex.ColumnReference(expanded, "_pw_window_end") + behavior.cutoff,
                ex.ColumnReference(expanded, "_pw_time"),
            )
        if behavior.delay is not None:
            release = (
                ex.ColumnReference(expanded, "_pw_window_start") + behavior.delay
            )
            expanded = expanded._buffer(
                release, ex.ColumnReference(expanded, "_pw_time")
            )
            if behavior.cutoff is not None and not behavior.keep_results:
                # clamp event times to the release time so the post-
                # buffer forget's watermark tracks releases — only the
                # forget consumes this (vectorized: if_else compiles to
                # a numpy plan, so the wave stays token-resident)
                expanded = expanded.with_columns(
                    _pw_time=if_else(
                        ex.ColumnReference(expanded, "_pw_time")
                        > ex.ColumnReference(expanded, "_pw_window_start")
                        + behavior.delay,
                        ex.ColumnReference(expanded, "_pw_time"),
                        ex.ColumnReference(expanded, "_pw_window_start")
                        + behavior.delay,
                    )
                )
        if behavior.cutoff is not None and not behavior.keep_results:
            expanded = expanded._forget(
                ex.ColumnReference(expanded, "_pw_window_end") + behavior.cutoff,
                ex.ColumnReference(expanded, "_pw_time"),
            )

    return WindowedTable(expanded, True)


def _windowby_session(
    table: Table, time_expr: ColumnExpression, window: SessionWindow, instance: Any
) -> Table:
    inst_expr = instance if instance is not None else wrap_arg(0)
    base = table.with_columns(_pw_time=time_expr, _pw_instance=inst_expr)
    # per instance: collect sorted (t, key), segment into sessions
    per_inst = base.groupby(base._pw_instance).reduce(
        base._pw_instance,
        _pw_sessions=ex.ApplyExpression(
            _assign_sessions,
            tuple,
            red.sorted_tuple(ex.MakeTupleExpression(ex.this._pw_time, ex.this.id)),
            window.max_gap,
            window.predicate,
        ),
    )
    flat = per_inst.flatten(per_inst._pw_sessions)
    assignments = flat.select(
        _pw_key=ex.this._pw_sessions[0],
        _pw_window_start=ex.this._pw_sessions[1],
        _pw_window_end=ex.this._pw_sessions[2],
        _pw_instance=ex.this._pw_instance,
    ).with_id(ex.this._pw_key)
    joined = base.join(
        assignments, base.id == assignments._pw_key, id=base.id
    ).select(
        *[ex.ColumnReference(base, n) for n in table._column_names()],
        _pw_time=ex.left._pw_time,
        _pw_instance=ex.right._pw_instance,
        _pw_window_start=ex.right._pw_window_start,
        _pw_window_end=ex.right._pw_window_end,
    )
    return joined.with_columns(
        _pw_window=ex.MakeTupleExpression(
            ex.this._pw_instance, ex.this._pw_window_start, ex.this._pw_window_end
        )
    )


def _windowby_intervals_over(
    table: Table, time_expr: ColumnExpression, window: IntervalsOverWindow, instance: Any
) -> Table:
    at_ref = window.at
    at_table: Table = at_ref.table
    lb, ub = window.lower_bound, window.upper_bound
    span = ub - lb

    def buckets_of(t: Any) -> tuple:
        b = t // span if not hasattr(t, "timestamp_ns") else t.timestamp_ns() // int(span)
        return (b - 1, b, b + 1)

    # expand data rows to covering buckets of their time
    data = table.with_columns(_pw_time=time_expr, _pw_instance=instance if instance is not None else 0)
    data_b = data.with_columns(
        _pw_bucket=apply_with_type(lambda t: (t // span) if not hasattr(t, "timestamp_ns") else t.timestamp_ns() // int(span), int, ex.this._pw_time)
    )
    # expand window centers to all buckets their interval overlaps
    centers = at_table.select(_pw_at=at_ref).with_columns(
        _pw_buckets=apply_with_type(
            lambda t: tuple(
                range(
                    int(((t + lb) // span) if not hasattr(t, "timestamp_ns") else (t + lb).timestamp_ns() // int(span)),
                    int(((t + ub) // span) if not hasattr(t, "timestamp_ns") else (t + ub).timestamp_ns() // int(span)) + 1,
                )
            ),
            tuple,
            ex.this._pw_at,
        )
    ).flatten(ex.this._pw_buckets)
    joined = data_b.join(
        centers, data_b._pw_bucket == centers._pw_buckets
    ).select(
        *[ex.ColumnReference(data_b, n) for n in table._column_names()],
        _pw_time=ex.left._pw_time,
        _pw_instance=ex.left._pw_instance,
        _pw_at=ex.right._pw_at,
    ).filter(
        (ex.this._pw_time >= ex.this._pw_at + lb)
        & (ex.this._pw_time <= ex.this._pw_at + ub)
    )
    expanded = joined.with_columns(
        _pw_window=ex.this._pw_at,
        _pw_window_start=ex.this._pw_at + lb,
        _pw_window_end=ex.this._pw_at + ub,
        _pw_window_location=ex.this._pw_at,
    )
    if window.is_outer:
        # outer windows: every `at` point yields a window even with no
        # data in [at+lb, at+ub] — one all-None data row per empty
        # window, exactly the reference's LEFT interval_join row
        # (reference: _window.py _IntervalsOverWindow._apply:555,
        # tests/temporal/test_windows.py is_outer=True fixture)
        at_distinct = (
            at_table.select(_pw_at=at_ref)
            .groupby(ex.this._pw_at)
            .reduce(_pw_at=ex.this._pw_at)
            .with_id_from(ex.this._pw_at)
        )
        have = (
            joined.groupby(ex.this._pw_at)
            .reduce(_pw_at=ex.this._pw_at)
            .with_id_from(ex.this._pw_at)
        )
        missing = at_distinct.join_left(
            have, at_distinct._pw_at == have._pw_at
        ).select(
            _pw_at=ex.left._pw_at, _pw_hit=ex.right._pw_at
        ).filter(ex.this._pw_hit.is_none())
        empty = missing.select(
            **{n: None for n in table._column_names()},
            _pw_time=None,
            _pw_instance=None,
            _pw_at=ex.this._pw_at,
            _pw_window=ex.this._pw_at,
            _pw_window_start=ex.this._pw_at + lb,
            _pw_window_end=ex.this._pw_at + ub,
            _pw_window_location=ex.this._pw_at,
        )
        expanded = expanded.concat_reindex(empty)
    return expanded
