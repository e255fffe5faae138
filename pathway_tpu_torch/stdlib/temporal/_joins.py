"""Temporal joins: interval_join, window_join, asof_join, asof_now_join.

Reference: stdlib/temporal/_interval_join.py (:41 interval, :577-1404 join
variants), _window_join.py, _asof_join.py (:479-1000), _asof_now_join.py
(:176-332). Strategy here: bucketize event times so the equi-join engine op
does the heavy lifting, then filter exactly; outer variants pad via key-set
difference.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import pathway_tpu_torch.internals.reducers as red
from pathway_tpu_torch.internals import expression as ex
from pathway_tpu_torch.internals.common import apply_with_type, coalesce
from pathway_tpu_torch.internals.expression import wrap_arg
from pathway_tpu_torch.internals import universe as univ_mod
from pathway_tpu_torch.internals.table import JoinMode, Table


@dataclass
class Interval:
    lower_bound: Any
    upper_bound: Any


def interval(lower_bound: Any, upper_bound: Any) -> Interval:
    return Interval(lower_bound, upper_bound)


def _as_int(t: Any) -> int:
    if hasattr(t, "timestamp_ns"):
        return t.timestamp_ns()
    if hasattr(t, "nanoseconds"):
        return t.nanoseconds()
    return t


class IntervalJoinResult:
    def __init__(
        self,
        left: Table,
        right: Table,
        left_time: ex.ColumnExpression,
        right_time: ex.ColumnExpression,
        iv: Interval,
        on: tuple,
        mode: str,
    ):
        self._left = left
        self._right = right
        self._lt = left_time
        self._rt = right_time
        self._iv = iv
        self._on = on
        self._mode = mode

    def select(self, *args: Any, **kwargs: Any) -> Table:
        lb, ub = self._iv.lower_bound, self._iv.upper_bound
        span = max(_as_int(ub) - _as_int(lb), 1)
        left, right = self._left, self._right

        lt_named = left.with_columns(_pw_t=self._lt).with_columns(
            _pw_buckets=apply_with_type(
                lambda t: tuple(
                    range(
                        (_as_int(t) + _as_int(lb)) // span,
                        (_as_int(t) + _as_int(ub)) // span + 1,
                    )
                ),
                tuple,
                ex.this._pw_t,
            ),
            _pw_lkey=ex.this.id,
        )
        l_exp = lt_named.flatten(ex.this._pw_buckets)
        # two stages: _pw_bucket reads _pw_t, which must already exist on
        # the table (a same-select self-reference would resolve against
        # the RAW right table and fail at lowering)
        rt_named = right.with_columns(_pw_t=self._rt).with_columns(
            _pw_bucket=apply_with_type(lambda t: _as_int(t) // span, int, ex.this._pw_t),
            _pw_rkey=ex.this.id,
        )
        conds = [l_exp._pw_buckets == rt_named._pw_bucket]
        for cond in self._on:
            if not isinstance(cond, ex.BinaryOpExpression) or cond._op != "==":
                raise TypeError("interval_join `on` conditions must be equalities")
            lc = _rebind(cond._left, self._left, l_exp, self._right, rt_named)
            rc = _rebind(cond._right, self._left, l_exp, self._right, rt_named)
            conds.append(lc == rc)
        matched = l_exp.join(rt_named, *conds).select(
            *[ex.ColumnReference(l_exp, n) for n in left._column_names()],
            **{
                "_pw_lt": ex.left._pw_t,
                "_pw_rt": ex.right._pw_t,
                "_pw_lkey": ex.left._pw_lkey,
                "_pw_rkey": ex.right._pw_rkey,
            },
            **{
                n: ex.ColumnReference(rt_named, n)
                for n in right._column_names()
                if n not in left._column_names()
            },
        ).filter(
            (ex.this._pw_rt - ex.this._pw_lt >= lb)
            & (ex.this._pw_rt - ex.this._pw_lt <= ub)
        )

        out_kwargs = self._make_select(matched, left, right, args, kwargs)
        result = matched.select(**out_kwargs)

        if self._mode in (JoinMode.LEFT, JoinMode.OUTER):
            matched_keys = matched.groupby(matched._pw_lkey).reduce(
                k=matched._pw_lkey
            ).with_id(ex.this.k)
            unmatched = self._left.difference(matched_keys)
            pad = {}
            for name, e in out_kwargs.items():
                pad[name] = _pad_expr(e, self._left, unmatched, right_side=self._right)
            padded = unmatched.select(**pad)
            # join-output keys are (lkey, rkey) hashes; padded rows keep
            # left keys — distinct key spaces by construction
            univ_mod.promise_are_pairwise_disjoint(result, padded)
            result = result.concat(padded)
        if self._mode in (JoinMode.RIGHT, JoinMode.OUTER):
            matched_rkeys = matched.groupby(matched._pw_rkey).reduce(
                k=matched._pw_rkey
            ).with_id(ex.this.k)
            unmatched_r = self._right.difference(matched_rkeys)
            pad = {}
            for name, e in out_kwargs.items():
                pad[name] = _pad_expr(e, self._right, unmatched_r, right_side=self._left)
            padded_r = unmatched_r.select(**pad)
            univ_mod.promise_are_pairwise_disjoint(result, padded_r)
            result = result.concat(padded_r)
        return result

    def _make_select(
        self, matched: Table, left: Table, right: Table, args: tuple, kwargs: dict
    ) -> dict[str, ex.ColumnExpression]:
        out: dict[str, ex.ColumnExpression] = {}
        for a in args:
            if isinstance(a, ex.ThisSplat):
                for n in left._column_names():
                    out[n] = ex.ColumnReference(matched, n)
                for n in right._column_names():
                    if n not in out:
                        out[n] = ex.ColumnReference(matched, n)
            elif isinstance(a, ex.ColumnReference):
                out[a.name] = ex.ColumnReference(matched, a.name)
        for name, e in kwargs.items():
            out[name] = _rebind(wrap_arg(e), left, matched, right, matched)
        return out


def _rebind(
    e: ex.ColumnExpression, left: Table, left_sub: Table, right: Table, right_sub: Table
) -> ex.ColumnExpression:
    """Rebind refs to left/right (or pw.left/pw.right/pw.this) onto the
    expanded/matched tables by column name."""
    if isinstance(e, ex.ColumnReference):
        tab = e.table
        if isinstance(tab, ex.ThisMarker):
            side = tab._side
            target = left_sub if side in ("left", "this") else right_sub
            if side == "this" and e.name not in left_sub._column_names():
                target = right_sub
            return ex.ColumnReference(target, e.name)
        if tab is left:
            return ex.ColumnReference(left_sub, e.name)
        if tab is right:
            return ex.ColumnReference(right_sub, e.name)
        return e
    import copy

    e2 = copy.copy(e)
    for name, val in list(vars(e2).items()):
        if isinstance(val, ex.ColumnExpression):
            setattr(e2, name, _rebind(val, left, left_sub, right, right_sub))
        elif isinstance(val, tuple) and any(isinstance(v, ex.ColumnExpression) for v in val):
            setattr(e2, name, tuple(
                _rebind(v, left, left_sub, right, right_sub)
                if isinstance(v, ex.ColumnExpression) else v
                for v in val
            ))
    return e2


def _pad_expr(
    e: ex.ColumnExpression, side: Table, side_sub: Table, right_side: Table
) -> ex.ColumnExpression:
    """Project an output expression for unmatched rows: side columns bind to
    the row, the other side's columns become None."""
    if isinstance(e, ex.ColumnReference):
        if e.name in side._column_names():
            return ex.ColumnReference(side_sub, e.name)
        return ex.ColumnConstExpression(None)
    import copy

    e2 = copy.copy(e)
    for name, val in list(vars(e2).items()):
        if isinstance(val, ex.ColumnExpression):
            setattr(e2, name, _pad_expr(val, side, side_sub, right_side))
        elif isinstance(val, tuple) and any(isinstance(v, ex.ColumnExpression) for v in val):
            setattr(e2, name, tuple(
                _pad_expr(v, side, side_sub, right_side)
                if isinstance(v, ex.ColumnExpression) else v
                for v in val
            ))
    return e2


def interval_join(
    self: Table, other: Table, self_time: Any, other_time: Any, iv: Interval,
    *on: Any, how: str = JoinMode.INNER, behavior: Any = None,
) -> IntervalJoinResult:
    return IntervalJoinResult(self, other, wrap_arg(self_time), wrap_arg(other_time), iv, on, how)


def interval_join_inner(self, other, self_time, other_time, iv, *on, **kw):
    return interval_join(self, other, self_time, other_time, iv, *on, how=JoinMode.INNER)


def interval_join_left(self, other, self_time, other_time, iv, *on, **kw):
    return interval_join(self, other, self_time, other_time, iv, *on, how=JoinMode.LEFT)


def interval_join_right(self, other, self_time, other_time, iv, *on, **kw):
    return interval_join(self, other, self_time, other_time, iv, *on, how=JoinMode.RIGHT)


def interval_join_outer(self, other, self_time, other_time, iv, *on, **kw):
    return interval_join(self, other, self_time, other_time, iv, *on, how=JoinMode.OUTER)


# ------------------------------------------------------------- window join


class WindowJoinResult:
    def __init__(self, left, right, left_time, right_time, window, on, mode):
        from pathway_tpu_torch.stdlib.temporal._window import Window

        self._left = left
        self._right = right
        self._lt = left_time
        self._rt = right_time
        self._window = window
        self._on = on
        self._mode = mode

    def select(self, *args: Any, **kwargs: Any) -> Table:
        l_exp = self._window.assign(self._left, wrap_arg(self._lt)).with_columns(
            _pw_lkey=ex.this.id
        )
        r_exp = self._window.assign(self._right, wrap_arg(self._rt)).with_columns(
            _pw_rkey=ex.this.id
        )
        conds = [l_exp._pw_window == r_exp._pw_window]
        for cond in self._on:
            lc = _rebind(cond._left, self._left, l_exp, self._right, r_exp)
            rc = _rebind(cond._right, self._left, l_exp, self._right, r_exp)
            conds.append(lc == rc)
        jr = l_exp.join(r_exp, *conds, how=self._mode)
        out: dict[str, ex.ColumnExpression] = {}
        for a in args:
            if isinstance(a, ex.ColumnReference):
                tab = a.table
                side = l_exp if (tab is self._left or (
                    isinstance(tab, ex.ThisMarker) and tab._side in ("left", "this")
                )) else r_exp
                out[a.name] = ex.ColumnReference(side, a.name)
        for name, e in kwargs.items():
            out[name] = _rebind(wrap_arg(e), self._left, l_exp, self._right, r_exp)
        out.setdefault("_pw_window_start", ex.ColumnReference(l_exp, "_pw_window_start"))
        return jr.select(**out)


def window_join(
    self: Table, other: Table, self_time: Any, other_time: Any, window: Any,
    *on: Any, how: str = JoinMode.INNER,
) -> WindowJoinResult:
    return WindowJoinResult(self, other, self_time, other_time, window, on, how)


def window_join_inner(self, other, st, ot, window, *on, **kw):
    return window_join(self, other, st, ot, window, *on, how=JoinMode.INNER)


def window_join_left(self, other, st, ot, window, *on, **kw):
    return window_join(self, other, st, ot, window, *on, how=JoinMode.LEFT)


def window_join_right(self, other, st, ot, window, *on, **kw):
    return window_join(self, other, st, ot, window, *on, how=JoinMode.RIGHT)


def window_join_outer(self, other, st, ot, window, *on, **kw):
    return window_join(self, other, st, ot, window, *on, how=JoinMode.OUTER)


# ---------------------------------------------------------------- asof join


class Direction:
    BACKWARD = "backward"
    FORWARD = "forward"
    NEAREST = "nearest"


def _asof_pick(pairs: tuple, t: Any, direction: str) -> Any:
    """pairs: sorted ((t', key), ...); pick per direction."""
    import bisect

    times = [p[0] for p in pairs]
    if direction == Direction.BACKWARD:
        i = bisect.bisect_right(times, t) - 1
        return pairs[i][1] if i >= 0 else None
    if direction == Direction.FORWARD:
        i = bisect.bisect_left(times, t)
        return pairs[i][1] if i < len(pairs) else None
    i = bisect.bisect_right(times, t) - 1
    cands = []
    if i >= 0:
        cands.append((abs(_as_int(t) - _as_int(times[i])), pairs[i][1]))
    if i + 1 < len(pairs):
        cands.append((abs(_as_int(times[i + 1]) - _as_int(t)), pairs[i + 1][1]))
    return min(cands)[1] if cands else None


class AsofJoinResult:
    def __init__(self, left, right, left_time, right_time, on, mode, direction, defaults):
        self._left = left
        self._right = right
        self._lt = wrap_arg(left_time)
        self._rt = wrap_arg(right_time)
        self._on = on
        self._mode = mode
        self._direction = direction
        self._defaults = defaults or {}

    def select(self, *args: Any, **kwargs: Any) -> Table:
        left, right = self._left, self._right
        # group right by the equality key, collect sorted (t, key)
        if self._on:
            cond = self._on[0]
            r_on = _rebind(cond._right, left, left, right, right)
            l_on = _rebind(cond._left, left, left, right, right)
        else:
            l_on = wrap_arg(0)
            r_on = wrap_arg(0)
        r_named = right.with_columns(_pw_t=self._rt, _pw_on=r_on)
        r_grouped = r_named.groupby(r_named._pw_on).reduce(
            _pw_on=r_named._pw_on,
            _pw_pairs=red.sorted_tuple(
                ex.MakeTupleExpression(ex.this._pw_t, ex.this.id)
            ),
        ).with_id_from(ex.this._pw_on)
        l_named = left.with_columns(_pw_t=self._lt, _pw_on=l_on)
        direction = self._direction
        looked = l_named.join_left(
            r_grouped, l_named._pw_on == r_grouped._pw_on, id=l_named.id
        ).select(
            *[ex.ColumnReference(l_named, n) for n in left._column_names()],
            _pw_t=ex.left._pw_t,
            _pw_match=ex.ApplyExpression(
                lambda pairs, t: _asof_pick(pairs, t, direction) if pairs else None,
                Any,
                ex.right._pw_pairs,
                ex.left._pw_t,
            ),
        )
        match_rows = right.ix(looked._pw_match, optional=True, context=looked)
        out: dict[str, ex.ColumnExpression] = {}
        for a in args:
            if isinstance(a, ex.ColumnReference):
                tab = a.table
                if tab is right or (isinstance(tab, ex.ThisMarker) and tab._side == "right"):
                    out[a.name] = ex.ColumnReference(match_rows, a.name)
                else:
                    out[a.name] = ex.ColumnReference(looked, a.name)
        for name, e in kwargs.items():
            out[name] = _rebind(wrap_arg(e), left, looked, right, match_rows)
        if self._mode == JoinMode.INNER:
            return looked.filter(looked._pw_match.is_not_none()).select(**{
                k: _rebind(v, left, ex.this, right, ex.this) if False else v
                for k, v in out.items()
            })
        return looked.select(**out)


def asof_join(
    self: Table, other: Table, self_time: Any, other_time: Any, *on: Any,
    how: str = JoinMode.LEFT, defaults: dict | None = None,
    direction: str = Direction.BACKWARD, behavior: Any = None,
) -> AsofJoinResult:
    return AsofJoinResult(self, other, self_time, other_time, on, how, direction, defaults)


def asof_join_left(self, other, st, ot, *on, **kw):
    kw.setdefault("how", JoinMode.LEFT)
    return asof_join(self, other, st, ot, *on, **kw)


def asof_join_right(self, other, st, ot, *on, **kw):
    return asof_join(other, self, ot, st, *on, **kw)


def asof_join_outer(self, other, st, ot, *on, **kw):
    kw["how"] = JoinMode.OUTER
    return asof_join(self, other, st, ot, *on, **kw)


# ------------------------------------------------------------ asof now join


class AsofNowJoinResult:
    """Query-stream join: left insertions join the right side's current
    state; results never re-update on right-side changes
    (reference: _asof_now_join.py:176)."""

    def __init__(self, left, right, on, mode):
        self._left = left
        self._right = right
        self._on = on
        self._mode = mode

    def select(self, *args: Any, **kwargs: Any) -> Table:
        from pathway_tpu_torch.internals.joins import JoinResult

        jr = JoinResult(self._left, self._right, self._on, self._mode, id=None)
        out = jr.select(*args, **kwargs)
        out._spec.params["asof_now"] = True
        return out


def asof_now_join(
    self: Table, other: Table, *on: Any, how: str = JoinMode.INNER,
    id: Any = None, **kw: Any,  # noqa: A002
) -> AsofNowJoinResult:
    return AsofNowJoinResult(self, other, on, how)


def asof_now_join_inner(self, other, *on, **kw):
    return asof_now_join(self, other, *on, how=JoinMode.INNER)


def asof_now_join_left(self, other, *on, **kw):
    return asof_now_join(self, other, *on, how=JoinMode.LEFT)
