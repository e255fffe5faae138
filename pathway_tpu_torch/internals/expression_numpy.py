"""Vectorized (numpy) compilation of numeric column expressions.

The token-resident batch path (engine/native/dataplane.py) decodes numeric
columns into flat arrays; this module compiles a `ColumnExpression` into a
plan evaluating directly on those arrays — the whole-batch replacement for
the per-row interpreted closures of `expression_compiler.py`.

Python numeric semantics are preserved row-wise:
  * int op int -> int, any float operand -> float (per ROW, not per
    column — JSON-parsed columns hold literal-faithful values);
  * rows whose int result may exceed the float53 exactness window are
    flagged BAD rather than silently wrapped;
  * division by zero / None operands / type errors -> BAD rows.
BAD rows land in tag 2: the aggregation error bucket for reducer args, or
the per-row Python fallback for map outputs (which reproduces the exact
ERROR + error-log behavior).

Reference parity: the reference evaluates expressions inside the engine on
typed Values (src/engine/expression.rs); this is the batched equivalent.
"""

from __future__ import annotations

from typing import Any, Callable

import numpy as np

from pathway_tpu_torch.internals import expression as ex

_F53 = float(1 << 53)  # |int| beyond this is not exactly representable


class _V:
    """A vectorized value: float view + int view + row masks."""

    __slots__ = ("vf", "vi", "isint", "isbool", "bad")

    def __init__(self, vf, vi, isint, isbool, bad):
        self.vf = vf  # float64 [n] — valid where not bad
        self.vi = vi  # int64 [n] — valid where isint (or isbool)
        self.isint = isint  # bool [n]
        self.isbool = isbool  # bool [n] (subset semantics: vi in {0,1})
        self.bad = bad  # bool [n] — error / fallback rows


class KeyColsPlan:
    """A pointer_from(...) value slot: the key128 computes in C from the
    projected column pieces (dp_rekey, byte-identical to key_for_values).
    MapNode special-cases this plan type — it needs row tokens, not
    decoded columns."""

    def __init__(self, cols: list[int]):
        self.cols = cols
        self.needed_cols: set[int] = set()


class NumpyPlan:
    """Compiled expression: eval(decoded_cols, n) -> (vi, vf, tag)."""

    def __init__(self, fn: Callable, needed_cols: set[int]):
        self._fn = fn
        self.needed_cols = needed_cols

    def eval_v(self, decoded: dict, n: int) -> _V:
        return self._fn(decoded, n)

    def eval(self, decoded: dict, n: int):
        """zs_agg layout: tag 0 int (vi), 1 float (vf), 2 bad."""
        v = self._fn(decoded, n)
        tag = np.where(v.bad, np.uint8(2), np.where(v.isint, 0, 1)).astype(np.uint8)
        vi = np.where(v.isint & ~v.bad, v.vi, 0)
        vf = np.where(~v.isint & ~v.bad, v.vf, 0.0)
        return vi.astype(np.int64), vf.astype(np.float64), tag

    def eval_map(self, decoded: dict, n: int):
        """dp_build_rows layout: (vi, vf, vtag) with vtag 0 int, 1 float,
        3 bool, 255 python-fallback."""
        v = self._fn(decoded, n)
        vtag = np.where(
            v.bad,
            np.uint8(255),
            np.where(v.isbool, np.uint8(3), np.where(v.isint, 0, 1)),
        ).astype(np.uint8)
        return v.vi.astype(np.int64), v.vf.astype(np.float64), vtag

    def eval_mask(self, decoded: dict, n: int):
        """Filter predicates: (keep_mask, fallback_mask). Non-bool truthy
        values follow Python truthiness on numerics."""
        v = self._fn(decoded, n)
        keep = np.where(v.isint | v.isbool, v.vi != 0, v.vf != 0.0)
        return keep & ~v.bad, v.bad


def _leaf_col(idx: int) -> Callable:
    def fn(decoded, n):
        vi, vf, tg = decoded[idx]
        isbool = tg == 3  # decode preserves boolness (dataplane tag 3)
        isint = (tg == 0) | isbool
        bad = tg == 2
        vf_full = np.where(isint, vi.astype(np.float64), vf)
        return _V(vf_full, vi, isint, isbool, bad)

    return fn


def _leaf_const(v: Any) -> Callable | None:
    if isinstance(v, bool):
        def fn(decoded, n):
            vi = np.full(n, 1 if v else 0, np.int64)
            return _V(vi.astype(np.float64), vi, np.ones(n, bool),
                      np.ones(n, bool), np.zeros(n, bool))
        return fn
    if isinstance(v, int):
        if abs(v) >= 1 << 62:
            return None
        def fn(decoded, n):
            vi = np.full(n, v, np.int64)
            return _V(vi.astype(np.float64), vi, np.ones(n, bool),
                      np.zeros(n, bool), np.zeros(n, bool))
        return fn
    if isinstance(v, float):
        def fn(decoded, n):
            return _V(np.full(n, v, np.float64), np.zeros(n, np.int64),
                      np.zeros(n, bool), np.zeros(n, bool), np.zeros(n, bool))
        return fn
    return None


def _arith(op: str, lf: Callable, rf: Callable) -> Callable:
    def fn(decoded, n):
        a = lf(decoded, n)
        b = rf(decoded, n)
        bad = a.bad | b.bad
        isint = a.isint & b.isint
        with np.errstate(all="ignore"):
            if op == "+":
                vf = a.vf + b.vf
                vi = a.vi + b.vi
            elif op == "-":
                vf = a.vf - b.vf
                vi = a.vi - b.vi
            elif op == "*":
                vf = a.vf * b.vf
                vi = a.vi * b.vi
            elif op == "/":
                bad = bad | (b.vf == 0.0)  # ZeroDivisionError rows
                vf = np.where(b.vf != 0.0, a.vf / np.where(b.vf != 0.0, b.vf, 1.0), 0.0)
                vi = np.zeros(n, np.int64)
                isint = np.zeros(n, bool)  # Python / is always float
            elif op == "//":
                bad = bad | (b.vf == 0.0)
                safe_f = np.where(b.vf != 0.0, b.vf, 1.0)
                vf = np.floor(a.vf / safe_f)
                safe_i = np.where(b.vi != 0, b.vi, 1)
                vi = np.where(isint, a.vi, 0) // np.where(isint, safe_i, 1)
            elif op == "%":
                bad = bad | (b.vf == 0.0)
                safe_f = np.where(b.vf != 0.0, b.vf, 1.0)
                vf = np.mod(a.vf, safe_f)
                safe_i = np.where(b.vi != 0, b.vi, 1)
                vi = np.mod(np.where(isint, a.vi, 0), np.where(isint, safe_i, 1))
            elif op == "**":
                # int ** negative-int is float in Python; 0 ** negative
                # raises — keep ** conservative: fall back unless both
                # operands are exact and the result stays in range
                vf = np.power(a.vf, b.vf)
                vi = np.zeros(n, np.int64)
                neg_exp = b.vf < 0
                isint = isint & ~neg_exp
                with np.errstate(all="ignore"):
                    vi = np.where(
                        isint, np.power(a.vi, np.maximum(b.vi, 0)), 0
                    )
                bad = bad | ~np.isfinite(vf) & (a.vf != 0.0) | ((a.vf == 0.0) & neg_exp)
            else:
                raise AssertionError(op)
        # int-result exactness window: |result| >= 2^53 may differ from
        # the arbitrary-precision Python value -> bad (Python fallback)
        if op in ("+", "-", "*", "//", "%", "**"):
            bad = bad | (isint & (np.abs(vf) >= _F53))
        return _V(vf, vi, isint, np.zeros(n, bool), bad)

    return fn


def _compare(op: str, lf: Callable, rf: Callable) -> Callable:
    def fn(decoded, n):
        a = lf(decoded, n)
        b = rf(decoded, n)
        bad = a.bad | b.bad
        # giant-int comparisons via float lose precision -> bad
        bad = bad | (a.isint & (np.abs(a.vf) >= _F53)) | (
            b.isint & (np.abs(b.vf) >= _F53)
        )
        with np.errstate(all="ignore"):
            if op == "==":
                m = a.vf == b.vf
            elif op == "!=":
                m = a.vf != b.vf
            elif op == "<":
                m = a.vf < b.vf
            elif op == "<=":
                m = a.vf <= b.vf
            elif op == ">":
                m = a.vf > b.vf
            elif op == ">=":
                m = a.vf >= b.vf
            else:
                raise AssertionError(op)
        vi = m.astype(np.int64)
        ones = np.ones(n, bool)
        return _V(vi.astype(np.float64), vi, ones, ones, bad)

    return fn


def _boolean(op: str, lf: Callable, rf: Callable) -> Callable:
    def fn(decoded, n):
        a = lf(decoded, n)
        b = rf(decoded, n)
        # Python & | ^ on bools; non-bool operands -> int bitwise, which
        # we only allow when both are ints
        bad = a.bad | b.bad | ~(a.isint | a.isbool) | ~(b.isint | b.isbool)
        if op == "&":
            vi = a.vi & b.vi
        elif op == "|":
            vi = a.vi | b.vi
        else:
            vi = a.vi ^ b.vi
        isbool = a.isbool & b.isbool
        return _V(vi.astype(np.float64), vi, np.ones(n, bool), isbool, bad)

    return fn


def compile_numpy(
    expr: ex.ColumnExpression, names: list[str]
) -> NumpyPlan | None:
    """Compile `expr` over a single table's columns (by name -> index);
    None when the expression shape isn't vectorizable (the caller keeps
    the per-row path)."""
    needed: set[int] = set()

    def rec(e: ex.ColumnExpression) -> Callable | None:
        if isinstance(e, ex.ColumnConstExpression):
            return _leaf_const(e._value)
        if isinstance(e, ex.IdReference):
            return None
        if isinstance(e, ex.ColumnReference):
            if e.name not in names:
                return None
            idx = names.index(e.name)
            needed.add(idx)
            return _leaf_col(idx)
        if isinstance(e, ex.BinaryOpExpression):
            lf = rec(e._left)
            rf = rec(e._right)
            if lf is None or rf is None:
                return None
            if e._op in ("+", "-", "*", "/", "//", "%", "**"):
                return _arith(e._op, lf, rf)
            if e._op in ("==", "!=", "<", "<=", ">", ">="):
                return _compare(e._op, lf, rf)
            if e._op in ("&", "|", "^"):
                return _boolean(e._op, lf, rf)
            return None
        if isinstance(e, ex.UnaryOpExpression):
            f = rec(e._expr)
            if f is None:
                return None
            if e._op == "-":
                def neg(decoded, n, _f=f):
                    v = _f(decoded, n)
                    return _V(-v.vf, -v.vi, v.isint, np.zeros(n, bool), v.bad)
                return neg
            if e._op == "~":
                def inv(decoded, n, _f=f):
                    v = _f(decoded, n)
                    bad = v.bad | ~(v.isint | v.isbool)
                    if True:
                        # Python: ~bool -> int (~True == -2); bools fall
                        # back so the per-row path matches exactly
                        bad = bad | v.isbool
                    return _V(
                        (~v.vi).astype(np.float64), ~v.vi,
                        np.ones(n, bool), np.zeros(n, bool), bad,
                    )
                return inv
            if e._op == "abs":
                def vabs(decoded, n, _f=f):
                    v = _f(decoded, n)
                    return _V(np.abs(v.vf), np.abs(v.vi), v.isint,
                              np.zeros(n, bool), v.bad)
                return vabs
            return None
        if isinstance(e, ex.IfElseExpression):
            cf = rec(e._if)
            tf = rec(e._then)
            ef = rec(e._else)
            if cf is None or tf is None or ef is None:
                return None

            def ifelse(decoded, n, _c=cf, _t=tf, _e=ef):
                c = _c(decoded, n)
                t = _t(decoded, n)
                el = _e(decoded, n)
                # condition must be a clean bool; branch rows inherit
                # their branch's value/flags, bad if their branch is bad
                pick = c.vi != 0
                bad = c.bad | ~c.isbool | np.where(pick, t.bad, el.bad)
                return _V(
                    np.where(pick, t.vf, el.vf),
                    np.where(pick, t.vi, el.vi),
                    np.where(pick, t.isint, el.isint),
                    np.where(pick, t.isbool, el.isbool),
                    bad,
                )

            return ifelse
        if isinstance(e, ex.IsNoneExpression):
            f = rec(e._expr)
            if f is None:
                return None
            # decoded numeric cols mark None as tag 2 (bad) — not
            # distinguishable from other errors; keep per-row path
            return None
        return None

    fn = rec(expr)
    if fn is None:
        return None
    return NumpyPlan(fn, needed)
