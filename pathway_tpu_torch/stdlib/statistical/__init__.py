"""pw.statistical (reference: stdlib/statistical/_interpolate.py:146)."""

from __future__ import annotations

from typing import Any

import pathway_tpu_torch.internals.expression as ex
from pathway_tpu_torch.internals.common import apply_with_type, coalesce
from pathway_tpu_torch.internals.table import Table


class InterpolateMode:
    LINEAR = "linear"


def _linear_interpolate(t, t_prev, v_prev, t_next, v_next):
    if v_prev is None and v_next is None:
        return None
    if v_prev is None:
        return v_next
    if v_next is None:
        return v_prev
    if t_next == t_prev:
        return v_prev
    return v_prev + (v_next - v_prev) * (t - t_prev) / (t_next - t_prev)


def interpolate(
    self: Table, timestamp: ex.ColumnReference, *values: ex.ColumnReference,
    mode: str = InterpolateMode.LINEAR,
) -> Table:
    """Fill None gaps in `values` by linear interpolation along `timestamp`.

    v0 note: interpolates between the sort-order neighbors of each row
    (matching the reference for alternating present/missing patterns; long
    missing runs converge over iterations).
    """
    if mode != InterpolateMode.LINEAR:
        raise ValueError(f"unknown interpolation mode {mode!r}")
    table = self

    def step(t: Table) -> dict[str, Table]:
        sorted_t = t.sort(key=t[timestamp.name])
        prevs = t.ix(sorted_t.prev, optional=True)
        nexts = t.ix(sorted_t.next, optional=True)
        kwargs = {}
        for v in values:
            name = v.name
            kwargs[name] = coalesce(
                t[name],
                apply_with_type(
                    _linear_interpolate, float,
                    t[timestamp.name], prevs[timestamp.name], prevs[name],
                    nexts[timestamp.name], nexts[name],
                ),
            )
        return {"t": t.with_columns(**kwargs)}

    from pathway_tpu_torch.internals.common import iterate

    return iterate(lambda t: step(t), t=table)


__all__ = ["interpolate", "InterpolateMode"]
