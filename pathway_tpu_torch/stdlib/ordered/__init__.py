"""pw.ordered: diff over sorted order (reference: stdlib/ordered/diff.py:123)."""

from __future__ import annotations

from typing import Any

import pathway_tpu_torch.internals.expression as ex
from pathway_tpu_torch.internals.table import Table


def diff(
    table: Table,
    timestamp: ex.ColumnExpression,
    *values: ex.ColumnReference,
    instance: Any = None,
) -> Table:
    """For each row, subtract the previous row's `values` (ordered by
    `timestamp`): diff_<col> = col - prev(col)."""
    sorted_t = table.sort(key=timestamp, instance=instance)
    prev_rows = table.ix(sorted_t.prev, optional=True)
    kwargs = {}
    for v in values:
        name = v.name
        # the first row (no predecessor) gets None, not an arithmetic
        # error — reference: stdlib/ordered/diff.py "the value of the
        # first row is None"
        kwargs["diff_" + name] = ex.IfElseExpression(
            ex.IsNoneExpression(prev_rows[name]),
            None,
            table[name] - prev_rows[name],
        )
    return table.select(*table, **kwargs)
