"""Inactivity detection (reference: stdlib/temporal/time_utils.py:125).

Detects gaps longer than `allowed_inactivity` in an event stream (per
instance): returns (inactivities, resumptions) — event-time based; rows
appear once the resuming event arrives.
"""

from __future__ import annotations

from typing import Any

from pathway_tpu_torch.internals import expression as ex
from pathway_tpu_torch.internals.table import Table


def inactivity_detection(
    table: Table,
    time_expr: Any,
    allowed_inactivity: Any,
    instance: Any = None,
    refresh_rate: Any = None,
) -> tuple[Table, Table]:
    t = table.with_columns(_pw_t=time_expr)
    sorted_t = t.sort(key=t._pw_t, instance=instance)
    prev_rows = t.ix(sorted_t.prev, optional=True)
    marked = t.select(
        inactive_since=prev_rows._pw_t,
        resumed_at=t._pw_t,
    ).filter(
        ex.this.inactive_since.is_not_none()
        & ((ex.this.resumed_at - ex.this.inactive_since) > allowed_inactivity)
    )
    inactivities = marked.select(inactive_since=ex.this.inactive_since)
    resumptions = marked.select(resumed_at=ex.this.resumed_at)
    return inactivities, resumptions
