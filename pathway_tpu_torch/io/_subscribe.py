"""pw.io.subscribe (reference: io/_subscribe.py)."""

from __future__ import annotations

from typing import Any, Callable

from pathway_tpu_torch.internals.parse_graph import G
from pathway_tpu_torch.internals.table import Table


def subscribe(
    table: Table,
    on_change: Callable[..., None] | None = None,
    on_end: Callable[[], None] | None = None,
    on_time_end: Callable[[int], None] | None = None,
    *,
    skip_persisted_batch: bool = True,
    name: str | None = None,
) -> None:
    """Call `on_change(key, row: dict, time: int, is_addition: bool)` for
    every change, `on_time_end(time)` after each closed engine time,
    `on_end()` at stream end."""
    names = table._column_names()

    def wrapped_on_change(key: Any, row: tuple, time: int, is_addition: bool) -> None:
        if on_change is not None:
            on_change(key=key, row=dict(zip(names, row)), time=time, is_addition=is_addition)

    G.add_sink(
        "subscribe",
        table,
        on_change=wrapped_on_change if on_change is not None else None,
        on_time_end=on_time_end,
        on_end=on_end,
    )
