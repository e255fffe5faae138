"""Bokeh plots over tables (reference: stdlib/viz/plotting.py).
Requires bokeh; without it, `plot` raises a clear ImportError (the rest
of viz works dependency-free)."""

from __future__ import annotations

from typing import Any, Callable

from pathway_tpu_torch.internals.table import Table


class PlotHandle:
    """What `Table.plot` returns: the bokeh figure plus the data plumbing.

    The ColumnDataSource snapshots the table when the plot is built;
    call `refresh()` to pull the current state (e.g. from a notebook
    button or a periodic callback — bokeh's push model needs a server
    session to drive updates), and `stop()` to end the background run.
    """

    def __init__(self, figure: Any, source: Any, refresh: Callable[[], None], live: Any):
        self.figure = figure
        self.source = source
        self._refresh = refresh
        self._live = live

    def refresh(self) -> None:
        self._refresh()

    def stop(self) -> None:
        if self._live is not None:
            self._live.stop()

    def _repr_html_(self) -> str:
        from bokeh.embed import file_html
        from bokeh.resources import CDN

        self.refresh()
        return file_html(self.figure, CDN)


def plot(
    self: Table,
    plotting_function: Callable[..., Any],
    sorting_col: Any = None,
) -> PlotHandle:
    """Build a Bokeh plot over the table's (live) state: the plotting
    function receives a ColumnDataSource; `refresh()` re-snapshots."""
    try:
        from bokeh.models import ColumnDataSource
    except ImportError as e:
        raise ImportError(
            "pw.Table.plot needs bokeh: `pip install bokeh`"
        ) from e

    names = self._column_names()
    live = self.live()

    def current_data() -> dict:
        rows = live.snapshot()
        if sorting_col is not None:
            key = sorting_col.name if hasattr(sorting_col, "name") else sorting_col
            rows = sorted(rows, key=lambda r: r[key])
        return {n: [r[n] for r in rows] for n in names}

    source = ColumnDataSource(data=current_data())
    fig = plotting_function(source)
    return PlotHandle(
        fig, source, lambda: source.data.update(current_data()), live
    )
