"""pw.Table.show / .plot — notebook visualization (reference:
stdlib/viz/{table_viz,plotting}.py, panel/bokeh-backed).

The reference renders through `panel`; here `show` works with no extra
dependency: bounded tables compute a static HTML preview immediately,
tables with live sources get a LiveTable-backed view whose
`_repr_html_` snapshots the current state each render. `plot` needs
bokeh and fails with a clear ImportError without it.
"""

from pathway_tpu_torch.stdlib.viz.plotting import PlotHandle, plot
from pathway_tpu_torch.stdlib.viz.table_viz import TableView, _has_connectors, show

from pathway_tpu_torch.internals.table import Table


def _table_repr_html(self: Table) -> str:
    # a bare `t` at a notebook prompt: bounded tables preview inline;
    # streaming ones must not silently start (and leak) a background run
    # per render — point at .show() instead
    if _has_connectors(self):
        return (
            "<em>streaming table — call <code>.show()</code> for a live "
            "view (and <code>.stop()</code> it when done)</em>"
        )
    return show(self)._repr_html_()


# attach like the reference does (viz/__init__ patches pw.Table)
Table.show = show  # type: ignore[attr-defined]
Table.plot = plot  # type: ignore[attr-defined]
Table._repr_html_ = _table_repr_html  # type: ignore[attr-defined]

__all__ = ["plot", "show", "TableView", "PlotHandle"]
