"""Table display for notebooks (reference: stdlib/viz/table_viz.py).

`show(table)` returns a TableView. Bounded pipelines (no connectors in
the spec tree) snapshot immediately; pipelines with live sources get a
LiveTable-backed view whose `_repr_html_` snapshots the CURRENT state on
every render — a bare `t` at a notebook prompt must never block on an
unbounded stream.
"""

from __future__ import annotations

import html
from typing import Any

from pathway_tpu_torch.internals.table import Table


def _has_connectors(table: Table) -> bool:
    seen: set[int] = set()

    def walk(spec: Any) -> bool:
        if id(spec) in seen:
            return False
        seen.add(id(spec))
        if spec.kind == "connector":
            return True
        return any(walk(t._spec) for t in spec.inputs)

    return walk(table._spec)


def _to_html(
    names: list[str],
    rows: list[tuple],
    include_id: bool,
    ids: list[Any] | None,
    n_rows: int | None,
    short_pointers: bool = True,
    sorters: Any = None,
) -> str:
    order = list(range(len(rows)))
    if sorters:
        # tabulator-style sorters: [{"field": name, "dir": "asc"|"desc"}]
        for s in reversed(list(sorters)):
            col = names.index(s["field"])
            order.sort(
                key=lambda i: (rows[i][col] is None, rows[i][col]),
                reverse=s.get("dir") == "desc",
            )
    rows = [rows[i] for i in order]
    ids = [ids[i] for i in order] if ids is not None else None
    if n_rows is not None:
        rows = rows[:n_rows]
        ids = ids[:n_rows] if ids is not None else None
    head = ([""] if include_id else []) + names
    out = ["<table><thead><tr>"]
    out += [f"<th>{html.escape(str(h))}</th>" for h in head]
    out.append("</tr></thead><tbody>")
    for i, row in enumerate(rows):
        out.append("<tr>")
        if include_id and ids is not None:
            sid = str(ids[i])
            if short_pointers:
                sid = sid[:10]
            out.append(f"<td><code>{html.escape(sid)}</code></td>")
        out += [f"<td>{html.escape(str(v))}</td>" for v in row]
        out.append("</tr>")
    out.append("</tbody></table>")
    return "".join(out)


class TableView:
    """Renderable handle: static (bounded snapshot) or live (streaming)."""

    def __init__(
        self,
        table: Table,
        *,
        include_id: bool = True,
        short_pointers: bool = True,
        sorters: Any = None,
        n_rows: int | None = 50,
        live: Any = None,
    ):
        self._table = table
        self._include_id = include_id
        self._short_pointers = short_pointers
        self._sorters = sorters
        self._n_rows = n_rows
        self._live = live
        self._static: tuple[list, list] | None = None
        if live is None:
            from pathway_tpu_torch.internals.lowering import Session

            session = Session()
            cap = session.capture(table)
            session.execute()
            items = sorted(cap.state.rows.items(), key=lambda kv: kv[0].value)
            self._static = ([k for k, _ in items], [r for _, r in items])

    def _snapshot(self) -> tuple[list, list]:
        if self._static is not None:
            return self._static
        rows = self._live.snapshot()
        names = self._table._column_names()
        return (
            [None] * len(rows),
            [tuple(r[n] for n in names) for r in rows],
        )

    def _repr_html_(self) -> str:
        ids, rows = self._snapshot()
        names = self._table._column_names()
        include_id = self._include_id and self._static is not None
        tag = (
            "" if self._static is not None
            else "<p><em>live view — re-render for the current state</em></p>"
        )
        return tag + _to_html(
            names, rows, include_id, ids, self._n_rows,
            short_pointers=self._short_pointers, sorters=self._sorters,
        )

    def __repr__(self) -> str:
        ids, rows = self._snapshot()
        return f"TableView({len(rows)} rows x {len(self._table._column_names())} cols)"

    def stop(self) -> None:
        if self._live is not None:
            self._live.stop()


def show(
    self: Table,
    *,
    snapshot: bool = True,
    include_id: bool = True,
    short_pointers: bool = True,
    sorters: Any = None,
    n_rows: int | None = 50,
) -> TableView:
    """Display a table in a notebook (reference: table_viz.py:26).

    Bounded pipelines compute a static preview immediately. Pipelines
    with live sources ALWAYS get the LiveTable-backed view regardless of
    `snapshot` — computing them synchronously could block forever on an
    unbounded stream."""
    live = None
    if not snapshot or _has_connectors(self):
        live = self.live()
    return TableView(
        self,
        include_id=include_id,
        short_pointers=short_pointers,
        sorters=sorters,
        n_rows=n_rows,
        live=live,
    )
