"""Interactive mode: live-updating table views.

Reference parity: internals/interactive.py (enable_interactive_mode,
LiveTable :130, LiveTableThread :87). `t.live()` (or
`pw.interactive.live(t)`) starts the pipeline on a background thread and
returns a LiveTable whose `snapshot()` / `to_pandas()` / `str()` always
reflect the rows as of the latest finished timestamp; notebooks render it
via `_repr_html_`. The run keeps pumping until the sources finish or
`stop()` is called.
"""

from __future__ import annotations

import threading
from typing import Any
from pathway_tpu_torch.analysis import lockgraph as _lockgraph

_interactive_enabled = False


def enable_interactive_mode() -> None:
    """Mark the session interactive (reference: interactive.py
    enable_interactive_mode). `Table.live()` works regardless; this flag
    only switches defaults for display helpers."""
    global _interactive_enabled
    _interactive_enabled = True


def is_interactive_mode_enabled() -> bool:
    return _interactive_enabled


class LiveTable:
    """A continuously updated snapshot of a table's rows.

    The pipeline (the table plus everything it depends on) runs on a
    daemon thread; every finished engine timestamp atomically replaces
    the visible snapshot.
    """

    def __init__(self, table: Any):
        from pathway_tpu_torch.internals.lowering import Session

        self._table = table
        self._columns = table._column_names()
        self._lock = _lockgraph.register_lock(
            "interactive.session", threading.Lock()
        )
        self._rows: dict[Any, tuple] = {}
        self._pending: dict[Any, tuple] = {}
        self._time: int = 0
        self._done = threading.Event()
        self._error: BaseException | None = None

        session = Session()

        def on_change(key: Any, row: tuple, time: int, diff: int) -> None:
            if diff > 0:
                self._pending[key] = row
            else:
                self._pending.pop(key, None)

        node = session.node_of(table)

        from pathway_tpu_torch.engine.core import Node, SubscribeNode

        def raw_on_change(key, row, time, is_addition):
            on_change(key, row, time, 1 if is_addition else -1)

        def on_time_end(time: int) -> None:
            with self._lock:
                self._rows = dict(self._pending)
                self._time = time

        # no on_end callback: Graph.end runs on_end BEFORE the node's
        # final finish_time, so signalling done there could wake waiters
        # before end-flushed rows land; the run thread's finally block
        # (after execute returns, i.e. after the FULL end sequence) is
        # the only completion signal
        SubscribeNode(
            session.graph, node, on_change=raw_on_change,
            on_time_end=on_time_end,
        )
        self._session = session

        def run() -> None:
            try:
                session.execute()
            except BaseException as e:  # noqa: BLE001 — surfaced via .failed
                self._error = e
            finally:
                with self._lock:
                    self._rows = dict(self._pending)
                self._done.set()

        self._thread = threading.Thread(
            target=run, daemon=True, name="pw-live-table"
        )
        self._thread.start()

    # ------------------------------------------------------------- reading

    def snapshot(self) -> list[dict]:
        with self._lock:
            return [dict(zip(self._columns, row)) for row in self._rows.values()]

    def to_pandas(self):
        import pandas as pd

        with self._lock:
            return pd.DataFrame(
                [row for row in self._rows.values()], columns=self._columns
            )

    @property
    def failed(self) -> bool:
        return self._error is not None

    @property
    def frontier(self) -> int:
        with self._lock:
            return self._time

    def wait(self, timeout: float | None = None) -> bool:
        """Blocks until the pipeline's sources finish (static pipelines)."""
        done = self._done.wait(timeout)
        if self._error is not None:
            raise self._error
        return done

    def stop(self) -> None:
        """Stops the background pump at the next wave boundary (the run
        finalizes with the usual end-of-stream flush)."""
        self._session.stop_event.set()

    def __str__(self) -> str:
        rows = self.snapshot()
        header = " | ".join(self._columns)
        body = "\n".join(
            " | ".join(str(r[c]) for c in self._columns) for r in rows
        )
        return f"{header}\n{body}" if body else header

    def _repr_html_(self) -> str:
        try:
            return self.to_pandas()._repr_html_()  # type: ignore[operator]
        except Exception:  # noqa: BLE001
            return f"<pre>{self}</pre>"


def live(table: Any) -> LiveTable:
    """Start a live view of `table` (reference: LiveTable._create)."""
    return LiveTable(table)


__all__ = ["enable_interactive_mode", "is_interactive_mode_enabled", "LiveTable", "live"]
