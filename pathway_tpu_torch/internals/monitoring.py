"""Console monitoring: the rich dashboard + periodic stats fallback.

Reference parity: internals/monitoring.py (:56-190) — the rich-based TUI
with per-connector and per-operator panels refreshed in place. When rich
is unavailable or stderr is not a terminal, a compact stats line per
commit-wave window goes through the standard logger instead (the
reference logs the same way in non-interactive runs).
"""

from __future__ import annotations

import logging
import time
from typing import Any

logger = logging.getLogger("pathway_tpu_torch.monitor")


class MonitoringLevel:
    NONE = "none"
    IN_OUT = "in_out"
    ALL = "all"


class StatsMonitor:
    """Collects the per-wave snapshot both renderers share."""

    def __init__(self, session: Any):
        self.session = session
        self.waves = 0
        self.t0 = time.time()
        self.rows_at_t0 = 0
        self.started = time.time()

    def snapshot(self, wave_time: int) -> dict:
        graph = self.session.graph
        rows = sum(n.rows_out for n in graph.nodes)
        dt = time.time() - self.t0
        rate = (rows - self.rows_at_t0) / dt if dt > 0 else 0.0
        inputs = [n for n in graph.nodes if type(n).__name__ == "InputNode"]
        hot = sorted(graph.nodes, key=lambda n: -n.time_ns)[:5]
        connectors = [
            {"name": c.name, "done": c.done}
            for c in getattr(self.session, "connectors", [])
        ]
        return {
            "time": wave_time,
            "waves": self.waves,
            "uptime": time.time() - self.started,
            "operators": len(graph.nodes),
            "inputs": len(inputs),
            "rows_out": rows,
            "rate": rate,
            "hot": [
                {
                    # plan-node label + call site via describe(): two
                    # GroupByNodes (different groupbys) stay apart in the
                    # TUI/log line, not just by opaque node id
                    "op": n.describe(),
                    "rows_in": n.rows_in,
                    "rows_out": n.rows_out,
                    "latency_ms": n.time_ns / 1e6,
                }
                for n in hot
            ],
            "connectors": connectors,
            "errors": len(graph.error_log.entries),
        }

    def roll(self, snap: dict) -> None:
        self.t0 = time.time()
        self.rows_at_t0 = snap["rows_out"]


def rich_renderable(snap: dict):
    """The dashboard layout for one stats snapshot (reference TUI shape:
    header line + connectors panel + hottest-operators panel)."""
    from rich.console import Group
    from rich.panel import Panel
    from rich.table import Table as RichTable

    head = (
        f"t={snap['time']}  waves={snap['waves']}  "
        f"uptime={snap['uptime']:.0f}s  rate={snap['rate']:,.0f} rows/s  "
        f"errors={snap['errors']}"
    )
    conn = RichTable(title="connectors", expand=True)
    conn.add_column("name")
    conn.add_column("state")
    for c in snap["connectors"]:
        conn.add_row(c["name"], "done" if c["done"] else "streaming")
    ops = RichTable(title="hottest operators", expand=True)
    ops.add_column("operator")
    ops.add_column("rows in", justify="right")
    ops.add_column("rows out", justify="right")
    ops.add_column("latency", justify="right")
    for h in snap["hot"]:
        ops.add_row(
            h["op"], f"{h['rows_in']:,}", f"{h['rows_out']:,}",
            f"{h['latency_ms']:,.0f}ms",
        )
    return Panel(Group(head, conn, ops), title="pathway_tpu_torch")


def attach_monitor(
    session: Any, every_n_waves: int = 50, use_tui: bool | None = None
) -> None:
    """Install a per-wave monitor: the rich Live dashboard on interactive
    terminals (use_tui=True forces it, e.g. tests), a logger stats line
    otherwise."""
    stats = StatsMonitor(session)
    live = None
    if use_tui is None:
        import sys

        use_tui = bool(getattr(sys.stderr, "isatty", lambda: False)())
    if use_tui:
        try:
            import sys

            from rich.console import Console
            from rich.live import Live

            # render on STDERR — the stream the tty gate checks — so a
            # piped stdout (results > file) never gets ANSI frames
            live = Live(
                auto_refresh=False,
                transient=True,
                console=Console(file=sys.stderr),
            )
            live.start()
        except Exception:  # noqa: BLE001 — no rich / broken terminal
            live = None

    def monitor(wave_time: int) -> None:
        stats.waves += 1
        if stats.waves % every_n_waves:
            return
        snap = stats.snapshot(wave_time)
        if live is not None:
            live.update(rich_renderable(snap), refresh=True)
        else:
            hot_s = ", ".join(
                f"{h['op']}={h['latency_ms']:.0f}ms"
                for h in snap["hot"] if h["latency_ms"]
            )
            logger.info(
                "t=%d waves=%d operators=%d inputs=%d rows_out=%d "
                "rate=%.0f rows/s hot=[%s]",
                snap["time"], snap["waves"], snap["operators"],
                snap["inputs"], snap["rows_out"], snap["rate"], hot_s,
            )
        stats.roll(snap)

    monitor.live = live  # tests / run teardown can reach the display
    session.monitors.append(monitor)
