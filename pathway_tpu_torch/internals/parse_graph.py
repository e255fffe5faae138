"""Global parse graph: registry of sinks awaiting pw.run
(reference: internals/parse_graph.py — global `G`)."""

from __future__ import annotations

from typing import Any, Callable


class Sink:
    def __init__(self, kind: str, table: Any, **params: Any):
        self.kind = kind
        self.table = table
        self.params = params


class ParseGraph:
    def __init__(self) -> None:
        self.sinks: list[Sink] = []
        # hooks run once per pw.run before execution (e.g. servers binding)
        self.pre_run_hooks: list[Callable[[], None]] = []

    def add_sink(self, kind: str, table: Any, **params: Any) -> Sink:
        s = Sink(kind, table, **params)
        self.sinks.append(s)
        return s

    def clear(self) -> None:
        self.sinks.clear()
        self.pre_run_hooks.clear()


G = ParseGraph()
