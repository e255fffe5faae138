"""pw.io.null: sink that discards rows (reference: NullWriter)."""

from __future__ import annotations

from typing import Any

from pathway_tpu_torch.internals.parse_graph import G


def write(table: Any, **kwargs: Any) -> None:
    G.add_sink("output", table, write_batch=lambda time, entries: None)
