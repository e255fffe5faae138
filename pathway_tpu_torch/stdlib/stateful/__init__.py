"""pw.stateful (reference: stdlib/stateful/deduplicate.py)."""

from __future__ import annotations

from typing import Any, Callable, TypeVar

from pathway_tpu_torch.internals.table import Table

TValue = TypeVar("TValue")


def deduplicate(
    table: Table,
    *,
    col: Any,
    instance: Any = None,
    acceptor: Callable[[Any, Any], bool],
    persistent_id: str | None = None,
    name: str | None = None,
) -> Table:
    return table.deduplicate(
        value=col, instance=instance, acceptor=acceptor, name=name
    )


__all__ = ["deduplicate"]
