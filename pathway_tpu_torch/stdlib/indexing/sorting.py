"""Sorted-order utilities: prev/next pointer tables and non-None neighbor
value retrieval.

Reference parity: stdlib/indexing/sorting.py — there the prev/next order is
maintained by a distributed binary search tree built with `pw.iterate`
(build_sorted_index :92, sort_from_index :137) because differential dataflow
has no native order-maintenance. Our engine has one: `Table.sort` lowers to
the incremental prev/next operator (engine SortNode; the reference's
equivalent is src/engine/dataflow/operators/prev_next.rs), so `sort_from_index`
is a thin wrapper and only the iterative value-propagation
(`retrieve_prev_next_values`, reference :195) is kept as dataflow.
"""

from __future__ import annotations

from typing import Any

import pathway_tpu_torch.internals.expression as ex
from pathway_tpu_torch.internals.common import if_else, iterate, require
from pathway_tpu_torch.internals.table import Table


def sort_from_index(table: Table, key: Any = None, instance: Any = None) -> Table:
    """prev/next pointers in `key` order (default: column `key`)."""
    key = key if key is not None else table.key
    return table.sort(key=key, instance=instance)


def build_sorted_index(nodes: Table) -> dict:
    """Reference-compat: returns {'index': prev/next table, 'oracle': None}.

    The reference's BST oracle supports range search; the incremental sort
    operator answers prev/next directly, which is what the stdlib consumers
    (diff, interpolate) use.
    """
    index = nodes.sort(key=nodes.key, instance=getattr(nodes, "instance", None))
    return {"index": index, "oracle": None}


def _retrieving_prev_next_value(tab: Table) -> Table:
    """One propagation step: inherit neighbor's answer when it is resolved."""
    import pathway_tpu_torch as pw

    prev_tab = tab.ix(tab.prev, optional=True)
    next_tab = tab.ix(tab.next, optional=True)
    return tab.select(
        tab.prev,
        tab.next,
        tab.value,
        prev_value=if_else(
            prev_tab.value.is_not_none(),
            prev_tab.id,
            prev_tab.prev_value,
        ),
        next_value=if_else(
            next_tab.value.is_not_none(),
            next_tab.id,
            next_tab.next_value,
        ),
    )


def retrieve_prev_next_values(
    ordered_table: Table, value: ex.ColumnReference | None = None
) -> Table:
    """For each row: pointers to the nearest prev/next rows whose `value` is
    not None (reference: sorting.py:195)."""
    if value is None:
        value = ordered_table.value
    else:
        value = ordered_table[value]
    tab = ordered_table.select(
        ordered_table.prev, ordered_table.next, value=value
    )
    tab = tab.with_columns(
        prev_value=require(tab.id, tab.value),
        next_value=require(tab.id, tab.value),
    )
    result = iterate(_retrieving_prev_next_value, tab=tab)
    return result.select(result.prev_value, result.next_value)
