"""Retriever ABCs + factory ABCs of the index layer.

Reference parity: python/pathway/stdlib/indexing/retrievers.py and the
InnerIndex ABC in data_index.py:206 — an index accepts data from
``data_column`` (with optional JSON metadata) and answers queries with
``(matched_id, score)`` pairs, smaller score = better match.
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from dataclasses import dataclass
from typing import Any, Callable

import pathway_tpu_torch.internals.expression as ex
from pathway_tpu_torch.internals import dtype as dt
from pathway_tpu_torch.internals import schema as sch
from pathway_tpu_torch.internals.expression import ColumnExpression, ColumnReference, wrap_arg
from pathway_tpu_torch.internals.table import OpSpec, Table
from pathway_tpu_torch.internals import universe as univ
from pathway_tpu_torch.stdlib.indexing.colnames import (
    _INDEX_REPLY,
    _INDEX_REPLY_ID,
    _INDEX_REPLY_SCORE,
    _MATCHED_ID,
    _SCORE,
)

_Q, _K, _FILTER = "_pw_q", "_pw_k", "_pw_filter"


@dataclass(frozen=True)
class InnerIndex(ABC):
    """An index over `data_column` (+ optional `metadata_column`).

    `query` keeps answers consistent with the evolving index (results are
    retracted/re-emitted when the indexed data changes); `query_as_of_now`
    freezes each answer at query arrival (the streaming RAG serving mode).
    """

    data_column: ColumnReference
    metadata_column: ColumnExpression | None = None

    @abstractmethod
    def _host_index_factory(self) -> Callable[[], Any]:
        """Returns a zero-arg factory building a fresh host/device index."""

    def _data_table(self) -> Table:
        return self.data_column.table

    def _data_expr(self) -> ColumnExpression:
        return self.data_column

    def _query_expr(self, query_column: ColumnReference) -> ColumnExpression:
        """Hook: vector indexes with an embedder transform the query column
        (reference: nearest_neighbors.py:132 `_calculate_embeddings`)."""
        return query_column

    def query(
        self,
        query_column: ColumnReference,
        *,
        number_of_matches: ColumnExpression | int = 3,
        metadata_filter: ColumnExpression | None = None,
    ) -> Table:
        return build_index_query(
            self, query_column,
            number_of_matches=number_of_matches,
            metadata_filter=metadata_filter,
            mode="reply", asof_now=False,
        )

    def query_as_of_now(
        self,
        query_column: ColumnReference,
        *,
        number_of_matches: ColumnExpression | int = 3,
        metadata_filter: ColumnExpression | None = None,
    ) -> Table:
        return build_index_query(
            self, query_column,
            number_of_matches=number_of_matches,
            metadata_filter=metadata_filter,
            mode="reply", asof_now=True,
        )


@dataclass(frozen=True)
class InnerIndexFactory(ABC):
    """Builds an InnerIndex given the data columns (reference:
    stdlib/indexing/retrievers.py InnerIndexFactory)."""

    @abstractmethod
    def build_inner_index(
        self,
        data_column: ColumnReference,
        metadata_column: ColumnExpression | None = None,
    ) -> InnerIndex:
        ...

    def build_index(
        self,
        data_column: ColumnReference,
        data_table: Table,
        metadata_column: ColumnExpression | None = None,
    ):
        from pathway_tpu_torch.stdlib.indexing.data_index import DataIndex

        return DataIndex(
            data_table=data_table,
            inner_index=self.build_inner_index(data_column, metadata_column),
        )


def build_index_query(
    inner: InnerIndex,
    query_column: ColumnReference,
    *,
    number_of_matches: ColumnExpression | int = 3,
    metadata_filter: ColumnExpression | None = None,
    mode: str = "reply",
    asof_now: bool = True,
    data_table: Table | None = None,
) -> Table:
    """Construct the external-index OpSpec and its output Table.

    Lowered by stdlib/indexing/lowering.py into an
    `engine.core.ExternalIndexNode` (reference:
    scope.use_external_index_as_of_now, src/engine/dataflow.rs:2224).
    """
    index_table = inner._data_table().select(
        **{
            _Q: inner._data_expr(),
            _FILTER: inner.metadata_column
            if inner.metadata_column is not None
            else wrap_arg(None),
        }
    )
    # the rowwise lowering resolves same-universe side tables, so selecting
    # off query_table works even when query_expr lives on a derived
    # (embedded) table
    query_expr = inner._query_expr(query_column)
    query_table = query_column.table
    if mode == "reply":
        q_selected = query_table.select(
            **{
                _Q: query_expr,
                _K: wrap_arg(number_of_matches),
                _FILTER: metadata_filter
                if metadata_filter is not None
                else wrap_arg(None),
            }
        )
        out_columns = {
            _INDEX_REPLY: sch.ColumnSchema(name=_INDEX_REPLY, dtype=dt.ANY)
        }
        universe = query_table._universe
        inputs = [index_table, q_selected]
        data_width = 0
        data_names: list[str] = []
    else:
        if data_table is None:
            raise ValueError("collapse/flat index queries need data_table")
        q_names = query_table._column_names()
        data_names = data_table._column_names()
        clash = set(q_names) & set(data_names)
        if clash:
            raise ValueError(
                f"query and data tables share column names {sorted(clash)}; "
                "rename one side before querying the index"
            )
        q_selected = query_table.select(
            *[query_table[n] for n in q_names],
            **{
                _Q: query_expr,
                _K: wrap_arg(number_of_matches),
                _FILTER: metadata_filter
                if metadata_filter is not None
                else wrap_arg(None),
            },
        )
        columns: dict[str, sch.ColumnSchema] = {}
        for n in q_names:
            columns[n] = sch.ColumnSchema(name=n, dtype=query_table._dtype_of(n))
        for pn in (_Q, _K, _FILTER):
            columns[pn] = sch.ColumnSchema(name=pn, dtype=dt.ANY)
        if mode == "collapse":
            for n in data_names:
                columns[n] = sch.ColumnSchema(name=n, dtype=dt.ANY)
            columns[_INDEX_REPLY_SCORE] = sch.ColumnSchema(
                name=_INDEX_REPLY_SCORE, dtype=dt.ANY
            )
            columns[_INDEX_REPLY_ID] = sch.ColumnSchema(
                name=_INDEX_REPLY_ID, dtype=dt.ANY
            )
            universe = query_table._universe
        else:  # flat
            for n in data_names:
                columns[n] = sch.ColumnSchema(name=n, dtype=data_table._dtype_of(n))
            columns[_SCORE] = sch.ColumnSchema(name=_SCORE, dtype=dt.FLOAT)
            columns[_MATCHED_ID] = sch.ColumnSchema(
                name=_MATCHED_ID, dtype=dt.ANY_POINTER
            )
            universe = univ.Universe()
        out_columns = columns
        inputs = [index_table, q_selected, data_table]
        data_width = len(data_names)

    spec = OpSpec(
        "external_index",
        inputs,
        host_index_factory=inner._host_index_factory(),
        mode=mode,
        asof_now=asof_now,
        data_width=data_width,
    )
    result = Table(spec, sch.schema_from_columns(out_columns), universe)
    if mode == "reply":
        return result
    return result.without(_Q, _K, _FILTER)
