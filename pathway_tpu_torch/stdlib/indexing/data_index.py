"""DataIndex — augments inner-index matches with data-table columns.

Reference parity: stdlib/indexing/data_index.py `DataIndex` (:278) with
`query` (:349) and `query_as_of_now` (:412). The reference repacks results in
Python dataflow (flatten + ix + collapse, `_repack_results` :294); here the
repacking happens inside the engine's ExternalIndexNode (modes
'collapse'/'flat'), which keeps it one operator and lets a whole query wave
share one batched TPU search.
"""

from __future__ import annotations

from dataclasses import dataclass

from pathway_tpu_torch.internals.expression import ColumnExpression, ColumnReference
from pathway_tpu_torch.internals.table import Table
from pathway_tpu_torch.stdlib.indexing.colnames import (
    _INDEX_REPLY_ID,
    _INDEX_REPLY_SCORE,
    _MATCHED_ID,
    _SCORE,
)
from pathway_tpu_torch.stdlib.indexing.retrievers import InnerIndex, build_index_query


@dataclass
class DataIndex:
    """Wraps an InnerIndex with the table holding the matched rows' data.

    Query results contain the query table's columns plus, per match, the
    data table's columns — as rank-ordered tuples when ``collapse_rows``
    (one output row per query), or one output row per match otherwise.
    """

    data_table: Table
    inner_index: InnerIndex

    def query(
        self,
        query_column: ColumnReference,
        *,
        number_of_matches: ColumnExpression | int = 3,
        collapse_rows: bool = True,
        with_distances: bool = False,
        metadata_filter: ColumnExpression | None = None,
    ) -> Table:
        """Answers update when the indexed data changes."""
        return self._query(
            query_column, number_of_matches, collapse_rows, with_distances,
            metadata_filter, asof_now=False,
        )

    def query_as_of_now(
        self,
        query_column: ColumnReference,
        *,
        number_of_matches: ColumnExpression | int = 3,
        collapse_rows: bool = True,
        with_distances: bool = False,
        metadata_filter: ColumnExpression | None = None,
    ) -> Table:
        """Each answer is frozen as of query arrival (serving mode)."""
        return self._query(
            query_column, number_of_matches, collapse_rows, with_distances,
            metadata_filter, asof_now=True,
        )

    def _query(
        self, query_column, number_of_matches, collapse_rows, with_distances,
        metadata_filter, asof_now,
    ) -> Table:
        result = build_index_query(
            self.inner_index,
            query_column,
            number_of_matches=number_of_matches,
            metadata_filter=metadata_filter,
            mode="collapse" if collapse_rows else "flat",
            asof_now=asof_now,
            data_table=self.data_table,
        )
        if not with_distances:
            result = result.without(
                _INDEX_REPLY_SCORE if collapse_rows else _SCORE
            )
        return result
