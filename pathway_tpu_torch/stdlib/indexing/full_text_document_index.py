"""Preset builder for full-text document indexes.

Reference parity: stdlib/indexing/full_text_document_index.py.
"""

from __future__ import annotations

from pathway_tpu_torch.internals.expression import ColumnExpression, ColumnReference
from pathway_tpu_torch.internals.table import Table
from pathway_tpu_torch.stdlib.indexing.bm25 import TantivyBM25
from pathway_tpu_torch.stdlib.indexing.data_index import DataIndex


def default_full_text_document_index(
    data_column: ColumnReference,
    data_table: Table,
    *,
    metadata_column: ColumnExpression | None = None,
) -> DataIndex:
    inner = TantivyBM25(data_column=data_column, metadata_column=metadata_column)
    return DataIndex(data_table=data_table, inner_index=inner)
