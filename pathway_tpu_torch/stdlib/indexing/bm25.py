"""Full-text BM25 retriever.

Reference parity: stdlib/indexing/bm25.py `TantivyBM25` (:41) +
`TantivyBM25Factory` — backed here by the in-process inverted index
(host_indexes.Bm25Index) instead of the tantivy crate
(src/external_integration/tantivy_integration.rs:16).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

from pathway_tpu_torch.internals.expression import ColumnExpression, ColumnReference
from pathway_tpu_torch.stdlib.indexing.host_indexes import Bm25Index
from pathway_tpu_torch.stdlib.indexing.retrievers import InnerIndex, InnerIndexFactory


@dataclass(frozen=True)
class TantivyBM25(InnerIndex):
    """BM25 ranking over tokenized text. Scores returned as negated BM25 so
    smaller = better, like every other retriever."""

    ram_budget: int = 50_000_000  # accepted for API parity; in-memory anyway
    in_memory_index: bool = True

    def _host_index_factory(self) -> Callable:
        return Bm25Index


@dataclass(frozen=True)
class TantivyBM25Factory(InnerIndexFactory):
    ram_budget: int = 50_000_000
    in_memory_index: bool = True

    def build_inner_index(
        self,
        data_column: ColumnReference,
        metadata_column: ColumnExpression | None = None,
    ) -> TantivyBM25:
        return TantivyBM25(
            data_column=data_column,
            metadata_column=metadata_column,
            ram_budget=self.ram_budget,
            in_memory_index=self.in_memory_index,
        )
