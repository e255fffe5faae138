"""Preset builders for vector document indexes.

Reference parity: stdlib/indexing/vector_document_index.py —
`default_vector_document_index` plus the deprecated `VectorDocumentIndex`
alias, and the per-backend variants. The embedder rides on the inner index
(`embedder=` field), which embeds both the data column and every query.
"""

from __future__ import annotations

import warnings
from typing import Any

from pathway_tpu_torch.internals.expression import ColumnExpression, ColumnReference
from pathway_tpu_torch.internals.table import Table
from pathway_tpu_torch.stdlib.indexing.data_index import DataIndex
from pathway_tpu_torch.stdlib.indexing.nearest_neighbors import (
    BruteForceKnn,
    IvfPqKnn,
    LshKnn,
    UsearchKnn,
)


def default_vector_document_index(
    data_column: ColumnReference,
    data_table: Table,
    *,
    dimensions: int,
    embedder: Any | None = None,
    metadata_column: ColumnExpression | None = None,
) -> DataIndex:
    """The default: exact KNN on the HBM vector slab (the TPU fast path)."""
    return default_brute_force_knn_document_index(
        data_column,
        data_table,
        dimensions=dimensions,
        embedder=embedder,
        metadata_column=metadata_column,
    )


def default_brute_force_knn_document_index(
    data_column: ColumnReference,
    data_table: Table,
    *,
    dimensions: int,
    embedder: Any | None = None,
    metadata_column: ColumnExpression | None = None,
    metric: str = "cos",
) -> DataIndex:
    inner = BruteForceKnn(
        data_column=data_column,
        metadata_column=metadata_column,
        dimensions=dimensions,
        metric=metric,
        embedder=embedder,
    )
    return DataIndex(data_table=data_table, inner_index=inner)


def default_usearch_knn_document_index(
    data_column: ColumnReference,
    data_table: Table,
    *,
    dimensions: int,
    embedder: Any | None = None,
    metadata_column: ColumnExpression | None = None,
    metric: str = "cos",
) -> DataIndex:
    inner = UsearchKnn(
        data_column=data_column,
        metadata_column=metadata_column,
        dimensions=dimensions,
        metric=metric,
        embedder=embedder,
    )
    return DataIndex(data_table=data_table, inner_index=inner)


def default_ivf_pq_knn_document_index(
    data_column: ColumnReference,
    data_table: Table,
    *,
    dimensions: int,
    embedder: Any | None = None,
    metadata_column: ColumnExpression | None = None,
    metric: str = "cos",
    n_lists: int | None = None,
    nprobe: int | None = None,
) -> DataIndex:
    """Incremental IVF-PQ ANN over the document vectors — the scaling
    tier past the brute-force slab (docs/retrieval.md). `PATHWAY_ANN=0`
    falls back to the exact slab with identical ranking semantics."""
    inner = IvfPqKnn(
        data_column=data_column,
        metadata_column=metadata_column,
        dimensions=dimensions,
        metric=metric,
        n_lists=n_lists,
        nprobe=nprobe,
        embedder=embedder,
    )
    return DataIndex(data_table=data_table, inner_index=inner)


def default_lsh_knn_document_index(
    data_column: ColumnReference,
    data_table: Table,
    *,
    dimensions: int,
    embedder: Any | None = None,
    metadata_column: ColumnExpression | None = None,
) -> DataIndex:
    inner = LshKnn(
        data_column=data_column,
        metadata_column=metadata_column,
        dimensions=dimensions,
        embedder=embedder,
    )
    return DataIndex(data_table=data_table, inner_index=inner)


def VectorDocumentIndex(  # noqa: N802 — reference-compat alias
    data_column: ColumnReference,
    data_table: Table,
    *,
    dimensions: int,
    embedder: Any | None = None,
    metadata_column: ColumnExpression | None = None,
) -> DataIndex:
    warnings.warn(
        "VectorDocumentIndex is deprecated; use default_vector_document_index",
        DeprecationWarning,
        stacklevel=2,
    )
    return default_vector_document_index(
        data_column,
        data_table,
        dimensions=dimensions,
        embedder=embedder,
        metadata_column=metadata_column,
    )
