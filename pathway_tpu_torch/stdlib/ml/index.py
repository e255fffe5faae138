"""Classic `KNNIndex` API (the pre-DataIndex interface).

Reference parity: stdlib/ml/index.py `KNNIndex` (:8) —
`get_nearest_items` / `get_nearest_items_asof_now` with collapse_rows /
with_distances / metadata_filter, backed there by the LSH classifier
(`knn_lsh_classifier_train`). Here it is a facade over the same DataIndex
machinery; `distance_type` picks the metric and the backend is the exact
HBM-slab KNN by default ("euclidean"/"cosine"), or the LSH index when
`use_lsh=True` (reference behavior).

The port adds one argument, `device`, passed to the slab and IVF-PQ
backends: the CUDA card by default, ``device="cpu"`` for a CPU mirror,
``device=False`` for the host scan. The LSH backend is host numpy.
"""

from __future__ import annotations

from typing import Any

from pathway_tpu_torch.internals.expression import ColumnExpression, ColumnReference
from pathway_tpu_torch.internals.table import Table
from pathway_tpu_torch.stdlib.indexing.data_index import DataIndex
from pathway_tpu_torch.stdlib.indexing.nearest_neighbors import (
    BruteForceKnn,
    IvfPqKnn,
    LshKnn,
)

_METRIC = {"euclidean": "l2sq", "cosine": "cos", "cos": "cos", "l2": "l2sq"}


class KNNIndex:
    def __init__(
        self,
        data_embedding: ColumnExpression,
        data: Table,
        n_dimensions: int,
        n_or: int = 20,
        n_and: int = 10,
        bucket_length: float = 10.0,
        distance_type: str = "euclidean",
        metadata: ColumnExpression | None = None,
        use_lsh: bool = False,
        use_ann: bool = False,
        device: Any = True,
    ):
        self.data = data
        if distance_type not in _METRIC:
            raise ValueError(f"unsupported distance_type {distance_type!r}")
        if use_lsh:
            inner: Any = LshKnn(
                data_column=data_embedding,
                metadata_column=metadata,
                dimensions=n_dimensions,
                n_or=n_or,
                n_and=n_and,
                bucket_length=bucket_length,
                distance_type="l2" if distance_type in ("euclidean", "l2") else "cos",
            )
        elif use_ann:
            # incremental IVF-PQ (docs/retrieval.md); PATHWAY_ANN=0
            # drops this back to the exact slab at lowering time
            inner = IvfPqKnn(
                data_column=data_embedding,
                metadata_column=metadata,
                dimensions=n_dimensions,
                metric=_METRIC[distance_type],
                device=device,
            )
        else:
            inner = BruteForceKnn(
                data_column=data_embedding,
                metadata_column=metadata,
                dimensions=n_dimensions,
                metric=_METRIC[distance_type],
                device=device,
            )
        self._index = DataIndex(data_table=data, inner_index=inner)

    def _shape_result(
        self, result: Table, query_table: Table, collapse_rows: bool,
        with_distances: bool,
    ) -> Table:
        """Reference output shape (stdlib/ml/index.py
        _extract_data_collapsed_rows/_extract_data_flat): only the DATA
        table's columns, plus `dist` when requested, on the query universe
        (collapse) or one row per match (flat)."""
        from pathway_tpu_torch.stdlib.indexing.colnames import (
            _INDEX_REPLY_SCORE,
            _SCORE,
        )

        cols = {n: result[n] for n in self.data._column_names()}
        if with_distances:
            cols["dist"] = result[_INDEX_REPLY_SCORE if collapse_rows else _SCORE]
        return result.select(**cols)

    def get_nearest_items(
        self,
        query_embedding: ColumnReference,
        k: ColumnExpression | int = 3,
        collapse_rows: bool = True,
        with_distances: bool = False,
        metadata_filter: ColumnExpression | None = None,
    ) -> Table:
        """Results keep updating as better documents arrive."""
        result = self._index.query(
            query_embedding,
            number_of_matches=k,
            collapse_rows=collapse_rows,
            with_distances=True,
            metadata_filter=metadata_filter,
        )
        return self._shape_result(
            result, query_embedding.table, collapse_rows, with_distances
        )

    def get_nearest_items_asof_now(
        self,
        query_embedding: ColumnReference,
        k: ColumnExpression | int = 3,
        collapse_rows: bool = True,
        with_distances: bool = False,
        metadata_filter: ColumnExpression | None = None,
    ) -> Table:
        """Results are frozen as of each query's arrival."""
        result = self._index.query_as_of_now(
            query_embedding,
            number_of_matches=k,
            collapse_rows=collapse_rows,
            with_distances=True,
            metadata_filter=metadata_filter,
        )
        return self._shape_result(
            result, query_embedding.table, collapse_rows, with_distances
        )
