"""kNN-LSH classifiers.

Reference parity: stdlib/ml/classifiers/_knn_lsh.py
(knn_lsh_classifier_train :64, knn_lsh_generic_classifier_train :135,
knn_lsh_euclidean_classifier_train :293, knn_lsh_classify :306) and
_lsh.py's euclidean/cosine bucketers. The reference expresses LSH
bucketing as dataflow (band columns + join on bucket); here the LSH
tables live in the engine's external-index operator (host LshIndex,
stdlib/indexing/host_indexes.py — the same OR-AND random-projection
scheme), so one query wave is answered in a single batched index call.
API and semantics (train -> model(queries, k) -> majority-vote classify)
match the reference.
"""

from __future__ import annotations

from typing import Any, Callable, Literal

from pathway_tpu_torch.internals.reducers import ArgMaxReducer, ReducerExpression
from pathway_tpu_torch.internals.table import Table
from pathway_tpu_torch.stdlib.indexing.colnames import _INDEX_REPLY_ID
from pathway_tpu_torch.stdlib.indexing.data_index import DataIndex
from pathway_tpu_torch.stdlib.indexing.nearest_neighbors import LshKnn

DistanceTypes = Literal["euclidean", "cosine"]

KnnModel = Callable[[Table, Any], Table]


def knn_lsh_classifier_train(
    data: Table,
    L: int,
    type: DistanceTypes = "euclidean",  # noqa: A002
    **kwargs: Any,
) -> KnnModel:
    """Build the LSH index over `data` (column ``data``: vectors).

    L is the number of repetitions of the LSH scheme (OR-tables). Extra
    kwargs: d (dimension), M (projections per table), A (bucket width).
    Returns a model: (queries, k) -> Table(query_id, knns_ids).
    """
    if type == "euclidean":
        return knn_lsh_euclidean_classifier_train(
            data,
            d=kwargs.get("d"),
            M=kwargs.get("M", 10),
            L=L,
            A=kwargs.get("A", 1.0),
        )
    if type == "cosine":
        inner = LshKnn(
            data_column=data.data,
            metadata_column=None,
            dimensions=kwargs.get("d"),
            n_or=L,
            n_and=kwargs.get("M", 10),
            bucket_length=kwargs.get("A", 1.0),
            distance_type="cos",
        )
        return _model_from_inner(data, inner)
    raise ValueError(f"unsupported LSH distance type {type!r}")


knn_lsh_train = knn_lsh_classifier_train


def knn_lsh_euclidean_classifier_train(
    data: Table, d: int | None, M: int, L: int, A: float
) -> KnnModel:
    """Euclidean LSH: M random projections per table, bucket width A,
    L OR-tables (reference :293)."""
    inner = LshKnn(
        data_column=data.data,
        metadata_column=None,
        dimensions=d,
        n_or=L,
        n_and=M,
        bucket_length=A,
        distance_type="l2",
    )
    return _model_from_inner(data, inner)


def knn_lsh_generic_classifier_train(
    data: Table,
    lsh_projection: Any = None,
    distance_function: str | Callable = "euclidean",
    L: int = 10,
    **kwargs: Any,
) -> KnnModel:
    """Generic variant (reference :135): `lsh_projection` is a callable
    vec -> sequence of per-table bucket ids (one per OR-table) and
    `distance_function` either a metric name ('euclidean' / 'cosine') or
    a callable (query_vec, doc_vec) -> float used to rescore bucket
    candidates."""
    if isinstance(distance_function, str):
        try:
            metric = {"euclidean": "l2", "cosine": "cos"}[distance_function]
        except KeyError:
            raise ValueError(
                f"unsupported LSH distance type {distance_function!r}"
            ) from None
    else:
        metric = "l2"  # unused: the callable rescorer takes over
    inner = LshKnn(
        data_column=data.data,
        metadata_column=None,
        # d/M/A keep the classifier-train spelling and defaults
        dimensions=kwargs.get("d"),
        n_or=L,
        n_and=kwargs.get("M", 10),
        bucket_length=kwargs.get("A", 1.0),
        distance_type=metric,
        projection=lsh_projection,
        distance=(
            distance_function if callable(distance_function) else None
        ),
    )
    return _model_from_inner(data, inner)


def _model_from_inner(data: Table, inner: LshKnn) -> KnnModel:
    index = DataIndex(data_table=data, inner_index=inner)

    def model(queries: Table, k: Any) -> Table:
        # rename the query vector column: the index layer requires query
        # and data column names to be disjoint
        q = queries.select(_pw_query_vec=queries.data)
        result = index.query(
            q._pw_query_vec, number_of_matches=k, collapse_rows=True,
            with_distances=False,
        )
        return result.select(
            query_id=result.id, knns_ids=result[_INDEX_REPLY_ID]
        )

    return model


def knn_lsh_classify(
    knn_model: KnnModel, data_labels: Table, queries: Table, k: Any
) -> Table:
    """Label each query by majority vote over its k nearest neighbors'
    labels (reference :306). Output: Table(predicted_label) keyed by the
    query id; queries with no neighbors are absent from the result."""
    import pathway_tpu_torch as pw

    knns = knn_model(queries, k)
    flat = knns.flatten(pw.this.knns_ids)
    labeled = flat.select(
        flat.query_id,
        label=data_labels.ix(flat.knns_ids).label,
    )
    votes = labeled.groupby(labeled.query_id, labeled.label).reduce(
        labeled.query_id,
        labeled.label,
        votes=pw.reducers.count(),
    )
    winner = votes.groupby(votes.query_id).reduce(
        votes.query_id,
        predicted_label=ReducerExpression(
            ArgMaxReducer(), votes.votes, votes.label
        ),
    )
    final = winner.with_id(winner.query_id)
    return final.select(predicted_label=final.predicted_label)


__all__ = [
    "DistanceTypes",
    "knn_lsh_classifier_train",
    "knn_lsh_train",
    "knn_lsh_classify",
    "knn_lsh_generic_classifier_train",
    "knn_lsh_euclidean_classifier_train",
]
