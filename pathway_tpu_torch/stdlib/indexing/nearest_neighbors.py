"""Vector KNN retrievers.

Counterpart of ``pathway_tpu/stdlib/indexing/nearest_neighbors.py``
(reference parity: stdlib/indexing/nearest_neighbors.py — `USearchKnn`
(:65), `BruteForceKnn` (:170), `LshKnn` (:262) and their factories
(:407-528)).

`BruteForceKnn` and `UsearchKnn` run on the port's vector slab
(`host_indexes.VectorSlabIndex`, a bf16 mirror on the card) with the exact
`torch.topk`: the JAX package's `UsearchKnn` selects `lax.approx_max_k`,
which has no torch counterpart, and there is no HNSW graph. `IvfPqKnn`
runs the port's incremental IVF-PQ index (`indexing/ann.py`), optionally
with its lists placed in RAM/disk tiers (``tiered=True``, `hot_lists`,
`ram_lists`) and behind the batched reranker. `LshKnn` is numpy. The vector indexes live on the CUDA card
unless `device` names another (``device="cpu"`` keeps a CPU mirror,
``device=False`` scans the host slab).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable

from pathway_tpu_torch.internals.expression import ColumnExpression, ColumnReference
from pathway_tpu_torch.stdlib.indexing.host_indexes import LshIndex, VectorSlabIndex
from pathway_tpu_torch.stdlib.indexing.retrievers import InnerIndex, InnerIndexFactory


class BruteForceKnnMetricKind:
    COS = "cos"
    L2SQ = "l2sq"


class USearchMetricKind:
    COS = "cos"
    L2SQ = "l2sq"
    IP = "dot"


def _calculate_embeddings(column: ColumnReference, embedder) -> ColumnReference:
    """Attach an embedding column when an embedder UDF is configured
    (reference: nearest_neighbors.py:52 `_calculate_embeddings`)."""
    if embedder is None:
        return column
    table = column.table.with_columns(_pw_embedded_column=embedder(column))
    return table._pw_embedded_column


class _EmbeddingKnn(InnerIndex):
    """Shared embed-the-query/data behavior of the vector indexes."""

    embedder: Any = None

    def _data_table(self):
        return self._data_ref().table

    def _data_expr(self):
        return self._data_ref()

    def _data_ref(self) -> ColumnReference:
        # memoized: _data_table()/_data_expr() must share ONE derived table,
        # otherwise every document is embedded once per call site and
        # same-table identity checks (HybridIndex) break
        cached = self.__dict__.get("_cached_data_ref")
        if cached is None:
            cached = _calculate_embeddings(self.data_column, self.embedder)
            object.__setattr__(self, "_cached_data_ref", cached)
        return cached

    def _query_expr(self, query_column: ColumnReference) -> ColumnReference:
        return _calculate_embeddings(query_column, self.embedder)


@dataclass(frozen=True)
class BruteForceKnn(_EmbeddingKnn):
    """Exact KNN over an HBM-resident vector slab (reference: BruteForceKnn,
    stdlib/indexing/nearest_neighbors.py:170)."""

    dimensions: int | None = None
    reserved_space: int = 1024
    metric: str = BruteForceKnnMetricKind.COS
    embedder: Any = None
    device: Any = True

    def _host_index_factory(self) -> Callable:
        dims, space, metric, device = (
            self.dimensions, self.reserved_space, self.metric, self.device
        )
        return lambda: VectorSlabIndex(
            dimensions=dims, reserved_space=space, metric=metric, approx=False,
            device=device,
        )


@dataclass(frozen=True)
class UsearchKnn(_EmbeddingKnn):
    """KNN under the reference's USearchKnn name (HNSW,
    stdlib/indexing/nearest_neighbors.py:65). Its slab is built with
    ``approx=True``, as the JAX package's is; the port serves that flag
    with the exact top-k (`lax.approx_max_k` has no torch counterpart).
    The HNSW tuning knobs are accepted for API compatibility and ignored."""

    dimensions: int | None = None
    reserved_space: int = 1024
    metric: str = USearchMetricKind.COS
    connectivity: int = 0  # unused on TPU
    expansion_add: int = 0  # unused on TPU
    expansion_search: int = 0  # unused on TPU
    embedder: Any = None
    device: Any = True

    def _host_index_factory(self) -> Callable:
        dims, space, metric, device = (
            self.dimensions, self.reserved_space, self.metric, self.device
        )
        return lambda: VectorSlabIndex(
            dimensions=dims, reserved_space=space, metric=metric, approx=True,
            device=device,
        )


@dataclass(frozen=True)
class IvfPqKnn(_EmbeddingKnn):
    """Device-native incremental IVF-PQ ANN (docs/retrieval.md): coarse
    k-means routing + product-quantized ADC scan + exact rescore,
    maintained under retractions with background retrains
    (`pathway_tpu_torch/indexing/ann.py`).

    Kill switch: ``PATHWAY_ANN=0`` builds the exact slab index instead —
    byte-identical ranking semantics (same (score, key) tie-break), the
    guarantee the `ann` CI leg pins. Corpora under `train_min` rows are
    served exactly either way.

    Tier placement (`tiered`/`hot_lists`/`ram_lists`, docs/retrieval.md
    §tier lifecycle) and the second-stage reranker (`rerank`,
    `stdlib/indexing/reranking.py`) ride the same build-time-env
    discipline: ``PATHWAY_ANN_TIERED=0`` pins the all-resident layout
    byte-identically, and the exact-slab fallback never wraps a
    reranker (an exact first stage has nothing to recover).
    """

    dimensions: int | None = None
    reserved_space: int = 1024
    metric: str = BruteForceKnnMetricKind.COS
    n_lists: int | None = None
    nprobe: int | None = None
    subvectors: int | None = None
    train_min: int = 256
    background_retrain: bool = True
    tiered: bool | None = None
    hot_lists: int | None = None
    ram_lists: int | None = None
    rerank: bool = False
    rerank_expand: int = 4
    embedder: Any = None
    device: Any = True

    def _host_index_factory(self) -> Callable:
        cfg = (
            self.dimensions, self.reserved_space, self.metric, self.n_lists,
            self.nprobe, self.subvectors, self.train_min,
            self.background_retrain, self.tiered, self.hot_lists,
            self.ram_lists, self.rerank, self.rerank_expand, self.device,
        )

        def build():
            # env read at BUILD time (graph lowering), not class-def time,
            # so a test leg's PATHWAY_ANN applies to every pipeline it runs
            from pathway_tpu_torch.indexing import IvfPqIndex, ann_enabled

            if not ann_enabled(True):
                return VectorSlabIndex(
                    dimensions=cfg[0], reserved_space=cfg[1], metric=cfg[2],
                    approx=False, device=cfg[13],
                )
            index = IvfPqIndex(
                dimensions=cfg[0], reserved_space=cfg[1], metric=cfg[2],
                device=cfg[13],
                n_lists=cfg[3], nprobe=cfg[4], subvectors=cfg[5],
                train_min=cfg[6], background_retrain=cfg[7],
                tiered=cfg[8], hot_lists=cfg[9], ram_lists=cfg[10],
            )
            if cfg[11]:
                from pathway_tpu_torch.stdlib.indexing.reranking import (
                    RerankedSlabIndex,
                )

                return RerankedSlabIndex(index, expand=cfg[12])
            return index

        return build


@dataclass(frozen=True)
class LshKnn(_EmbeddingKnn):
    """LSH-bucketed approximate KNN (reference: LshKnn,
    stdlib/indexing/nearest_neighbors.py:262 over ml/classifiers/_knn_lsh.py)."""

    dimensions: int | None = None
    n_or: int = 4
    n_and: int = 8
    bucket_length: float = 2.0
    distance_type: str = "l2"
    embedder: Any = None
    # generic-LSH callables (reference knn_lsh_generic_classifier_train):
    # projection(vec) -> per-table bucket ids; distance(q, doc) -> float
    projection: Any = None
    distance: Any = None

    def _host_index_factory(self) -> Callable:
        cfg = (self.dimensions, self.n_or, self.n_and, self.bucket_length,
               self.distance_type, self.projection, self.distance)
        return lambda: LshIndex(
            dimensions=cfg[0], n_or=cfg[1], n_and=cfg[2],
            bucket_length=cfg[3], metric=cfg[4],
            projection=cfg[5], distance=cfg[6],
        )


@dataclass(frozen=True)
class BruteForceKnnFactory(InnerIndexFactory):
    dimensions: int | None = None
    reserved_space: int = 1024
    metric: str = BruteForceKnnMetricKind.COS
    embedder: Any = None
    device: Any = True

    def build_inner_index(
        self,
        data_column: ColumnReference,
        metadata_column: ColumnExpression | None = None,
    ) -> BruteForceKnn:
        return BruteForceKnn(
            data_column=data_column,
            metadata_column=metadata_column,
            dimensions=self.dimensions,
            reserved_space=self.reserved_space,
            metric=self.metric,
            embedder=self.embedder,
            device=self.device,
        )


@dataclass(frozen=True)
class UsearchKnnFactory(InnerIndexFactory):
    dimensions: int | None = None
    reserved_space: int = 1024
    metric: str = USearchMetricKind.COS
    connectivity: int = 0
    expansion_add: int = 0
    expansion_search: int = 0
    embedder: Any = None
    device: Any = True

    def build_inner_index(
        self,
        data_column: ColumnReference,
        metadata_column: ColumnExpression | None = None,
    ) -> UsearchKnn:
        return UsearchKnn(
            data_column=data_column,
            metadata_column=metadata_column,
            dimensions=self.dimensions,
            reserved_space=self.reserved_space,
            metric=self.metric,
            embedder=self.embedder,
            device=self.device,
        )


@dataclass(frozen=True)
class IvfPqKnnFactory(InnerIndexFactory):
    dimensions: int | None = None
    reserved_space: int = 1024
    metric: str = BruteForceKnnMetricKind.COS
    n_lists: int | None = None
    nprobe: int | None = None
    subvectors: int | None = None
    train_min: int = 256
    background_retrain: bool = True
    tiered: bool | None = None
    hot_lists: int | None = None
    ram_lists: int | None = None
    rerank: bool = False
    rerank_expand: int = 4
    embedder: Any = None
    device: Any = True

    def build_inner_index(
        self,
        data_column: ColumnReference,
        metadata_column: ColumnExpression | None = None,
    ) -> IvfPqKnn:
        return IvfPqKnn(
            data_column=data_column,
            metadata_column=metadata_column,
            dimensions=self.dimensions,
            reserved_space=self.reserved_space,
            metric=self.metric,
            n_lists=self.n_lists,
            nprobe=self.nprobe,
            subvectors=self.subvectors,
            train_min=self.train_min,
            background_retrain=self.background_retrain,
            tiered=self.tiered,
            hot_lists=self.hot_lists,
            ram_lists=self.ram_lists,
            rerank=self.rerank,
            rerank_expand=self.rerank_expand,
            embedder=self.embedder,
            device=self.device,
        )


@dataclass(frozen=True)
class LshKnnFactory(InnerIndexFactory):
    dimensions: int | None = None
    n_or: int = 4
    n_and: int = 8
    bucket_length: float = 2.0
    distance_type: str = "l2"
    embedder: Any = None

    def build_inner_index(
        self,
        data_column: ColumnReference,
        metadata_column: ColumnExpression | None = None,
    ) -> LshKnn:
        return LshKnn(
            data_column=data_column,
            metadata_column=metadata_column,
            dimensions=self.dimensions,
            n_or=self.n_or,
            n_and=self.n_and,
            bucket_length=self.bucket_length,
            distance_type=self.distance_type,
            embedder=self.embedder,
        )
