"""Hybrid retrieval — reciprocal-rank fusion of several retrievers.

Reference parity: stdlib/indexing/hybrid_index.py `HybridIndex` (:14) +
`HybridIndexFactory`: each retriever ranks the query; a doc's fused score is
sum over retrievers of 1/(k + rank), higher = better, negated into the
uniform smaller-is-better convention. The reference fuses in Python dataflow
(flatten + groupby over reply tuples); here fusion happens inside one hybrid
host index so the whole thing stays a single engine operator.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable

from pathway_tpu_torch.internals.expression import (
    ColumnExpression,
    ColumnReference,
    MakeTupleExpression,
)
from pathway_tpu_torch.internals.keys import Key
from pathway_tpu_torch.internals.table import Table
from pathway_tpu_torch.stdlib.indexing.retrievers import InnerIndex, InnerIndexFactory


class _HybridHostIndex:
    """Fans add/remove/search out to sub-indexes and fuses rankings.

    `add` receives a tuple with one data payload per sub-index (their data
    columns may differ — e.g. embeddings + raw text); `search` receives a
    tuple with one query payload per sub-index (each retriever's own query
    transform — embedded vector for KNNs, raw text for BM25).
    """

    def __init__(self, subs: list[Any], rrf_k: float, per_sub_factor: int = 2):
        self.subs = subs
        self.rrf_k = rrf_k
        self.per_sub_factor = per_sub_factor

    def add(self, key: Key, data: Any, metadata: Any = None) -> None:
        for sub, payload in zip(self.subs, data):
            sub.add(key, payload, metadata)

    def remove(self, key: Key) -> None:
        for sub in self.subs:
            sub.remove(key)

    def search(self, query: Any, k: int, metadata_filter: str | None = None):
        fetch = max(k * self.per_sub_factor, k)
        ranked_lists = [
            sub.search(payload, fetch, metadata_filter)
            for sub, payload in zip(self.subs, query)
        ]
        scores: dict[Key, float] = {}
        for results in ranked_lists:
            for key, _score in results:
                scores.setdefault(key, 0.0)
        for results in ranked_lists:
            for rank, (key, _score) in enumerate(results):
                scores[key] += 1.0 / (self.rrf_k + rank + 1)
            if len(results) < fetch:
                # SHORT list: this sub ranked everything it matches, so a
                # doc absent from it bounds at "just past the fetch
                # horizon" — pad it there (strictly below every real hit
                # of this sub) instead of dropping its contribution to 0.
                # Without the pad, a sub returning 2 hits (a rare BM25
                # term) outranks every other sub's top hits: its lone
                # 1/(K+1) ties the other sub's rank-0 and beats its
                # rank-1, however strong those vector matches are.
                seen = {key for key, _ in results}
                pad = 1.0 / (self.rrf_k + fetch + 1)
                for key in scores:
                    if key not in seen:
                        scores[key] += pad
        # (score, key) tie-break: fusion output must not depend on dict
        # insertion order (worker-count invariance, like every retriever)
        ranked = sorted(
            scores.items(), key=lambda kv: (-kv[1], kv[0].value)
        )[:k]
        return [(key, -s) for key, s in ranked]


@dataclass(frozen=True)
class HybridIndex(InnerIndex):
    """RRF fusion index. All retrievers must index the same table (the data
    payloads are zipped row-wise into the engine)."""

    retrievers: tuple[InnerIndex, ...] = ()
    k: float = 60.0  # the RRF constant

    def __init__(self, retrievers: list[InnerIndex], k: float = 60.0):
        if len(retrievers) < 2:
            raise ValueError("HybridIndex requires at least two retrievers")
        first = retrievers[0]
        # compare the USER-facing source table: embedder retrievers derive
        # fresh embedded tables, which would never be identical
        tables = {id(r.data_column.table) for r in retrievers}
        if len(tables) != 1:
            raise ValueError("all HybridIndex retrievers must index one table")
        object.__setattr__(self, "data_column", first.data_column)
        object.__setattr__(self, "metadata_column", first.metadata_column)
        object.__setattr__(self, "retrievers", tuple(retrievers))
        object.__setattr__(self, "k", k)

    def _data_table(self) -> Table:
        return self.retrievers[0].data_column.table

    def _data_expr(self) -> ColumnExpression:
        return MakeTupleExpression(*[r._data_expr() for r in self.retrievers])

    def _query_expr(self, query_column: ColumnExpression) -> ColumnExpression:
        # each sub-index gets its own query transform (embedder KNNs embed,
        # BM25 passes the raw text) — zipped with subs in _HybridHostIndex
        return MakeTupleExpression(
            *[r._query_expr(query_column) for r in self.retrievers]
        )

    def _host_index_factory(self) -> Callable:
        factories = [r._host_index_factory() for r in self.retrievers]
        rrf_k = self.k
        return lambda: _HybridHostIndex([f() for f in factories], rrf_k)


@dataclass(frozen=True)
class HybridIndexFactory(InnerIndexFactory):
    retriever_factories: list[InnerIndexFactory] = field(default_factory=list)
    k: float = 60.0

    def build_inner_index(
        self,
        data_column: ColumnReference,
        metadata_column: ColumnExpression | None = None,
    ) -> HybridIndex:
        retrievers = [
            f.build_inner_index(data_column, metadata_column)
            for f in self.retriever_factories
        ]
        return HybridIndex(retrievers, k=self.k)
