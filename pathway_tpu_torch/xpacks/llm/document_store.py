"""DocumentStore — the indexing pipeline behind RAG serving.

Reference parity: xpacks/llm/document_store.py `DocumentStore` (:32):
`build_pipeline` (:286) wires docs -> parse (:233) -> post-process (:247) ->
split (:260) -> DataIndex; query services `retrieve_query` (:426),
`inputs_query` (:385), `statistics_query` (:323); filter merging
`merge_filters` (:356); `SlidesDocumentStore` (:471).
"""

from __future__ import annotations

from typing import Any, Callable, Iterable

import pathway_tpu_torch as pw
from pathway_tpu_torch.internals.json import Json
from pathway_tpu_torch.internals.table import Table
from pathway_tpu_torch.stdlib.indexing.colnames import _INDEX_REPLY_SCORE
from pathway_tpu_torch.stdlib.indexing.data_index import DataIndex
from pathway_tpu_torch.stdlib.indexing.retrievers import InnerIndexFactory


def default_retriever_factory(
    embedder: pw.UDF,
    dimensions: int | None = None,
    *,
    ann: bool | None = None,
    with_bm25: bool = False,
    rrf_k: float = 60.0,
    tiered: bool | None = None,
    hot_lists: int | None = None,
    ram_lists: int | None = None,
    rerank: bool = False,
    rerank_expand: int = 4,
) -> InnerIndexFactory:
    """Config-driven retriever selection for document stores.

    `ann` picks the incremental IVF-PQ tier over the exact slab
    (docs/retrieval.md); None defers to the ``PATHWAY_ANN`` env var
    with an exact default (and ``PATHWAY_ANN=0`` vetoes an explicit
    True at lowering time either way — the kill-switch contract).
    `with_bm25` wraps the KNN in a HybridIndexFactory with a BM25
    leg fused by reciprocal rank (the reference's USearch+Tantivy
    pairing as one operator).

    `tiered`/`hot_lists`/`ram_lists` place the IVF routing lists
    across the device/RAM/disk hierarchy, and `rerank` recovers the
    first-stage recall with the batched on-device second stage plus
    adaptive geometric candidate expansion (`rerank_expand` is the
    round-0 overfetch multiplier) — both only meaningful with the
    ANN retriever, silently inert on the exact slab.
    """
    from pathway_tpu_torch.indexing import ann_enabled
    from pathway_tpu_torch.stdlib.indexing.bm25 import TantivyBM25Factory
    from pathway_tpu_torch.stdlib.indexing.hybrid_index import HybridIndexFactory
    from pathway_tpu_torch.stdlib.indexing.nearest_neighbors import (
        BruteForceKnnFactory,
        IvfPqKnnFactory,
    )

    if dimensions is None:
        dimensions = embedder.get_embedding_dimension()
    # ann=False is an explicit exact request the env must not override;
    # ann=True is an opt-in PATHWAY_ANN=0 can veto; None defers entirely
    if ann is not False and ann_enabled(default=bool(ann)):
        knn: InnerIndexFactory = IvfPqKnnFactory(
            dimensions=dimensions, embedder=embedder,
            tiered=tiered, hot_lists=hot_lists, ram_lists=ram_lists,
            rerank=rerank, rerank_expand=rerank_expand,
        )
    else:
        knn = BruteForceKnnFactory(dimensions=dimensions, embedder=embedder)
    if not with_bm25:
        return knn
    return HybridIndexFactory([knn, TantivyBM25Factory()], k=rrf_k)


class DocumentStore:
    """Builds and serves a live document index.

    Args:
        docs: table (or list of tables) of raw documents with columns
            ``data`` (bytes|str) and ``_metadata`` (dict/Json) — the shape
            produced by ``pw.io.fs.read(..., format="binary",
            with_metadata=True)``.
        retriever_factory: builds the inner index over the chunk text.
        parser: UDF bytes -> list[(text, metadata)]; default ParseUtf8.
        splitter: UDF text -> list[(chunk, metadata)]; default no-op.
        doc_post_processors: optional list of (text, metadata) -> (text,
            metadata) callables applied between parsing and splitting.
    """

    class StatisticsQuerySchema(pw.Schema):
        pass

    FilterSchema = pw.schema_from_types(
        metadata_filter=str | None, filepath_globpattern=str | None
    )
    InputsQuerySchema = FilterSchema

    RetrieveQuerySchema = pw.schema_from_types(
        query=str, k=int, metadata_filter=str | None, filepath_globpattern=str | None
    )

    QueryResultSchema = pw.schema_from_types(result=object)
    InputsResultSchema = pw.schema_from_types(result=object)

    def __init__(
        self,
        docs: Table | Iterable[Table],
        retriever_factory: InnerIndexFactory,
        parser: pw.UDF | None = None,
        splitter: pw.UDF | None = None,
        doc_post_processors: list[Callable] | None = None,
    ):
        from pathway_tpu_torch.xpacks.llm.parsers import ParseUtf8
        from pathway_tpu_torch.xpacks.llm.splitters import NullSplitter

        self.docs = docs
        self.retriever_factory = retriever_factory
        self.parser = parser if parser is not None else ParseUtf8()
        self.splitter = splitter if splitter is not None else NullSplitter()
        self.doc_post_processors = doc_post_processors or []
        self.build_pipeline()

    # ------------------------------------------------------------ pipeline

    def _clean_tables(self, docs: Table | Iterable[Table]) -> list[Table]:
        tables = [docs] if isinstance(docs, Table) else list(docs)
        out = []
        for t in tables:
            cols = t._column_names()
            if "data" not in cols:
                raise ValueError("DocumentStore sources need a `data` column")
            if "_metadata" in cols:
                out.append(t.select(data=t.data, _metadata=t._metadata))
            else:
                out.append(t.select(data=t.data, _metadata=pw.apply(lambda: {})))
        return out

    def build_pipeline(self) -> None:
        tables = self._clean_tables(self.docs)
        if not tables:
            raise ValueError(
                "provide at least one data source, e.g. "
                "pw.io.fs.read('./docs', format='binary', with_metadata=True)"
            )
        docs = tables[0].concat_reindex(*tables[1:]) if len(tables) > 1 else tables[0]
        self.input_docs = docs.select(text=docs.data, metadata=docs._metadata)
        self.parsed_docs = self._apply_processor(self.input_docs, self.parser)
        post = self.parsed_docs
        for proc in self.doc_post_processors:
            post = post.select(
                _pp=pw.apply(
                    lambda t, m, p=proc: tuple(p(t, m)), post.text, post.metadata
                )
            ).select(
                text=pw.this._pp[0],
                metadata=pw.this._pp[1],
            )
        self.post_processed_docs = post
        self.chunked_docs = self._apply_processor(
            self.post_processed_docs, self.splitter
        )
        self._retriever = self.retriever_factory.build_index(
            self.chunked_docs.text,
            self.chunked_docs,
            metadata_column=self.chunked_docs.metadata,
        )
        self.stats = self.parsed_docs.reduce(
            count=pw.reducers.count(),
            last_modified=pw.reducers.max(
                pw.apply(_meta_int("modified_at"), self.parsed_docs.metadata)
            ),
            last_indexed=pw.reducers.max(
                pw.apply(_meta_int("seen_at"), self.parsed_docs.metadata)
            ),
            paths=pw.reducers.tuple(
                pw.apply(_meta_str("path"), self.parsed_docs.metadata)
            ),
        )

    def _apply_processor(self, docs: Table, processor: pw.UDF) -> Table:
        """processor(text, metadata-unaware) -> list of (text, extra_meta);
        output rows merge extra metadata over the document metadata."""

        def run(text: Any, metadata: Any) -> tuple:
            pieces = processor.func(text)
            base = metadata.value if isinstance(metadata, Json) else (metadata or {})
            out = []
            for piece in pieces:
                if isinstance(piece, (tuple, list)) and len(piece) == 2:
                    chunk, extra = piece
                else:
                    chunk, extra = piece, {}
                merged = dict(base)
                merged.update(extra or {})
                out.append((str(chunk), merged))
            return tuple(out)

        return (
            docs.select(_parts=pw.apply(run, docs.text, docs.metadata))
            .flatten(pw.this._parts)
            .select(
                text=pw.this._parts[0],
                metadata=pw.this._parts[1],
            )
        )

    # ------------------------------------------------------------- queries

    @staticmethod
    def merge_filters(queries: Table) -> Table:
        """Combine metadata_filter and filepath_globpattern into one filter
        string (reference: document_store.py:356)."""

        def _merge(metadata_filter: Any, globpattern: Any) -> Any:
            # unlike the reference (which rewrites JMESPath backticks for the
            # jmespath library), our filter grammar evaluates backtick JSON
            # literals natively — pass the expression through untouched
            parts = []
            if metadata_filter:
                parts.append(f"({metadata_filter})")
            if globpattern:
                parts.append(f"globmatch('{globpattern}', path)")
            return " && ".join(parts) if parts else None

        keep = [
            n
            for n in queries._column_names()
            if n not in ("metadata_filter", "filepath_globpattern")
        ]
        return queries.select(
            *[queries[n] for n in keep],
            metadata_filter=pw.apply(
                _merge, queries.metadata_filter, queries.filepath_globpattern
            ),
        )

    def retrieve_query(self, retrieval_queries: Table) -> Table:
        """Top-k chunks per query (reference: document_store.py:426)."""
        queries = self.merge_filters(retrieval_queries)
        results = self._retriever.query_as_of_now(
            queries.query,
            number_of_matches=queries.k,
            metadata_filter=queries.metadata_filter,
            collapse_rows=True,
            with_distances=True,
        )

        def fmt(texts: Any, metas: Any, scores: Any) -> Json:
            texts = texts or ()
            metas = metas or ()
            scores = scores or ()
            return Json(
                sorted(
                    [
                        {"text": t, "metadata": _plain(m), "dist": s}
                        for t, m, s in zip(texts, metas, scores)
                    ],
                    key=lambda d: d["dist"],
                )
            )

        return results.select(
            result=pw.apply(
                fmt, results.text, results.metadata, results[_INDEX_REPLY_SCORE]
            )
        )

    def inputs_query(self, input_queries: Table) -> Table:
        """List indexed input documents (reference: document_store.py:385)."""
        from pathway_tpu_torch.stdlib.indexing.filters import compile_filter

        all_metas = self.input_docs.reduce(
            metadatas=pw.reducers.tuple(self.input_docs.metadata)
        )
        queries = self.merge_filters(input_queries)

        def fmt(metas: Any, metadata_filter: Any) -> Json:
            metas = metas or ()
            out = [_plain(m) for m in metas]
            if metadata_filter:
                pred = compile_filter(str(metadata_filter))
                out = [m for m in out if pred(m)]
            return Json(out)

        joined = queries.join_left(all_metas, id=queries.id).select(
            result=pw.apply(fmt, pw.right.metadatas, pw.left.metadata_filter)
        )
        return joined

    def statistics_query(self, info_queries: Table) -> Table:
        """Index statistics (reference: document_store.py:323)."""

        def fmt(count: Any, last_modified: Any, last_indexed: Any) -> Json:
            if count:
                return Json(
                    {
                        "file_count": count,
                        "last_modified": last_modified,
                        "last_indexed": last_indexed,
                    }
                )
            return Json(
                {"file_count": 0, "last_modified": None, "last_indexed": None}
            )

        return info_queries.join_left(self.stats, id=info_queries.id).select(
            result=pw.apply(
                fmt, pw.right.count, pw.right.last_modified, pw.right.last_indexed
            )
        )

    @property
    def index(self) -> DataIndex:
        return self._retriever


class SlidesDocumentStore(DocumentStore):
    """DocumentStore variant exposing the parsed slide inventory
    (reference: document_store.py:471)."""

    def parsed_documents_query(self, parse_docs_queries: Table) -> Table:
        all_parsed = self.parsed_docs.reduce(
            metadatas=pw.reducers.tuple(self.parsed_docs.metadata)
        )

        def fmt(metas: Any) -> Json:
            return Json([_plain(m) for m in (metas or ())])

        return parse_docs_queries.join_left(
            all_parsed, id=parse_docs_queries.id
        ).select(result=pw.apply(fmt, pw.right.metadatas))


def _plain(m: Any) -> Any:
    if isinstance(m, Json):
        return m.value
    return m


def _meta_int(field: str) -> Callable[[Any], int]:
    def get(m: Any) -> int:
        d = m.value if isinstance(m, Json) else (m or {})
        try:
            return int(d.get(field, 0))
        except (TypeError, ValueError, AttributeError):
            return 0

    return get


def _meta_str(field: str) -> Callable[[Any], str]:
    def get(m: Any) -> str:
        d = m.value if isinstance(m, Json) else (m or {})
        try:
            return str(d.get(field, ""))
        except AttributeError:
            return ""

    return get
