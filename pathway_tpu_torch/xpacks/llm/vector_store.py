"""VectorStoreServer / VectorStoreClient — the self-contained
embed + index + REST service.

Reference parity: xpacks/llm/vector_store.py `VectorStoreServer` (:38,
from_langchain_components :92, from_llamaindex_components :136,
run_server :456), `SlidesVectorStoreServer` (:566) and
`VectorStoreClient` (:629). The indexing pipeline itself delegates to
DocumentStore (the reference kept a parallel implementation; one code
path is enough here), while this module owns what the reference's class
owns on top of it: plain-callable component adapters (LangChain /
LlamaIndex interop), embedding-dimension probing, the slides variant
with metadata redaction, and the HTTP client.

Counterpart of ``pathway_tpu/xpacks/llm/vector_store.py``, copied under
the rename but for one seam: with neither an embedder nor an index
factory given, the server embeds with the port's ``TorchEmbedder`` (on
the CUDA card). ``ann=True`` reaches the port's ``IvfPqKnnFactory``
through ``default_retriever_factory``.
"""

from __future__ import annotations

import asyncio
import json
import urllib.error
import urllib.request
from typing import Any, Callable

import pathway_tpu_torch as pw
from pathway_tpu_torch.internals.json import Json
from pathway_tpu_torch.internals.table import Table
from pathway_tpu_torch.xpacks.llm.document_store import (
    DocumentStore,
    _plain,
    default_retriever_factory,
)


def _call_maybe_async(fn: Callable, *args: Any) -> Any:
    res = fn(*args)
    if asyncio.iscoroutine(res):
        # run on the engine's dedicated loop thread: asyncio.run would
        # raise under an already-running loop (Jupyter, async apps)
        from pathway_tpu_torch.engine.runtime import _get_async_loop

        return asyncio.run_coroutine_threadsafe(res, _get_async_loop()).result()
    return res


class _CallableUDF(pw.UDF):
    """Adapter: a plain (sync or async) callable used where the pipeline
    expects a pw.UDF. The reference's VectorStoreServer accepts raw
    callables for embedder/parser/splitter; this preserves that API over
    the UDF-based DocumentStore. deterministic defaults False (memoize
    results) — an API-backed embedder is not bit-stable across calls, and
    recompute-on-retraction would retract values never inserted."""

    def __init__(self, fn: Callable, *, deterministic: bool = False):
        super().__init__(deterministic=deterministic)
        self._fn = fn
        if asyncio.iscoroutinefunction(fn):

            async def _w(x: Any, **kwargs: Any) -> Any:
                return await fn(x)

        else:

            def _w(x: Any, **kwargs: Any) -> Any:  # type: ignore[misc]
                return fn(x)

        self.__wrapped__ = _w  # type: ignore[method-assign]


class _CallableEmbedder(_CallableUDF):
    def get_embedding_dimension(self, **kwargs: Any) -> int:
        # probe like the reference: embed a sentinel and measure
        return len(_call_maybe_async(self._fn, "."))


def _as_embedder(embedder: Any) -> Any:
    if embedder is None or isinstance(embedder, pw.UDF):
        return embedder
    return _CallableEmbedder(embedder)


def _as_processor(fn: Any) -> Any:
    if fn is None or isinstance(fn, pw.UDF):
        return fn
    if asyncio.iscoroutinefunction(fn):
        # DocumentStore applies parsers/splitters synchronously inside
        # the document pipeline (only the embedder rides async-apply) —
        # failing here beats a coroutine-is-not-iterable crash at runtime
        raise ValueError(
            "parser/splitter callables must be synchronous; wrap async "
            "work in an async embedder or a pw.UDF with an async executor"
        )
    return _CallableUDF(fn)


class VectorStoreServer:
    """Builds the document indexing pipeline and serves it over REST
    (reference: vector_store.py:38). Accepts either pw.UDF components or
    plain callables (the reference's calling convention)."""

    def __init__(
        self,
        *docs: Table,
        embedder: Any = None,
        parser: Any = None,
        splitter: Any = None,
        doc_post_processors: list[Callable] | None = None,
        index_factory: Any = None,
        ann: bool | None = None,
        with_bm25: bool = False,
    ):
        if embedder is None and index_factory is None:
            from pathway_tpu_torch.xpacks.llm.embedders import TorchEmbedder

            embedder = TorchEmbedder()
        embedder = _as_embedder(embedder)
        self.embedder = embedder
        if index_factory is None:
            # ann=True -> incremental IVF-PQ tier; None defers to
            # PATHWAY_ANN (exact default); with_bm25 adds RRF text
            # fusion. See docs/retrieval.md.
            index_factory = default_retriever_factory(
                embedder, ann=ann, with_bm25=with_bm25
            )
        self.document_store = DocumentStore(
            list(docs),
            retriever_factory=index_factory,
            parser=_as_processor(parser),
            splitter=_as_processor(splitter),
            doc_post_processors=doc_post_processors,
        )

    # ------------------------------------------------ component adapters

    @classmethod
    def from_langchain_components(
        cls,
        *docs: Table,
        embedder: Any,
        parser: Any = None,
        splitter: Any = None,
        **kwargs: Any,
    ) -> "VectorStoreServer":
        """Build from LangChain components (reference:
        vector_store.py:92): `embedder` is a langchain Embeddings object
        (`aembed_documents`), `splitter` a BaseDocumentTransformer.
        langchain_core is only imported when a splitter is given (its
        Document type is needed to feed transform_documents)."""
        generic_splitter = None
        if splitter is not None:
            try:
                from langchain_core.documents import Document
            except ImportError as e:
                raise ImportError(
                    "a LangChain splitter needs langchain_core: "
                    "`pip install langchain_core`"
                ) from e

            def generic_splitter(x: str) -> list[tuple[str, dict]]:
                return [
                    (doc.page_content, doc.metadata)
                    for doc in splitter.transform_documents(
                        [Document(page_content=x)]
                    )
                ]

        async def generic_embedder(x: str) -> Any:
            res = await embedder.aembed_documents([x])
            import numpy as np

            return np.asarray(res[0], dtype=np.float32)

        return cls(
            *docs,
            embedder=generic_embedder,
            parser=parser,
            splitter=generic_splitter,
            **kwargs,
        )

    @classmethod
    def from_llamaindex_components(
        cls,
        *docs: Table,
        transformations: list[Any],
        parser: Any = None,
        **kwargs: Any,
    ) -> "VectorStoreServer":
        """Build from LlamaIndex TransformComponents (reference:
        vector_store.py:136): the LAST transformation must be an
        embedding component (`aget_text_embedding`); earlier ones run as
        the splitter. llama_index is only imported when there are node
        transformations to run."""
        if not transformations:
            raise ValueError("Transformations list cannot be None or empty.")
        transformations = list(transformations)
        embedder = transformations.pop()
        if not hasattr(embedder, "aget_text_embedding"):
            raise ValueError(
                "Last step of transformations should be an embedding "
                f"component (aget_text_embedding), found {type(embedder)}."
            )

        async def embedding_callable(x: str) -> Any:
            import numpy as np

            return np.asarray(
                await embedder.aget_text_embedding(x), dtype=np.float32
            )

        generic_transformer = None
        if transformations:
            try:
                from llama_index.core.ingestion.pipeline import (
                    run_transformations,
                )
                from llama_index.core.schema import MetadataMode, TextNode
            except ImportError as e:
                raise ImportError(
                    "LlamaIndex node transformations need llama-index-core: "
                    "`pip install llama-index-core`"
                ) from e

            def generic_transformer(x: str) -> list[tuple[str, dict]]:
                nodes = run_transformations([TextNode(text=x)], transformations)
                return [
                    (
                        node.get_content(metadata_mode=MetadataMode.NONE),
                        node.extra_info or {},
                    )
                    for node in nodes
                ]

        return cls(
            *docs,
            embedder=embedding_callable,
            parser=parser,
            splitter=generic_transformer,
            **kwargs,
        )

    # ---------------------------------------------------------- services

    RetrieveQuerySchema = DocumentStore.RetrieveQuerySchema
    StatisticsQuerySchema = DocumentStore.StatisticsQuerySchema
    InputsQuerySchema = DocumentStore.InputsQuerySchema

    def retrieve_query(self, queries: Table) -> Table:
        return self.document_store.retrieve_query(queries)

    def statistics_query(self, queries: Table) -> Table:
        return self.document_store.statistics_query(queries)

    def inputs_query(self, queries: Table) -> Table:
        return self.document_store.inputs_query(queries)

    @property
    def index(self):
        return self.document_store.index

    def __repr__(self) -> str:
        return (
            f"{type(self).__name__}(embedder={type(self.embedder).__name__}, "
            f"store={type(self.document_store).__name__})"
        )

    def run_server(
        self,
        host: str = "0.0.0.0",
        port: int = 8000,
        threaded: bool = False,
        with_cache: bool = True,
        cache_backend: Any = None,
        **kwargs: Any,
    ):
        from pathway_tpu_torch.xpacks.llm.servers import DocumentStoreServer

        # serve SELF (duck-typed store), not the inner DocumentStore —
        # subclass endpoint overrides (SlidesVectorStoreServer's redacted
        # inputs listing) must be what REST clients reach
        server = DocumentStoreServer(host, port, self)
        return server.run(
            threaded=threaded,
            with_cache=with_cache,
            cache_backend=cache_backend,
            **kwargs,
        )


class SlidesVectorStoreServer(VectorStoreServer):
    """Vector index for the slide-search template (reference:
    vector_store.py:566): `inputs` lists metadata AFTER parsing and
    post-processing (one entry per parsed slide, not per input file),
    with bulky fields (the base64 slide image) redacted."""

    excluded_response_metadata: list[str] = ["b64_image"]

    def inputs_query(self, input_queries: Table) -> Table:
        from pathway_tpu_torch.stdlib.indexing.filters import compile_filter

        store = self.document_store
        all_metas = store.parsed_docs.reduce(
            metadatas=pw.reducers.tuple(store.parsed_docs.metadata)
        )
        queries = DocumentStore.merge_filters(input_queries)
        excluded = list(self.excluded_response_metadata)

        def fmt(metas: Any, metadata_filter: Any) -> Json:
            out = [_plain(m) for m in (metas or ())]
            if metadata_filter:
                pred = compile_filter(str(metadata_filter))
                out = [m for m in out if pred(m)]
            # copy before redacting: _plain returns the LIVE metadata
            # dicts — popping in place would strip the slide images from
            # the store itself for every later consumer
            redacted = []
            for m in out:
                if isinstance(m, dict):
                    m = {k: v for k, v in m.items() if k not in excluded}
                redacted.append(m)
            return Json(redacted)

        return queries.join_left(all_metas, id=queries.id).select(
            result=pw.apply(fmt, pw.right.metadatas, pw.left.metadata_filter)
        )

    def parsed_documents_query(self, parse_docs_queries: Table) -> Table:
        return self.inputs_query(parse_docs_queries)


class VectorStoreClient:
    """HTTP client for the vector-store endpoints (reference:
    vector_store.py:629)."""

    def __init__(
        self,
        host: str | None = None,
        port: int | None = None,
        url: str | None = None,
        timeout: float | None = 15.0,
        additional_headers: dict[str, str] | None = None,
    ):
        err = "Either (`host` and `port`) or `url` must be set, but not both."
        if url is not None:
            if host is not None or port is not None:
                raise ValueError(err)
            self.url = url
        else:
            if host is None:
                raise ValueError(err)
            # default matches run_server's port=8000 — a silent :80
            # fallback would point at the wrong service
            port = port or 8000
            self.url = f"http://{host}:{port}"
        self.timeout = timeout
        self.additional_headers = additional_headers or {}

    def _post(self, route: str, payload: dict) -> Any:
        req = urllib.request.Request(
            self.url + route,
            data=json.dumps(payload).encode(),
            headers={
                "Content-Type": "application/json",
                **self.additional_headers,
            },
            method="POST",
        )
        try:
            with urllib.request.urlopen(req, timeout=self.timeout) as resp:
                return json.loads(resp.read().decode())
        except urllib.error.HTTPError as e:
            detail = e.read().decode(errors="replace")[:500]
            raise RuntimeError(
                f"vector store request {route} failed: HTTP {e.code} {detail}"
            ) from e

    def query(
        self,
        query: str,
        k: int = 3,
        metadata_filter: str | None = None,
        filepath_globpattern: str | None = None,
    ) -> list[dict]:
        return self._post(
            "/v1/retrieve",
            {
                "query": query,
                "k": k,
                "metadata_filter": metadata_filter,
                "filepath_globpattern": filepath_globpattern,
            },
        )

    __call__ = query

    def get_vectorstore_statistics(self) -> dict:
        return self._post("/v1/statistics", {})

    def get_input_files(
        self,
        metadata_filter: str | None = None,
        filepath_globpattern: str | None = None,
    ) -> list[dict]:
        return self._post(
            "/v1/inputs",
            {
                "metadata_filter": metadata_filter,
                "filepath_globpattern": filepath_globpattern,
            },
        )
