"""REST servers exposing RAG services.

Reference parity: xpacks/llm/servers.py — `BaseRestServer` (:16) registering
(route, schema, handler) over `rest_connector`, `QARestServer` (:92),
`QASummaryRestServer` (:140), `DocumentStoreServer` (:193),
`serve_callable` (:227).
"""

from __future__ import annotations

import threading
from typing import Any, Callable

import pathway_tpu_torch as pw
from pathway_tpu_torch.internals.table import Table


class BaseRestServer:
    def __init__(self, host: str, port: int, gateway: Any = None, **kwargs: Any):
        from pathway_tpu_torch.io.http import PathwayWebserver

        self.host = host
        self.port = port
        self.webserver = PathwayWebserver(host=host, port=port)
        # one ServingGateway fronts every route of this server
        # (admission control + watermark backpressure, docs/serving.md §6)
        self.gateway = gateway

    def serve(
        self,
        route: str,
        schema: Any,
        handler: Callable[[Table], Table],
        **kwargs: Any,
    ) -> None:
        queries, writer = pw.io.http.rest_connector(
            webserver=self.webserver,
            route=route,
            schema=schema,
            delete_completed_queries=kwargs.pop(
                "delete_completed_queries", False
            ),
            gateway=self.gateway,
        )
        writer(handler(queries))

    def run(
        self,
        threaded: bool = False,
        with_cache: bool = True,
        cache_backend: Any = None,
        **kwargs: Any,
    ):
        """Start serving (runs pw.run; `threaded=True` returns the thread).

        `with_cache`+`cache_backend` wire UDF caching through the
        persistence layer in cache-only mode — no input journaling /
        replay attaches to a serving process (reference: servers.py run
        with_cache, default Backend.filesystem('./Cache'))."""
        if with_cache:
            if cache_backend is None:
                cache_backend = pw.persistence.Backend.filesystem("./Cache")
            kwargs.setdefault(
                "persistence_config",
                pw.persistence.Config.udf_caching(cache_backend),
            )
        if threaded:
            t = threading.Thread(target=pw.run, kwargs=kwargs, daemon=True)
            t.start()
            return t
        return pw.run(**kwargs)


class QARestServer(BaseRestServer):
    """Routes of the QA pipeline (reference: servers.py:92):
    /v1/retrieve, /v1/statistics, /v1/pw_list_documents, /v1/pw_ai_answer,
    /v2/answer, /v2/list_documents."""

    def __init__(self, host: str, port: int, rag_question_answerer: Any, **kwargs: Any):
        super().__init__(host, port, **kwargs)
        self.serve(
            "/v1/retrieve",
            rag_question_answerer.RetrieveQuerySchema,
            rag_question_answerer.retrieve,
        )
        self.serve(
            "/v1/statistics",
            rag_question_answerer.StatisticsQuerySchema,
            rag_question_answerer.statistics,
        )
        self.serve(
            "/v1/pw_list_documents",
            rag_question_answerer.InputsQuerySchema,
            rag_question_answerer.list_documents,
        )
        self.serve(
            "/v1/pw_ai_answer",
            rag_question_answerer.AnswerQuerySchema,
            rag_question_answerer.answer_query,
        )
        self.serve(
            "/v2/answer",
            rag_question_answerer.AnswerQuerySchema,
            rag_question_answerer.answer_query,
        )
        self.serve(
            "/v2/list_documents",
            rag_question_answerer.InputsQuerySchema,
            rag_question_answerer.list_documents,
        )


class QASummaryRestServer(QARestServer):
    """Adds /v1/pw_ai_summary (reference: servers.py:140)."""

    def __init__(self, host: str, port: int, rag_question_answerer: Any, **kwargs: Any):
        super().__init__(host, port, rag_question_answerer, **kwargs)
        self.serve(
            "/v1/pw_ai_summary",
            rag_question_answerer.SummarizeQuerySchema,
            rag_question_answerer.summarize_query,
        )
        self.serve(
            "/v2/summarize",
            rag_question_answerer.SummarizeQuerySchema,
            rag_question_answerer.summarize_query,
        )


class DocumentStoreServer(BaseRestServer):
    """Standalone DocumentStore REST surface (reference: servers.py:193):
    /v1/retrieve, /v1/statistics, /v1/inputs."""

    def __init__(self, host: str, port: int, document_store: Any, **kwargs: Any):
        super().__init__(host, port, **kwargs)
        self.serve(
            "/v1/retrieve",
            document_store.RetrieveQuerySchema,
            document_store.retrieve_query,
        )
        self.serve(
            "/v1/statistics",
            document_store.StatisticsQuerySchema,
            document_store.statistics_query,
        )
        self.serve(
            "/v1/inputs",
            document_store.InputsQuerySchema,
            document_store.inputs_query,
        )


def serve_callable(
    route: str,
    schema: Any,
    host: str = "0.0.0.0",
    port: int = 8000,
    **rest_kwargs: Any,
):
    """Decorator: expose an async callable as a REST endpoint through the
    dataflow (reference: servers.py:227)."""

    def decorator(callable_fn: Callable) -> Callable:
        server = BaseRestServer(host, port)

        def handler(queries: Table) -> Table:
            args = [queries[n] for n in queries._column_names()]
            return queries.select(result=pw.apply_async(callable_fn, *args))

        server.serve(route, schema, handler)
        callable_fn._pw_server = server  # type: ignore[attr-defined]
        return callable_fn

    return decorator
