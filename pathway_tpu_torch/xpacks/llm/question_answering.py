"""RAG question-answering pipelines.

Reference parity: xpacks/llm/question_answering.py —
`BaseRAGQuestionAnswerer` (:314, retrieve -> prompt -> LLM),
`AdaptiveRAGQuestionAnswerer` (:622) built on
`answer_with_geometric_rag_strategy` (:97): ask with k docs; on
"No information found" re-ask with k*factor docs, up to max_iters.
`SummaryQuestionAnswerer` (:307).
"""

from __future__ import annotations

import asyncio
from typing import Any

import pathway_tpu_torch as pw
from pathway_tpu_torch.internals.json import Json
from pathway_tpu_torch.internals.table import Table
from pathway_tpu_torch.xpacks.llm.document_store import DocumentStore
from pathway_tpu_torch.xpacks.llm.prompts import DEFAULT_QA_TEMPLATE, DEFAULT_SUMMARY_TEMPLATE

NO_INFO = "No information found."


AnswerQuerySchema = pw.schema_from_types(
    prompt=str,
    filters=str | None,
    return_context_docs=bool | None,
)

SummarizeQuerySchema = pw.schema_from_types(text_list=object)


async def _call_llm(llm: Any, prompt: str) -> str:
    messages = Json([{"role": "user", "content": prompt}])
    res = llm.func(messages)
    if asyncio.iscoroutine(res):
        res = await res
    return str(res)


async def answer_with_geometric_rag_strategy(
    question: str,
    documents: list[str],
    llm_chat: Any,
    n_starting_documents: int = 2,
    factor: int = 2,
    max_iterations: int = 4,
    strict_prompt: bool = False,
) -> str:
    """Geometric context expansion (reference: question_answering.py:97)."""
    n = n_starting_documents
    answer = NO_INFO
    for _ in range(max_iterations):
        docs = documents[:n]
        prompt = DEFAULT_QA_TEMPLATE.format(
            context="\n\n".join(str(d) for d in docs), query=question
        )
        answer = await _call_llm(llm_chat, prompt)
        if NO_INFO.rstrip(".").lower() not in answer.lower():
            return answer
        if n >= len(documents):
            break
        n *= factor
    return answer


class BaseRAGQuestionAnswerer:
    """retrieve -> prompt -> LLM (reference: question_answering.py:314)."""

    AnswerQuerySchema = AnswerQuerySchema
    SummarizeQuerySchema = SummarizeQuerySchema
    RetrieveQuerySchema = DocumentStore.RetrieveQuerySchema
    StatisticsQuerySchema = DocumentStore.StatisticsQuerySchema
    InputsQuerySchema = DocumentStore.InputsQuerySchema

    def __init__(
        self,
        llm: Any,
        indexer: DocumentStore,
        *,
        search_topk: int = 6,
        prompt_template: Any = None,
        summarize_template: Any = None,
    ):
        self.llm = llm
        self.indexer = indexer
        self.search_topk = search_topk
        self.prompt_template = prompt_template or DEFAULT_QA_TEMPLATE
        self.summarize_template = summarize_template or DEFAULT_SUMMARY_TEMPLATE
        self.server: Any = None

    # -------------------------------------------------------------- answer

    def _retrieve_docs(self, queries: Table) -> Table:
        """queries(prompt, filters) -> + docs tuple column."""
        prepared = queries.select(
            query=queries.prompt,
            k=self.search_topk,
            metadata_filter=queries.filters,
            filepath_globpattern=None,
        )
        merged = DocumentStore.merge_filters(prepared)
        results = self.indexer.index.query_as_of_now(
            merged.query,
            number_of_matches=merged.k,
            metadata_filter=merged.metadata_filter,
            collapse_rows=True,
            with_distances=False,
        )
        return results  # has columns: query, k, metadata_filter, text, metadata, ids

    def answer_query(self, pw_ai_queries: Table) -> Table:
        """The /v1/pw_ai_answer service."""
        docs = self._retrieve_docs(pw_ai_queries)
        llm = self.llm
        template = self.prompt_template

        async def answer(query: Any, texts: Any, metas: Any, want_docs: Any) -> Json:
            texts = texts or ()
            prompt = template.format(
                context="\n\n".join(str(t) for t in texts), query=str(query)
            )
            response = await _call_llm(llm, prompt)
            payload: dict[str, Any] = {"response": response}
            if want_docs:
                payload["context_docs"] = [
                    {"text": t, "metadata": m.value if isinstance(m, Json) else m}
                    for t, m in zip(texts, metas or ())
                ]
            return Json(payload)

        # materialize the flag onto the docs universe first: async-apply
        # arguments may only reference their own table
        docs = docs.with_columns(_want_docs=_want_docs_expr(pw_ai_queries, docs))
        answered = docs.select(
            result=pw.apply_async(
                answer, docs.query, docs.text, docs.metadata, docs._want_docs
            )
        )
        return answered

    pw_ai_query = answer_query  # reference-compat alias

    # ----------------------------------------------------------- summarize

    def summarize_query(self, summarize_queries: Table) -> Table:
        llm = self.llm
        template = self.summarize_template

        async def summarize(text_list: Any) -> Json:
            items = text_list.value if isinstance(text_list, Json) else text_list
            prompt = template.format(text="\n\n".join(str(t) for t in items or ()))
            return Json({"response": await _call_llm(llm, prompt)})

        return summarize_queries.select(
            result=pw.apply_async(summarize, summarize_queries.text_list)
        )

    # ------------------------------------------------------- index services

    def retrieve(self, queries: Table) -> Table:
        return self.indexer.retrieve_query(queries)

    def statistics(self, queries: Table) -> Table:
        return self.indexer.statistics_query(queries)

    def list_documents(self, queries: Table) -> Table:
        return self.indexer.inputs_query(queries)

    # --------------------------------------------------------------- serve

    def build_server(self, host: str, port: int, **kwargs: Any):
        from pathway_tpu_torch.xpacks.llm.servers import QARestServer

        self.server = QARestServer(host, port, self, **kwargs)
        return self.server

    def run_server(self, host: str = "0.0.0.0", port: int = 8000, **kwargs: Any):
        if self.server is None:
            self.build_server(host, port)
        return self.server.run(**kwargs)


class AdaptiveRAGQuestionAnswerer(BaseRAGQuestionAnswerer):
    """Geometric context expansion (reference: question_answering.py:622).

    Retrieves `max_context_docs` once, then asks the LLM with a geometrically
    growing prefix — cheap-first question answering."""

    def __init__(
        self,
        llm: Any,
        indexer: DocumentStore,
        *,
        n_starting_documents: int = 2,
        factor: int = 2,
        max_iterations: int = 4,
        **kwargs: Any,
    ):
        kwargs.setdefault(
            "search_topk", n_starting_documents * factor ** (max_iterations - 1)
        )
        super().__init__(llm, indexer, **kwargs)
        self.n_starting_documents = n_starting_documents
        self.factor = factor
        self.max_iterations = max_iterations

    def answer_query(self, pw_ai_queries: Table) -> Table:
        docs = self._retrieve_docs(pw_ai_queries)
        llm = self.llm
        n0, factor, iters = (
            self.n_starting_documents,
            self.factor,
            self.max_iterations,
        )

        async def answer(query: Any, texts: Any) -> Json:
            response = await answer_with_geometric_rag_strategy(
                str(query), list(texts or ()), llm, n0, factor, iters
            )
            return Json({"response": response})

        return docs.select(result=pw.apply_async(answer, docs.query, docs.text))

    pw_ai_query = answer_query


class SummaryQuestionAnswerer(BaseRAGQuestionAnswerer):
    """Summarization-only endpoint surface (reference:
    question_answering.py:307)."""


def _want_docs_expr(queries: Table, docs: Table):
    if "return_context_docs" in docs._column_names():
        return docs.return_context_docs
    if "return_context_docs" in queries._column_names():
        # collapse result preserves query columns, so this should not happen;
        # defensive fallback
        return queries.return_context_docs
    return False
