"""Prompt templates for the RAG pipelines.

Reference parity: xpacks/llm/prompts.py (447 LoC of template text +
`RAGPromptTemplate`/`prompt_qa` style helpers). Text is original.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import pathway_tpu_torch as pw


@dataclass
class RAGPromptTemplate:
    """A template with {context} and {query} slots."""

    template: str

    def format(self, context: str, query: str) -> str:
        return self.template.format(context=context, query=query)


DEFAULT_QA_TEMPLATE = RAGPromptTemplate(
    template=(
        "Answer the question based only on the context below. If the context "
        "does not contain the answer, reply exactly: No information found.\n\n"
        "Context:\n{context}\n\nQuestion: {query}\nAnswer:"
    )
)

DEFAULT_SUMMARY_TEMPLATE = (
    "Summarize the following texts into a single short summary:\n\n{text}\n\nSummary:"
)


@pw.udf
def prompt_qa(query: str, docs: tuple) -> str:
    """Build a QA prompt from retrieved doc texts (reference: prompts.py
    prompt_qa / prompt_short_qa family)."""
    context = "\n\n".join(str(d) for d in docs)
    return DEFAULT_QA_TEMPLATE.format(context=context, query=query)


@pw.udf
def prompt_qa_geometric_rag(query: str, docs: tuple) -> str:
    context = "\n\n".join(str(d) for d in docs)
    return DEFAULT_QA_TEMPLATE.format(context=context, query=query)


@pw.udf
def prompt_summarize(texts: tuple) -> str:
    return DEFAULT_SUMMARY_TEMPLATE.format(text="\n\n".join(str(t) for t in texts))


@pw.udf
def prompt_citing_qa(query: str, docs: tuple) -> str:
    context = "\n\n".join(
        f"[{i + 1}] {d}" for i, d in enumerate(str(d) for d in docs)
    )
    return (
        "Answer using only the numbered context passages and cite them as "
        f"[n].\n\nContext:\n{context}\n\nQuestion: {query}\nAnswer:"
    )
