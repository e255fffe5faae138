"""Rerankers — (doc, query) -> relevance score UDFs + top-k filtering.

Reference parity: xpacks/llm/rerankers.py — `LLMReranker` (:58),
`CrossEncoderReranker` (:186, torch), `EncoderReranker` (:251, sentence
transformers), `FlashRankReranker` (:319), `rerank_topk_filter` (:28).

Counterpart of ``pathway_tpu/xpacks/llm/rerankers.py``, copied under the
rename but for one seam: `EncoderReranker` scores with the port's own
encoder, ``TorchEmbedder`` (on the CUDA card by default; the query and
the doc are encoded in one batch and scored by their inner product).
`CrossEncoderReranker` and `FlashRankReranker` stay behind their optional
imports, as in the JAX package.
"""

from __future__ import annotations

from typing import Any

import numpy as np

import pathway_tpu_torch as pw
from pathway_tpu_torch.internals.json import Json


@pw.udf
def rerank_topk_filter(
    docs: list[Any], scores: list[float], k: int = 5
) -> tuple[list[Any], list[float]]:
    """Keep the k best-scored docs (reference: rerankers.py:28)."""
    paired = sorted(zip(docs, scores), key=lambda ds: -ds[1])[:k]
    if not paired:
        return ([], [])
    top_docs, top_scores = zip(*paired)
    return (list(top_docs), list(top_scores))


class LLMReranker(pw.UDF):
    """Ask a chat model to rate doc relevance 1-5 (reference: rerankers.py:58)."""

    PROMPT = (
        "Given a query and a document, rate on an integer scale of 1 to 5 "
        "how relevant the document is to the query. Answer with ONLY the "
        "number.\nQuery: {query}\nDocument: {doc}\nRating:"
    )

    def __init__(self, llm: Any, *, retry_strategy: Any = None, cache_strategy: Any = None):
        from pathway_tpu_torch.internals import udfs

        super().__init__(
            executor=udfs.async_executor(retry_strategy=retry_strategy),
            cache_strategy=cache_strategy,
        )
        self.llm = llm

    async def __wrapped__(self, doc: str, query: str, **kwargs: Any) -> float:
        from pathway_tpu_torch.xpacks.llm._utils import _extract_value

        prompt = self.PROMPT.format(query=query, doc=doc)
        messages = [{"role": "user", "content": prompt}]
        res = self.llm.func(Json(messages))
        import asyncio

        if asyncio.iscoroutine(res):
            res = await res
        try:
            return float(str(_extract_value(res)).strip()[0])
        except (ValueError, IndexError):
            raise ValueError(f"reranker got unparsable rating {res!r}") from None


class EncoderReranker(pw.UDF):
    """Bi-encoder similarity scoring on the card (reference:
    rerankers.py:251 uses sentence_transformers; here the embedder, by
    default a ``TorchEmbedder``, encodes query and doc in one batch and
    scores by inner product)."""

    def __init__(self, embedder: Any = None, **kwargs: Any):
        super().__init__()
        if embedder is None:
            from pathway_tpu_torch.xpacks.llm.embedders import TorchEmbedder

            embedder = TorchEmbedder()
        self.embedder = embedder

    def __wrapped__(self, doc: str, query: str, **kwargs: Any) -> float:
        qv, dv = self.embedder.encode_many([query, doc])
        return float(np.dot(qv, dv))


class CrossEncoderReranker(pw.UDF):
    """Torch cross-encoder (reference: rerankers.py:186), behind the
    optional `sentence_transformers` import."""

    def __init__(self, model_name: str, **kwargs: Any):
        super().__init__()
        try:
            from sentence_transformers import CrossEncoder
        except ImportError as e:
            raise ImportError(
                "CrossEncoderReranker requires `sentence_transformers`; "
                "EncoderReranker runs on the card without extra deps"
            ) from e
        self.model = CrossEncoder(model_name)

    def __wrapped__(self, doc: str, query: str, **kwargs: Any) -> float:
        return float(self.model.predict([(query, doc)])[0])


class FlashRankReranker(pw.UDF):
    """flashrank listwise reranker (reference: rerankers.py:319)."""

    def __init__(self, model_name: str = "ms-marco-TinyBERT-L-2-v2", **kwargs: Any):
        super().__init__()
        try:
            import flashrank  # noqa: F401
        except ImportError as e:
            raise ImportError("FlashRankReranker requires `flashrank`") from e
        import flashrank

        self.ranker = flashrank.Ranker(model_name=model_name)

    def __wrapped__(self, doc: str, query: str, **kwargs: Any) -> float:
        import flashrank

        req = flashrank.RerankRequest(query=query, passages=[{"text": doc}])
        return float(self.ranker.rerank(req)[0]["score"])
