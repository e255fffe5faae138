"""Embedders — text -> vector UDFs.

Counterpart of ``pathway_tpu/xpacks/llm/embedders.py``: ``BaseEmbedder``
and the port's own model embedder ``TorchEmbedder`` (hash tokenizer + the
flagship encoder, the counterpart of ``JaxEmbedder``) with the same
tokenizer, row and sequence buckets and wave coalescer. As a ``pw.UDF``
its async ``__wrapped__`` submits one text to the coalescer, which folds
every row of a wave into one encoder dispatch on the card;
``encode_many(texts)`` encodes synchronously. The provider embedders
(``OpenAIEmbedder``, ``LiteLLMEmbedder``, ``GeminiEmbedder``) and the
local ``SentenceTransformerEmbedder`` (on the card by default) are the JAX
package's, each importing its provider's package when built.

``TorchEmbedder`` records a batch as the span ``embed.batch`` over the
leaf spans ``embed.tokenize``, ``embed.pad``, ``embed.upload``,
``embed.encode`` (the launches) and ``embed.readback`` (profiler
annotations ``pathway/embed.<phase>`` while a ``torch.profiler`` session
runs), and with the observability plane on counts
``pathway_embed_seconds_total{phase}`` and
``pathway_embed_tokens_total{kind=real|padded}``.
"""

from __future__ import annotations

import weakref
from typing import Any

import numpy as np
import torch

import pathway_tpu_torch as pw
from pathway_tpu_torch.engine.device_plane import get_device_plane
from pathway_tpu_torch.internals import observability as _obs
from pathway_tpu_torch.internals import spans as _spans
from pathway_tpu_torch.internals import udfs
from pathway_tpu_torch.internals.expression import ColumnExpression
from pathway_tpu_torch.models.tokenizer import HashTokenizer
from pathway_tpu_torch.models.transformer import (
    Params,
    TransformerConfig,
    TransformerEncoder,
    embedder_config,
)
from pathway_tpu_torch.xpacks.llm._utils import _coerce_sync


class BaseEmbedder(pw.UDF):
    def get_embedding_dimension(self, **kwargs: Any) -> int:
        return len(_coerce_sync(self.__wrapped__)(".", **kwargs))

    def __call__(self, input: ColumnExpression, *args: Any, **kwargs: Any) -> ColumnExpression:
        return super().__call__(input, *args, **kwargs)


class OpenAIEmbedder(BaseEmbedder):
    """OpenAI embeddings API (reference: embedders.py:85)."""

    def __init__(
        self,
        *,
        capacity: int | None = None,
        retry_strategy: udfs.AsyncRetryStrategy | None = None,
        cache_strategy: udfs.CacheStrategy | None = None,
        model: str | None = "text-embedding-3-small",
        **openai_kwargs: Any,
    ):
        executor = udfs.async_executor(capacity=capacity, retry_strategy=retry_strategy)
        super().__init__(executor=executor, cache_strategy=cache_strategy)
        try:
            import openai
        except ImportError as e:
            raise ImportError(
                "OpenAIEmbedder requires `openai`; use TorchEmbedder for the "
                "path on the card"
            ) from e
        self.kwargs = {"model": model, **openai_kwargs}
        # one client for all rows: connection pooling matters on the
        # hottest path of the pipeline
        self.client = openai.AsyncOpenAI()

    async def __wrapped__(self, input: str, **kwargs: Any) -> np.ndarray:
        merged = {**self.kwargs, **kwargs}
        ret = await self.client.embeddings.create(input=[input or "."], **merged)
        return np.array(ret.data[0].embedding)


class LiteLLMEmbedder(BaseEmbedder):
    """LiteLLM embeddings (reference: embedders.py:180)."""

    def __init__(
        self,
        *,
        capacity: int | None = None,
        retry_strategy: udfs.AsyncRetryStrategy | None = None,
        cache_strategy: udfs.CacheStrategy | None = None,
        model: str | None = None,
        **kwargs: Any,
    ):
        executor = udfs.async_executor(capacity=capacity, retry_strategy=retry_strategy)
        super().__init__(executor=executor, cache_strategy=cache_strategy)
        try:
            import litellm  # noqa: F401
        except ImportError as e:
            raise ImportError(
                "LiteLLMEmbedder requires `litellm`; use TorchEmbedder for the path on the card"
            ) from e
        self.kwargs = {"model": model, **kwargs}

    async def __wrapped__(self, input: str, **kwargs: Any) -> np.ndarray:
        import litellm

        merged = {**self.kwargs, **kwargs}
        ret = await litellm.aembedding(input=[input or "."], **merged)
        return np.array(ret.data[0]["embedding"])


class GeminiEmbedder(BaseEmbedder):
    """Google Gemini embeddings (reference: embedders.py:330)."""

    def __init__(
        self,
        *,
        capacity: int | None = None,
        retry_strategy: udfs.AsyncRetryStrategy | None = None,
        cache_strategy: udfs.CacheStrategy | None = None,
        model: str | None = "models/embedding-001",
        **kwargs: Any,
    ):
        executor = udfs.async_executor(capacity=capacity, retry_strategy=retry_strategy)
        super().__init__(executor=executor, cache_strategy=cache_strategy)
        try:
            import google.generativeai as genai  # noqa: F401
        except ImportError as e:
            raise ImportError(
                "GeminiEmbedder requires `google-generativeai`; use TorchEmbedder for "
                "the path on the card"
            ) from e
        self.kwargs = {"model": model, **kwargs}

    def __wrapped__(self, input: str, **kwargs: Any) -> np.ndarray:
        import google.generativeai as genai

        merged = {**self.kwargs, **kwargs}
        ret = genai.embed_content(content=input or ".", **merged)
        return np.array(ret["embedding"])


class SentenceTransformerEmbedder(BaseEmbedder):
    """Local sentence-transformers model, row-wise (reference:
    embedders.py:270), on the card unless `device` says otherwise; kept
    for drop-in compatibility, TorchEmbedder is the port's wave-batched
    path."""

    def __init__(
        self,
        model: str,
        call_kwargs: dict = {},
        device: str = "cuda",
        **init_kwargs: Any,
    ):
        super().__init__()
        try:
            from sentence_transformers import SentenceTransformer
        except ImportError as e:
            raise ImportError(
                "SentenceTransformerEmbedder requires `sentence_transformers`; "
                "use TorchEmbedder for the path on the card"
            ) from e
        self.model = SentenceTransformer(model, device=device, **init_kwargs)
        self.kwargs = dict(call_kwargs)

    def __wrapped__(self, text: str, **kwargs: Any) -> np.ndarray:
        merged = {**self.kwargs, **kwargs}
        return self.model.encode(text or ".", **merged)


def bucket_len(longest: int, cap: int) -> int:
    """Power-of-two sequence bucket (>= 16), the device plane's rule."""
    return get_device_plane().buckets.seq_bucket(longest, cap)


def pad_left_rows(
    rows: list, cap: int, pad_rows_to: int | None = None,
    n_rows: int | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """Left-pad variable-length token rows into (ids, mask) int32 arrays
    at a bucketed width (real tokens end at the last column). The batch
    pads with all-masked rows: to exactly `n_rows`, to a multiple of
    `pad_rows_to`, or to the plane's power-of-two row bucket."""
    bucket = bucket_len(max((len(r) for r in rows), default=1) or 1, cap)
    if n_rows is not None:
        n = n_rows
    elif pad_rows_to is not None:
        n = ((len(rows) + pad_rows_to - 1) // pad_rows_to) * pad_rows_to
    else:
        n = get_device_plane().buckets.rows_bucket(len(rows))
    ids = np.zeros((n, bucket), np.int32)
    mask = np.zeros((n, bucket), np.int32)
    for i, r in enumerate(rows):
        r = r[-bucket:]
        ids[i, bucket - len(r):] = r
        mask[i, bucket - len(r):] = 1
    return ids, mask


class TorchEmbedder(BaseEmbedder):
    """Wave-batched text embedder on the card (or on `device`).

    Pass `params` (a parameter tree, e.g. from
    ``models.convert.params_from_numpy``) for a given model; without
    them the weights are random from `generator` (default seed 0).
    """

    def __init__(
        self,
        config: TransformerConfig | None = None,
        params: Params | None = None,
        tokenizer: Any = None,
        *,
        max_batch: int = 4096,
        cache_strategy: udfs.CacheStrategy | None = None,
        device: str | torch.device | None = None,
        generator: torch.Generator | None = None,
    ):
        super().__init__(executor=udfs.async_executor(), cache_strategy=cache_strategy)
        self.config = config or embedder_config(
            vocab_size=32768, d_model=256, n_heads=8, n_layers=4, d_ff=1024,
            max_len=128, embed_dim=256,
        )
        self.model = TransformerEncoder(
            self.config, params, device=device, generator=generator
        )
        self.device = self.model.device
        self.tokenizer = tokenizer or HashTokenizer(
            vocab_size=self.config.vocab_size, max_len=self.config.max_len
        )
        self._plane = get_device_plane()
        self._encode = self._plane.program(
            self._plane.unique_name("embed_encode"), self.model
        )
        self._batcher = self._plane.coalescer(self._encode_batch, max_batch=max_batch)
        # the plane is process-global: release this instance's program
        # when the embedder dies
        self._finalizer = weakref.finalize(
            self, self._plane.drop_program, self._encode.name
        )
        _obs.maybe_enable_from_env()  # the plane's switch holds outside pw.run too

    @property
    def dispatches(self) -> int:
        """Encoder dispatches so far (each runs one attention per layer)."""
        return self._encode.dispatches

    @torch.inference_mode()
    def encode_tokens(self, ids: np.ndarray | torch.Tensor, mask: np.ndarray | torch.Tensor) -> torch.Tensor:
        """Embeddings [b, embed_dim] f32 on the embedder's device for
        padded token ids and mask [b, s]; one dispatch."""
        ids_t = torch.as_tensor(ids).to(self.device, torch.long)
        mask_t = torch.as_tensor(mask).to(self.device, torch.int32)
        return self._encode(ids_t, mask_t, bucket=tuple(ids_t.shape))

    def _encode_batch(self, texts: list[str]) -> list[np.ndarray]:
        with _spans.span("embed.batch", leaf=False):
            with _spans.span("embed.tokenize") as tokenize:
                ids, mask = self.tokenizer.batch([t or "." for t in texts])
            with _spans.span("embed.pad") as pad:
                # rows and sequence up to the plane's power-of-two buckets
                (ids, mask), _rows = self._plane.pad_rows([ids, mask], ids.shape[0])
                seq = ids.shape[1]
                bucket = bucket_len(seq, self.config.max_len)
                if bucket != seq:
                    ids = np.pad(ids, ((0, 0), (0, bucket - seq)))
                    mask = np.pad(mask, ((0, 0), (0, bucket - seq)))
            with _spans.span("embed.upload") as upload:
                ids_t = torch.as_tensor(ids).to(self.device, torch.long)
                mask_t = torch.as_tensor(mask).to(self.device, torch.int32)
            with _spans.span("embed.encode") as encode:
                out = self.encode_tokens(ids_t, mask_t)
            with _spans.span("embed.readback") as readback:
                out = out.cpu().numpy()
        phases = (tokenize, pad, upload, encode, readback)
        plane = _obs.PLANE
        if plane is not None and all(sp.id for sp in phases):
            m = plane.metrics
            real = int(mask.sum())  # the padding adds zeros
            for sp in phases:
                m.counter(
                    "pathway_embed_seconds_total", {"phase": sp.name[len("embed."):]},
                    (sp.end_ns - sp.start_ns) / 1e9,
                    help="host seconds of TorchEmbedder batches by phase",
                )
            for kind, n in (("real", real), ("padded", ids.size - real)):
                m.counter(
                    "pathway_embed_tokens_total", {"kind": kind}, n,
                    help="token positions TorchEmbedder encoded: real tokens and padding",
                )
        return [out[i] for i in range(len(texts))]

    async def __wrapped__(self, input: str, **kwargs: Any) -> np.ndarray:
        """One text's embedding, coalesced with the rest of its wave."""
        return await self._batcher.submit(input)

    def encode_many(self, texts: list[str]) -> list[np.ndarray]:
        """Synchronous bulk encode (at most the row bucket cap per call)."""
        return self._encode_batch(texts)
