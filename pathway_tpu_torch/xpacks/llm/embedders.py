"""Embedders — text -> vector UDFs.

Counterpart of ``pathway_tpu/xpacks/llm/embedders.py``: ``BaseEmbedder``
and the port's own model embedder ``TorchEmbedder`` (hash tokenizer + the
flagship encoder, the counterpart of ``JaxEmbedder``) with the same
tokenizer, row and sequence buckets and wave coalescer. As a ``pw.UDF``
its async ``__wrapped__`` submits one text to the coalescer, which folds
every row of a wave into one encoder dispatch on the card;
``encode_many(texts)`` encodes synchronously. The JAX package's remote
API embedders (OpenAI, LiteLLM, Gemini, sentence-transformers) wait.
"""

from __future__ import annotations

import weakref
from typing import Any

import numpy as np
import torch

import pathway_tpu_torch as pw
from pathway_tpu_torch.engine.device_plane import get_device_plane
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
        ids, mask = self.tokenizer.batch([t or "." for t in texts])
        # rows and sequence up to the plane's power-of-two buckets
        (ids, mask), _rows = self._plane.pad_rows([ids, mask], ids.shape[0])
        seq = ids.shape[1]
        bucket = bucket_len(seq, self.config.max_len)
        if bucket != seq:
            ids = np.pad(ids, ((0, 0), (0, bucket - seq)))
            mask = np.pad(mask, ((0, 0), (0, bucket - seq)))
        out = self.encode_tokens(ids, mask).cpu().numpy()
        return [out[i] for i in range(len(texts))]

    async def __wrapped__(self, input: str, **kwargs: Any) -> np.ndarray:
        """One text's embedding, coalesced with the rest of its wave."""
        return await self._batcher.submit(input)

    def encode_many(self, texts: list[str]) -> list[np.ndarray]:
        """Synchronous bulk encode (at most the row bucket cap per call)."""
        return self._encode_batch(texts)
