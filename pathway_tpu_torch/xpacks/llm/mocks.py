"""Fake chats/embedders for tests (reference: xpacks/llm/tests/mocks.py)."""

from __future__ import annotations

import hashlib
from typing import Any

import numpy as np

import pathway_tpu_torch as pw
from pathway_tpu_torch.internals.json import Json


class IdentityMockChat(pw.UDF):
    """Returns 'model: last user message'."""

    def __wrapped__(self, messages: Any, model: str = "mock", **kwargs: Any) -> str:
        msgs = messages.value if isinstance(messages, Json) else messages
        if isinstance(msgs, list):
            content = msgs[-1]["content"]
        else:
            content = str(msgs)
        return f"{model}: {content}"


class FakeChatModel(pw.UDF):
    """Always answers 'Text'."""

    def __wrapped__(self, messages: Any, **kwargs: Any) -> str:
        return "Text"


class EchoChat(pw.UDF):
    """Returns the last user message verbatim."""

    def __wrapped__(self, messages: Any, **kwargs: Any) -> str:
        msgs = messages.value if isinstance(messages, Json) else messages
        return msgs[-1]["content"] if isinstance(msgs, list) else str(msgs)


def fake_embeddings_model(x: str, dim: int = 8) -> np.ndarray:
    """Deterministic pseudo-embedding: hash of each token folded into dim
    buckets, L2-normalized; similar token sets -> similar vectors."""
    vec = np.zeros(dim, np.float32)
    for tok in str(x).lower().split():
        h = int(hashlib.md5(tok.encode()).hexdigest(), 16)
        vec[h % dim] += 1.0
    n = np.linalg.norm(vec)
    return vec / n if n > 0 else vec + 1.0 / np.sqrt(dim)


class FakeEmbedder(pw.UDF):
    def __init__(self, dim: int = 8):
        super().__init__(deterministic=True)
        self.dim = dim

    def __wrapped__(self, text: str, **kwargs: Any) -> np.ndarray:
        return fake_embeddings_model(text, self.dim)

    def get_embedding_dimension(self, **kwargs: Any) -> int:
        return self.dim
