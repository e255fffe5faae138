"""Document splitters/chunkers.

Reference parity: xpacks/llm/splitters.py `TokenCountSplitter` (:34,
tiktoken-based) and `NullSplitter`. tiktoken is unavailable in this image,
so token counting falls back to the word tokenizer (close enough for
chunk-budgeting; swap `tokenize_fn` for exact parity).
"""

from __future__ import annotations

import re
from typing import Any, Callable

import pathway_tpu_torch as pw
from pathway_tpu_torch.internals.json import Json


class BaseSplitter(pw.UDF):
    def __call__(self, text: Any, **kwargs: Any):
        return super().__call__(text, **kwargs)


class NullSplitter(BaseSplitter):
    """One chunk per document (reference: splitters.py NullSplitter)."""

    def __wrapped__(self, txt: str, **kwargs: Any) -> list[tuple[str, dict]]:
        return [(txt, {})]


_SENTENCE_SPLIT = re.compile(r"(?<=[.!?])\s+|\n{2,}")


def _default_tokenize(text: str) -> list[str]:
    return text.split()


class TokenCountSplitter(BaseSplitter):
    """Greedy chunking into [min_tokens, max_tokens] windows along sentence
    boundaries (reference: splitters.py:34)."""

    def __init__(
        self,
        min_tokens: int = 50,
        max_tokens: int = 500,
        encoding_name: str = "cl100k_base",
        tokenize_fn: Callable[[str], list[str]] | None = None,
    ):
        super().__init__(deterministic=True)
        self.min_tokens = min_tokens
        self.max_tokens = max_tokens
        self.encoding_name = encoding_name
        if tokenize_fn is None:
            try:
                import tiktoken

                enc = tiktoken.get_encoding(encoding_name)
                tokenize_fn = lambda s: enc.encode(s)  # noqa: E731
            except Exception:  # noqa: BLE001 — tiktoken downloads encodings
                # on first use; fall back to word counting offline
                tokenize_fn = _default_tokenize
        self._tokenize = tokenize_fn

    def chunk(self, text: str, metadata: dict | None = None) -> list[tuple[str, dict]]:
        sentences = [s for s in _SENTENCE_SPLIT.split(text or "") if s.strip()]
        chunks: list[str] = []
        current: list[str] = []
        count = 0
        for sent in sentences:
            n = len(self._tokenize(sent))
            if count + n > self.max_tokens and count >= self.min_tokens:
                chunks.append(" ".join(current))
                current, count = [], 0
            # a single oversize sentence is split hard at the token budget
            while n > self.max_tokens:
                toks = sent.split()
                head, sent = (
                    " ".join(toks[: self.max_tokens]),
                    " ".join(toks[self.max_tokens:]),
                )
                if current:
                    chunks.append(" ".join(current))
                    current, count = [], 0
                chunks.append(head)
                n = len(self._tokenize(sent))
            if sent.strip():
                current.append(sent)
                count += n
        if current:
            chunks.append(" ".join(current))
        return [(c, dict(metadata or {})) for c in chunks if c.strip()]

    def __wrapped__(self, txt: str, **kwargs: Any) -> list[tuple[str, dict]]:
        return self.chunk(txt)
