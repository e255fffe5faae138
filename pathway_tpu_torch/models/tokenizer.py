"""Deterministic hashing tokenizer.

The port's own copy of ``pathway_tpu/models/tokenizer.py`` (numpy only),
so the port never imports the JAX package. Words are hashed into a fixed
vocab (feature hashing); the ids are identical to the JAX package's.
"""

from __future__ import annotations

import re

import numpy as np

_WORD_RE = re.compile(r"[a-z0-9]+", re.IGNORECASE)

_FNV_OFFSET = 0xCBF29CE484222325
_FNV_PRIME = 0x100000001B3
_MASK = 0xFFFFFFFFFFFFFFFF


def _fnv1a(data: bytes) -> int:
    h = _FNV_OFFSET
    for byte in data:
        h = ((h ^ byte) * _FNV_PRIME) & _MASK
    return h


class HashTokenizer:
    def __init__(self, vocab_size: int = 32768, max_len: int = 128):
        # ids 0 = pad, 1 = cls; words map into [2, vocab)
        self.vocab_size = vocab_size
        self.max_len = max_len

    def tokenize(self, text: str) -> list[int]:
        ids = [1]
        for m in _WORD_RE.finditer(text.lower()):
            ids.append(2 + _fnv1a(m.group(0).encode()) % (self.vocab_size - 2))
            if len(ids) >= self.max_len:
                break
        return ids

    def batch(self, texts: list[str], pad_to: int | None = None):
        """Returns (ids [b, L] int32, mask [b, L] int32) padded numpy arrays."""
        tokenized = [self.tokenize(t) for t in texts]
        longest = max((len(t) for t in tokenized), default=1)
        length = pad_to or min(self.max_len, max(longest, 1))
        ids = np.zeros((len(texts), length), np.int32)
        mask = np.zeros((len(texts), length), np.int32)
        for i, toks in enumerate(tokenized):
            toks = toks[:length]
            ids[i, : len(toks)] = toks
            mask[i, : len(toks)] = 1
        return ids, mask
