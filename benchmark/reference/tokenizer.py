"""Frozen copy of the port's hash tokenizer.

From ``pathway_tpu_torch/models/tokenizer.py`` (``HashTokenizer.tokenize``
and the FNV-1a hash) at commit a5f5f3e: ids 0 = pad, 1 = a leading class
token, each word (a run of [a-z0-9], lower-cased) hashed by 64-bit FNV-1a
into [2, vocab), the row cut at ``max_len`` ids.
"""

from __future__ import annotations

import re

_WORD_RE = re.compile(r"[a-z0-9]+", re.IGNORECASE)
_FNV_OFFSET = 0xCBF29CE484222325
_FNV_PRIME = 0x100000001B3
_MASK = 0xFFFFFFFFFFFFFFFF


def fnv1a(data: bytes) -> int:
    h = _FNV_OFFSET
    for byte in data:
        h = ((h ^ byte) * _FNV_PRIME) & _MASK
    return h


def tokenize(text: str, vocab_size: int, max_len: int) -> list[int]:
    ids = [1]
    for m in _WORD_RE.finditer(text.lower()):
        ids.append(2 + fnv1a(m.group(0).encode()) % (vocab_size - 2))
        if len(ids) >= max_len:
            break
    return ids
