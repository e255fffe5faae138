"""Deterministic hashing tokenizer.

The port's own copy of ``pathway_tpu/models/tokenizer.py`` (numpy only),
so the port never imports the JAX package. Words are hashed into a fixed
vocab (feature hashing); the ids are identical to the JAX package's.

ASCII rows are hashed by one compiled pass over the batch's bytes
(``hash_tokenizer.cpp``, built by ``engine.native.build_library`` and
called through ``ctypes``, which releases the interpreter lock for the
call). Every other row keeps the Python path (``_fnv1a`` over the
matches of ``_WORD_RE``), since Unicode lower-casing and ``IGNORECASE``
give some non-ASCII letters ids only that path reproduces; so does every
row when no compiler is found, when ``PATHWAY_TPU_NATIVE=0`` turns the
native planes off, or when a vocab outside ``(2, 2**31]`` leaves the ids
to Python's integers. With the observability plane on,
``pathway_tokenizer_rows_total{path=native|python}`` counts the rows
each path took.
"""

from __future__ import annotations

import ctypes
import os
import re
import threading
from pathlib import Path

import numpy as np

from pathway_tpu_torch.analysis import lockgraph as _lockgraph
from pathway_tpu_torch.internals import observability as _obs

_WORD_RE = re.compile(r"[a-z0-9]+", re.IGNORECASE)

_FNV_OFFSET = 0xCBF29CE484222325
_FNV_PRIME = 0x100000001B3
_MASK = 0xFFFFFFFFFFFFFFFF

_LOCK = _lockgraph.register_lock("tokenizer.resolve", threading.Lock())
_LIB: ctypes.CDLL | None = None
_TRIED = False


def _fnv1a(data: bytes) -> int:
    h = _FNV_OFFSET
    for byte in data:
        h = ((h ^ byte) * _FNV_PRIME) & _MASK
    return h


def _load() -> ctypes.CDLL | None:
    """The compiled pass, built on first use; None without a compiler or
    with the native planes off."""
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    with _LOCK:
        if _TRIED:
            return _LIB
        _TRIED = True
        if os.environ.get("PATHWAY_TPU_NATIVE", "1") == "0":
            return None
        from pathway_tpu_torch.engine.native import build_library

        path = build_library(Path(__file__).with_name("hash_tokenizer.cpp"), "hash_tokenizer", 120)
        if path is None:
            return None
        try:
            lib = ctypes.CDLL(str(path))
        except OSError:
            return None
        i32p = np.ctypeslib.ndpointer(dtype=np.int32, flags="C_CONTIGUOUS")
        i64p = np.ctypeslib.ndpointer(dtype=np.int64, flags="C_CONTIGUOUS")
        lib.ht_rows.restype = None
        lib.ht_rows.argtypes = [
            ctypes.c_char_p, i64p, ctypes.c_int64, ctypes.c_uint64,
            ctypes.c_int64, ctypes.c_int64, i32p, i32p, i64p,
        ]
        _LIB = lib
    return _LIB


def _fit(a: np.ndarray, length: int) -> np.ndarray:
    """`a` cut or zero-padded to `length` columns."""
    if a.shape[1] == length:
        return a
    out = np.zeros((a.shape[0], length), a.dtype)
    w = min(a.shape[1], length)
    out[:, :w] = a[:, :w]
    return out


class HashTokenizer:
    def __init__(self, vocab_size: int = 32768, max_len: int = 128):
        # ids 0 = pad, 1 = cls; words map into [2, vocab)
        self.vocab_size = vocab_size
        self.max_len = max_len

    def _tokenize_python(self, text: str) -> list[int]:
        ids = [1]
        for m in _WORD_RE.finditer(text.lower()):
            ids.append(2 + _fnv1a(m.group(0).encode()) % (self.vocab_size - 2))
            if len(ids) >= self.max_len:
                break
        return ids

    def _paths(self, texts: list[str]) -> list[bool]:
        """Which rows the compiled pass takes."""
        fast = 2 < self.vocab_size <= 2**31 and _load() is not None
        native = [fast and t.isascii() for t in texts]
        plane = _obs.PLANE
        if plane is not None:
            n_native = sum(native)
            for path, rows in (("native", n_native), ("python", len(texts) - n_native)):
                if rows:
                    plane.metrics.counter(
                        "pathway_tokenizer_rows_total", {"path": path}, rows,
                        help="rows HashTokenizer hashed, by path",
                    )
        return native

    def _hash(self, texts: list[str], native: list[bool], width: int | None):
        """[n, width] ids and mask of the rows that `native` marks, hashed by
        the compiled pass, and the count of ids of each of those rows; a
        falsy `width` is as many ids as the longest of them can hold."""
        n = len(texts)
        cap = max(self.max_len, 2)  # at max_len 1 a row still takes a word
        lens = np.fromiter((len(t) if f else 0 for t, f in zip(texts, native)), np.int64, n)
        if not width:
            # each word but the last takes a separator after it
            width = min(cap, 1 + (int(lens.max(initial=0)) + 1) // 2)
        ids = np.zeros((n, width), np.int32)
        mask = np.zeros((n, width), np.int32)
        count = np.zeros(n, np.int64)
        if any(native):
            offsets = np.zeros(n + 1, np.int64)
            np.cumsum(lens, out=offsets[1:])
            data = "".join(t for t, f in zip(texts, native) if f).encode("ascii")
            _load().ht_rows(
                data, offsets, n, self.vocab_size - 2, min(cap, width), width, ids, mask, count,
            )
        return ids, mask, count

    def tokenize(self, text: str) -> list[int]:
        native = self._paths([text])
        if not native[0]:
            return self._tokenize_python(text)
        ids, _, count = self._hash([text], native, None)
        return ids[0, : count[0]].tolist()

    def batch(self, texts: list[str], pad_to: int | None = None):
        """Returns (ids [b, L] int32, mask [b, L] int32) padded numpy arrays."""
        native = self._paths(texts)
        python = {i: self._tokenize_python(t) for i, t in enumerate(texts) if not native[i]}
        ids, mask, count = self._hash(texts, native, pad_to)
        longest = max(int(count.max(initial=1)), max(map(len, python.values()), default=1))
        length = pad_to or min(self.max_len, max(longest, 1))
        ids, mask = _fit(ids, length), _fit(mask, length)
        for i, toks in python.items():
            toks = toks[:length]
            ids[i, : len(toks)] = toks
            mask[i, : len(toks)] = 1
        return ids, mask
