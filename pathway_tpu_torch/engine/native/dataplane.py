"""ctypes loader + Python surface for the native data plane (dataplane.cpp).

The data plane keeps production rows token-resident: a `NativeBatch` is
four flat numpy arrays (key_lo, key_hi, token, diff) plus an `InternTable`
holding each distinct row's canonical bytes (the exact byte format of
`internals.keys._serialize_value`, so keys hashed here are bit-identical
to Python's). Engine nodes that understand batches never touch Python
objects per row; `materialize()` decodes rows only at true Python
boundaries (UDFs, captures, subscribers).

Reference parity: differential-dataflow's typed-record hot path
(reference/src/engine/dataflow.rs:2270,5506) vs Python-object
interpretation — this module is the boundary that keeps rows native.
"""

from __future__ import annotations

import ctypes
import os
import struct
import threading
from pathlib import Path
from typing import Any, Iterable

import numpy as np

from pathway_tpu_torch.engine.native import build_library
from pathway_tpu_torch.internals.keys import Key
from pathway_tpu_torch.analysis import lockgraph as _lockgraph

_HERE = Path(__file__).resolve().parent
_LOCK = _lockgraph.register_lock(
    "native.dataplane_resolve", threading.Lock()
)
_LIB: ctypes.CDLL | None = None
_TRIED = False

u64p = np.ctypeslib.ndpointer(dtype=np.uint64, flags="C_CONTIGUOUS")
i64p = np.ctypeslib.ndpointer(dtype=np.int64, flags="C_CONTIGUOUS")
f64p = np.ctypeslib.ndpointer(dtype=np.float64, flags="C_CONTIGUOUS")
u8p = np.ctypeslib.ndpointer(dtype=np.uint8, flags="C_CONTIGUOUS")
c_u64_p = ctypes.POINTER(ctypes.c_uint64)


def _build() -> Path | None:
    return build_library(_HERE / "dataplane.cpp", "dataplane", 180)


def _load() -> ctypes.CDLL | None:
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    with _LOCK:
        if _TRIED:
            return _LIB
        _TRIED = True
        if os.environ.get("PATHWAY_TPU_NATIVE", "1") == "0":
            return None
        path = _build()
        if path is None:
            return None
        try:
            lib = ctypes.CDLL(str(path))
        except OSError:
            return None
        c = ctypes
        lib.dp_tab_new.restype = c.c_void_p
        lib.dp_tab_free.argtypes = [c.c_void_p]
        lib.dp_tab_len.restype = c.c_int64
        lib.dp_tab_len.argtypes = [c.c_void_p]
        lib.dp_tab_intern.restype = c.c_uint64
        lib.dp_tab_intern.argtypes = [c.c_void_p, c.c_char_p, c.c_int64]
        lib.dp_tab_get.restype = c.c_int64
        lib.dp_tab_get.argtypes = [c.c_void_p, c.c_uint64, c.POINTER(c.c_char_p)]
        lib.dp_hash128.argtypes = [c.c_char_p, c.c_int64, c_u64_p, c_u64_p]
        lib.dp_ingest_jsonl.restype = c.c_int64
        lib.dp_ingest_jsonl.argtypes = [
            c.c_void_p, c.c_char_p, c.c_int64, c.c_int64,
            c.POINTER(c.c_char_p), i64p, u8p, i64p, c.c_int64,
            c.c_uint64, c.c_uint64, c.c_int64, u64p, u64p, u64p, u8p,
            i64p, i64p, c.c_int64,
        ]
        lib.dp_ingest_csv.restype = c.c_int64
        lib.dp_ingest_csv.argtypes = [
            c.c_void_p, c.c_char_p, c.c_int64, c.c_char, c.c_int64,
            i64p, u8p, u8p, i64p, c.c_int64, c.c_uint64, c.c_uint64,
            c.c_int64, u64p, u64p, u64p, u8p, i64p, i64p, c.c_int64,
        ]
        lib.dp_cheap_seq_key.argtypes = [
            c.c_uint64, c.c_uint64, c_u64_p, c_u64_p,
        ]
        lib.dp_cheap_join_key.argtypes = [
            c.c_uint64, c.c_uint64, c.c_uint64, c.c_uint64, c_u64_p, c_u64_p,
        ]
        lib.dp_decode_num_cols.restype = c.c_int64
        lib.dp_decode_num_cols.argtypes = [
            c.c_void_p, c.c_int64, u64p, i64p, c.c_int64, i64p, f64p, u8p,
        ]
        lib.dp_decode_str_cols.restype = c.c_int64
        lib.dp_decode_str_cols.argtypes = [
            c.c_void_p, c.c_int64, u64p, i64p, c.c_int64,
            c.c_char_p, c.c_int64, i64p, i64p, u8p,
        ]
        lib.dp_project_group.restype = c.c_int64
        lib.dp_project_group.argtypes = [
            c.c_void_p, c.c_int64, u64p, i64p, c.c_int64, c.c_int64, u64p,
            i64p, c.c_uint8,
        ]
        lib.dp_route_key.argtypes = [c.c_int64, u64p, u64p, c.c_int64, i64p]
        lib.dp_rekey_salt.argtypes = [
            c.c_int64, u64p, u64p, c.c_int64, u64p, u64p,
        ]
        lib.dp_rekey.restype = c.c_int64
        lib.dp_rekey.argtypes = [
            c.c_void_p, c.c_int64, u64p, i64p, c.c_int64, c.c_uint8,
            u64p, u64p,
        ]
        lib.dp_build_rows.restype = c.c_int64
        lib.dp_build_rows.argtypes = [
            c.c_void_p, c.c_int64, u64p, c.c_int64, i64p, i64p,
            i64p, f64p, u8p, u64p, u8p,
        ]
        lib.dp_format_csv.restype = c.c_int64
        lib.dp_format_csv.argtypes = [
            c.c_void_p, c.c_int64, u64p, i64p, c.c_int64, c.c_char,
            c.c_char_p, c.c_int64, i64p, i64p,
        ]
        lib.dp_distinct_check.restype = c.c_int64
        lib.dp_distinct_check.argtypes = [c.c_int64, u64p, u64p, i64p]
        lib.dp_consolidate.restype = c.c_int64
        lib.dp_consolidate.argtypes = [c.c_int64, u64p, u64p, u64p, i64p]
        lib.dj_new.restype = c.c_void_p
        lib.dj_free.argtypes = [c.c_void_p]
        lib.dj_update.argtypes = [
            c.c_void_p, c.c_int64, u64p, u64p, u64p, u64p, i64p,
        ]
        lib.dj_probe.restype = c.c_int64
        lib.dj_probe.argtypes = [
            c.c_void_p, c.c_int64, u64p, c.c_int64, i64p, u64p, u64p, u64p, i64p,
        ]
        lib.dj_len.restype = c.c_int64
        lib.dj_len.argtypes = [c.c_void_p]
        lib.dj_export.restype = c.c_int64
        lib.dj_export.argtypes = [c.c_void_p, u64p, u64p, u64p, u64p, i64p]
        lib.dj_groups.restype = c.c_int64
        lib.dj_groups.argtypes = [c.c_void_p, c.c_int64, u64p, i64p]
        lib.dj_evict.restype = c.c_int64
        lib.dj_evict.argtypes = [
            c.c_void_p, c.c_uint64, c.c_int64, u64p, u64p, u64p, i64p,
        ]
        lib.dp_bloom_build.argtypes = [c.c_int64, u64p, c.c_int64, c.c_int64, u8p]
        lib.dp_bloom_check.restype = c.c_int64
        lib.dp_bloom_check.argtypes = [u8p, c.c_int64, c.c_int64, c.c_uint64]
        lib.dp_join_rows.restype = c.c_int64
        lib.dp_join_rows.argtypes = [
            c.c_void_p, c.c_int64, u64p, u64p, u64p, u64p, u64p, u64p,
            c.c_int64, c.c_int64, i64p, c.c_int64, u64p, u64p, u64p,
        ]
        lib.dp_splice_cols.restype = c.c_int64
        lib.dp_splice_cols.argtypes = [
            c.c_void_p, c.c_int64, c.c_int64, u64p, c.c_int64, i64p, i64p,
            u64p,
        ]
        lib.dp_decode_key_col.restype = c.c_int64
        lib.dp_decode_key_col.argtypes = [
            c.c_void_p, c.c_int64, u64p, c.c_int64, u64p, u64p, u8p,
        ]
        lib.dp_flatten.restype = c.c_int64
        lib.dp_flatten.argtypes = [
            c.c_void_p, c.c_int64, u64p, u64p, u64p, i64p, c.c_int64, u8p,
            c.c_int64, u64p, u64p, u64p, i64p,
        ]
        lib.dp_export_tokens.restype = c.c_int64
        lib.dp_export_tokens.argtypes = [
            c.c_void_p, c.c_int64, u64p, c.c_char_p, c.c_int64, i64p, c.c_int64,
        ]
        lib.dp_import_tokens.restype = c.c_int64
        lib.dp_import_tokens.argtypes = [
            c.c_void_p, c.c_int64, u64p, c.c_char_p, i64p, c.c_int64,
        ]
        _LIB = lib
    return _LIB


def available() -> bool:
    return _load() is not None


def ingest_reentrant() -> bool:
    """True when the loaded kernel declares its ingest_* entry points
    reentrant (bit 0 of dp_abi_flags): per-call state is stack-local and
    the shared InternTable is only touched through its shared_mutex,
    with each call interning its morsel's rows as one batch under a
    single write-lock acquisition. Morsel-parallel scan decode
    (io/fs.py) gates on this so a stale library without the contract
    degrades to serial decode instead of racing."""
    lib = _load()
    if lib is None:
        return False
    fn = getattr(lib, "dp_abi_flags", None)
    if fn is None:  # pre-contract library: assume nothing
        return False
    try:
        fn.restype = ctypes.c_int64
        return bool(int(fn()) & 1)
    except (ctypes.ArgumentError, OSError):
        return False


# -------------------------------------------------------- row (de)serialize

_TAG_NONE, _TAG_BOOL, _TAG_INT, _TAG_FLOAT, _TAG_STR, _TAG_BYTES, _TAG_KEY = (
    range(7)
)


def decode_row(b: bytes) -> tuple:
    """Canonical bytes -> Python row tuple (scalar tags only)."""
    out: list[Any] = []
    pos = 0
    n = len(b)
    while pos < n:
        tag = b[pos]
        pos += 1
        if tag == _TAG_NONE:
            out.append(None)
        elif tag == _TAG_BOOL:
            out.append(b[pos] == 1)
            pos += 1
        elif tag == _TAG_INT:
            out.append(struct.unpack_from("<q", b, pos)[0])
            pos += 8
        elif tag == _TAG_FLOAT:
            out.append(struct.unpack_from("<d", b, pos)[0])
            pos += 8
        elif tag == _TAG_STR:
            ln = struct.unpack_from("<q", b, pos)[0]
            pos += 8
            out.append(b[pos : pos + ln].decode("utf-8"))
            pos += ln
        elif tag == _TAG_BYTES:
            ln = struct.unpack_from("<q", b, pos)[0]
            pos += 8
            out.append(b[pos : pos + ln])
            pos += ln
        elif tag == _TAG_KEY:
            out.append(Key(int.from_bytes(b[pos : pos + 16], "little")))
            pos += 16
        elif tag == 0x0E:
            from pathway_tpu_torch.internals.errors import ERROR

            out.append(ERROR)
        else:
            raise ValueError(f"non-scalar tag {tag} in native row")
    return tuple(out)


def encode_scalar(v: Any) -> bytes | None:
    """One value -> canonical piece; None return = not plane-representable.
    (Must stay byte-identical to keys._serialize_value for these types.)"""
    t = type(v)
    if v is None:
        return b"\x00"
    if t is bool or isinstance(v, np.bool_):
        return b"\x01\x01" if v else b"\x01\x00"
    if t is int or isinstance(v, np.integer):
        try:
            return b"\x02" + struct.pack("<q", int(v))
        except (struct.error, OverflowError):
            return None
    if t is float or isinstance(v, np.floating):
        return b"\x03" + struct.pack("<d", float(v))
    if t is str:
        eb = v.encode("utf-8")
        return b"\x04" + struct.pack("<q", len(eb)) + eb
    if t is bytes:
        return b"\x05" + struct.pack("<q", len(v)) + v
    if t is Key:
        return b"\x06" + v.value.to_bytes(16, "little")
    from pathway_tpu_torch.internals.errors import ErrorValue

    if isinstance(v, ErrorValue):
        # plane-internal poison marker (never feeds key hashing)
        return b"\x0e"
    return None


def encode_row(row: tuple) -> bytes | None:
    """Row tuple -> canonical bytes; None when any value is non-scalar."""
    pieces = []
    for v in row:
        p = encode_scalar(v)
        if p is None:
            return None
        pieces.append(p)
    return b"".join(pieces)


class InternTable:
    """Process-side handle on a C++ intern table + a token->row cache.

    ``stat_intern_rows`` / ``stat_materialize_rows`` are monotone plane-
    boundary counters: every Python-row intern and every token decode into
    Python entries bumps them. The iterate scope samples them around its
    boundary plumbing to PROVE a fixpoint round never round-trips rows
    through Python objects (tests/test_iterate_native.py)."""

    def __init__(self) -> None:
        lib = _load()
        assert lib is not None
        self._lib = lib
        self._h = lib.dp_tab_new()
        self._row_cache: dict[int, tuple] = {}
        self.stat_intern_rows = 0
        self.stat_materialize_rows = 0

    def __del__(self) -> None:
        if getattr(self, "_h", None):
            self._lib.dp_tab_free(self._h)
            self._h = None

    def __len__(self) -> int:
        return self._lib.dp_tab_len(self._h)

    def intern(self, data: bytes) -> int:
        return self._lib.dp_tab_intern(self._h, data, len(data))

    def intern_row(self, row: tuple) -> int | None:
        self.stat_intern_rows += 1
        b = encode_row(row)
        if b is None:
            return None
        tok = self.intern(b)
        self._row_cache.setdefault(tok, row)
        return tok

    def get_bytes(self, token: int) -> bytes:
        ptr = ctypes.c_char_p()
        n = self._lib.dp_tab_get(self._h, token, ctypes.byref(ptr))
        if n < 0:
            raise KeyError(f"unknown intern token {token}")
        return ctypes.string_at(ptr, n)

    def row(self, token: int) -> tuple:
        r = self._row_cache.get(token)
        if r is None:
            r = decode_row(self.get_bytes(token))
            self._row_cache[token] = r
        return r


_DEFAULT_TAB: InternTable | None = None
_DEFAULT_TAB_LOCK = _lockgraph.register_lock(
    "native.default_table", threading.Lock()
)


def default_table() -> InternTable:
    """The process-wide intern table (all engine sessions share it; tokens
    are comparable across nodes and worker threads)."""
    global _DEFAULT_TAB
    with _DEFAULT_TAB_LOCK:
        if _DEFAULT_TAB is None:
            _DEFAULT_TAB = InternTable()
    return _DEFAULT_TAB


class NativeBatch:
    """A token-resident z-set batch: (key, token, diff) flat arrays.

    `distinct_hint`: the PRODUCER vouches that all diffs are +1 with
    pairwise-distinct keys (fresh sequential-key ingest). Propagated by
    select (a subset of distinct keys stays distinct) and by concat when
    every input carries it (sequential key ranges never collide), letting
    `is_distinct_insert` skip its O(n) hash-set scan on the ingest path.
    """

    __slots__ = ("tab", "key_lo", "key_hi", "token", "diff", "distinct_hint")

    def __init__(
        self,
        tab: InternTable,
        key_lo: np.ndarray,
        key_hi: np.ndarray,
        token: np.ndarray,
        diff: np.ndarray,
        distinct_hint: bool = False,
    ):
        self.tab = tab
        self.key_lo = key_lo
        self.key_hi = key_hi
        self.token = token
        self.diff = diff
        self.distinct_hint = distinct_hint

    def __len__(self) -> int:
        return len(self.token)

    def materialize(self) -> list[tuple]:
        """Decode to [(Key, row, diff)] — the Python-object boundary."""
        tab = self.tab
        tab.stat_materialize_rows += len(self.token)
        lo = self.key_lo
        hi = self.key_hi
        tok = self.token
        diff = self.diff
        return [
            (
                Key((int(hi[i]) << 64) | int(lo[i])),
                tab.row(int(tok[i])),
                int(diff[i]),
            )
            for i in range(len(tok))
        ]

    def select(self, idx: np.ndarray) -> "NativeBatch":
        """Row subset/permutation by integer or boolean index array."""
        # a PERMUTED batch keeps distinctness; only a boolean mask or a
        # strictly-increasing index is guaranteed duplicate-free, so the
        # hint survives boolean masks and is dropped for integer arrays
        keep_hint = self.distinct_hint and (
            getattr(idx, "dtype", None) is not None and idx.dtype == np.bool_
        )
        return NativeBatch(
            self.tab,
            np.ascontiguousarray(self.key_lo[idx]),
            np.ascontiguousarray(self.key_hi[idx]),
            np.ascontiguousarray(self.token[idx]),
            np.ascontiguousarray(self.diff[idx]),
            distinct_hint=keep_hint,
        )

    def with_diff(self, diff: np.ndarray) -> "NativeBatch":
        return NativeBatch(self.tab, self.key_lo, self.key_hi, self.token, diff)

    def keys_array(self) -> np.ndarray:
        """128-bit keys as object array of Key (rarely needed)."""
        return np.array(
            [Key((int(h) << 64) | int(lo)) for h, lo in zip(self.key_hi, self.key_lo)],
            dtype=object,
        )

    @staticmethod
    def concat(batches: "list[NativeBatch]") -> "NativeBatch":
        assert batches
        tab = batches[0].tab
        return NativeBatch(
            tab,
            np.concatenate([b.key_lo for b in batches]),
            np.concatenate([b.key_hi for b in batches]),
            np.concatenate([b.token for b in batches]),
            np.concatenate([b.diff for b in batches]),
            # sequential-key ranges from one table never collide
            distinct_hint=all(b.distinct_hint for b in batches),
        )

    def is_distinct_insert(self) -> bool:
        """True when all diffs are +1 with pairwise-distinct keys (already
        consolidated — the shape every fresh ingest produces)."""
        if self.distinct_hint:
            return True
        lib = _load()
        return bool(
            lib.dp_distinct_check(len(self), self.key_lo, self.key_hi, self.diff)
        )

    def consolidate(self) -> "NativeBatch":
        lib = _load()
        lo = self.key_lo.copy()
        hi = self.key_hi.copy()
        tok = self.token.copy()
        diff = self.diff.copy()
        m = lib.dp_consolidate(len(tok), lo, hi, tok, diff)
        return NativeBatch(self.tab, lo[:m], hi[:m], tok[:m], diff[:m])

    # ------------------------------------------------------------- wire form

    def to_wire(self) -> tuple:
        """Compact picklable form for cross-process exchange: tokens are
        rewritten to dense local ids + a unique-row blob. The flat arrays
        stay numpy ndarrays so pickle protocol 5 ships their buffers
        out-of-band (process_mesh's zero-copy frames); ``from_wire``
        accepts the older bytes fields too, keeping the wire compatible
        across a supervisor restart mid-upgrade."""
        lib = _load()
        n = len(self.token)
        blob_cap = 1 << 16
        ulen = np.empty(max(n, 1), np.int64)
        while True:
            # dp_export_tokens rewrites the tokens to local ids as it goes,
            # also on an attempt whose blob was too small: every attempt
            # starts from a fresh copy of the batch's own tokens
            tok = self.token.copy()
            blob = ctypes.create_string_buffer(blob_cap)
            n_u = lib.dp_export_tokens(
                self.tab._h, n, tok, blob, blob_cap, ulen, len(ulen)
            )
            if n_u >= 0:
                break
            blob_cap = max(-n_u, blob_cap * 2)
        used = int(ulen[:n_u].sum()) if n_u else 0
        return (
            np.ascontiguousarray(self.key_lo, np.uint64),
            np.ascontiguousarray(self.key_hi, np.uint64),
            tok,
            np.ascontiguousarray(self.diff, np.int64),
            blob.raw[:used],
            np.ascontiguousarray(ulen[:n_u]),
        )

    @staticmethod
    def _wire_col(field, dtype) -> np.ndarray:
        """One wire field as a fresh contiguous array: ndarray fields
        (protocol-5 wire) copy out of the receive buffer; bytes fields
        (legacy wire) decode as before."""
        if isinstance(field, np.ndarray):
            return np.ascontiguousarray(field, dtype).copy()
        return np.frombuffer(field, dtype).copy()

    @staticmethod
    def from_wire(w: tuple, tab: InternTable | None = None) -> "NativeBatch":
        lib = _load()
        tab = tab or default_table()
        col = NativeBatch._wire_col
        lo = col(w[0], np.uint64)
        hi = col(w[1], np.uint64)
        tok = col(w[2], np.uint64)
        diff = col(w[3], np.int64)
        ulen = col(w[5], np.int64)
        blob = w[4] if isinstance(w[4], bytes) else bytes(w[4])
        rc = lib.dp_import_tokens(tab._h, len(tok), tok, blob, ulen, len(ulen))
        if rc != 0:
            raise ValueError("corrupt native wire batch")
        return NativeBatch(tab, lo, hi, tok, diff)


class NativeJoinArr:
    """C++ join-side arrangement: jk_token -> multiset of (key, row token)."""

    def __init__(self) -> None:
        lib = _load()
        assert lib is not None
        self._lib = lib
        self._h = lib.dj_new()

    def __del__(self) -> None:
        if getattr(self, "_h", None):
            self._lib.dj_free(self._h)
            self._h = None

    def __len__(self) -> int:
        return self._lib.dj_len(self._h)

    def update(self, jk, key_lo, key_hi, token, diff) -> None:
        self._lib.dj_update(
            self._h, len(jk),
            np.ascontiguousarray(jk), np.ascontiguousarray(key_lo),
            np.ascontiguousarray(key_hi), np.ascontiguousarray(token),
            np.ascontiguousarray(diff),
        )

    def probe(self, jk: np.ndarray):
        """Cross each jk[i] with this arrangement's group: returns
        (input_idx, key_lo, key_hi, token, count) flat match arrays."""
        n = len(jk)
        jk = np.ascontiguousarray(jk)
        cap = max(4 * n, 256)
        while True:
            idx = np.empty(cap, np.int64)
            klo = np.empty(cap, np.uint64)
            khi = np.empty(cap, np.uint64)
            tok = np.empty(cap, np.uint64)
            cnt = np.empty(cap, np.int64)
            m = self._lib.dj_probe(self._h, n, jk, cap, idx, klo, khi, tok, cnt)
            if m >= 0:
                return idx[:m], klo[:m], khi[:m], tok[:m], cnt[:m]
            cap = -m

    def export_state(self):
        n = len(self)
        jk = np.empty(n, np.uint64)
        klo = np.empty(n, np.uint64)
        khi = np.empty(n, np.uint64)
        tok = np.empty(n, np.uint64)
        cnt = np.empty(n, np.int64)
        m = self._lib.dj_export(self._h, jk, klo, khi, tok, cnt)
        assert m == n
        return jk, klo, khi, tok, cnt

    def group_sizes(self):
        """(jk, live_row_count) per resident group, iteration order."""
        cap = 256
        while True:
            jk = np.empty(cap, np.uint64)
            nrows = np.empty(cap, np.int64)
            m = self._lib.dj_groups(self._h, cap, jk, nrows)
            if m >= 0:
                return jk[:m], nrows[:m]
            cap = -m

    def evict_group(self, jk: int):
        """Export one group's live rows in insertion order and erase it:
        (key_lo, key_hi, token, count) arrays, empty when absent. The
        insertion order is the order dj_probe would have emitted, so a
        later re-insert via update() round-trips byte-identically."""
        cap = 64
        while True:
            klo = np.empty(cap, np.uint64)
            khi = np.empty(cap, np.uint64)
            tok = np.empty(cap, np.uint64)
            cnt = np.empty(cap, np.int64)
            m = self._lib.dj_evict(self._h, jk, cap, klo, khi, tok, cnt)
            if m >= 0:
                return klo[:m], khi[:m], tok[:m], cnt[:m]
            cap = -m


def bloom_build(hashes: np.ndarray, m_bits: int, k: int) -> np.ndarray:
    """Bloom bitset (uint8 array of m_bits/8 bytes) over pre-hashed u64
    keys; m_bits must be a power of two. Falls back to a pure-python
    build when the native library is unavailable."""
    bits = np.zeros(m_bits // 8, np.uint8)
    lib = _load()
    h = np.ascontiguousarray(hashes, np.uint64)
    if lib is not None:
        lib.dp_bloom_build(len(h), h, m_bits, k, bits)
        return bits
    for hv in h.tolist():
        h1 = _bloom_mix(hv)
        h2 = _bloom_mix(h1 ^ 0x9E3779B97F4A7C15) | 1
        for j in range(k):
            b = (h1 + j * h2) % m_bits
            bits[b >> 3] |= 1 << (b & 7)
    return bits


def bloom_check(bits: np.ndarray, m_bits: int, k: int, hash_: int) -> bool:
    lib = _load()
    if lib is not None:
        return bool(lib.dp_bloom_check(bits, m_bits, k, hash_))
    h1 = _bloom_mix(hash_)
    h2 = _bloom_mix(h1 ^ 0x9E3779B97F4A7C15) | 1
    for j in range(k):
        b = (h1 + j * h2) % m_bits
        if not (bits[b >> 3] & (1 << (b & 7))):
            return False
    return True


def _bloom_mix(x: int) -> int:
    # mirror of dp_bloom_mix in dataplane.cpp — the two builds must agree
    # bit-for-bit so a bitset built on one plane checks on the other
    M = (1 << 64) - 1
    x ^= x >> 33
    x = (x * 0xFF51AFD7ED558CCD) & M
    x ^= x >> 33
    x = (x * 0xC4CEB9FE1A85EC53) & M
    x ^= x >> 33
    return x


def join_rows(
    tab: InternTable,
    l_lo, l_hi, l_tok,
    r_lo, r_hi, r_tok,
    id_mode: int = 0,
    out_cols: "list[int] | None" = None,
    l_width: int = 0,
):
    """Assemble joined output rows (lkey, rkey, *lrow, *rrow) as interned
    tokens with output keys (id_mode 0=hash, 1=left, 2=right) —
    byte-identical to the object plane's join output rows.

    `out_cols` fuses the post-join select into the emission: each entry
    indexes the virtual joined row (0 lkey, 1 rkey, 2+c combined column)
    and only those pieces are assembled — one row build for join+select
    instead of two full passes."""
    lib = _load()
    n = len(l_tok)
    out_lo = np.empty(n, np.uint64)
    out_hi = np.empty(n, np.uint64)
    out_tok = np.empty(n, np.uint64)
    if out_cols is None:
        n_out, sel = -1, np.empty(0, np.int64)
    else:
        n_out, sel = len(out_cols), np.asarray(out_cols, np.int64)
    rc = lib.dp_join_rows(
        tab._h, n,
        np.ascontiguousarray(l_lo), np.ascontiguousarray(l_hi),
        np.ascontiguousarray(l_tok),
        np.ascontiguousarray(r_lo), np.ascontiguousarray(r_hi),
        np.ascontiguousarray(r_tok),
        id_mode, n_out, sel, l_width, out_lo, out_hi, out_tok,
    )
    if rc != 0:
        return None
    return out_lo, out_hi, out_tok


# ------------------------------------------------------------------ ingest


def ingest_jsonl(
    tab: InternTable,
    data: bytes,
    col_names: list[str],
    pk_idx: list[int],
    seq_base: int,
    seq_start: int,
    col_tags: list[int] | None = None,
    key_mode: int = 0,
):
    """Parse a jsonlines chunk. Returns (batch_arrays, statuses,
    line_offsets): tokens/keys are valid where status==0; status==1 lines
    need the Python fallback parser; 2 = blank. col_tags: declared dtype
    tag per column (2=int 3=float, 0=any) for lossless literal coercion.
    key_mode 1 = cheap sequential keys (plan-gated id elision)."""
    lib = _load()
    n_cols = len(col_names)
    name_bufs = [n.encode("utf-8") for n in col_names]
    name_arr = (ctypes.c_char_p * n_cols)(*name_bufs)
    name_lens = np.array([len(b) for b in name_bufs], np.int64)
    tags = np.asarray(col_tags if col_tags is not None else [0] * n_cols, np.uint8)
    cap = data.count(b"\n") + 2
    out_tok = np.empty(cap, np.uint64)
    out_lo = np.empty(cap, np.uint64)
    out_hi = np.empty(cap, np.uint64)
    status = np.empty(cap, np.uint8)
    ls = np.empty(cap, np.int64)
    le = np.empty(cap, np.int64)
    pk = np.asarray(pk_idx or [0], np.int64)
    n = lib.dp_ingest_jsonl(
        tab._h, data, len(data), n_cols,
        ctypes.cast(name_arr, ctypes.POINTER(ctypes.c_char_p)), name_lens,
        tags, pk, len(pk_idx), seq_base, seq_start, key_mode,
        out_tok, out_lo, out_hi, status, ls, le, cap,
    )
    return (
        (out_lo[:n], out_hi[:n], out_tok[:n]),
        status[:n],
        (ls[:n], le[:n]),
    )


def ingest_csv(
    tab: InternTable,
    data: bytes,
    field_idx: list[int],
    dtypes: list[int],
    optional: list[bool],
    pk_idx: list[int],
    seq_base: int,
    seq_start: int,
    delim: bytes = b",",
    key_mode: int = 0,
):
    """Parse CSV records (header already consumed by the caller)."""
    lib = _load()
    n_cols = len(field_idx)
    cap = data.count(b"\n") + 2
    out_tok = np.empty(cap, np.uint64)
    out_lo = np.empty(cap, np.uint64)
    out_hi = np.empty(cap, np.uint64)
    status = np.empty(cap, np.uint8)
    ls = np.empty(cap, np.int64)
    le = np.empty(cap, np.int64)
    pk = np.asarray(pk_idx or [0], np.int64)
    n = lib.dp_ingest_csv(
        tab._h, data, len(data), delim, n_cols,
        np.asarray(field_idx, np.int64),
        np.asarray(dtypes, np.uint8),
        np.asarray([1 if o else 0 for o in optional], np.uint8),
        pk, len(pk_idx), seq_base, seq_start, key_mode,
        out_tok, out_lo, out_hi, status, ls, le, cap,
    )
    return (
        (out_lo[:n], out_hi[:n], out_tok[:n]),
        status[:n],
        (ls[:n], le[:n]),
    )


_M64 = (1 << 64) - 1


def cheap_seq_key(base: int, n: int) -> int:
    """The C cheap sequential key as a 128-bit int (mirror-equality
    tests against internals.keys.cheap_sequential_key_at)."""
    lib = _load()
    lo = ctypes.c_uint64()
    hi = ctypes.c_uint64()
    lib.dp_cheap_seq_key(base, n, ctypes.byref(lo), ctypes.byref(hi))
    return (hi.value << 64) | lo.value


def cheap_join_key_c(lkey: int, rkey: int) -> int:
    """The C cheap join id as a 128-bit int (mirror-equality tests)."""
    lib = _load()
    lo = ctypes.c_uint64()
    hi = ctypes.c_uint64()
    lib.dp_cheap_join_key(
        lkey & _M64, lkey >> 64, rkey & _M64, rkey >> 64,
        ctypes.byref(lo), ctypes.byref(hi),
    )
    return (hi.value << 64) | lo.value


# ------------------------------------------------------------ node helpers


def decode_num_cols(tab: InternTable, tokens: np.ndarray, col_idx: list[int]):
    """-> (vals_i, vals_f, tags) each [n_cols, n]; tags match the zs_agg
    layout (0=int, 1=float, 2=error-bucket). None on malformed rows."""
    lib = _load()
    n = len(tokens)
    k = len(col_idx)
    vi = np.zeros(k * n, np.int64)
    vf = np.zeros(k * n, np.float64)
    tg = np.zeros(k * n, np.uint8)
    rc = lib.dp_decode_num_cols(
        tab._h, n, np.ascontiguousarray(tokens),
        np.asarray(col_idx, np.int64), k, vi, vf, tg,
    )
    if rc != 0:
        return None
    return vi.reshape(k, n), vf.reshape(k, n), tg.reshape(k, n)


def decode_str_cols(tab: InternTable, tokens: np.ndarray, col_idx: list[int]):
    """-> list of per-column lists of str|None, or None on malformed rows /
    non-string values (kind==2)."""
    lib = _load()
    n = len(tokens)
    k = len(col_idx)
    cap = max(64 * n, 4096)
    off = np.zeros(k * n, np.int64)
    slen = np.zeros(k * n, np.int64)
    kind = np.zeros(k * n, np.uint8)
    ci = np.asarray(col_idx, np.int64)
    toks = np.ascontiguousarray(tokens)
    while True:
        buf = ctypes.create_string_buffer(cap)
        used = lib.dp_decode_str_cols(tab._h, n, toks, ci, k, buf, cap, off, slen, kind)
        if used == -(2**63):
            return None
        if used >= 0:
            break
        cap = -used
    raw = buf.raw
    cols: list[list] = []
    for j in range(k):
        col: list = []
        for i in range(n):
            o = j * n + i
            if kind[o] == 0:
                col.append(raw[off[o] : off[o] + slen[o]].decode("utf-8"))
            elif kind[o] == 1:
                col.append(None)
            else:
                return None
        cols.append(col)
    return cols


def project_group(
    tab: InternTable, tokens: np.ndarray, col_idx: list[int], n_shards: int = 0,
    forbid_error: bool = False,
):
    """-> (gtokens, shards|None); None result on malformed rows.
    forbid_error: rows whose projected pieces carry the ERROR tag get
    gtoken 0 (join-key semantics — the object plane drops ERROR jks)."""
    lib = _load()
    n = len(tokens)
    gt = np.empty(n, np.uint64)
    sh = np.empty(n, np.int64)
    rc = lib.dp_project_group(
        tab._h, n, np.ascontiguousarray(tokens),
        np.asarray(col_idx, np.int64), len(col_idx), n_shards, gt, sh,
        0x0E if forbid_error else 0,
    )
    if rc != 0:
        return None
    return gt, (sh if n_shards > 0 else None)


def rekey(tab: InternTable, tokens: np.ndarray, col_idx: list[int]):
    """New 128-bit record keys = blake2b of the projected column pieces —
    byte-identical to `key_for_values(*cols)` (with_id_from / reindex).
    Returns (lo, hi) with 0/0 marking rows whose key columns hold ERROR
    (those must take the object-plane key path: the planes' ERROR
    serializations differ); None on malformed rows."""
    lib = _load()
    n = len(tokens)
    lo = np.empty(n, np.uint64)
    hi = np.empty(n, np.uint64)
    rc = lib.dp_rekey(
        tab._h, n, np.ascontiguousarray(tokens),
        np.asarray(col_idx, np.int64), len(col_idx), 0x0E, lo, hi,
    )
    if rc != 0:
        return None
    return lo, hi


def rekey_salt(key_lo: np.ndarray, key_hi: np.ndarray, salt: int):
    """New keys = blake2b-128 of (key piece, int salt piece) per row —
    byte-identical to hash_values(key, salt) (concat_reindex)."""
    lib = _load()
    n = len(key_lo)
    lo = np.empty(n, np.uint64)
    hi = np.empty(n, np.uint64)
    lib.dp_rekey_salt(
        n, np.ascontiguousarray(key_lo), np.ascontiguousarray(key_hi),
        salt, lo, hi,
    )
    return lo, hi


def route_key(key_lo: np.ndarray, key_hi: np.ndarray, n_shards: int) -> np.ndarray:
    lib = _load()
    n = len(key_lo)
    out = np.empty(n, np.int64)
    lib.dp_route_key(
        n, np.ascontiguousarray(key_lo), np.ascontiguousarray(key_hi), n_shards, out
    )
    return out


def build_rows(
    tab: InternTable,
    in_tokens: np.ndarray,
    specs: list,
    vals_i: np.ndarray,
    vals_f: np.ndarray,
    vtag: np.ndarray,
):
    """specs: per output column, ('col', src_idx) or ('val', slot). The
    val arrays are [n_slots, n] row-major (slot = second spec element).
    Returns (tokens, status)."""
    lib = _load()
    n = len(in_tokens)
    n_out = len(specs)
    src_kind = np.array([0 if s[0] == "col" else 1 for s in specs], np.int64)
    src_col = np.array([s[1] for s in specs], np.int64)
    out_tok = np.empty(n, np.uint64)
    status = np.empty(n, np.uint8)
    rc = lib.dp_build_rows(
        tab._h, n, np.ascontiguousarray(in_tokens), n_out, src_kind, src_col,
        np.ascontiguousarray(vals_i.reshape(-1)),
        np.ascontiguousarray(vals_f.reshape(-1)),
        np.ascontiguousarray(vtag.reshape(-1)),
        out_tok, status,
    )
    assert rc == 0
    return out_tok, status


def splice_cols(
    tab: InternTable,
    toks: "list[np.ndarray] | np.ndarray",
    specs: list[tuple[int, int]],
):
    """Build rows picking columns across k aligned source rows: specs[j]
    = (source, col). `toks` is a list of k aligned token arrays (or one
    [k, n] array). None on malformed rows."""
    lib = _load()
    if isinstance(toks, list):
        toks = np.stack([np.asarray(t, np.uint64) for t in toks])
    toks = np.ascontiguousarray(toks, np.uint64)
    k, n = toks.shape
    side = np.asarray([s for s, _ in specs], np.int64)
    idx = np.asarray([c for _, c in specs], np.int64)
    out = np.empty(n, np.uint64)
    rc = lib.dp_splice_cols(
        tab._h, n, k, toks.reshape(-1), len(specs), side, idx, out,
    )
    if rc != 0:
        return None
    return out


def decode_key_col(tab: InternTable, tokens: np.ndarray, col: int):
    """-> (lo, hi, status) with status 0=Key 1=None 2=other scalar;
    None on malformed rows."""
    lib = _load()
    n = len(tokens)
    lo = np.empty(n, np.uint64)
    hi = np.empty(n, np.uint64)
    st = np.empty(n, np.uint8)
    rc = lib.dp_decode_key_col(
        tab._h, n, np.ascontiguousarray(tokens), col, lo, hi, st
    )
    if rc != 0:
        return None
    return lo, hi, st


def flatten_batch(tab: InternTable, batch: "NativeBatch", col: int):
    """Expand a str/bytes column into per-character child rows with
    hash_values(parent_key, j) keys. Returns (child NativeBatch,
    fallback_mask) — fallback rows (non-str/bytes column) take the
    object path. None on total kernel failure."""
    lib = _load()
    n = len(batch)
    fb = np.empty(max(n, 1), np.uint8)
    tok = np.ascontiguousarray(batch.token)
    lo = np.ascontiguousarray(batch.key_lo)
    hi = np.ascontiguousarray(batch.key_hi)
    df = np.ascontiguousarray(batch.diff)
    cap = max(4 * n, 256)
    while True:
        o_lo = np.empty(cap, np.uint64)
        o_hi = np.empty(cap, np.uint64)
        o_tok = np.empty(cap, np.uint64)
        o_diff = np.empty(cap, np.int64)
        m = lib.dp_flatten(
            tab._h, n, tok, lo, hi, df, col, fb, cap, o_lo, o_hi, o_tok, o_diff
        )
        if m >= 0:
            break
        cap = -m
    child = NativeBatch(tab, o_lo[:m], o_hi[:m], o_tok[:m], o_diff[:m])
    return child, fb[:n] != 0


def format_csv(
    tab: InternTable,
    tokens: np.ndarray,
    diffs: np.ndarray,
    time: int,
    delim: bytes = b",",
):
    """-> (csv_bytes, fallback_row_indices)."""
    lib = _load()
    n = len(tokens)
    fb = np.empty(max(n, 1), np.int64)
    nfb = np.zeros(1, np.int64)
    cap = max(64 * n, 4096)
    toks = np.ascontiguousarray(tokens)
    dfs = np.ascontiguousarray(diffs)
    while True:
        out = ctypes.create_string_buffer(cap)
        used = lib.dp_format_csv(tab._h, n, toks, dfs, time, delim, out, cap, fb, nfb)
        if used >= 0:
            break
        cap = -used + 1024
    return out.raw[:used], fb[: int(nfb[0])]
