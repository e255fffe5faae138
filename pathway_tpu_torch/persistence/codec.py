"""Typed binary codec for durable state (journals + operator snapshots).

Reference parity: the reference serializes journal entries and operator
snapshots with typed bincode (src/persistence/ — SnapshotEvent derives
bincode Encode/Decode), not a language-pinned object dump. This module
is the equivalent: a self-describing tag-length encoding over the engine
Value domain plus the engine's state containers, with an explicit
escape tag for genuinely opaque Python state (custom reducer
accumulators). Everything on the common path round-trips without
`pickle`, so journal segments have a stable, documented layout:

  record  := u32 payload_len | u32 crc32(payload) | payload
  payload := value                     (self-describing, tagged)

A torn tail write (crash mid-append) fails the length or crc check and
reading stops — the same discard-torn-tail semantics the pickle journal
had, now detected by checksum rather than by unpickling failure.
"""

from __future__ import annotations

import pickle
import struct
import zlib
from collections import defaultdict
from typing import Any

from pathway_tpu_torch.internals.keys import Key

_NONE = 0x00
_BOOL = 0x01
_INT64 = 0x02
_FLOAT = 0x03
_STR = 0x04
_BYTES = 0x05
_KEY = 0x06
_TUPLE = 0x07
_NDARRAY = 0x08
_DT_NAIVE = 0x09
_DURATION = 0x0A
_DT_UTC = 0x0B
_JSON = 0x0C
_BIGINT = 0x0D
_LIST = 0x0E
_DICT = 0x0F
_PICKLE = 0x10
_KEYED_STATE = 0x11
_MULTISET_STATE = 0x12
_DEFAULTDICT_INT = 0x13
_DEFAULTDICT_LIST = 0x14
_SET = 0x15
_FROZENSET = 0x16
_ERROR = 0x17

_I64_MIN, _I64_MAX = -(1 << 63), (1 << 63) - 1


_MODULES: tuple | None = None


def _lazy():
    global _MODULES
    if _MODULES is None:
        import numpy as np

        from pathway_tpu_torch.internals import datetime_types as dtt
        from pathway_tpu_torch.internals import json as pw_json
        from pathway_tpu_torch.internals.errors import ERROR

        _MODULES = (np, pw_json, dtt, ERROR)
    return _MODULES


def _enc(out: bytearray, v: Any) -> None:
    np, pw_json, dtt, ERROR = _lazy()
    t = type(v)
    if v is None:
        out.append(_NONE)
    elif t is bool or isinstance(v, np.bool_):
        out.append(_BOOL)
        out.append(1 if v else 0)
    elif t is int or isinstance(v, np.integer):
        i = int(v)
        if _I64_MIN <= i <= _I64_MAX:
            out.append(_INT64)
            out += struct.pack("<q", i)
        else:
            b = i.to_bytes((i.bit_length() + 8) // 8, "little", signed=True)
            out.append(_BIGINT)
            out += struct.pack("<I", len(b))
            out += b
    elif t is float or isinstance(v, np.floating):
        out.append(_FLOAT)
        out += struct.pack("<d", float(v))
    elif t is str:
        b = v.encode("utf-8")
        out.append(_STR)
        out += struct.pack("<I", len(b))
        out += b
    elif t is bytes:
        out.append(_BYTES)
        out += struct.pack("<I", len(v))
        out += v
    elif t is Key:
        out.append(_KEY)
        out += v.value.to_bytes(16, "little")
    elif t is tuple:
        out.append(_TUPLE)
        out += struct.pack("<I", len(v))
        for x in v:
            _enc(out, x)
    elif t is list:
        out.append(_LIST)
        out += struct.pack("<I", len(v))
        for x in v:
            _enc(out, x)
    elif v is ERROR:
        out.append(_ERROR)
    elif isinstance(v, np.ndarray):
        ds_str = str(v.dtype)
        if (
            v.dtype.hasobject
            or v.dtype.names is not None
            or v.dtype.kind not in "?biufcmMSU"
            or len(ds_str) > 255
        ):
            # object/structured/exotic dtypes have no round-trippable
            # raw-buffer form (np.dtype(str(dt)) fails for compound
            # dtypes; object tobytes() dumps pointers) — explicit escape
            b = pickle.dumps(v, protocol=4)
            out.append(_PICKLE)
            out += struct.pack("<I", len(b))
            out += b
            return
        ds = ds_str.encode()
        v = np.ascontiguousarray(v)
        out.append(_NDARRAY)
        out.append(len(ds))
        out += ds
        out.append(v.ndim)
        out += struct.pack(f"<{v.ndim}q", *v.shape)
        raw = v.tobytes()
        out += struct.pack("<Q", len(raw))
        out += raw
    elif isinstance(v, dtt.DateTimeUtc):
        out.append(_DT_UTC)
        out += struct.pack("<q", v.timestamp_ns())
    elif isinstance(v, dtt.DateTimeNaive):
        out.append(_DT_NAIVE)
        out += struct.pack("<q", v.timestamp_ns())
    elif isinstance(v, dtt.Duration):
        out.append(_DURATION)
        out += struct.pack("<q", v.nanoseconds())
    elif isinstance(v, pw_json.Json):
        b = pw_json.Json.dumps(v.value).encode("utf-8")
        out.append(_JSON)
        out += struct.pack("<I", len(b))
        out += b
    elif isinstance(v, defaultdict) and v.default_factory in (int, list):
        out.append(
            _DEFAULTDICT_INT if v.default_factory is int else _DEFAULTDICT_LIST
        )
        out += struct.pack("<I", len(v))
        for k, x in v.items():
            _enc(out, k)
            _enc(out, x)
    elif t is dict:
        out.append(_DICT)
        out += struct.pack("<I", len(v))
        for k, x in v.items():
            _enc(out, k)
            _enc(out, x)
    elif t is set or t is frozenset:
        out.append(_SET if t is set else _FROZENSET)
        out += struct.pack("<I", len(v))
        for x in v:
            _enc(out, x)
    else:
        from pathway_tpu_torch.engine.core import KeyedState, MultisetState

        if t is KeyedState:
            out.append(_KEYED_STATE)
            out += struct.pack("<I", len(v.rows))
            for k, row in v.rows.items():
                _enc(out, k)
                _enc(out, row)
        elif t is MultisetState:
            out.append(_MULTISET_STATE)
            out += struct.pack("<I", len(v.groups))
            for dkey, group in v.groups.items():
                _enc(out, dkey)
                out += struct.pack("<I", len(group))
                for tok, (payload, cnt) in group.items():
                    _enc(out, tok)
                    _enc(out, payload)
                    out += struct.pack("<q", cnt)
        else:
            # opaque Python state (custom reducer accumulators, exotic
            # wrappers): explicit, tagged escape — the only pickle left
            b = pickle.dumps(v, protocol=4)
            out.append(_PICKLE)
            out += struct.pack("<I", len(b))
            out += b


class _Reader:
    __slots__ = ("buf", "pos")

    def __init__(self, buf: bytes | memoryview):
        self.buf = memoryview(buf)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        p = self.pos
        if p + n > len(self.buf):
            raise ValueError("truncated value")
        self.pos = p + n
        return self.buf[p : p + n]

    def u8(self) -> int:
        return self.take(1)[0]

    def u32(self) -> int:
        return struct.unpack("<I", self.take(4))[0]

    def i64(self) -> int:
        return struct.unpack("<q", self.take(8))[0]


def _dec(r: _Reader) -> Any:
    np, pw_json, dtt, ERROR = _lazy()
    tag = r.u8()
    if tag == _NONE:
        return None
    if tag == _BOOL:
        return bool(r.u8())
    if tag == _INT64:
        return r.i64()
    if tag == _FLOAT:
        return struct.unpack("<d", r.take(8))[0]
    if tag == _STR:
        return str(r.take(r.u32()), "utf-8")
    if tag == _BYTES:
        return bytes(r.take(r.u32()))
    if tag == _KEY:
        return Key(int.from_bytes(r.take(16), "little"))
    if tag == _TUPLE:
        return tuple(_dec(r) for _ in range(r.u32()))
    if tag == _LIST:
        return [_dec(r) for _ in range(r.u32())]
    if tag == _ERROR:
        return ERROR
    if tag == _NDARRAY:
        ds = str(r.take(r.u8()), "ascii")
        ndim = r.u8()
        shape = struct.unpack(f"<{ndim}q", r.take(8 * ndim))
        raw = r.take(struct.unpack("<Q", r.take(8))[0])
        # .copy(): frombuffer over bytes yields a READ-ONLY view; restored
        # rows must stay mutable like freshly-ingested ones
        return (
            np.frombuffer(bytes(raw), dtype=np.dtype(ds))
            .reshape(shape)
            .copy()
        )
    if tag == _DT_UTC:
        return dtt.DateTimeUtc(ns=r.i64())
    if tag == _DT_NAIVE:
        return dtt.DateTimeNaive(ns=r.i64())
    if tag == _DURATION:
        return dtt.Duration(nanoseconds=r.i64())
    if tag == _JSON:
        import json as _stdjson

        return pw_json.Json(_stdjson.loads(str(r.take(r.u32()), "utf-8")))
    if tag == _BIGINT:
        return int.from_bytes(r.take(r.u32()), "little", signed=True)
    if tag in (_DEFAULTDICT_INT, _DEFAULTDICT_LIST):
        d: Any = defaultdict(int if tag == _DEFAULTDICT_INT else list)
        for _ in range(r.u32()):
            k = _dec(r)
            d[k] = _dec(r)
        return d
    if tag == _DICT:
        out = {}
        for _ in range(r.u32()):
            k = _dec(r)
            out[k] = _dec(r)
        return out
    if tag in (_SET, _FROZENSET):
        items = [_dec(r) for _ in range(r.u32())]
        return set(items) if tag == _SET else frozenset(items)
    if tag == _PICKLE:
        return pickle.loads(bytes(r.take(r.u32())))  # noqa: S301
    if tag == _KEYED_STATE:
        from pathway_tpu_torch.engine.core import KeyedState

        ks = KeyedState()
        for _ in range(r.u32()):
            k = _dec(r)
            ks.rows[k] = _dec(r)
        return ks
    if tag == _MULTISET_STATE:
        from pathway_tpu_torch.engine.core import MultisetState

        ms = MultisetState()
        for _ in range(r.u32()):
            dkey = _dec(r)
            group = {}
            for _ in range(r.u32()):
                tok = _dec(r)
                payload = _dec(r)
                cnt = struct.unpack("<q", r.take(8))[0]
                group[tok] = (payload, cnt)
            ms.groups[dkey] = group
        return ms
    raise ValueError(f"unknown tag 0x{tag:02x}")


def encode_value(v: Any) -> bytes:
    out = bytearray()
    _enc(out, v)
    return bytes(out)


def decode_value(b: bytes | memoryview) -> Any:
    return _dec(_Reader(b))


# ------------------------------------------------------- record framing

_HEADER = struct.Struct("<II")

# Every journal segment / snapshot blob starts with a magic + version.
# An unrecognized format (e.g. a file written by an older layout) fails
# LOUDLY instead of parsing as an empty torn tail and silently dropping
# journaled history.
MAGIC = b"PWBIN\x01"


def frame(payload: bytes) -> bytes:
    return _HEADER.pack(len(payload), zlib.crc32(payload)) + payload


def encode_record(v: Any, *, with_magic: bool = False) -> bytes:
    head = MAGIC if with_magic else b""
    return head + frame(encode_value(v))


def read_records(buf: bytes, *, with_magic: bool = False):
    """Yield decoded records; stops silently at a torn tail (short header,
    short payload, or crc mismatch — all the shapes a crash can leave).
    With `with_magic`, a non-empty buffer must start with MAGIC or the
    read raises (unknown/legacy format, not a crash artifact)."""
    for payload in _frames(buf, with_magic=with_magic):
        yield decode_value(payload)


def count_records(buf: bytes, *, with_magic: bool = False) -> int:
    """Number of intact records, walking frames (length + crc) without
    decoding payloads — restore-time counting must not reconstruct every
    value (or run the pickle escape) just to count."""
    return sum(1 for _ in _frames(buf, with_magic=with_magic))


def valid_prefix_len(buf: bytes, *, with_magic: bool = False) -> int:
    """Byte length of the longest intact prefix (magic + whole crc-valid
    frames). A writer reopening a segment truncates to this before
    appending — otherwise events written after a crash-torn frame would
    sit beyond the point every reader stops at, silently unreadable."""
    n = len(buf)
    pos = 0
    if with_magic:
        if n < len(MAGIC) or bytes(buf[: len(MAGIC)]) != MAGIC:
            return 0  # partial/absent header: rewrite from scratch
        pos = len(MAGIC)
    view = memoryview(buf)
    while pos + _HEADER.size <= n:
        length, crc = _HEADER.unpack_from(buf, pos)
        end = pos + _HEADER.size + length
        if end > n or zlib.crc32(view[pos + _HEADER.size : end]) != crc:
            break
        pos = end
    return pos


def _frames(buf: bytes, *, with_magic: bool):
    pos = 0
    n = len(buf)
    if with_magic and n:
        if n < len(MAGIC):
            return  # crash-truncated mid-header: torn, i.e. empty
        if bytes(buf[: len(MAGIC)]) != MAGIC:
            raise ValueError(
                "unrecognized journal/snapshot format (missing "
                f"{MAGIC!r} header); refusing to read — the file predates "
                "the typed-binary layout or is foreign"
            )
        pos = len(MAGIC)
    view = memoryview(buf)
    while pos + _HEADER.size <= n:
        length, crc = _HEADER.unpack_from(buf, pos)
        start = pos + _HEADER.size
        end = start + length
        if end > n:
            return  # torn: payload truncated
        payload = view[start:end]
        if zlib.crc32(payload) != crc:
            return  # torn or corrupt: stop before emitting garbage
        yield payload
        pos = end
