"""128-bit content-addressed row keys (pointers).

TPU-native equivalent of the reference's `Key` (src/engine/value.rs:41-63):
a 128-bit hash used as a stable, content-addressed row identifier. The
reference uses xxh3-128; we use blake2b truncated to 128 bits — the contract
(deterministic, content-addressed, uniformly distributed, shardable) is the
same, the hash function is an implementation detail.

Keys double as the sharding domain: `shard(n)` buckets a key onto one of n
workers / TPU cores; the same bucketing drives the ICI all_to_all exchange
plan in `pathway_tpu_torch.parallel`.
"""

from __future__ import annotations

import hashlib
import struct
import threading
from typing import Any, Iterable

from pathway_tpu_torch.analysis import lockgraph as _lockgraph

_MASK = (1 << 128) - 1
_SALT_SEQ = 0x9E3779B97F4A7C15F39CC0605CEDC834


class Key:
    """A 128-bit pointer / row id."""

    __slots__ = ("value",)

    def __init__(self, value: int):
        self.value = value & _MASK

    def __repr__(self) -> str:
        return f"^{self.value:032X}"[:12] + "..."

    def __str__(self) -> str:
        return f"^{self.value:032X}"

    def __eq__(self, other: Any) -> bool:
        return isinstance(other, Key) and self.value == other.value

    def __lt__(self, other: "Key") -> bool:
        return self.value < other.value

    def __le__(self, other: "Key") -> bool:
        return self.value <= other.value

    def __gt__(self, other: "Key") -> bool:
        return self.value > other.value

    def __ge__(self, other: "Key") -> bool:
        return self.value >= other.value

    def __hash__(self) -> int:
        return self.value & 0x7FFFFFFFFFFFFFFF

    def salted_with(self, salt: int) -> "Key":
        """Mix a salt into the key (reference: value.rs salted_with)."""
        return Key(_hash_bytes(self.value.to_bytes(16, "little") + salt.to_bytes(8, "little", signed=False)))

    def with_shard_of(self, other: "Key", n_shards: int = 1 << 16) -> "Key":
        """Keep `other`'s shard bucket while retaining this key's identity
        (reference: value.rs with_shard_of — co-locates instance groups)."""
        bucket = other.shard(n_shards)
        base = self.value & (_MASK >> 16)
        return Key((bucket << 112) | base)

    def shard(self, n: int) -> int:
        """Shard bucket in [0, n) — top bits, matching exchange routing."""
        return (self.value >> 112) % n

    def to_hi_lo(self) -> tuple[int, int]:
        return (self.value >> 64, self.value & 0xFFFFFFFFFFFFFFFF)

    @staticmethod
    def from_hi_lo(hi: int, lo: int) -> "Key":
        return Key((hi << 64) | lo)


def _hash_bytes(data: bytes) -> int:
    return int.from_bytes(hashlib.blake2b(data, digest_size=16).digest(), "little")


_np = None
_pw_json = None
_dt_types = None


def _lazy_modules():
    global _np, _pw_json, _dt_types
    if _np is None:
        import numpy

        from pathway_tpu_torch.internals import datetime_types, json

        _np = numpy
        _pw_json = json
        _dt_types = datetime_types
    return _np, _pw_json, _dt_types


def _serialize_value(value: Any, out: list[bytes]) -> None:
    """Canonical serialization of a Value for hashing (type-tagged)."""
    np, pw_json, dtt = _lazy_modules()
    DateTimeNaive, DateTimeUtc, Duration = (
        dtt.DateTimeNaive, dtt.DateTimeUtc, dtt.Duration
    )

    if value is None:
        out.append(b"\x00")
    elif isinstance(value, bool) or isinstance(value, np.bool_):
        out.append(b"\x01" + (b"\x01" if value else b"\x00"))
    elif isinstance(value, (int, np.integer)):
        out.append(b"\x02" + struct.pack("<q", int(value)))
    elif isinstance(value, (float, np.floating)):
        out.append(b"\x03" + struct.pack("<d", float(value)))
    elif isinstance(value, str):
        b = value.encode("utf-8")
        out.append(b"\x04" + struct.pack("<q", len(b)) + b)
    elif isinstance(value, bytes):
        out.append(b"\x05" + struct.pack("<q", len(value)) + value)
    elif isinstance(value, Key):
        out.append(b"\x06" + value.value.to_bytes(16, "little"))
    elif isinstance(value, tuple):
        out.append(b"\x07" + struct.pack("<q", len(value)))
        for v in value:
            _serialize_value(v, out)
    elif isinstance(value, np.ndarray):
        out.append(b"\x08" + str(value.dtype).encode() + str(value.shape).encode() + value.tobytes())
    elif isinstance(value, DateTimeUtc):
        out.append(b"\x0b" + struct.pack("<q", value.timestamp_ns()))
    elif isinstance(value, DateTimeNaive):
        out.append(b"\x09" + struct.pack("<q", value.timestamp_ns()))
    elif isinstance(value, Duration):
        out.append(b"\x0a" + struct.pack("<q", value.nanoseconds()))
    elif isinstance(value, pw_json.Json):
        out.append(b"\x0c" + pw_json.Json.dumps(value.value).encode("utf-8"))
    else:
        # Opaque objects: hash by repr (stable within a run for wrappers)
        out.append(b"\x0d" + repr(value).encode("utf-8", "replace"))


def _fast_piece(v: Any) -> bytes | None:
    """Byte-identical to _serialize_value for the hot scalar types (the
    join/flatten/group output-key shapes); None falls back to the
    generic serializer."""
    t = type(v)
    if t is Key:
        return b"\x06" + v.value.to_bytes(16, "little")
    if t is int:
        return b"\x02" + struct.pack("<q", v)
    if v is None:
        return b"\x00"
    if t is str:
        b = v.encode("utf-8")
        return b"\x04" + struct.pack("<q", len(b)) + b
    return None


def hash_values(*values: Any) -> int:
    pieces: list[bytes] = []
    for v in values:
        p = _fast_piece(v)
        if p is None:
            break
        pieces.append(p)
    else:
        return _hash_bytes(b"".join(pieces))
    out: list[bytes] = []
    for v in values:
        _serialize_value(v, out)
    return _hash_bytes(b"".join(out))


def key_for_values(*values: Any) -> Key:
    """Content-addressed key from column values (reference: Key::for_values)."""
    return Key(hash_values(*values))


def key_for_value(value: Any) -> Key:
    return Key(hash_values(value))


_seq_next = 0
# eager: the old lazy None-check was itself racy (two first callers could
# each install a different lock and interleave their reservations), and
# its import-cost rationale died when lockgraph pulled threading in above
_seq_lock = _lockgraph.register_lock("keys.sequence", threading.Lock())


def reserve_sequential(n: int) -> int:
    """Reserve n consecutive sequence numbers; returns the first. The
    native ingest path computes the same blake2b(pack(base, i) + salt)
    keys in C++ from this range, so native and Python rows share one
    non-colliding sequence. O(1) in n — a multi-million-row scan reserves
    per parse chunk, and an O(n) reservation was a measured hotspot."""
    global _seq_next
    with _seq_lock:
        start = _seq_next
        _seq_next = start + n
    return start


def sequential_key(base: int = 0) -> Key:
    """Auto-generated key for rows without a primary key: hash of a sequence
    number (keeps keys uniformly spread over the shard space)."""
    return sequential_key_at(reserve_sequential(1), base)


def sequential_key_at(n: int, base: int = 0) -> Key:
    """The key for an explicit sequence number (from reserve_sequential) —
    the formula the native ingest computes in C++ (dataplane.cpp
    finish_row)."""
    return Key(_hash_bytes(struct.pack("<QQ", base, n) + _SALT_SEQ.to_bytes(16, "little")))


# ------------------------------------------------- cheap keys (id elision)
#
# When the plan optimizer (internals/planner.py) proves a source's row
# identities can never be observed in any output, scans derive sequential
# keys with this SplitMix64-based mix instead of blake2b — about half the
# measured per-row parse cost. Bit-identical mirrors of dataplane.cpp's
# cheap_seq_key / cheap_join_key (the fallback-line path of a native scan
# and the object path of a cheap-id join must land on the SAME keys the C
# parser computes).

_M64 = (1 << 64) - 1
_SEQ_SALT_LO = 0xF39CC0605CEDC834
_SEQ_SALT_HI = 0x9E3779B97F4A7C15


def _smix64(z: int) -> int:
    z = (z + 0x9E3779B97F4A7C15) & _M64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _M64
    return z ^ (z >> 31)


def cheap_sequential_key_at(n: int, base: int = 0) -> Key:
    """Cheap sequential key (plan-gated id elision; see planner.py)."""
    x = _smix64(base ^ _SEQ_SALT_LO)
    lo = _smix64(x ^ n)
    hi = _smix64((lo + n + _SEQ_SALT_HI) & _M64)
    if lo == 0 and hi == 0:
        lo = 1  # (0, 0) is the plane's ERROR sentinel
    return Key((hi << 64) | lo)


def cheap_join_key(lkey: Key, rkey: Key) -> Key:
    """Cheap join output id for id-elided joins (JoinNode id_mode
    'cheap'); mirrors dataplane.cpp cheap_join_key."""
    llo, lhi = lkey.value & _M64, lkey.value >> 64
    rlo, rhi = rkey.value & _M64, rkey.value >> 64
    lo = _smix64(llo ^ _smix64((rlo + _SEQ_SALT_LO) & _M64))
    # C precedence: lhi ^ (smix64(rhi + SALT_HI) + lo), u64 wrap
    hi = _smix64(lhi ^ ((_smix64((rhi + _SEQ_SALT_HI) & _M64) + lo) & _M64))
    if lo == 0 and hi == 0:
        lo = 1
    return Key((hi << 64) | lo)


def ref_scalar(*args: Any, optional: bool = False, instance: Any = None) -> Key:
    """Public `pw.Table.pointer_from` semantics."""
    if instance is not None:
        base = key_for_values(*args)
        inst = key_for_values(instance)
        return base.with_shard_of(inst)
    return key_for_values(*args)
