"""ctypes loader for the native z-set kernel.

Builds `zset.cpp` with g++ on first use into ``pathway_tpu_torch/_build/``
(keyed by a source hash + CPU tag; see :func:`build_library` for how
concurrent processes share one build), exposes typed wrappers, and degrades
to None when no compiler is available — engine call sites keep a
pure-Python path, the reference's host behaviour. :func:`planes` reports
which planes loaded. Disable with PATHWAY_TPU_NATIVE=0.

Reference parity: the reference's native layer is the Rust engine + vendored
differential dataflow (reference/src/, external/); this kernel covers
the same hot loops (consolidation, arrangement state, delta join with
checkpointable export/import, line/CSV tokenization) behind a C ABI.

Dispatch policy — what runs native and why:
  * GroupBy aggregation (zs_agg_*) IS the production hot path
    (engine/core.py GroupByNode): semigroup delta-aggregation is
    O(batch) in C++ with per-call output much smaller than its input, so
    the Python↔C boundary is crossed once per wave and amortized —
    measured ~9x the Python recompute path (tests/test_native_engine.py).
  * CSV/line tokenization (zs_split_*) feeds io/fs.py's chunked reader.
  * JOIN enumeration deliberately stays in Python: a join's output is the
    same size as its match set, and every output row must be materialized
    as Python objects for downstream operators either way — profiling
    (30k-row join+groupby) shows the cost concentrated in per-row key
    hashing and row freezing at that boundary, not in the arrangement
    bookkeeping the C++ delta-join (zs_arr_*) would replace. Those
    boundary costs were attacked directly instead (keys.hash_values fast
    path, freeze_value hash-probe fast path: ~1.8x on join-heavy
    pipelines); zs_arr_* remains available (and tested) for a future
    token-resident engine core where rows stay interned end-to-end.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np
from pathway_tpu_torch.analysis import lockgraph as _lockgraph

_HERE = Path(__file__).resolve().parent
_LOCK = _lockgraph.register_lock("native.batch_resolve", threading.Lock())
_LIB: ctypes.CDLL | None = None
_TRIED = False

u64p = np.ctypeslib.ndpointer(dtype=np.uint64, flags="C_CONTIGUOUS")
i64p = np.ctypeslib.ndpointer(dtype=np.int64, flags="C_CONTIGUOUS")
f64p = np.ctypeslib.ndpointer(dtype=np.float64, flags="C_CONTIGUOUS")
u8p = np.ctypeslib.ndpointer(dtype=np.uint8, flags="C_CONTIGUOUS")


def _cpu_tag() -> str:
    """Identify the CPU the artifact was built for; -march=native output
    must never be dlopened on a different microarchitecture (SIGILL)."""
    try:
        with open("/proc/cpuinfo") as f:
            # model name (x86) / CPU part+Features (arm) identify the uarch;
            # 'flags'/'Features' carry the ISA extensions -march=native uses.
            lines = sorted(
                {
                    ln.strip()
                    for ln in f
                    if ln.startswith(("model name", "flags", "Features", "CPU part"))
                }
            )
        if lines:
            return hashlib.sha256("\n".join(lines).encode()).hexdigest()[:8]
    except OSError:
        pass
    import platform

    return hashlib.sha256(platform.machine().encode()).hexdigest()[:8]


BUILD_DIR = _HERE.parent.parent / "_build"

# stem -> seconds g++ took in this process (absent: loaded from the cache)
BUILD_SECONDS: dict[str, float] = {}


def build_library(src: Path, stem: str, timeout: int) -> Path | None:
    """Build `src` into ``_build/lib<stem>-<hash>-<cpu>.so`` once per
    source and CPU, or return the cached library; None when no compiler
    succeeds. g++ writes a private name that ``os.replace`` moves into
    place under an exclusive ``fcntl`` lock, so a process that races a
    build either waits for it or finds the finished file: none loads a
    half-written library or unlinks another's."""
    import fcntl
    import time

    tag = hashlib.sha256(src.read_bytes()).hexdigest()[:16] + "-" + _cpu_tag()
    out = BUILD_DIR / f"lib{stem}-{tag}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / f"lib{stem}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if out.exists():  # built by the process that held the lock
            return out
        tmp = BUILD_DIR / f".lib{stem}-{tag}.{os.getpid()}.so"
        cmd = [
            "g++", "-O3", "-march=native", "-std=c++17", "-shared", "-fPIC",
            str(src), "-o", str(tmp),
        ]
        t0 = time.perf_counter()
        try:
            try:
                subprocess.run(cmd, check=True, capture_output=True, timeout=timeout)
            except (subprocess.SubprocessError, FileNotFoundError, OSError):
                # retry without -march=native (unsupported on some toolchains)
                cmd.remove("-march=native")
                subprocess.run(cmd, check=True, capture_output=True, timeout=timeout)
        except (subprocess.SubprocessError, FileNotFoundError, OSError):
            tmp.unlink(missing_ok=True)
            return None
        os.replace(tmp, out)
        BUILD_SECONDS[stem] = time.perf_counter() - t0
        for stale in BUILD_DIR.glob(f"lib{stem}-*.so"):
            if stale != out:
                stale.unlink(missing_ok=True)
    return out


def _build() -> Path | None:
    return build_library(_HERE / "zset.cpp", "zset", 120)


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
        lib.zs_consolidate.restype = ctypes.c_int64
        lib.zs_consolidate.argtypes = [ctypes.c_int64, u64p, u64p, u64p, i64p]
        lib.zs_difference.restype = ctypes.c_int64
        lib.zs_difference.argtypes = [
            ctypes.c_int64, u64p, u64p, u64p, i64p,
            ctypes.c_int64, u64p, u64p, u64p, i64p,
            u64p, u64p, u64p, i64p,
        ]
        lib.zs_keyed_new.restype = ctypes.c_void_p
        lib.zs_keyed_free.argtypes = [ctypes.c_void_p]
        lib.zs_keyed_update.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, u64p, u64p, u64p, i64p,
        ]
        lib.zs_keyed_get.argtypes = [ctypes.c_void_p, ctypes.c_int64, u64p, u64p, u64p]
        lib.zs_keyed_len.restype = ctypes.c_int64
        lib.zs_keyed_len.argtypes = [ctypes.c_void_p]
        lib.zs_keyed_items.restype = ctypes.c_int64
        lib.zs_keyed_items.argtypes = [ctypes.c_void_p, u64p, u64p, u64p]
        lib.zs_arr_new.restype = ctypes.c_void_p
        lib.zs_arr_free.argtypes = [ctypes.c_void_p]
        lib.zs_arr_update.argtypes = [ctypes.c_void_p, ctypes.c_int64, u64p, u64p, i64p]
        lib.zs_arr_group_size.restype = ctypes.c_int64
        lib.zs_arr_group_size.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
        lib.zs_arr_get.restype = ctypes.c_int64
        lib.zs_arr_get.argtypes = [ctypes.c_void_p, ctypes.c_uint64, u64p, i64p]
        lib.zs_arr_group_count.restype = ctypes.c_int64
        lib.zs_arr_group_count.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
        lib.zs_arr_delta_join.restype = ctypes.c_int64
        lib.zs_arr_delta_join.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, u64p, ctypes.c_int64, i64p, u64p, i64p,
        ]
        lib.zs_agg_new.restype = ctypes.c_void_p
        lib.zs_agg_new.argtypes = [ctypes.c_int64, i64p]
        lib.zs_agg_free.argtypes = [ctypes.c_void_p]
        lib.zs_agg_update.restype = ctypes.c_int64
        lib.zs_agg_update.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, u64p, i64p, f64p, u8p, i64p,
            u64p, i64p, i64p, f64p, i64p, u8p,
        ]
        lib.zs_agg_len.restype = ctypes.c_int64
        lib.zs_agg_len.argtypes = [ctypes.c_void_p]
        lib.zs_agg_export.restype = ctypes.c_int64
        lib.zs_agg_export.argtypes = [
            ctypes.c_void_p, u64p, i64p, i64p, f64p, i64p, i64p, i64p, u8p,
        ]
        lib.zs_agg_import.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, u64p, i64p, i64p, f64p, i64p,
            i64p, i64p, u8p,
        ]
        lib.zs_split_lines.restype = ctypes.c_int64
        lib.zs_split_lines.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64, i64p, i64p,
        ]
        lib.zs_split_csv_records.restype = ctypes.c_int64
        lib.zs_split_csv_records.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64, i64p, i64p,
        ]
        lib.zs_split_csv_fields.restype = ctypes.c_int64
        lib.zs_split_csv_fields.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_char, ctypes.c_int64,
            i64p, i64p, i64p,
        ]
        _LIB = lib
    return _LIB


def available() -> bool:
    return _load() is not None


def planes() -> dict:
    """Which host planes loaded in this process: the z-set kernel, the
    data plane, and the g++ seconds each build took here (a library found
    in the cache took none)."""
    from pathway_tpu_torch.engine.native import dataplane

    return {
        "zset": available(),
        "dataplane": dataplane.available(),
        "build_seconds": dict(BUILD_SECONDS),
    }


# ------------------------------------------------------------ typed wrappers


def consolidate_tokens(
    key_lo: np.ndarray, key_hi: np.ndarray, token: np.ndarray, diff: np.ndarray
) -> int:
    """In-place token consolidation; returns the compacted length."""
    lib = _load()
    assert lib is not None
    return lib.zs_consolidate(len(key_lo), key_lo, key_hi, token, diff)


def difference_tokens(a, b):
    """Consolidated z-set difference A ⊖ B over (lo, hi, tok, diff) column
    quads — the iterate scope's feedback subtraction (C ⊖ P) in one C
    pass. Returns (lo, hi, tok, diff) of the non-zero remainder."""
    lib = _load()
    assert lib is not None
    a_lo, a_hi, a_tok, a_diff = (np.ascontiguousarray(x) for x in a)
    b_lo, b_hi, b_tok, b_diff = (np.ascontiguousarray(x) for x in b)
    cap = max(len(a_lo) + len(b_lo), 1)
    out_lo = np.empty(cap, np.uint64)
    out_hi = np.empty(cap, np.uint64)
    out_tok = np.empty(cap, np.uint64)
    out_diff = np.empty(cap, np.int64)
    m = lib.zs_difference(
        len(a_lo), a_lo, a_hi, a_tok, a_diff,
        len(b_lo), b_lo, b_hi, b_tok, b_diff,
        out_lo, out_hi, out_tok, out_diff,
    )
    return out_lo[:m], out_hi[:m], out_tok[:m], out_diff[:m]


class NativeKeyedState:
    """C++ keyed state: 128-bit key -> payload token."""

    def __init__(self) -> None:
        lib = _load()
        assert lib is not None
        self._lib = lib
        self._h = lib.zs_keyed_new()

    def __del__(self) -> None:
        if getattr(self, "_h", None):
            self._lib.zs_keyed_free(self._h)
            self._h = None

    def update(self, key_lo, key_hi, token, diff) -> None:
        self._lib.zs_keyed_update(self._h, len(key_lo), key_lo, key_hi, token, diff)

    def get(self, key_lo, key_hi) -> np.ndarray:
        out = np.empty(len(key_lo), np.uint64)
        self._lib.zs_keyed_get(self._h, len(key_lo), key_lo, key_hi, out)
        return out

    def __len__(self) -> int:
        return self._lib.zs_keyed_len(self._h)

    def items_arrays(self):
        n = len(self)
        lo = np.empty(n, np.uint64)
        hi = np.empty(n, np.uint64)
        tok = np.empty(n, np.uint64)
        self._lib.zs_keyed_items(self._h, lo, hi, tok)
        return lo, hi, tok


class NativeArrangement:
    """C++ arrangement: dkey token -> multiset of payload tokens."""

    def __init__(self) -> None:
        lib = _load()
        assert lib is not None
        self._lib = lib
        self._h = lib.zs_arr_new()

    def __del__(self) -> None:
        if getattr(self, "_h", None):
            self._lib.zs_arr_free(self._h)
            self._h = None

    def update(self, dkey, token, diff) -> None:
        self._lib.zs_arr_update(self._h, len(dkey), dkey, token, diff)

    def get(self, dkey: int):
        n = self._lib.zs_arr_group_size(self._h, dkey)
        if n == 0:
            return np.empty(0, np.uint64), np.empty(0, np.int64)
        tok = np.empty(n, np.uint64)
        cnt = np.empty(n, np.int64)
        m = self._lib.zs_arr_get(self._h, dkey, tok, cnt)
        return tok[:m], cnt[:m]

    def group_count(self, dkey: int) -> int:
        return self._lib.zs_arr_group_count(self._h, dkey)

    def delta_join(self, dkeys: np.ndarray):
        """For each dkeys[i], cross with this arrangement's group.

        Returns (input_idx, token, count) arrays of the flattened matches.
        """
        cap = max(len(dkeys) * 4, 256)
        while True:
            idx = np.empty(cap, np.int64)
            tok = np.empty(cap, np.uint64)
            cnt = np.empty(cap, np.int64)
            m = self._lib.zs_arr_delta_join(self._h, len(dkeys), dkeys, cap, idx, tok, cnt)
            if m >= 0:
                return idx[:m], tok[:m], cnt[:m]
            cap = -m


class NativeGroupAgg:
    """C++ semigroup aggregation: gtoken -> per-reducer (isum, fsum, cnt).

    The engine's native groupby hot path for invertible reducers
    (count/sum/avg). `update` applies a batch and returns the affected
    groups' post-update aggregates; work is O(batch), independent of
    group sizes. Flags per (group, reducer): bit0 = saw float
    contributions, bit1 = has non-numeric rows (ERROR poison).
    """

    KIND_COUNT = 0
    KIND_SUM = 1
    KIND_AVG = 2

    def __init__(self, kinds: list[int]) -> None:
        lib = _load()
        assert lib is not None
        self._lib = lib
        self._n_red = len(kinds)
        self._h = lib.zs_agg_new(
            len(kinds), np.asarray(kinds, np.int64)
        )

    def __del__(self) -> None:
        if getattr(self, "_h", None):
            self._lib.zs_agg_free(self._h)
            self._h = None

    def update(
        self,
        gtoken: np.ndarray,  # [n] uint64
        vals_i: np.ndarray,  # [n_red, n] int64
        vals_f: np.ndarray,  # [n_red, n] float64
        vals_tag: np.ndarray,  # [n_red, n] uint8: 0=int 1=float 2=bad
        diff: np.ndarray,  # [n] int64
    ):
        """Returns (gtokens[m], totals[m], isum[m,R], fsum[m,R], cnt[m,R],
        flags[m,R]) for the affected unique groups."""
        n = len(gtoken)
        r = self._n_red
        out_g = np.empty(n, np.uint64)
        out_total = np.empty(n, np.int64)
        out_i = np.empty(max(n * r, 1), np.int64)
        out_f = np.empty(max(n * r, 1), np.float64)
        out_cnt = np.empty(max(n * r, 1), np.int64)
        out_flags = np.empty(max(n * r, 1), np.uint8)
        m = self._lib.zs_agg_update(
            self._h, n, gtoken,
            np.ascontiguousarray(vals_i.reshape(-1)),
            np.ascontiguousarray(vals_f.reshape(-1)),
            np.ascontiguousarray(vals_tag.reshape(-1)),
            diff,
            out_g, out_total, out_i, out_f, out_cnt, out_flags,
        )
        return (
            out_g[:m],
            out_total[:m],
            out_i[: m * r].reshape(m, r),
            out_f[: m * r].reshape(m, r),
            out_cnt[: m * r].reshape(m, r),
            out_flags[: m * r].reshape(m, r),
        )

    def __len__(self) -> int:
        return self._lib.zs_agg_len(self._h)

    def export_state(self) -> dict:
        """Full picklable state for operator checkpointing."""
        m = len(self)
        r = self._n_red
        g = np.empty(m, np.uint64)
        total = np.empty(m, np.int64)
        isum = np.empty(max(m * r, 1), np.int64)
        fsum = np.empty(max(m * r, 1), np.float64)
        cnt = np.empty(max(m * r, 1), np.int64)
        fseen = np.empty(max(m * r, 1), np.int64)
        err = np.empty(max(m * r, 1), np.int64)
        ovf = np.empty(max(m * r, 1), np.uint8)
        n = self._lib.zs_agg_export(self._h, g, total, isum, fsum, cnt, fseen, err, ovf)
        assert n == m
        return {
            "g": g, "total": total, "isum": isum[: m * r],
            "fsum": fsum[: m * r], "cnt": cnt[: m * r],
            "fseen": fseen[: m * r], "err": err[: m * r], "ovf": ovf[: m * r],
        }

    def import_state(self, st: dict) -> None:
        m = len(st["g"])
        r = self._n_red
        for name in ("isum", "fsum", "cnt", "fseen", "err", "ovf"):
            if len(st[name]) != m * r:
                raise ValueError(
                    f"agg snapshot {name} has {len(st[name])} slots, "
                    f"expected {m}x{r} — reducer set changed since checkpoint"
                )
        if len(st["total"]) != m:
            raise ValueError("agg snapshot total/group length mismatch")
        self._lib.zs_agg_import(
            self._h, m,
            np.ascontiguousarray(st["g"], np.uint64),
            np.ascontiguousarray(st["total"], np.int64),
            np.ascontiguousarray(st["isum"], np.int64),
            np.ascontiguousarray(st["fsum"], np.float64),
            np.ascontiguousarray(st["cnt"], np.int64),
            np.ascontiguousarray(st["fseen"], np.int64),
            np.ascontiguousarray(st["err"], np.int64),
            np.ascontiguousarray(st["ovf"], np.uint8),
        )


def split_lines(data: bytes):
    """Returns (start, end) offset arrays of lines in `data`."""
    lib = _load()
    assert lib is not None
    cap = max(data.count(b"\n") + 2, 16)
    start = np.empty(cap, np.int64)
    end = np.empty(cap, np.int64)
    n = lib.zs_split_lines(data, len(data), cap, start, end)
    if n < 0:  # shouldn't happen given the count-based cap
        cap = -n
        start = np.empty(cap, np.int64)
        end = np.empty(cap, np.int64)
        n = lib.zs_split_lines(data, len(data), cap, start, end)
    return start[:n], end[:n]


def split_csv_records(data: bytes):
    """(start, end) offsets of CSV records — newlines inside quoted fields
    do not split."""
    lib = _load()
    assert lib is not None
    cap = max(data.count(b"\n") + 2, 16)
    start = np.empty(cap, np.int64)
    end = np.empty(cap, np.int64)
    n = lib.zs_split_csv_records(data, len(data), cap, start, end)
    if n < 0:
        cap = -n
        start = np.empty(cap, np.int64)
        end = np.empty(cap, np.int64)
        n = lib.zs_split_csv_records(data, len(data), cap, start, end)
    return start[:n], end[:n]


def split_csv_line(line: bytes, delim: bytes = b","):
    """Returns list of decoded CSV fields of one line (RFC-4180 quoting)."""
    lib = _load()
    assert lib is not None
    cap = line.count(delim) + 2
    start = np.empty(cap, np.int64)
    end = np.empty(cap, np.int64)
    quoted = np.empty(cap, np.int64)
    n = lib.zs_split_csv_fields(line, len(line), delim, cap, start, end, quoted)
    if n < 0:
        cap = -n
        start = np.empty(cap, np.int64)
        end = np.empty(cap, np.int64)
        quoted = np.empty(cap, np.int64)
        n = lib.zs_split_csv_fields(line, len(line), delim, cap, start, end, quoted)
    fields = []
    for i in range(n):
        raw = line[start[i]:end[i]]
        if quoted[i]:
            raw = _decode_quoted_field(raw.strip())
        fields.append(raw.decode("utf-8", errors="replace"))
    return fields


def _decode_quoted_field(raw: bytes) -> bytes:
    """RFC-4180 quoted field with csv-module junk semantics: '\"a\"x' ->
    'ax' (text after the closing quote concatenates, quotes dropped)."""
    if not raw.startswith(b'"'):
        return raw.replace(b'""', b'"')
    parts = []
    pos = 1
    while True:
        q = raw.find(b'"', pos)
        if q == -1:  # unterminated quote: take the rest verbatim
            parts.append(raw[pos:])
            pos = len(raw)
            break
        if raw[q + 1 : q + 2] == b'"':  # doubled quote -> literal quote
            parts.append(raw[pos : q + 1])
            pos = q + 2
        else:  # closing quote
            parts.append(raw[pos:q])
            pos = q + 1
            break
    return b"".join(parts) + raw[pos:]
