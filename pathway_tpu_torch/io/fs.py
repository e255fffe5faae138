"""Filesystem connector: csv / json(lines) / plaintext / binary read+write.

Reference: io/fs (read/write over the Rust posix-like reader,
src/connectors/scanner/filesystem.rs + data_format.rs parsers). Static mode
reads the current contents once; streaming mode keeps polling the path for
new/updated files, the reference's directory-watch behavior.
"""

from __future__ import annotations

import csv as _csv
import glob as _glob
import logging
import json as _json
import os
import threading
import time as _time
from typing import Any, Callable, Iterable

from pathway_tpu_torch.engine.runtime import InputSession, ThreadConnector
from pathway_tpu_torch.internals import dtype as dt
from pathway_tpu_torch.internals import schema as sch
from pathway_tpu_torch.internals import universe as univ
from pathway_tpu_torch.internals.datasink import CallbackDataSink
from pathway_tpu_torch.internals.json import Json
from pathway_tpu_torch.internals.keys import (
    Key,
    cheap_sequential_key_at,
    key_for_values,
    reserve_sequential,
    sequential_key,
    sequential_key_at,
)
from pathway_tpu_torch.internals.parse_graph import G
from pathway_tpu_torch.internals.table import OpSpec, Table
from pathway_tpu_torch.io._retry import log_degradation as _log_degradation

logger = logging.getLogger("pathway_tpu_torch.io.fs")


# -------------------------------------------------- native (token) ingest
#
# When the schema is representable in the native data plane, files parse in
# C++ (engine/native/dataplane.cpp): rows intern to tokens, keys hash in
# C, and the engine receives NativeBatch segments instead of per-row Python
# tuples. Lines the C parser rejects (nested JSON values, bigints, …) fall
# back to the Python parser row by row — both kinds share one key sequence.
# Reference: the Rust reader + parser chain, src/connectors/scanner/
# filesystem.rs + data_format.rs, which likewise never surfaces per-row
# objects to the host language.


def _native_info(format: str, schema, csv_settings, with_metadata: bool):  # noqa: A002
    if with_metadata or format not in ("json", "jsonlines", "csv"):
        return None
    try:
        from pathway_tpu_torch.engine.native import dataplane as dp
    except Exception:  # noqa: BLE001
        return None
    if not dp.available():
        return None
    names = list(schema.__columns__)
    pk = schema.primary_key_columns() or []
    info: dict[str, Any] = {
        "dp": dp,
        "names": names,
        "pk_idx": [names.index(c) for c in pk],
        "pk": pk,
        "schema": schema,
        # scan-tuning channel (internals/planner.py): the plan optimizer
        # mutates this dict at lowering time — key_mode 1 = cheap
        # sequential keys (id elision), filters = numpy cond plans pushed
        # below the graph into the parse (advisory row reduction: rows a
        # plan can't judge stay in, the real FilterNode above decides)
        "tuning": {"key_mode": 0, "filters": []},
        # chunk-size override read HERE, at connector construction —
        # never per parse call (tests force multi-chunk files to
        # exercise mid-file frontier positions; the env-read-per-chunk
        # was the PR 9(h) hot-path bug class)
        "chunk": int(os.environ.get("PATHWAY_FS_CHUNK", 4 << 20)),
    }
    # morsel-parallel decode (engine/morsel.py), likewise decided at
    # construction. Concurrent decode into one intern table additionally
    # requires the kernel's reentrancy contract (dp_abi_flags bit 0) —
    # a stale library without it degrades to the serial chunk path.
    from pathway_tpu_torch.engine import morsel as _msl

    info["morsel"] = _msl.enabled() and dp.ingest_reentrant()
    info["morsel_rows"] = _msl.morsel_rows()
    if format in ("json", "jsonlines"):
        info["kind"] = "json"
        # declared dtype tags for lossless literal coercion in C
        jt = []
        for n in names:
            base = dt.unoptionalize(schema.__columns__[n].dtype)
            jt.append(2 if base == dt.INT else 3 if base == dt.FLOAT else 0)
        info["json_tags"] = jt
        return info
    # csv needs a native _coerce plan for every column
    tags, opts = [], []
    for n in names:
        d = schema.__columns__[n].dtype
        base = dt.unoptionalize(d)
        tag = {dt.INT: 2, dt.FLOAT: 3, dt.BOOL: 1, dt.STR: 4}.get(base)
        if tag is None and base == getattr(dt, "ANY", None):
            tag = 4  # _coerce leaves unknown dtypes as the raw string
        if tag is None:
            return None
        tags.append(tag)
        opts.append(isinstance(d, dt.Optional))
    delim = getattr(csv_settings, "delimiter", ",") if csv_settings else ","
    if len(delim) != 1:
        return None
    info.update(kind="csv", dtypes=tags, optional=opts, delim=delim.encode())
    return info


def _py_fallback_row(info: dict, line: bytes):
    """Python parse of one line the C parser rejected; returns a row tuple
    or None (unparseable -> logged upstream semantics: skip)."""
    names = info["names"]
    schema = info["schema"]
    if info["kind"] == "json":  # (fallback-line reparse, not resume)
        try:
            rec = _json.loads(line.decode("utf-8", errors="replace"))
        except (ValueError, UnicodeDecodeError) as e:
            from pathway_tpu_torch.internals.errors import global_error_log

            global_error_log().log(f"fs.read json parse error: {e}")
            return None
        if not isinstance(rec, dict):
            from pathway_tpu_torch.internals.errors import global_error_log

            global_error_log().log(
                "fs.read: json line is not an object; row skipped"
            )
            return None
        row = []
        for n in names:
            v = rec.get(n)
            if isinstance(v, (dict, list)):
                v = Json(v)
            else:
                v = _json_coerce(v, schema.__columns__[n].dtype)
            row.append(v)
        return tuple(row)
    # csv
    from pathway_tpu_torch.engine import native as zs

    fields = zs.split_csv_line(line, info["delim"])
    field_idx = info["field_idx"]
    row = []
    for j, n in enumerate(names):
        fi = field_idx[j]
        v = fields[fi] if 0 <= fi < len(fields) else None
        row.append(_coerce(v, schema.__columns__[n].dtype) if v is not None else None)
    return tuple(row)


def _read_csv_header(f, info: dict) -> int:
    """Read + apply the header record from the current position; returns
    the byte offset just past it. (Quoted newlines in headers are not
    supported by the chunked reader.)"""
    from pathway_tpu_torch.engine import native as zs

    hdr = f.readline()
    end = f.tell()
    cols = zs.split_csv_line(hdr.rstrip(b"\r\n"), info["delim"])
    col_pos = {h: i for i, h in enumerate(cols)}
    info["field_idx"] = [col_pos.get(n, -1) for n in info["names"]]
    return end


def _chunk_bodies(path: str, info: dict, start_pos: int = 0):
    """Yield (body, end_abs_pos) record-aligned chunks of one file
    (serial IO + boundary alignment; the CPU-heavy parse runs elsewhere).
    Consumes the CSV header (always from byte 0 — the field mapping) and
    fills info['field_idx'] as a side effect. `start_pos` (a previously
    reported record-aligned frontier position) seeks past consumed data."""
    is_csv = info["kind"] == "csv"
    # chunk size decided at connector construction (see the info dict
    # builder) — this per-file loop must not read the environment
    CHUNK = info.get("chunk") or 4 << 20
    with open(path, "rb") as f:
        abs_pos = 0
        if is_csv:
            abs_pos = _read_csv_header(f, info)
        if start_pos > abs_pos:
            f.seek(start_pos)
            abs_pos = start_pos
        pending = b""
        while True:
            chunk = f.read(CHUNK)
            eof = not chunk
            data = pending + chunk
            pending = b""
            if not data:
                return
            if not eof:
                if is_csv:
                    from pathway_tpu_torch.engine import native as zs

                    starts, _ends = zs.split_csv_records(data)
                    if len(starts) <= 1:
                        pending = data
                        continue
                    cut = int(starts[-1])
                else:
                    cut = data.rfind(b"\n") + 1
                    if cut == 0:
                        pending = data
                        continue
                body, pending = data[:cut], data[cut:]
            else:
                body = data
            if body:
                abs_pos += len(body)
                yield body, abs_pos
            if eof:
                return


def _scan_filter_batch(dp, tab, batch, plans):
    """Pushed-down scan filters: advisory row reduction at the parse.
    Rows a plan flags BAD (or whole batches the decode can't judge) are
    KEPT — the FilterNode/FusedRowwiseNode above re-applies the exact
    per-row semantics, so pushing filters never changes results or
    error-log behavior, it only stops provably-dropped rows from ever
    entering the dataflow."""
    for plan in plans:
        cols = sorted(plan.needed_cols)
        if not cols:
            continue
        dec = dp.decode_num_cols(tab, batch.token, cols)
        if dec is None:
            return batch
        vi, vf, tg = dec
        decoded = {c: (vi[j], vf[j], tg[j]) for j, c in enumerate(cols)}
        keep, bad = plan.eval_mask(decoded, len(batch))
        mask = keep | bad
        if not mask.all():
            batch = batch.select(mask)
        if not len(batch):
            return batch
    return batch


def _parse_body(info: dict, tab, body: bytes, seq_start: int):
    """CPU part of one chunk (GIL-released C call). Returns
    (NativeBatch|None, fallback entries). A chunk containing ANY Python-
    fallback line is emitted entirely as entries, in file order — the
    event order a resuming run re-derives must not depend on whether the
    native parser was available (persistence count-skip resume)."""
    import numpy as np

    dp = info["dp"]
    pk_idx = info["pk_idx"]
    tuning = info.get("tuning") or {}
    key_mode = int(tuning.get("key_mode", 0))
    if info["kind"] == "csv":
        (lo, hi, tok), status, (ls, le) = dp.ingest_csv(
            tab, body, info["field_idx"], info["dtypes"],
            info["optional"], pk_idx, 0, seq_start, info["delim"],
            key_mode=key_mode,
        )
    else:
        (lo, hi, tok), status, (ls, le) = dp.ingest_jsonl(
            tab, body, info["names"], pk_idx, 0, seq_start,
            info.get("json_tags"), key_mode=key_mode,
        )
    ok = status == 0
    if not (status == 1).any():
        batch = None
        if ok.any():
            batch = dp.NativeBatch(
                tab,
                np.ascontiguousarray(lo[ok]),
                np.ascontiguousarray(hi[ok]),
                np.ascontiguousarray(tok[ok]),
                np.ones(int(ok.sum()), np.int64),
                # sequential keys are globally unique; pk keys can repeat
                distinct_hint=not pk_idx,
            )
            if tuning.get("filters"):
                batch = _scan_filter_batch(dp, tab, batch, tuning["filters"])
                if not len(batch):
                    batch = None
        return batch, []
    entries = []
    for i in range(len(status)):
        if status[i] == 2:
            continue  # blank line
        if status[i] == 0:
            key = Key((int(hi[i]) << 64) | int(lo[i]))
            entries.append((key, tab.row(int(tok[i]))))
            continue
        row = _py_fallback_row(info, body[ls[i] : le[i]])
        if row is None:
            continue
        if pk_idx:
            key = key_for_values(*[row[j] for j in pk_idx])
        elif key_mode == 1:
            # the cheap-key mirror of the C parser's id-elided keys
            key = cheap_sequential_key_at(seq_start + int(i))
        else:
            key = sequential_key_at(seq_start + int(i))
        entries.append((key, row))
    return None, entries


def _file_metadata(path: str, st) -> dict:
    """Per-file metadata record (reference: src/connectors/metadata/
    file_like.rs FileLikeMetadata — created_at, modified_at, owner, path,
    size, seen_at)."""
    owner = None
    try:
        import pwd

        owner = pwd.getpwuid(st.st_uid).pw_name
    except (ImportError, KeyError):
        pass  # no pwd module / unmapped uid: owner stays None by design
    except OSError as e:
        _log_degradation(logger, "fs.metadata.owner", e, logging.DEBUG)
    return {
        "path": path,
        "size": st.st_size,
        "modified_at": int(st.st_mtime),
        "created_at": int(st.st_ctime),
        "seen_at": int(_time.time()),
        "owner": owner,
    }


def _file_head_sig(path: str, size: int) -> list:
    """Identity of a file's head: [n, blake2b(first n bytes)] with
    n = min(4096, size at record time). Frontier positions are only valid
    against the file they came from (log rotation / replacement must
    trigger a full re-read, not a seek into unrelated content); hashing a
    RECORDED length keeps the signature stable when a small file grows."""
    import hashlib as _hl

    n = min(4096, size)
    try:
        with open(path, "rb") as f:
            return [n, _hl.blake2b(f.read(n), digest_size=8).hexdigest()]
    except OSError:
        return [0, ""]


def _head_sig_matches(path: str, st, ent_sig) -> bool:
    try:
        n, want = int(ent_sig[0]), ent_sig[1]
    except (TypeError, ValueError, IndexError):
        return False
    if st.st_size < n:
        return False
    return _file_head_sig(path, n) == [n, want]


def _py_resume_rows(
    path: str, format: str, schema, csv_settings, start_pos: int, pk  # noqa: A002
):
    """Object-plane resume from a record-aligned byte frontier (used when
    a 'pos' frontier exists but the native parser is unavailable —
    e.g. resuming on a host without a C++ toolchain). Yields (key, row)."""
    names = list(schema.__columns__)
    pk = pk or []
    delim = getattr(csv_settings, "delimiter", ",") if csv_settings else ","
    with open(path, "rb") as f:
        header = b""
        if format == "csv":
            header = f.readline()
        if start_pos > f.tell():
            f.seek(start_pos)
        rest = f.read()
    if format == "csv":
        import io as _io

        reader = _csv.DictReader(
            _io.StringIO((header + rest).decode("utf-8", errors="replace")),
            delimiter=delim,
        )
        for rec in reader:
            row = tuple(
                _coerce(rec.get(n), schema.__columns__[n].dtype)
                if rec.get(n) is not None
                else None
                for n in names
            )
            key = (
                key_for_values(*[row[names.index(c)] for c in pk])
                if pk
                else sequential_key()
            )
            yield key, row
        return
    for line in rest.split(b"\n"):
        line = line.strip()
        if not line:
            continue
        try:
            rec = _json.loads(line.decode("utf-8", errors="replace"))
        except ValueError as e:
            from pathway_tpu_torch.internals.errors import global_error_log

            global_error_log().log(f"fs.read json parse error in {path}: {e}")
            continue
        row = tuple(
            Json(v)
            if isinstance(v := rec.get(n), (dict, list))
            else _json_coerce(v, schema.__columns__[n].dtype)
            for n in names
        )
        # key from the COERCED values — must match the normal path's keys
        # or resume splits one logical row across two identities
        key = (
            key_for_values(*[row[names.index(c)] for c in pk])
            if pk
            else sequential_key()
        )
        yield key, row


def _morsel_bodies(info: dict, body: bytes, start_abs: int, m_rows: int):
    """Record-aligned morsel slices of one chunk body: ≤ m_rows records
    each, yielded in file order as (sub_body, abs_end_pos). Concatenated
    in order the slices reproduce the body byte-for-byte, and every
    slice boundary is a valid resume frontier."""
    if info["kind"] == "csv":
        from pathway_tpu_torch.engine import native as zs

        starts, _ends = zs.split_csv_records(body)
        if len(starts) <= m_rows:
            yield body, start_abs + len(body)
            return
        cuts = [int(starts[k]) for k in range(m_rows, len(starts), m_rows)]
    else:
        import numpy as np

        nl = np.flatnonzero(np.frombuffer(body, np.uint8) == 10)
        if len(nl) + 1 <= m_rows:  # +1: a possible final unterminated line
            yield body, start_abs + len(body)
            return
        cuts = [int(nl[k]) + 1 for k in range(m_rows - 1, len(nl), m_rows)]
    prev = 0
    for cut in cuts:
        if cut <= prev:
            continue
        yield body[prev:cut], start_abs + cut
        prev = cut
    if prev < len(body):
        yield body[prev:], start_abs + len(body)


def _native_parse_file(
    path: str, info: dict, tab, emit_batch, emit_entry,
    start_pos: int = 0, on_progress: Callable[[int], None] | None = None,
):
    """Chunked native parse of one file: complete records go through the C
    parser as NativeBatch segments; rejected lines re-parse in Python.
    With morsels on (info['morsel'], decided at connector construction)
    each chunk splits into record-aligned ~info['morsel_rows'] slices
    first; either way the units parse CONCURRENTLY on the worker pool
    (the C parser releases the GIL and interns each unit's rows as one
    batch — dp_abi_flags bit 0), a window at a time, emitted in file
    order. The window is the per-source double-buffered prefetch ring:
    ~2 morsels per worker stay in flight, so file IO and decode overlap
    the previous wave's compute instead of serializing behind it.
    emit_batch(NativeBatch); emit_entry((key, row)); on_progress(abs_pos)
    fires after each unit's rows are emitted (record-aligned byte
    frontier for persistence). Key ranges are reserved at submit, in
    file order, so sequence keys never depend on pool scheduling —
    PATHWAY_MORSEL=0 reproduces the serial chunk path byte-identically."""
    from pathway_tpu_torch.engine.workers import _pool, worker_threads

    pk_idx = info["pk_idx"]

    threads = worker_threads()
    morsel_on = bool(info.get("morsel"))
    m_rows = int(info.get("morsel_rows") or 0) or 65536
    window = max(2, threads)
    if morsel_on:
        window = max(window, 2 * threads)
    pool = (
        _pool()
        if (threads > 2 or (morsel_on and threads > 1))
        else None
    )
    inflight: list = []

    def flush_one() -> None:
        job, end_pos = inflight.pop(0)
        batch, entries = job.result() if pool else job
        if batch is not None:
            emit_batch(batch)
        for e in entries:
            emit_entry(e)
        if on_progress is not None:
            on_progress(end_pos)

    def submit(body: bytes, end_pos: int) -> None:
        # reserve the key range HERE so sequence ranges follow file order
        # regardless of pool scheduling
        n_cap = body.count(b"\n") + (0 if body.endswith(b"\n") else 1)
        seq_start = reserve_sequential(max(n_cap, 1)) if not pk_idx else 0
        if pool is not None:
            inflight.append(
                (pool.submit(_parse_body, info, tab, body, seq_start), end_pos)
            )
        else:
            inflight.append((_parse_body(info, tab, body, seq_start), end_pos))
        if len(inflight) >= window:
            flush_one()

    for body, end_pos in _chunk_bodies(path, info, start_pos):
        if morsel_on:
            for sub, sub_end in _morsel_bodies(
                info, body, end_pos - len(body), m_rows
            ):
                submit(sub, sub_end)
        else:
            submit(body, end_pos)
    while inflight:
        flush_one()


def _list_files(path: str) -> list[str]:
    if os.path.isdir(path):
        out = []
        for root, _dirs, files in os.walk(path):
            for f in sorted(files):
                out.append(os.path.join(root, f))
        return sorted(out)
    if any(c in path for c in "*?["):
        return sorted(_glob.glob(path))
    if os.path.exists(path):
        return [path]
    return []


def _json_coerce(v: Any, dtype: dt.DType) -> Any:
    """Lossless literal-to-schema coercion for JSON values: 1.0 in an int
    column becomes int 1; 3 in a float column becomes 3.0. Keeps token
    identity stable across literal spellings — byte-identical rule to the
    native parser (dataplane.cpp json_value_piece)."""
    base = dt.unoptionalize(dtype)
    if base == dt.INT and type(v) is float and v.is_integer() and abs(v) <= float(1 << 53):
        return int(v)
    if base == dt.FLOAT and type(v) is int and abs(v) <= 1 << 53:
        return float(v)
    return v


def _coerce(value: str, dtype: dt.DType) -> Any:
    base = dt.unoptionalize(dtype)
    if value == "" and isinstance(dtype, dt.Optional):
        return None
    try:
        if base == dt.INT:
            return int(value)
        if base == dt.FLOAT:
            return float(value)
        if base == dt.BOOL:
            return value.strip().lower() in ("true", "1", "yes", "on")
        if base == dt.JSON:
            return Json(_json.loads(value))
    except (ValueError, TypeError):
        return None if isinstance(dtype, dt.Optional) else value
    return value


def _parse_file(
    path: str, format: str, schema: sch.SchemaMetaclass, csv_settings: Any = None,
    with_metadata: bool = False,
) -> Iterable[dict[str, Any]]:
    names = list(schema.__columns__)
    meta = None
    if with_metadata:
        st = os.stat(path)
        meta = Json(_file_metadata(path, st))
    if format in ("plaintext", "plaintext_by_file"):
        if format == "plaintext_by_file":
            with open(path, "r", errors="replace") as f:
                row = {"data": f.read()}
                if with_metadata:
                    row["_metadata"] = meta
                yield row
            return
        with open(path, "r", errors="replace") as f:
            for line in f:
                line = line.rstrip("\n")
                if line or True:
                    row = {"data": line}
                    if with_metadata:
                        row["_metadata"] = meta
                    yield row
        return
    if format == "binary":
        with open(path, "rb") as f:
            row = {"data": f.read()}
            if with_metadata:
                row["_metadata"] = meta
            yield row
        return
    if format == "csv":
        delim = ","
        if csv_settings is not None:
            delim = getattr(csv_settings, "delimiter", ",")
        from pathway_tpu_torch.engine import native

        if native.available():
            # native path: chunked reads, C++ record + RFC-4180 field
            # split (reference keeps tokenization native too:
            # data_tokenize.rs) — large files never load whole
            dbytes = delim.encode()
            col_idx: dict[str, int] | None = None
            CHUNK = 1 << 22  # 4 MiB

            with open(path, "rb") as fb:
                pending = b""
                eof = False
                while not eof:
                    chunk = fb.read(CHUNK)
                    eof = not chunk
                    data = pending + chunk
                    if not data:
                        break
                    starts, ends = native.split_csv_records(data)
                    if len(starts) == 0:
                        pending = b""
                        continue
                    if not eof:
                        # the final record may continue into the next
                        # chunk — hold it back
                        limit = len(starts) - 1
                        pending = data[starts[-1]:]
                        if limit == 0:
                            continue
                    else:
                        limit = len(starts)
                        pending = b""
                    for li in range(limit):
                        line = data[starts[li]:ends[li]]
                        if not line:
                            continue
                        fields = native.split_csv_line(line, dbytes)
                        if col_idx is None:  # header record
                            col_idx = {h: i for i, h in enumerate(fields)}
                            continue
                        row = {}
                        for n in names:
                            if n == "_metadata":
                                continue
                            i = col_idx.get(n)
                            v = (
                                fields[i]
                                if i is not None and i < len(fields)
                                else None
                            )
                            row[n] = (
                                _coerce(v, schema.__columns__[n].dtype)
                                if v is not None
                                else None
                            )
                        if with_metadata:
                            row["_metadata"] = meta
                        yield row
            return
        with open(path, "r", newline="", errors="replace") as f:
            reader = _csv.DictReader(f, delimiter=delim)
            for rec in reader:
                row = {}
                for n in names:
                    if n == "_metadata":
                        continue
                    v = rec.get(n)
                    row[n] = _coerce(v, schema.__columns__[n].dtype) if v is not None else None
                if with_metadata:
                    row["_metadata"] = meta
                yield row
        return
    if format in ("json", "jsonlines"):
        with open(path, "r", errors="replace") as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = _json.loads(line)
                except ValueError as e:
                    from pathway_tpu_torch.internals.errors import global_error_log

                    global_error_log().log(
                        f"fs.read json parse error in {path}: {e}"
                    )
                    continue
                row = {}
                for n in names:
                    if n == "_metadata":
                        continue
                    v = rec.get(n)
                    if isinstance(v, (dict, list)):
                        v = Json(v)
                    else:
                        v = _json_coerce(v, schema.__columns__[n].dtype)
                    row[n] = v
                if with_metadata:
                    row["_metadata"] = meta
                yield row
        return
    raise ValueError(f"unknown format {format!r}")


def read(
    path: str | os.PathLike,
    *,
    format: str = "csv",  # noqa: A002
    schema: Any = None,
    mode: str = "streaming",
    csv_settings: Any = None,
    autocommit_duration_ms: int | None = 1500,
    with_metadata: bool = False,
    name: str | None = None,
    **kwargs: Any,
) -> Table:
    path = os.fspath(path)
    if schema is None:
        if format in ("plaintext", "plaintext_by_file"):
            schema = sch.schema_from_types(data=str)
        elif format == "binary":
            schema = sch.schema_from_types(data=bytes)
        else:
            raise ValueError(f"schema required for format {format!r}")
    if with_metadata and "_metadata" not in schema.__columns__:
        cols = dict(schema.__columns__)
        cols["_metadata"] = sch.ColumnSchema(name="_metadata", dtype=dt.JSON)
        schema = sch.schema_from_columns(cols)
    names = list(schema.__columns__)
    pk = schema.primary_key_columns()

    native_info = _native_info(format, schema, csv_settings, with_metadata)

    if mode == "static":
        # static ingest happens HERE, at graph-build time — record its
        # wall clock so the pipeline profiler's ingest stage covers it
        # (observability.pretime; the run itself only sees ready rows)
        from pathway_tpu_torch.internals import observability as _obs

        _ingest_t0 = _time.perf_counter()
        # pk sources keep the object plane: duplicate-pk rows rely on the
        # keyed RowwiseNode's last-write-wins, which the stateless native
        # map path deliberately doesn't reproduce
        if native_info is not None and not pk:
            from pathway_tpu_torch.engine.native import dataplane as dp

            # LAZY static scan: the parse runs at lowering time, after
            # the plan optimizer has decided this scan's tuning (cheap
            # keys, pushed filters) — and only on the process that owns
            # the rows. Cached per tuning state so a second pw.run over
            # the same parse graph doesn't re-read the files.
            tuning = native_info["tuning"]
            cache: dict[tuple, tuple] = {}

            def parse():
                # plan objects key the cache by IDENTITY (and are kept
                # alive by it): two sessions pushing different filters
                # must never share a parse, while the common no-tuning
                # rerun still hits
                sig = (
                    tuning.get("key_mode", 0),
                    tuple(tuning.get("filters", ())),
                )
                hit = cache.get(sig)
                if hit is not None:
                    return hit
                t0 = _time.perf_counter()
                tab = dp.default_table()
                batches: list = []
                data: list = []
                for f in _list_files(path):
                    _native_parse_file(
                        f, native_info, tab,
                        batches.append,
                        lambda kr: data.append((kr[0], kr[1], 1)),
                    )
                _obs.pretime("ingest", _time.perf_counter() - t0)
                cache[sig] = (batches, data)
                return cache[sig]

            if kwargs.get("_eager_static"):
                # parse NOW with default tuning and pin it (benchmarks
                # that clock the engine after ingest; the optimizer must
                # not re-tune an already-materialized scan — a tuning
                # change would force a second parse)
                tuning["pinned"] = True
                parse()
            spec = OpSpec(
                "static_native", [], parse=parse,
                scan_tuning=tuning, name=os.fspath(path),
            )
            return Table(spec, schema, univ.Universe())
        rows = []
        for f in _list_files(path):
            for rec in _parse_file(f, format, schema, csv_settings, with_metadata):
                rows.append(tuple(rec.get(n) for n in names))
        keys = None
        if pk:
            keys = [key_for_values(*[r[names.index(c)] for c in pk]) for r in rows]
        table = Table.from_rows(schema, rows, keys=keys)
        _obs.pretime("ingest", _time.perf_counter() - _ingest_t0)
        return table

    # streaming: poll for new files forever (reference directory watcher).
    # _single_pass (kwargs, internal/bench): deliver current files once and
    # finish — a finite stream with streaming-mode chunking/commit waves.
    single_pass = bool(kwargs.get("_single_pass"))

    def factory(session: InputSession) -> ThreadConnector:
        def run_fn(sess: InputSession) -> None:
            # persistence offset frontier (reference: OffsetAntichain,
            # src/persistence/frontier.rs): ['done', mtime, size] marks a
            # fully-consumed file; ['pos', p] a record-aligned byte
            # position inside one — the source SEEKS on resume instead of
            # the journal count-skipping replayed events
            resume = dict(sess.resume_frontier or {})
            # in-run per-file progress, the same record shape: lets a
            # grown file continue from its consumed end mid-run, and a
            # MODIFIED or DELETED file replace/remove its rows — retract
            # everything previously delivered, then re-read (reference:
            # src/connectors/metadata/ file change tracking, posix
            # scanner delete+insert on modified files)
            progress: dict[str, list] = {}
            # what to retract on replacement: native batches keep only
            # array refs (rows stay interned in the process-wide table);
            # object-plane rows keep (key, row) copies — the price of
            # replacement semantics on the object plane, dropped when the
            # file is deleted
            delivered: dict[str, list] = {}
            # token-resident chunked reads need plain insert sessions
            # (upsert bookkeeping is per-row)
            use_native = native_info is not None and not sess.upsert_mode
            if use_native:
                from pathway_tpu_torch.engine.native import dataplane as dp

                tab = dp.default_table()

            def retract(f: str) -> None:
                for chunk in delivered.pop(f, []):
                    if chunk[0] == "nb":
                        import numpy as _np

                        _lo, _hi, _tok = chunk[1], chunk[2], chunk[3]
                        sess.insert_batch(
                            dp.NativeBatch(
                                tab, _lo, _hi, _tok,
                                _np.full(len(_tok), -1, _np.int64),
                            )
                        )
                    else:
                        sess.remove(chunk[1], chunk[2])

            while True:
                listed = set()
                for f in _list_files(path):
                    listed.add(f)
                    try:
                        st = os.stat(f)
                        mtime = st.st_mtime
                    except OSError:
                        continue
                    ent = resume.pop(f, None)
                    if ent is None:
                        ent = progress.get(f)
                        if (
                            ent is not None
                            and ent[0] == "done"
                            and ent[1] == mtime
                            and ent[2] == st.st_size
                        ):
                            continue  # unchanged since last delivery
                    sig = _file_head_sig(f, st.st_size)
                    start_pos = 0
                    replaced = False
                    if ent is not None:
                        # frontier entries carry a head signature: a
                        # rotated/replaced file must never resume at a
                        # byte offset of unrelated content — mismatch
                        # falls back to a full re-read (in-run: with the
                        # old rows retracted first; across restarts the
                        # journal/state already holds them)
                        sig_ok = _head_sig_matches(f, st, ent[-1])
                        if ent[0] == "done" and sig_ok:
                            if ent[1] == mtime and ent[2] == st.st_size:
                                progress[f] = ent
                                continue
                            if st.st_size > ent[2]:
                                # appended tail: resume at the consumed
                                # end instead of re-reading everything
                                start_pos = int(ent[2])
                        elif ent[0] == "pos" and sig_ok and st.st_size >= int(ent[1]):
                            start_pos = int(ent[1])
                        if start_pos == 0:
                            replaced = True
                    if replaced and not sess.upsert_mode:
                        retract(f)  # file content changed: replace rows
                    # last consumed position: exact even when the file
                    # grows during the read (the 'done' stat is taken
                    # BEFORE parsing, so growth re-delivers, never loses)
                    last_pos = st.st_size
                    # upsert sessions replace by key; retention would be
                    # dead memory (retract() is never called for them)
                    record = (
                        delivered.setdefault(f, [])
                        if not sess.upsert_mode
                        else []
                    )
                    if use_native:
                        def prog(pos: int, _f=f, _sig=sig) -> None:
                            nonlocal last_pos
                            last_pos = pos
                            sess.mark_frontier({_f: ["pos", pos, _sig]})

                        def ins_batch(nb, _rec=record) -> None:
                            _rec.append(("nb", nb.key_lo, nb.key_hi, nb.token))
                            sess.insert_batch(nb)

                        def ins_row(kr, _rec=record) -> None:
                            _rec.append(("row", kr[0], kr[1]))
                            sess.insert(kr[0], kr[1])

                        _native_parse_file(
                            f, native_info, tab,
                            ins_batch,
                            ins_row,
                            start_pos=start_pos,
                            on_progress=prog,
                        )
                    elif start_pos:
                        for key, row in _py_resume_rows(
                            f, format, schema, csv_settings, start_pos, pk
                        ):
                            if not sess.upsert_mode:
                                record.append(("row", key, row))
                            sess.insert(key, row)
                    else:
                        for rec in _parse_file(f, format, schema, csv_settings, with_metadata):
                            row = tuple(rec.get(n) for n in names)
                            key = (
                                key_for_values(*[rec.get(c) for c in pk])
                                if pk
                                else sequential_key()
                            )
                            if not sess.upsert_mode:
                                record.append(("row", key, row))
                            sess.insert(key, row)
                    done = ["done", mtime, last_pos, sig]
                    progress[f] = done
                    sess.mark_frontier({f: done})
                # deleted files: retract their rows and free the tracking
                # (reference: the scanner's file-removal deletions)
                for gone in [f for f in progress if f not in listed]:
                    progress.pop(gone, None)
                    if not sess.upsert_mode:
                        retract(gone)
                    else:
                        delivered.pop(gone, None)
                if single_pass:
                    return
                _time.sleep((autocommit_duration_ms or 1500) / 1000.0)

        conn = ThreadConnector(name or f"fs:{path}", session, run_fn)
        # offset-frontier resume: seek instead of journal count-skip
        conn.replay_style = "offset"
        return conn

    spec = OpSpec(
        "connector", [], factory=factory, upsert=pk is not None, name=name,
        native_plane=native_info is not None and not pk,
        scan_tuning=(
            native_info["tuning"] if native_info is not None and not pk
            else None
        ),
    )
    return Table(spec, schema, univ.Universe())


class _FileWriter:
    """File sink with two durability modes.

    * **direct** (default): rows append to the open file per wave —
      fast, but a crash can leave a torn trailing line and a resumed
      run re-delivers uncheckpointed waves (at-least-once).
    * **atomic** (``enable_atomic``, armed by the exactly-once outbox,
      io/outbox.py): waves buffer in memory; the outbox commits each
      sealed range as an offset-named segment written temp + fsync +
      rename (``{filename}.pw-{offset}.seg``), so a segment either
      exists whole or not at all — torn sink lines are impossible, and
      a replay of the same range rewrites the same segment
      byte-identically (idempotent). ``close`` consolidates the
      segments back into the single ``filename`` users asked for, via
      the same temp + fsync + rename.
    """

    def __init__(self, filename: str, format: str):
        self.filename = filename
        self.format = format
        self._file = None
        self._csv_writer = None
        self._names: list[str] | None = None
        self._atomic = False
        self._pending: list[str] = []

    def open(self, names: list[str]) -> None:
        self._names = names
        self._file = open(self.filename, "w", newline="")
        if self.format == "csv":
            self._csv_writer = _csv.writer(self._file)
            self._csv_writer.writerow(names + ["time", "diff"])

    def _format(self, time: int, entries: list) -> str:
        if self.format == "csv":
            import io as _io

            buf = _io.StringIO()
            w = _csv.writer(buf)
            for _key, row, diff in entries:
                w.writerow(list(row) + [time, diff])
            return buf.getvalue()
        if self.format in ("json", "jsonlines"):
            out = []
            for _key, row, diff in entries:
                rec = dict(zip(self._names, row))
                rec["time"] = time
                rec["diff"] = diff
                out.append(Json.dumps(rec) + "\n")
            return "".join(out)
        return "".join(str(row[0]) + "\n" for _key, row, _diff in entries)

    def write(self, time: int, entries: list) -> None:
        if self._atomic:
            self._pending.append(self._format(time, entries))
            return
        assert self._file is not None
        self._file.write(self._format(time, entries))

    # ------------------------------------------------ atomic epoch commits

    def enable_atomic(self) -> None:
        """Switch to segment-buffered transactional mode (called by the
        outbox wiring before any wave flows)."""
        self._atomic = True

    def abort_pending(self) -> None:
        """Drop uncommitted buffered output (a delivery that failed will
        be replayed whole from the outbox WAL)."""
        self._pending.clear()

    def reset_segments(self) -> None:
        """A fresh outbox (nothing ever sealed or acked) owns no
        segments: drop orphans an unrelated previous run may have left
        beside the output path, or close() would consolidate their
        stale rows into this run's file."""
        for seg in self._segment_paths():
            try:
                os.unlink(seg)
            except OSError as e:
                # a surviving orphan would consolidate its STALE rows
                # into this run's file at close() — loud, counted
                _log_degradation(logger, "fs.outbox.orphan_segment", e)

    def _segment_paths(self) -> list[str]:
        pre = os.path.basename(self.filename) + ".pw-"
        d = os.path.dirname(self.filename) or "."
        out = []
        for fn in os.listdir(d):
            if fn.startswith(pre) and fn.endswith(".seg"):
                out.append(os.path.join(d, fn))
        return sorted(out)

    def commit_segment(self, seq: int) -> None:
        """Make the buffered range durable as ONE atomic segment named
        by its outbox offset: write-temp + fsync + rename. A replayed
        range re-commits the same name with the same bytes."""
        data = "".join(self._pending).encode("utf-8")
        self._pending.clear()
        if not data:
            return
        seg = f"{self.filename}.pw-{seq:012d}.seg"
        tmp = seg + ".tmp"
        with open(tmp, "wb") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, seg)
        dirfd = os.open(os.path.dirname(seg) or ".", os.O_RDONLY)
        try:
            os.fsync(dirfd)
        finally:
            os.close(dirfd)

    def native_writer(self):
        """write_native(time, NativeBatch) when this format has a C
        formatter (csv only), else None."""
        if self.format != "csv":
            return None
        try:
            from pathway_tpu_torch.engine.native import dataplane as dp
        except Exception:  # noqa: BLE001
            return None
        if not dp.available():
            return None

        def write_native(time: int, batch) -> None:
            assert self._file is not None
            data, fallback = dp.format_csv(batch.tab, batch.token, batch.diff, time)
            # csv.writer owns the text stream; route bytes through it as
            # a single pre-formatted blob to keep one file handle
            self._file.flush()
            self._file.buffer.write(data) if hasattr(self._file, "buffer") else self._file.write(data.decode("utf-8"))
            if len(fallback):
                sub = batch.select(fallback)
                self.write(time, sub.materialize())

        return write_native

    def flush(self) -> None:
        if self._atomic:
            return  # durability is per committed segment
        if self._file:
            self._file.flush()

    def close(self) -> None:
        if self._file:
            self._file.close()
            self._file = None
        if not self._atomic:
            return
        # consolidate segments into the single output file (temp +
        # fsync + rename): the clean-finish contract stays "one file",
        # while a crash mid-run leaves only whole segments behind
        segs = self._segment_paths()
        tmp = self.filename + ".pw-consolidate.tmp"
        with open(tmp, "w", newline="") as f:
            if self.format == "csv" and self._names is not None:
                w = _csv.writer(f)
                w.writerow(self._names + ["time", "diff"])
            for seg in segs:
                with open(seg, "r", newline="") as sf:
                    f.write(sf.read())
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self.filename)
        dirfd = os.open(os.path.dirname(self.filename) or ".", os.O_RDONLY)
        try:
            os.fsync(dirfd)
        finally:
            os.close(dirfd)
        for seg in segs:
            try:
                os.unlink(seg)
            except OSError as e:
                # already consolidated; next run's reset drops the
                # leftover — still worth an operator's eyes
                _log_degradation(
                    logger, "fs.outbox.segment_cleanup", e, logging.DEBUG
                )


def write(table: Table, filename: str | os.PathLike, *, format: str = "csv", **kwargs: Any) -> None:  # noqa: A002
    filename = os.fspath(filename)
    writer = _FileWriter(filename, format)
    names = table._column_names()
    writer.open(names)
    G.add_sink(
        "output",
        table,
        write_batch=lambda time, entries: writer.write(time, entries),
        flush=writer.flush,
        close=writer.close,
        write_native=writer.native_writer(),
        # the file writer emits column values + time + diff, never row
        # ids — lets the planner's id-elision analysis keep cheap keys
        # for cones that end here (internals/planner.py)
        observes_ids=False,
        # transactional hooks (io/outbox.py): under exactly-once the
        # outbox buffers waves and commits each sealed range as ONE
        # offset-named atomic segment — replay-idempotent, no torn lines
        exactly_once={
            "enable": writer.enable_atomic,
            "commit": writer.commit_segment,
            "abort": writer.abort_pending,
            "reset": writer.reset_segments,
        },
    )
