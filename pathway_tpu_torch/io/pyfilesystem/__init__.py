"""pw.io.pyfilesystem — read files from any PyFilesystem2 source.

Reference parity: python/pathway/io/pyfilesystem/__init__.py — walks the
FS, emits one binary row per file keyed by its path (upsert semantics:
modified files overwrite, deleted files retract), optionally with a
`_metadata` JSON column, polling every `refresh_interval` seconds in
streaming mode.

The `source` is duck-typed against the PyFilesystem `FS` surface
(`walk.files`, `getmodified`, `open`, `getinfo`) so any object-store FS
(`fs.osfs.OSFS`, `fs-s3fs`, zip/tar FS, or an in-memory fake in tests)
works; the `fs` package itself is not required by the framework.
"""

from __future__ import annotations

import json as _json
import time as _time
from typing import Any

from pathway_tpu_torch.engine.runtime import InputSession, ThreadConnector
from pathway_tpu_torch.internals import dtype as dt
from pathway_tpu_torch.internals import schema as sch
from pathway_tpu_torch.internals import universe as univ
from pathway_tpu_torch.internals.json import Json
from pathway_tpu_torch.internals.keys import ref_scalar
from pathway_tpu_torch.internals.table import OpSpec, Table


def _metadata_dict(source: Any, path: str) -> dict:
    try:
        info = source.getinfo(path, namespaces=["basic", "details", "access"])
    except Exception:  # noqa: BLE001 — deleted between walk and stat
        return {"path": path, "seen_at": int(_time.time())}

    def ts(v: Any) -> int | None:
        return int(v.timestamp()) if v is not None else None

    return {
        "created_at": ts(getattr(info, "created", None)),
        "modified_at": ts(getattr(info, "modified", None)),
        "accessed_at": ts(getattr(info, "accessed", None)),
        "seen_at": int(_time.time()),
        "size": getattr(info, "size", None),
        "owner": getattr(info, "user", None),
        "name": getattr(info, "name", None),
        "path": path,
    }


def read(
    source: Any,
    *,
    path: str = "",
    refresh_interval: float = 30,
    mode: str = "streaming",
    with_metadata: bool = False,
    name: str | None = None,
) -> Table:
    """Reads every file under `path` of a PyFilesystem source into a
    binary `data` column keyed by file path (reference docstring
    semantics: modified files update their row, deletions retract it;
    `mode='static'` takes one snapshot and finishes)."""
    cols = {"data": sch.ColumnSchema(name="data", dtype=dt.BYTES)}
    if with_metadata:
        cols["_metadata"] = sch.ColumnSchema(name="_metadata", dtype=dt.JSON)
    schema = sch.schema_from_columns(cols)

    _RETRY = object()  # re-read marker that keeps deletion tracking intact

    def factory(session: InputSession) -> ThreadConnector:
        def run_fn(sess: InputSession) -> None:
            modify_times: dict[str, Any] = {}
            while True:
                start = _time.time()
                existing: set[str] = set()
                changed: list[str] = []
                try:
                    walk_paths = list(source.walk.files(path=path or "/"))
                except Exception:  # noqa: BLE001 — source briefly
                    # unavailable: skip the cycle (an empty listing would
                    # read as "everything deleted" and retract the world)
                    if mode == "static":
                        return
                    _time.sleep(refresh_interval)
                    continue
                for p in walk_paths:
                    existing.add(p)
                    try:
                        modified = source.getmodified(p)
                    except Exception:  # noqa: BLE001
                        continue
                    if modify_times.get(p) != modified:
                        modify_times[p] = modified
                        changed.append(p)
                for p in changed:
                    try:
                        with source.open(p, "rb") as f:
                            data = f.read()
                    except Exception:  # noqa: BLE001 — vanished mid-read:
                        # keep the tracking entry (so a real deletion still
                        # retracts) but force a re-read attempt next cycle
                        modify_times[p] = _RETRY
                        continue
                    if isinstance(data, str):
                        data = data.encode("utf-8")
                    row: tuple = (data,)
                    if with_metadata:
                        row = (data, Json(_metadata_dict(source, p)))
                    # upsert session: modified files overwrite in place
                    sess.insert(ref_scalar(p), row)
                for p in list(modify_times):
                    if p not in existing:
                        modify_times.pop(p)
                        # upsert sessions stage the retraction from their
                        # own current-row map; no row payload needed
                        sess.remove(ref_scalar(p))
                if mode == "static":
                    return
                elapsed = _time.time() - start
                if elapsed < refresh_interval:
                    _time.sleep(min(refresh_interval - elapsed, refresh_interval))

        return ThreadConnector(name or "pyfilesystem", session, run_fn)

    spec = OpSpec("connector", [], factory=factory, upsert=True, name=name)
    return Table(spec, schema, univ.Universe())


__all__ = ["read"]
