"""pw.io.deltalake — Delta Lake table source/sink.

Reference parity: python/pathway/io/deltalake/__init__.py (read :38,
write :170) backed by the native delta-rs integration. Implemented
against the `deltalake` Python package (delta-rs bindings): read scans
table versions and emits row deltas per version; write appends each
minibatch with `time`/`diff` columns. Raises a clear ImportError when the
package is not installed.
"""

from __future__ import annotations

import time as _time
from typing import Any

from pathway_tpu_torch.io._external import require_module


def read(
    uri: str,
    *,
    schema: Any = None,
    mode: str = "streaming",
    autocommit_duration_ms: int | None = 1500,
    persistent_id: str | None = None,
    name: str | None = None,
    poll_interval_s: float = 5.0,
    storage_options: dict | None = None,
    **kwargs: Any,
) -> Any:
    """Reads a Delta table; streaming mode follows new table versions and
    emits their row-level changes."""
    dl = require_module("deltalake", "deltalake")

    from pathway_tpu_torch.io.python import ConnectorSubject
    from pathway_tpu_torch.io.python import read as python_read

    if schema is None:
        raise ValueError("pw.io.deltalake.read requires a schema")
    columns = list(schema.__columns__)
    pk = schema.primary_key_columns()
    if mode == "streaming" and not pk:
        raise ValueError(
            "pw.io.deltalake.read in streaming mode requires primary-key "
            "columns in the schema: new table versions are diffed against "
            "the previous snapshot per key"
        )

    class DeltaSubject(ConnectorSubject):
        def run(self) -> None:
            table = dl.DeltaTable(uri, storage_options=storage_options)
            version = -1
            snapshot: dict[tuple, dict] = {}  # pk values -> row
            while True:
                table.update_incremental()
                new_version = table.version()
                if new_version > version:
                    rows = table.to_pyarrow_table().to_pylist()
                    current: dict[tuple, dict] = {}
                    for rec in rows:
                        row = {c: rec.get(c) for c in columns}
                        if pk:
                            current[tuple(row[c] for c in pk)] = row
                        else:  # static single read: emit everything once
                            self.next(**row)
                    if pk:
                        for k, row in current.items():
                            if snapshot.get(k) != row:
                                self.next(**row)  # upsert (pk-keyed session)
                        for k in set(snapshot) - set(current):
                            self._remove(snapshot[k])
                        snapshot = current
                    version = new_version
                if mode != "streaming":
                    return
                _time.sleep(poll_interval_s)

    return python_read(
        DeltaSubject(),
        schema=schema,
        autocommit_duration_ms=autocommit_duration_ms,
        name=name or f"deltalake:{uri}",
    )


def write(
    table: Any,
    uri: str,
    *,
    storage_options: dict | None = None,
    min_commit_frequency: int | None = None,
    **kwargs: Any,
) -> None:
    """Appends the table's update stream (with time/diff columns) to a
    Delta table, creating it on first write."""
    dl = require_module("deltalake", "deltalake")
    pa = require_module("pyarrow", "deltalake")

    from pathway_tpu_torch.internals.parse_graph import G

    names = table._column_names()

    def write_batch(time: int, entries: list) -> None:
        rows = [
            {**dict(zip(names, row)), "time": time, "diff": diff}
            for _key, row, diff in entries
        ]
        if not rows:
            return
        dl.write_deltalake(
            uri,
            pa.Table.from_pylist(rows),
            mode="append",
            storage_options=storage_options,
        )

    G.add_sink("output", table, write_batch=write_batch)


__all__ = ["read", "write"]
