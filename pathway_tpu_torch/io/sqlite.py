"""pw.io.sqlite — real connector over the stdlib sqlite3
(reference: SqliteReader src/connectors/data_storage.rs:1415)."""

from __future__ import annotations

import sqlite3
import time as _time
from typing import Any

from pathway_tpu_torch.engine.runtime import InputSession, ThreadConnector
from pathway_tpu_torch.internals import schema as sch
from pathway_tpu_torch.internals import universe as univ
from pathway_tpu_torch.internals.keys import key_for_values, sequential_key
from pathway_tpu_torch.internals.parse_graph import G
from pathway_tpu_torch.internals.table import OpSpec, Table


def read(
    path: str,
    table_name: str,
    schema: Any,
    *,
    mode: str = "streaming",
    autocommit_duration_ms: int = 1000,
    **kwargs: Any,
) -> Table:
    names = list(schema.__columns__)
    pk = schema.primary_key_columns()
    cols = ", ".join(names)

    if mode == "static":
        conn = sqlite3.connect(path)
        try:
            rows = [tuple(r) for r in conn.execute(f"SELECT {cols} FROM {table_name}")]  # noqa: S608
        finally:
            conn.close()
        keys = None
        if pk:
            keys = [key_for_values(*[r[names.index(c)] for c in pk]) for r in rows]
        return Table.from_rows(schema, rows, keys=keys)

    def factory(session: InputSession) -> ThreadConnector:
        def run_fn(sess: InputSession) -> None:
            conn = sqlite3.connect(path)
            last_rowid = 0
            try:
                while True:
                    cur = conn.execute(
                        f"SELECT rowid, {cols} FROM {table_name} WHERE rowid > ?",  # noqa: S608
                        (last_rowid,),
                    )
                    for rec in cur:
                        last_rowid = max(last_rowid, rec[0])
                        row = tuple(rec[1:])
                        key = (
                            key_for_values(*[row[names.index(c)] for c in pk])
                            if pk
                            else sequential_key()
                        )
                        sess.insert(key, row)
                    _time.sleep(autocommit_duration_ms / 1000.0)
            finally:
                conn.close()

        return ThreadConnector(f"sqlite:{path}", session, run_fn)

    spec = OpSpec("connector", [], factory=factory, upsert=pk is not None)
    return Table(spec, schema, univ.Universe())


def write(table: Table, path: str, table_name: str, **kwargs: Any) -> None:
    names = table._column_names()
    placeholders = ", ".join("?" for _ in range(len(names) + 2))
    collist = ", ".join([*names, "time", "diff"])

    state: dict[str, Any] = {"conn": None}

    def ensure() -> sqlite3.Connection:
        if state["conn"] is None:
            conn = sqlite3.connect(path, check_same_thread=False)
            coldefs = ", ".join([f"{n}" for n in names] + ["time INTEGER", "diff INTEGER"])
            conn.execute(f"CREATE TABLE IF NOT EXISTS {table_name} ({coldefs})")
            state["conn"] = conn
        return state["conn"]

    def write_batch(time: int, entries: list) -> None:
        conn = ensure()
        conn.executemany(
            f"INSERT INTO {table_name} ({collist}) VALUES ({placeholders})",  # noqa: S608
            [tuple(row) + (time, diff) for _k, row, diff in entries],
        )
        conn.commit()

    G.add_sink("output", table, write_batch=write_batch)
