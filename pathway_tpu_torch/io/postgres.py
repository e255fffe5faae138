"""pw.io.postgres — write table updates / snapshots to PostgreSQL.

Reference parity: python/pathway/io/postgres/__init__.py (write :18,
write_snapshot :113) backed by the native PsqlWriter
(src/connectors/data_storage.rs:1080). Implemented against psycopg2 (or
psycopg 3 — whichever is importable); raises a clear ImportError when
neither client is installed.
"""

from __future__ import annotations

from typing import Any

from pathway_tpu_torch.internals.json import Json
from pathway_tpu_torch.internals.parse_graph import G


def _connect(settings: dict) -> Any:
    try:
        import psycopg2 as pg  # type: ignore[import-not-found]

        return pg.connect(**settings)
    except ImportError:
        pass
    try:
        import psycopg as pg3  # type: ignore[import-not-found]

        return pg3.connect(**settings)
    except ImportError as e:
        raise ImportError(
            "pw.io.postgres requires psycopg2 or psycopg, neither of which "
            "is installed in this environment"
        ) from e


def _sql_value(v: Any) -> Any:
    if isinstance(v, Json):
        return Json.dumps(v)
    return v


def write(
    table: Any,
    postgres_settings: dict,
    table_name: str,
    max_batch_size: int | None = None,
    init_mode: str = "default",
) -> None:
    """Appends the table's stream of updates to a Postgres table that has
    `time` and `diff` integer columns (reference :18)."""
    names = table._column_names()
    cols = ", ".join([*names, "time", "diff"])
    placeholders = ", ".join(["%s"] * (len(names) + 2))
    sql = f"INSERT INTO {table_name} ({cols}) VALUES ({placeholders})"
    state: dict[str, Any] = {"conn": None}

    def _conn() -> Any:
        if state["conn"] is None or getattr(state["conn"], "closed", False):
            state["conn"] = _connect(postgres_settings)
        return state["conn"]

    def write_batch(time: int, entries: list) -> None:
        conn = _conn()
        try:
            with conn.cursor() as cur:
                batch = 0
                for _key, row, diff in entries:
                    cur.execute(sql, [*(_sql_value(v) for v in row), time, diff])
                    batch += 1
                    if max_batch_size and batch >= max_batch_size:
                        conn.commit()
                        batch = 0
            conn.commit()
        except Exception:
            try:
                conn.rollback()
            finally:
                state["conn"] = None  # reconnect next batch
            raise

    def close() -> None:
        if state["conn"] is not None:
            state["conn"].close()

    G.add_sink("output", table, write_batch=write_batch, close=close)


def write_snapshot(
    table: Any,
    postgres_settings: dict,
    table_name: str,
    primary_key: list[str],
    max_batch_size: int | None = None,
    init_mode: str = "default",
) -> None:
    """Maintains the current snapshot of the table in Postgres: upsert by
    primary key on insertion, delete on retraction (reference :113)."""
    names = table._column_names()
    cols = ", ".join([*names, "time", "diff"])
    placeholders = ", ".join(["%s"] * (len(names) + 2))
    conflict = ", ".join(primary_key)
    updates = ", ".join(
        f"{n} = EXCLUDED.{n}" for n in [*names, "time", "diff"] if n not in primary_key
    )
    upsert_sql = (
        f"INSERT INTO {table_name} ({cols}) VALUES ({placeholders}) "
        f"ON CONFLICT ({conflict}) DO UPDATE SET {updates}"
    )
    delete_sql = f"DELETE FROM {table_name} WHERE " + " AND ".join(
        f"{k} = %s" for k in primary_key
    )
    pk_idx = [names.index(k) for k in primary_key]
    state: dict[str, Any] = {"conn": None}

    def _conn() -> Any:
        if state["conn"] is None or getattr(state["conn"], "closed", False):
            state["conn"] = _connect(postgres_settings)
        return state["conn"]

    def write_batch(time: int, entries: list) -> None:
        # net the batch per primary key first: an in-batch update arrives
        # as (+new, -old) in arbitrary order, and applying them in entry
        # order could upsert then delete the live row
        final: dict[tuple, tuple | None] = {}
        for _key, row, diff in entries:
            pkv = tuple(row[i] for i in pk_idx)
            if diff > 0:
                final[pkv] = row
            else:
                final.setdefault(pkv, None)
        conn = _conn()
        try:
            with conn.cursor() as cur:
                for pkv, row in final.items():
                    if row is not None:
                        cur.execute(
                            upsert_sql, [*(_sql_value(v) for v in row), time, 1]
                        )
                    else:
                        cur.execute(delete_sql, list(pkv))
            conn.commit()
        except Exception:
            try:
                conn.rollback()
            finally:
                state["conn"] = None
            raise

    def close() -> None:
        if state["conn"] is not None:
            state["conn"].close()

    G.add_sink("output", table, write_batch=write_batch, close=close)


__all__ = ["write", "write_snapshot"]
