"""pw.debug: static tables, capture-and-compare helpers.

Reference: python/pathway/debug/__init__.py (table_from_markdown :429,
table_from_pandas :343, compute_and_print :207,
compute_and_print_update_stream :235).
"""

from __future__ import annotations

import re
from typing import Any, Iterable

import numpy as np

from pathway_tpu_torch.engine.core import CaptureNode
from pathway_tpu_torch.internals import dtype as dt
from pathway_tpu_torch.internals import schema as sch
from pathway_tpu_torch.internals.keys import Key, key_for_values, sequential_key
from pathway_tpu_torch.internals.lowering import Session
from pathway_tpu_torch.internals.table import OpSpec, Table
from pathway_tpu_torch.internals import universe as univ

_SPECIAL = {"__time__", "__diff__", "__key__"}


def _parse_scalar(tok: str) -> Any:
    if tok in ("None", "null"):
        return None
    if tok in ("True", "true"):
        return True
    if tok in ("False", "false"):
        return False
    try:
        return int(tok)
    except ValueError:
        pass
    try:
        return float(tok)
    except ValueError:
        pass
    if len(tok) >= 2 and tok[0] == tok[-1] and tok[0] in "\"'":
        return tok[1:-1]
    return tok


def table_from_markdown(
    txt: str,
    *,
    id_from: list[str] | None = None,
    unsafe_trusted_ids: bool = False,
    schema: Any = None,
    split_on_whitespace: bool = True,
    _stream: bool = False,
) -> Table:
    """Build a static table from a markdown-ish fixture.

    Supports optional `__time__` and `__diff__` columns to script an input
    stream (the tier-2 streaming-test pattern from the reference's
    tests/utils.py).
    """
    lines = [ln.strip() for ln in txt.strip().splitlines()]
    lines = [ln for ln in lines if ln and not set(ln) <= {"-", "|", " ", "+"}]
    if not lines:
        raise ValueError("empty table")
    if "|" in lines[0]:
        split = lambda ln: [c.strip() for c in ln.strip("|").split("|")]  # noqa: E731
    else:
        split = lambda ln: ln.split()  # noqa: E731
    header = split(lines[0])
    rows_raw = [split(ln) for ln in lines[1:]]
    col_names = [h for h in header if h not in _SPECIAL]
    data_rows: list[tuple] = []
    times: list[int] = []
    diffs: list[int] = []
    keys: list[Any] | None = [] if id_from or unsafe_trusted_ids else None
    parsed_columns: dict[str, list[Any]] = {n: [] for n in col_names}
    for raw in rows_raw:
        if len(raw) != len(header):
            raise ValueError(f"row {raw} does not match header {header}")
        vals = {}
        t, d = 0, 1
        for h, tok in zip(header, raw):
            if h == "__time__":
                t = int(tok)
            elif h == "__diff__":
                d = int(tok)
            elif h == "__key__":
                pass
            else:
                vals[h] = _parse_scalar(tok)
        row = tuple(vals[n] for n in col_names)
        data_rows.append(row)
        times.append(t)
        diffs.append(d)
        for n in col_names:
            parsed_columns[n].append(vals[n])

    if schema is not None:
        table_schema = schema
        # coerce parsed values to declared dtypes
        coerced = []
        for row in data_rows:
            out = []
            for (n, v) in zip(col_names, row):
                want = schema.__columns__[n].dtype if n in schema.__columns__ else dt.ANY
                if want == dt.FLOAT and isinstance(v, int):
                    v = float(v)
                if want == dt.STR and not isinstance(v, str) and v is not None:
                    v = str(v)
                out.append(v)
            coerced.append(tuple(out))
        data_rows = coerced
    else:
        columns = {}
        for n in col_names:
            vals = [v for v in parsed_columns[n] if v is not None]
            if not vals:
                d_ = dt.ANY
            else:
                d_ = dt.dtype_of_value(vals[0])
                for v in vals[1:]:
                    d_ = dt.types_lca(d_, dt.dtype_of_value(v))
            if any(v is None for v in parsed_columns[n]):
                d_ = dt.Optional(d_)
            columns[n] = sch.ColumnSchema(name=n, dtype=d_, primary_key=n in (id_from or []))
        table_schema = sch.schema_from_columns(columns)

    # streaming fixtures must replay in time order
    order = sorted(range(len(data_rows)), key=lambda i: times[i])
    data_rows = [data_rows[i] for i in order]
    times = [times[i] for i in order]
    diffs = [diffs[i] for i in order]

    t = Table.from_rows(table_schema, data_rows, times=times, diffs=diffs)
    if id_from:
        names = list(table_schema.__columns__)
        # re-key by the id_from columns
        rows = t._spec.params["rows"]
        new_rows = []
        for (tm, _k, row, d) in rows:
            kv = [row[names.index(c)] for c in id_from]
            new_rows.append((tm, key_for_values(*kv), row, d))
        t._spec.params["rows"] = new_rows
    return t


# markdown alias used all over reference tests
parse_to_table = table_from_markdown


def table_from_rows(
    schema: Any, rows: list[tuple], unsafe_trusted_ids: bool = False, is_stream: bool = False
) -> Table:
    """rows: tuples of column values; when is_stream, trailing (time, diff)."""
    if is_stream:
        data = [r[:-2] for r in rows]
        times = [r[-2] for r in rows]
        diffs = [r[-1] for r in rows]
        order = sorted(range(len(data)), key=lambda i: times[i])
        return Table.from_rows(
            schema,
            [data[i] for i in order],
            times=[times[i] for i in order],
            diffs=[diffs[i] for i in order],
        )
    return Table.from_rows(schema, rows)


def table_from_pandas(
    df: Any, *, id_from: list[str] | None = None, unsafe_trusted_ids: bool = False,
    schema: Any = None,
) -> Table:
    if schema is None:
        schema = sch.schema_from_pandas(df, id_from=id_from)
    names = [n for n in schema.__columns__]
    rows = []
    keys: list[Any] | None = None
    for _, r in df.iterrows():
        row = []
        for n in names:
            v = r[n]
            if isinstance(v, np.integer):
                v = int(v)
            elif isinstance(v, np.floating):
                v = float(v)
            elif isinstance(v, np.bool_):
                v = bool(v)
            row.append(v)
        rows.append(tuple(row))
    if id_from:
        keys = [tuple(r[names.index(c)] for c in id_from) for r in rows]
        keys = [key_for_values(*k) for k in keys]
    return Table.from_rows(schema, rows, keys=keys)


def _run_capture(table: Table) -> CaptureNode:
    session = Session()
    # captures observe row keys, so id elision self-vetoes; chain fusion
    # still applies (single-consumer proofs over this table's spec DAG)
    session.attach_plan_roots([table], sink_meta=[(table, True)])
    cap = session.capture(table)
    session.execute()
    return cap


def table_to_dicts(table: Table):
    cap = _run_capture(table)
    names = table._column_names()
    keys = list(cap.state.rows.keys())
    columns = {
        n: {k: cap.state.rows[k][i] for k in keys} for i, n in enumerate(names)
    }
    return keys, columns


def table_from_parquet(
    path: str, *, id_from: list[str] | None = None,
    unsafe_trusted_ids: bool = False,
) -> Table:
    """Read a parquet file into a static table (reference: debug
    table_from_parquet; pandas/pyarrow-backed)."""
    import pandas as pd

    return table_from_pandas(
        pd.read_parquet(path), id_from=id_from,
        unsafe_trusted_ids=unsafe_trusted_ids,
    )


def table_to_parquet(table: Table, filename: str) -> None:
    """Compute a table and write it to parquet (reference: debug
    table_to_parquet)."""
    table_to_pandas(table, include_id=False).to_parquet(filename)


def table_to_pandas(table: Table, include_id: bool = True):
    import pandas as pd

    cap = _run_capture(table)
    names = table._column_names()
    records = []
    index = []
    for k, row in cap.state.rows.items():
        records.append(dict(zip(names, row)))
        index.append(k)
    if include_id:
        return pd.DataFrame(records, index=index)
    return pd.DataFrame(records)


def _fmt_val(v: Any) -> str:
    if isinstance(v, str):
        return v
    return repr(v) if not isinstance(v, (int, float, bool, type(None))) else str(v)


def compute_and_print(
    table: Table,
    *,
    include_id: bool = True,
    short_pointers: bool = True,
    n_rows: int | None = None,
    squash_updates: bool = True,
    terminate_on_error: bool = True,
) -> None:
    cap = _run_capture(table)
    names = table._column_names()
    rows = sorted(
        cap.state.rows.items(), key=lambda kv: kv[0].value
    )
    if n_rows is not None:
        rows = rows[:n_rows]
    header = ([""] if include_id else []) + names
    out_rows = []
    for k, row in rows:
        cells = [str(k)[:8] if short_pointers else str(k)] if include_id else []
        cells += [_fmt_val(v) for v in row]
        out_rows.append(cells)
    widths = [
        max(len(header[i]), *(len(r[i]) for r in out_rows)) if out_rows else len(header[i])
        for i in range(len(header))
    ]
    # rstrip: no trailing pad on the last column, so doctest expected
    # outputs don't need invisible trailing whitespace
    print(" | ".join(h.ljust(w) for h, w in zip(header, widths)).rstrip())
    for r in out_rows:
        print(" | ".join(c.ljust(w) for c, w in zip(r, widths)).rstrip())


def compute_and_print_update_stream(
    table: Table, *, include_id: bool = True, **kwargs: Any
) -> None:
    cap = _run_capture(table)
    names = table._column_names() + ["__time__", "__diff__"]
    print(" | ".join((["id"] if include_id else []) + names))
    for (t, k, row, d) in cap.stream:
        cells = ([str(k)[:8]] if include_id else []) + [
            _fmt_val(v) for v in row
        ] + [str(t), str(d)]
        print(" | ".join(cells))


def diff_tables(t1: Table, t2: Table) -> dict:
    """Computes and prints the difference between two tables' final
    states. Returns {"only_left": [...], "only_right": [...], "changed":
    [(key, left_row, right_row), ...]} keyed on row ids; empty lists mean
    the tables are identical."""
    from pathway_tpu_torch.engine.core import freeze_row
    from pathway_tpu_torch.internals.lowering import Session

    session = Session()
    cap1 = session.capture(t1)
    cap2 = session.capture(t2)
    session.execute()
    rows1 = {k.value: r for k, r in cap1.state.rows.items()}
    rows2 = {k.value: r for k, r in cap2.state.rows.items()}
    only_left = [(k, rows1[k]) for k in rows1.keys() - rows2.keys()]
    only_right = [(k, rows2[k]) for k in rows2.keys() - rows1.keys()]
    changed = [
        (k, rows1[k], rows2[k])
        for k in rows1.keys() & rows2.keys()
        if freeze_row(rows1[k]) != freeze_row(rows2[k])
    ]
    if not (only_left or only_right or changed):
        print("tables are identical")
    else:
        for k, row in only_left:
            print(f"- {k:032X} {row}")
        for k, row in only_right:
            print(f"+ {k:032X} {row}")
        for k, l_row, r_row in changed:
            print(f"~ {k:032X} {l_row} -> {r_row}")
    return {
        "only_left": only_left,
        "only_right": only_right,
        "changed": changed,
    }
