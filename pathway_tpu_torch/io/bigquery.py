"""pw.io.bigquery — write table updates to a Google BigQuery table.

Reference parity: python/pathway/io/bigquery/__init__.py (write :55):
per-minibatch buffered rows inserted via the BigQuery streaming API with
`time`/`diff` fields. Implemented against google.cloud.bigquery.
"""

from __future__ import annotations

from typing import Any

from pathway_tpu_torch.internals.json import Json
from pathway_tpu_torch.internals.parse_graph import G
from pathway_tpu_torch.io._external import require_module


def write(
    table: Any,
    dataset_name: str,
    table_name: str,
    service_user_credentials_file: str,
) -> None:
    """Streams the table's changes into `dataset_name.table_name`; the
    target schema must include integral `time` and `diff` fields."""
    bigquery = require_module("google.cloud.bigquery", "bigquery")
    service_account = require_module("google.oauth2.service_account", "bigquery")

    credentials = service_account.Credentials.from_service_account_file(
        service_user_credentials_file
    )
    names = table._column_names()
    state: dict[str, Any] = {"client": None}

    def _client() -> Any:
        if state["client"] is None:
            state["client"] = bigquery.Client(credentials=credentials)
        return state["client"]

    def write_batch(time: int, entries: list) -> None:
        rows = []
        for _key, row, diff in entries:
            doc = {}
            for n, v in zip(names, row):
                doc[n] = v.value if isinstance(v, Json) else v
            doc["time"] = time
            doc["diff"] = diff
            rows.append(doc)
        if not rows:
            return
        target = _client().get_table(f"{dataset_name}.{table_name}")
        errors = _client().insert_rows_json(target, rows)
        if errors:
            raise RuntimeError(f"bigquery insert errors: {errors[:3]}")

    G.add_sink("output", table, write_batch=write_batch)


__all__ = ["write"]
