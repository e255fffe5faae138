"""pw.io.mongodb — write table updates to a MongoDB collection.

Reference parity: python/pathway/io/mongodb/__init__.py (write :14)
backed by the native MongoWriter (src/connectors/data_storage.rs).
Implemented against pymongo; raises a clear ImportError when it is not
installed.
"""

from __future__ import annotations

from typing import Any

from pathway_tpu_torch.internals.json import Json
from pathway_tpu_torch.internals.parse_graph import G
from pathway_tpu_torch.io._external import require_module


def write(
    table: Any,
    *,
    connection_string: str,
    database: str,
    collection: str,
    max_batch_size: int | None = None,
) -> None:
    """Appends the table's update stream to a MongoDB collection; each
    document gets `time` and `diff` fields (reference :14)."""
    pymongo = require_module("pymongo", "mongodb")
    names = table._column_names()
    state: dict[str, Any] = {"client": None}

    def _coll() -> Any:
        if state["client"] is None:
            state["client"] = pymongo.MongoClient(connection_string)
        return state["client"][database][collection]

    def write_batch(time: int, entries: list) -> None:
        docs = []
        for _key, row, diff in entries:
            doc = {}
            for n, v in zip(names, row):
                doc[n] = v.value if isinstance(v, Json) else v
            doc["time"] = time
            doc["diff"] = diff
            docs.append(doc)
            if max_batch_size and len(docs) >= max_batch_size:
                _coll().insert_many(docs)
                docs = []
        if docs:
            _coll().insert_many(docs)

    def close() -> None:
        if state["client"] is not None:
            state["client"].close()

    G.add_sink("output", table, write_batch=write_batch, close=close)


__all__ = ["write"]
