"""pw.io.elasticsearch — write table updates to an Elasticsearch index.

Reference parity: python/pathway/io/elasticsearch/__init__.py
(ElasticSearchAuth :12, write :52) backed by the native ElasticSearchWriter
(src/connectors/data_storage.rs). Elasticsearch speaks HTTP/JSON, so this
connector is implemented directly over `requests` (no elasticsearch client
package needed): each batch becomes one `_bulk` request of `index` actions
with `time`/`diff` fields attached, mirroring the reference's output
format.
"""

from __future__ import annotations

import json as _json
from typing import Any

from pathway_tpu_torch.internals.json import Json
from pathway_tpu_torch.internals.parse_graph import G


class ElasticSearchAuth:
    """Authorization for the ES HTTP API: basic / apikey / bearer."""

    def __init__(self, kind: str, **params: str):
        self.kind = kind
        self.params = params

    @classmethod
    def apikey(cls, apikey_id: str, apikey: str) -> "ElasticSearchAuth":
        return cls("apikey", apikey_id=apikey_id, apikey=apikey)

    @classmethod
    def basic(cls, username: str, password: str) -> "ElasticSearchAuth":
        return cls("basic", username=username, password=password)

    @classmethod
    def bearer(cls, bearer: str) -> "ElasticSearchAuth":
        return cls("bearer", bearer=bearer)

    def apply(self, kwargs: dict) -> dict:
        headers = kwargs.setdefault("headers", {})
        if self.kind == "basic":
            kwargs["auth"] = (self.params["username"], self.params["password"])
        elif self.kind == "apikey":
            import base64

            token = base64.b64encode(
                f"{self.params['apikey_id']}:{self.params['apikey']}".encode()
            ).decode()
            headers["Authorization"] = f"ApiKey {token}"
        elif self.kind == "bearer":
            headers["Authorization"] = f"Bearer {self.params['bearer']}"
        return kwargs


def write(
    table: Any, host: str, auth: ElasticSearchAuth | None, index_name: str
) -> None:
    """Write a table's update stream to the given index via the `_bulk`
    HTTP API; each document carries `time` and `diff` fields."""
    import requests

    names = table._column_names()
    url = host.rstrip("/") + "/_bulk"

    def write_batch(time: int, entries: list) -> None:
        lines = []
        for _key, row, diff in entries:
            doc = {}
            for n, v in zip(names, row):
                doc[n] = v.value if isinstance(v, Json) else v
            doc["time"] = time
            doc["diff"] = diff
            lines.append(_json.dumps({"index": {"_index": index_name}}))
            lines.append(Json.dumps(doc))
        if not lines:
            return
        kwargs: dict = {
            "data": ("\n".join(lines) + "\n").encode(),
            "headers": {"Content-Type": "application/x-ndjson"},
            "timeout": 30,
        }
        if auth is not None:
            kwargs = auth.apply(kwargs)
        resp = requests.post(url, **kwargs)
        resp.raise_for_status()
        body = resp.json()
        if body.get("errors"):
            failed = [
                item["index"].get("error")
                for item in body.get("items", [])
                if item.get("index", {}).get("error")
            ]
            raise RuntimeError(f"elasticsearch bulk errors: {failed[:3]}")

    G.add_sink("output", table, write_batch=write_batch)


__all__ = ["ElasticSearchAuth", "write"]
