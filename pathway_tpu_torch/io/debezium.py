"""pw.io.debezium — change-data-capture (CDC) ingestion.

Reference parity: python/pathway/io/debezium/__init__.py (read) +
DebeziumMessageParser in src/connectors/data_format.rs:1053. The message
format layer — the part the reference implements natively — is fully
implemented here, transport-free: a Debezium envelope
``{"payload": {"before": ..., "after": ..., "op": "c|u|d|r"}}`` maps to
z-set deltas (+after, -before). Transports: Kafka (via pw.io.kafka,
client-gated) or NATS (pw.io.nats, no client needed).
"""

from __future__ import annotations

import json as _json
from typing import Any


class DebeziumMessageParser:
    """Parses one Debezium value payload into z-set deltas.

    Returns a list of (values_dict, diff). Handles plain envelopes, the
    flattened form produced by Debezium's ExtractNewRecordState SMT, and
    tombstones (None payload -> no deltas; deletion rides the 'd' op).
    Reference: DebeziumMessageParser, data_format.rs:1053.
    """

    def __init__(self, columns: list[str]):
        self.columns = columns

    def _project(self, doc: dict | None) -> dict | None:
        if not isinstance(doc, dict):
            return None
        return {c: doc.get(c) for c in self.columns}

    def parse(self, payload: bytes | str | None) -> list[tuple[dict, int]]:
        if payload in (None, b"", ""):
            return []  # tombstone
        doc = _json.loads(payload)
        if not isinstance(doc, dict):
            return []
        envelope = doc.get("payload", doc)
        if not isinstance(envelope, dict):
            return []
        if "op" not in envelope and "after" not in envelope and "before" not in envelope:
            # flattened (ExtractNewRecordState): the record IS the row
            row = self._project(envelope)
            return [(row, 1)] if row is not None else []
        op = envelope.get("op", "r")
        before = self._project(envelope.get("before"))
        after = self._project(envelope.get("after"))
        out: list[tuple[dict, int]] = []
        if op in ("c", "r"):  # create / snapshot read
            if after is not None:
                out.append((after, 1))
        elif op == "u":
            if before is not None:
                out.append((before, -1))
            if after is not None:
                out.append((after, 1))
        elif op == "d":
            if before is not None:
                out.append((before, -1))
        return out


def read(
    rdkafka_settings: dict,
    topic_name: str,
    *,
    schema: Any = None,
    autocommit_duration_ms: int | None = 1500,
    persistent_id: str | None = None,
    name: str | None = None,
    **kwargs: Any,
) -> Any:
    """Reads a Debezium CDC topic from Kafka into a table whose rows track
    the source table (inserts/updates/deletes applied as z-set deltas).
    Requires the confluent_kafka client (see pw.io.kafka); for the
    client-free transport use read_nats()."""
    from pathway_tpu_torch.io.kafka import read as kafka_read

    raw = kafka_read(
        rdkafka_settings,
        topic_name,
        format="raw",
        autocommit_duration_ms=autocommit_duration_ms,
        name=name or f"debezium:{topic_name}",
        **kwargs,
    )
    return _apply_cdc(raw, schema)


def read_nats(
    uri: str,
    topic: str,
    *,
    schema: Any = None,
    autocommit_duration_ms: int | None = 1500,
    name: str | None = None,
    **kwargs: Any,
) -> Any:
    """Debezium CDC over NATS (e.g. a Debezium Server sink): same format
    layer, pure-socket transport."""
    from pathway_tpu_torch.io.nats import read as nats_read

    raw = nats_read(
        uri,
        topic,
        format="raw",
        autocommit_duration_ms=autocommit_duration_ms,
        name=name or f"debezium:{topic}",
        **kwargs,
    )
    return _apply_cdc(raw, schema)


def _apply_cdc(raw: Any, schema: Any) -> Any:
    """raw(data: bytes) -> CDC-applied table with `schema` columns, keyed
    by the schema's primary key: each message's deltas flow as z-set
    updates, so downstream state tracks the source table live."""
    if schema is None:
        raise ValueError("pw.io.debezium requires a schema")
    import pathway_tpu_torch as pw

    columns = list(schema.__columns__)
    parser = DebeziumMessageParser(columns)

    @pw.udf(deterministic=True)
    def parse(data: bytes) -> list:
        try:
            return [
                (tuple(vals.get(c) for c in columns), diff)
                for vals, diff in parser.parse(data)
            ]
        except Exception:  # noqa: BLE001 — unparsable message: no deltas
            return []

    flat = raw.select(delta=parse(raw.data)).flatten(pw.this.delta)
    hints = schema.typehints()
    cols = {
        c: pw.apply_with_type(
            (lambda i: lambda d: d[0][i])(i),
            hints[c],
            flat.delta,
        )
        for i, c in enumerate(columns)
    }
    diffed = flat.select(
        **cols, _cdc_diff=pw.apply_with_type(lambda d: d[1], int, flat.delta)
    )
    # collapse +1/-1 deltas per row content: keep rows whose net diff > 0
    pk = schema.primary_key_columns() or columns
    grouped = diffed.groupby(*[diffed[c] for c in columns]).reduce(
        *[diffed[c] for c in columns],
        _net=pw.reducers.sum(diffed._cdc_diff),
    )
    live = grouped.filter(pw.this._net > 0)
    final = live.select(*[live[c] for c in columns])
    return final.with_id_from(*[final[c] for c in pk])


__all__ = ["read", "read_nats", "DebeziumMessageParser"]
