"""pw.io.kafka — Kafka source/sink.

Reference parity: python/pathway/io/kafka/__init__.py (read :27, write
:510) backed by src/connectors/data_storage.rs KafkaReader :692 /
KafkaWriter :1006. The reference links librdkafka natively; here the
connector is implemented against the `confluent_kafka` Python client
(librdkafka's official binding) when it is installed — the full read/
write paths below are real, not stubs — and raises a clear ImportError
otherwise. For a pure-socket message-queue connector that needs no
client library at all, see pw.io.nats.

Offsets: the consumer commits through the framework's persistence layer —
the journaled event stream is the replay source (persistence/__init__.py),
and `start_from_timestamp_ms` / stored offsets seek the live consumer, so
resume does not depend on broker-side consumer-group state.
"""

from __future__ import annotations

import json as _json
import logging
import time as _time
from typing import Any, Iterable

from pathway_tpu_torch.internals import schema as sch
from pathway_tpu_torch.internals.json import Json
from pathway_tpu_torch.internals.parse_graph import G
from pathway_tpu_torch.io._external import require_module
from pathway_tpu_torch.io._retry import log_degradation

logger = logging.getLogger("pathway_tpu_torch.io.kafka")


def read(
    rdkafka_settings: dict,
    topic: str | list[str] | None = None,
    *,
    schema: Any = None,
    format: str = "raw",  # noqa: A002
    debug_data: Any = None,
    autocommit_duration_ms: int | None = 1500,
    json_field_paths: dict[str, str] | None = None,
    autogenerate_key: bool = False,
    with_metadata: bool = False,
    start_from_timestamp_ms: int | None = None,
    parallel_readers: int | None = None,
    persistent_id: str | None = None,
    name: str | None = None,
    terminate_on_eof: bool = False,
    **kwargs: Any,
) -> Any:
    """Reads Kafka topic(s) into a streaming table.

    Formats: 'raw' (bytes `data`), 'plaintext' (utf-8 `data`), 'json'
    (columns from `schema`, optional `json_field_paths` dot-paths).
    `terminate_on_eof` ends the stream at the partition tails instead of
    waiting for new messages (bounded runs / tests).
    """
    ck = require_module("confluent_kafka", "kafka")

    from pathway_tpu_torch.io.python import ConnectorSubject
    from pathway_tpu_torch.io.python import read as python_read

    topics = [topic] if isinstance(topic, str) else list(topic or [])
    if format == "json":
        if schema is None:
            raise ValueError("pw.io.kafka.read(format='json') requires a schema")
    else:
        schema = sch.schema_from_types(data=bytes if format == "raw" else str)
    columns = list(schema.__columns__)
    paths = {
        col: [p for p in path.lstrip("/").replace("/", ".").split(".") if p]
        for col, path in (json_field_paths or {}).items()
    }

    settings = dict(rdkafka_settings)
    settings.setdefault("group.id", f"pathway-{name or topics and topics[0]}")
    settings.setdefault("enable.auto.commit", False)
    if terminate_on_eof:
        settings["enable.partition.eof"] = True

    class KafkaSubject(ConnectorSubject):
        def __init__(self) -> None:
            self._consumer = None

        def run(self) -> None:
            consumer = ck.Consumer(settings)
            self._consumer = consumer
            resume = self.resume_frontier()
            if resume:
                # offset-frontier resume (reference: data_storage.rs
                # seek_to_committed): start each partition exactly past
                # the last checkpointed message, independent of broker
                # group state
                parts = []
                for t in topics:
                    meta = consumer.list_topics(t, timeout=10)
                    for p in meta.topics[t].partitions:
                        off = resume.get(f"{t}\x00{p}")
                        parts.append(
                            ck.TopicPartition(
                                t, p,
                                int(off) if off is not None
                                else ck.OFFSET_STORED,
                            )
                        )
                consumer.assign(parts)
            elif start_from_timestamp_ms is not None:
                parts = []
                for t in topics:
                    meta = consumer.list_topics(t, timeout=10)
                    for p in meta.topics[t].partitions:
                        parts.append(
                            ck.TopicPartition(t, p, start_from_timestamp_ms)
                        )
                offsets = consumer.offsets_for_times(parts, timeout=10)
                consumer.assign(offsets)
            else:
                consumer.subscribe(topics)
            eofs: set[tuple[str, int]] = set()
            while True:
                msg = consumer.poll(0.2)
                if msg is None:
                    continue
                if msg.error():
                    if (
                        terminate_on_eof
                        and msg.error().code() == ck.KafkaError._PARTITION_EOF
                    ):
                        eofs.add((msg.topic(), msg.partition()))
                        n_parts = sum(
                            len(consumer.list_topics(t, timeout=10).topics[t].partitions)
                            for t in topics
                        )
                        if len(eofs) >= n_parts:
                            return
                        continue
                    raise RuntimeError(f"kafka: {msg.error()}")
                self._deliver(msg)
                # client-side offset frontier: the checkpoint records it
                # and resume seeks exactly past this message — the journal
                # never sees kafka events
                self.mark_frontier(
                    {f"{msg.topic()}\x00{msg.partition()}": msg.offset() + 1}
                )
                # broker-side committed offsets stay best-effort (other
                # consumers / lag monitoring)
                try:
                    consumer.commit(msg, asynchronous=True)
                except Exception as e:  # noqa: BLE001 — commit is
                    # best-effort (resume rides the CLIENT-side offset
                    # frontier above), but lag monitors read the broker
                    # side: log + count the degradation
                    log_degradation(
                        logger, "kafka.broker_commit", e, logging.DEBUG
                    )

        def _deliver(self, msg: Any) -> None:
            payload = msg.value() or b""
            if format == "raw":
                self.next(data=payload)
            elif format == "plaintext":
                self.next(data=payload.decode("utf-8", errors="replace"))
            else:
                try:
                    doc = _json.loads(payload)
                except ValueError:
                    return
                row = {}
                for col in columns:
                    node: Any = doc
                    for part in paths.get(col, [col]):
                        node = node.get(part) if isinstance(node, dict) else None
                    row[col] = node
                self.next(**row)

        def on_stop(self) -> None:
            if self._consumer is not None:
                self._consumer.close()

    return python_read(
        KafkaSubject(),
        schema=schema,
        autocommit_duration_ms=autocommit_duration_ms,
        name=name or f"kafka:{','.join(topics)}",
        # committed broker offsets mean only-new delivery after restart;
        # the persistence journal replays history (never skip live events)
        replay_style="offset",  # client-side offset frontier + seek-on-resume
    )


def simple_read(
    server: str,
    topic: str,
    *,
    read_only_new: bool = False,
    **kwargs: Any,
) -> Any:
    """Simplified reader: bootstrap server + topic (reference :299)."""
    settings = {
        "bootstrap.servers": server,
        "auto.offset.reset": "latest" if read_only_new else "earliest",
    }
    return read(settings, topic, **kwargs)


def write(
    table: Any,
    rdkafka_settings: dict,
    topic_name: str,
    *,
    format: str = "json",  # noqa: A002
    delimiter: str = ",",
    key: Any = None,
    value: Any = None,
    headers: Iterable[Any] | None = None,
    **kwargs: Any,
) -> None:
    """Writes table updates to a Kafka topic with pathway_time /
    pathway_diff headers (reference :510)."""
    ck = require_module("confluent_kafka", "kafka")
    names = table._column_names()
    header_cols = [h.name for h in headers] if headers else []
    value_idx = 0
    key_idx = names.index(key.name) if key is not None else None
    if format in ("plaintext", "raw"):
        if value is not None:
            value_idx = names.index(value.name)
        elif len(names) != 1:
            raise ValueError(
                f"pw.io.kafka.write(format={format!r}) needs `value` when "
                "the table has more than one column"
            )
    state: dict[str, Any] = {"producer": None}

    def _producer() -> Any:
        if state["producer"] is None:
            state["producer"] = ck.Producer(dict(rdkafka_settings))
        return state["producer"]

    def _write(time: int, entries: list, ids: list | None = None) -> None:
        producer = _producer()
        for i, (_k, row, diff) in enumerate(entries):
            hdrs = [
                ("pathway_time", str(time).encode()),
                ("pathway_diff", str(diff).encode()),
            ] + [(c, str(row[names.index(c)]).encode()) for c in header_cols]
            if ids is not None:
                # exactly-once replay safety (io/outbox.py): a stable
                # content key per record — consumers drop exact repeats
                hdrs.append(("pathway_msg_id", str(ids[i]).encode()))
            if format == "json":
                payload = Json.dumps(dict(zip(names, row))).encode()
            elif format == "dsv":
                payload = delimiter.join(str(v) for v in row).encode()
            elif format == "plaintext":
                payload = str(row[value_idx]).encode()
            elif format == "raw":
                v = row[value_idx]
                payload = v if isinstance(v, bytes) else str(v).encode()
            else:
                raise ValueError(f"unsupported kafka output format {format!r}")
            kbytes = None
            if key_idx is not None:
                kv = row[key_idx]
                kbytes = kv if isinstance(kv, bytes) else str(kv).encode()
            producer.produce(topic_name, payload, key=kbytes, headers=hdrs)
        producer.flush(10)

    def drain() -> None:
        # produce() only queues locally; the outbox must not ack a
        # sealed range until the broker actually holds it. flush()
        # returning a nonzero remainder means messages are still
        # queued — raising keeps the range sealed for the next fence
        # instead of silently downgrading exactly-once to at-most-once.
        # Outbox-only on purpose: in the direct per-wave path a raise
        # here would make the retry loop re-produce the whole batch
        # (duplicates with no crash), so the pre-outbox contract there
        # stays "queue locally, drain on close"
        if state["producer"] is not None:
            remaining = state["producer"].flush(10)
            if remaining:
                raise ConnectionError(
                    f"kafka producer still holds {remaining} "
                    "undelivered message(s) after flush timeout"
                )

    def close() -> None:
        if state["producer"] is not None:
            state["producer"].flush(10)

    G.add_sink(
        "output", table,
        write_batch=lambda time, entries: _write(time, entries),
        write_keyed=_write,
        close=close,
        exactly_once={"flush": drain},
    )


__all__ = ["read", "simple_read", "write"]
