"""pw.io.pubsub — Google Cloud Pub/Sub source/sink.

Reference parity: python/pathway/io/pubsub/__init__.py. Implemented
against google.cloud.pubsub_v1; raises a clear ImportError when it is
not installed.
"""

from __future__ import annotations

from typing import Any

from pathway_tpu_torch.internals import schema as sch
from pathway_tpu_torch.io._external import require_module


def read(
    subscription: str,
    *,
    project_id: str | None = None,
    schema: Any = None,
    format: str = "raw",  # noqa: A002
    autocommit_duration_ms: int | None = 1500,
    name: str | None = None,
    **kwargs: Any,
) -> Any:
    """Streams messages from a Pub/Sub subscription ('raw' bytes or
    'json' rows per `schema`)."""
    pubsub_v1 = require_module("google.cloud.pubsub_v1", "pubsub")

    import json as _json

    from pathway_tpu_torch.io.python import ConnectorSubject
    from pathway_tpu_torch.io.python import read as python_read

    if format == "json":
        if schema is None:
            raise ValueError("pw.io.pubsub.read(format='json') requires a schema")
    else:
        schema = sch.schema_from_types(data=bytes)
    columns = list(schema.__columns__)

    class PubSubSubject(ConnectorSubject):
        def run(self) -> None:
            subscriber = pubsub_v1.SubscriberClient()
            path = (
                subscription
                if subscription.startswith("projects/")
                else subscriber.subscription_path(project_id, subscription)
            )

            def callback(message: Any) -> None:
                if format == "raw":
                    self.next(data=bytes(message.data))
                else:
                    try:
                        doc = _json.loads(message.data)
                        self.next(**{c: doc.get(c) for c in columns})
                    except ValueError:
                        pass
                message.ack()

            future = subscriber.subscribe(path, callback=callback)
            future.result()  # blocks for the life of the stream

    return python_read(
        PubSubSubject(),
        schema=schema,
        autocommit_duration_ms=autocommit_duration_ms,
        name=name or f"pubsub:{subscription}",
        replay_style="live",
    )


def write(table: Any, publisher: Any, project_id: str, topic_id: str) -> None:
    """Publishes the table's updates to a Pub/Sub topic with pathway_time
    / pathway_diff attributes (reference API: caller-made PublisherClient)."""
    require_module("google.cloud.pubsub_v1", "pubsub")
    from pathway_tpu_torch.internals.json import Json
    from pathway_tpu_torch.internals.parse_graph import G

    names = table._column_names()
    topic_path = publisher.topic_path(project_id, topic_id)

    def write_batch(time: int, entries: list) -> None:
        futures = []
        for _key, row, diff in entries:
            payload = Json.dumps(dict(zip(names, row))).encode()
            futures.append(
                publisher.publish(
                    topic_path, payload,
                    pathway_time=str(time), pathway_diff=str(diff),
                )
            )
        for f in futures:
            f.result(timeout=30)

    G.add_sink("output", table, write_batch=write_batch)


__all__ = ["read", "write"]
