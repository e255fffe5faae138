"""pw.io: connector families (reference: python/pathway/io/, 28 families).

Local/file and Python-subject connectors are fully native here; external
service connectors (kafka, postgres, s3, ...) are present with the same
API surface and fail at use-time if their client library is missing
(nothing is bundled in this image — the wire protocols are gated, the
descriptor/api layer is real).
"""

from pathway_tpu_torch.io import csv, fs, jsonlines, null, outbox, plaintext, python
from pathway_tpu_torch.io._retry import CircuitOpen, RetryPolicy
from pathway_tpu_torch.io._subscribe import subscribe

# service-backed families (gated on their client libs)
from pathway_tpu_torch.io import (  # noqa: E402
    airbyte,
    bigquery,
    debezium,
    deltalake,
    elasticsearch,
    gdrive,
    http,
    kafka,
    logstash,
    minio,
    mongodb,
    nats,
    postgres,
    pubsub,
    pyfilesystem,
    redpanda,
    s3,
    s3_csv,
    slack,
    sqlite,
)

__all__ = [
    "csv", "fs", "jsonlines", "null", "outbox", "plaintext", "python",
    "subscribe", "RetryPolicy", "CircuitOpen",
    "kafka", "redpanda", "s3", "s3_csv", "minio", "deltalake", "sqlite",
    "nats", "postgres", "elasticsearch", "mongodb", "debezium", "bigquery",
    "pubsub", "pyfilesystem", "logstash", "http", "gdrive", "slack", "airbyte",
]
