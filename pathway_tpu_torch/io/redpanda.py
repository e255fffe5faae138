"""pw.io.redpanda — Kafka-API-compatible source/sink.

Reference parity: python/pathway/io/redpanda/__init__.py, which is the
Kafka connector addressed at a Redpanda broker (the wire protocol is the
same); identical delegation here.
"""

from pathway_tpu_torch.io.kafka import read, simple_read, write

__all__ = ["read", "simple_read", "write"]
