"""``prefill_sync_ms.answer``'s reading in the Kimi Linear cell: host
milliseconds a prefill waits in its first token's read-back while the
device finishes it."""

from benchmark import harness

UNIT, LAYER, MOVES = "ms", "decoder", "answer_p95_ms"


def read(rec: dict):
    return harness.metric_module("prefill_sync_ms.answer").read(rec)
