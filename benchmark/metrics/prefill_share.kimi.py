"""``prefill_share.answer``'s reading in the Kimi Linear cell: host
seconds the continuous batcher spent in prefills over the window."""

from benchmark import harness

UNIT, LAYER, MOVES = "%", "slot scheduler", "answer_p95_ms"


def read(rec: dict):
    return harness.metric_module("prefill_share.answer").read(rec)
