"""``queue_wait_ms.answer``'s reading in the Kimi Linear cell: milliseconds
a request waits in the batcher's admission queue, from ``submit`` to the
start of its prefill, over the prefills of the window."""

from benchmark import harness

UNIT, LAYER, MOVES = "ms", "slot scheduler", "answer_p95_ms"


def read(rec: dict):
    return harness.metric_module("queue_wait_ms.answer").read(rec)
