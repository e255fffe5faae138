"""``decode_step_ms.answer``'s reading in the Kimi Linear cell: host
milliseconds a decode step of the continuous batcher takes, its token
read-back included."""

from benchmark import harness

UNIT, LAYER, MOVES = "ms", "slot scheduler", "answer_tokens_per_s"


def read(rec: dict):
    return harness.metric_module("decode_step_ms.answer").read(rec)
