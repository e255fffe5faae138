"""``step_sync_ms.answer``'s reading in the Kimi Linear cell: host
milliseconds a decode step waits in its token read-back while the device
finishes the step."""

from benchmark import harness

UNIT, LAYER, MOVES = "ms", "decoder", "answer_tokens_per_s"


def read(rec: dict):
    return harness.metric_module("step_sync_ms.answer").read(rec)
