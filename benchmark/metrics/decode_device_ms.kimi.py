"""``decode_device_ms.answer``'s reading in the Kimi Linear cell: device
milliseconds a traced decode step takes, the union of the device's
intervals in each decode step's segment of the trace, over the steps."""

from benchmark import harness

UNIT, LAYER, MOVES = "ms", "decoder", "answer_tokens_per_s"


def read(rec: dict):
    return harness.metric_module("decode_device_ms.answer").read(rec)
