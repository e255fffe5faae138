"""``idle_share.answer``'s reading in the Kimi Linear cell: one minus the
union of the device's busy intervals over the traced window."""

from benchmark import harness

UNIT, LAYER, MOVES = "%", "device", "answer_tokens_per_s"


def read(rec: dict):
    return harness.metric_module("idle_share.answer").read(rec)
