"""``step_launch_ms.answer``'s reading in the Kimi Linear cell: host
milliseconds of a decode step from its start to the return of the step
program, before the token read-back (the eager step launches every
layer's operations from Python)."""

from benchmark import harness

UNIT, LAYER, MOVES = "ms", "decoder", "answer_tokens_per_s"


def read(rec: dict):
    return harness.metric_module("step_launch_ms.answer").read(rec)
