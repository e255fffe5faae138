"""``prefill_launch_ms.answer``'s reading in the Kimi Linear cell: host
milliseconds of a prefill from its start to the return of the prefill
program (KDA's chunked form launches a loop of chunks), before its first
token's read-back."""

from benchmark import harness

UNIT, LAYER, MOVES = "ms", "decoder", "answer_p95_ms"


def read(rec: dict):
    return harness.metric_module("prefill_launch_ms.answer").read(rec)
