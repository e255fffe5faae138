"""The decode steps' least time over their device time, in the traced
run. Each traced step's least time is ``roofline.decode_least_s`` of its
rows and their real keys (each row's prompt and decoded tokens, not the
whole cache), as the batcher held them when the step was taken. Its
device time is the union of the device's intervals in the step's
segment of the trace (``benchmark/trace.py``: from the step's call to
the batcher's next call into the program)."""

from benchmark import roofline

UNIT, LAYER, MOVES = "%", "decoder", "answer_tokens_per_s"


def read(rec: dict):
    tr = rec.get("trace")
    steps = (tr or {}).get("segments", {}).get("decode_step")
    if not steps:
        return None
    device_s = sum(s for _, s in steps)
    if device_s <= 0:
        return None
    least = sum(roofline.decode_least_s(rows, keys, rec["model"]) for (rows, keys), _ in steps)
    return 100.0 * least / device_s
