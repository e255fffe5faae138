"""Device milliseconds a decode step takes, in the traced run: the union
of the device's intervals in each decode step's segment of the trace
(``benchmark/trace.py``), over the steps. Beside the host's
``decode_step_ms.answer`` it says how much of a step the device works."""

UNIT, LAYER, MOVES = "ms", "decoder", "answer_tokens_per_s"


def read(rec: dict):
    tr = rec.get("trace")
    steps = (tr or {}).get("segments", {}).get("decode_step")
    if not steps:
        return None
    return 1e3 * sum(s for _, s in steps) / len(steps)
