"""Host milliseconds of a prefill from its start (padding, upload) to the
return of the prefill program, before its first token's read-back: the
window's change in ``ContinuousBatcher.stats``
``prefill_launch_seconds`` over ``prefills``."""

UNIT, LAYER, MOVES = "ms", "decoder", "answer_p95_ms"


def read(rec: dict):
    st = rec.get("stats") or {}
    if "prefill_launch_seconds" not in st or st["prefills"] <= 0:
        return None
    return 1e3 * st["prefill_launch_seconds"] / st["prefills"]
