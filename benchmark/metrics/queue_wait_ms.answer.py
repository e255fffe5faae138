"""Milliseconds a request waits in the batcher's admission queue, from
``submit`` to the start of its prefill: the window's change in
``ContinuousBatcher.stats`` ``queue_seconds`` over ``prefills`` (each
request's wait is counted at its prefill)."""

UNIT, LAYER, MOVES = "ms", "slot scheduler", "answer_p95_ms"


def read(rec: dict):
    st = rec.get("stats") or {}
    if "queue_seconds" not in st or st["prefills"] <= 0:
        return None
    return 1e3 * st["queue_seconds"] / st["prefills"]
