"""Host seconds the continuous batcher spent in prefills (each with its
first token's read-back) over the window: the window's change in
``ContinuousBatcher.stats`` ``prefill_seconds``."""

UNIT, LAYER, MOVES = "%", "slot scheduler", "answer_p95_ms"


def read(rec: dict):
    st = rec.get("stats")
    if not st or st["prefills"] <= 0:
        return None
    return 100.0 * st["prefill_seconds"] / rec["window_s"]
