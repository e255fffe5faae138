"""Host milliseconds a prefill waits in its first token's read-back while
the device finishes it: the window's change in
``ContinuousBatcher.stats`` ``prefill_sync_seconds`` over ``prefills``."""

UNIT, LAYER, MOVES = "ms", "decoder", "answer_p95_ms"


def read(rec: dict):
    st = rec.get("stats") or {}
    if "prefill_sync_seconds" not in st or st["prefills"] <= 0:
        return None
    return 1e3 * st["prefill_sync_seconds"] / st["prefills"]
