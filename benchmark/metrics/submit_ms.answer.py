"""Milliseconds the caller's thread spends in ``ContinuousBatcher.submit``
(tokenizing and queueing the prompt): the window's change in
``ContinuousBatcher.stats`` ``submit_seconds`` over ``submitted``."""

UNIT, LAYER, MOVES = "ms", "chat entry", "answer_p95_ms"


def read(rec: dict):
    st = rec.get("stats") or {}
    if "submit_seconds" not in st or st["submitted"] <= 0:
        return None
    return 1e3 * st["submit_seconds"] / st["submitted"]
