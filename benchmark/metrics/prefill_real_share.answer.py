"""The share of the prefills' positions that hold a prompt token, the
rest being the left padding up to the sequence bucket: the window's
change in ``ContinuousBatcher.stats`` ``prefill_tokens`` over
``prefill_positions``."""

UNIT, LAYER, MOVES = "%", "slot scheduler", "answer_p95_ms"


def read(rec: dict):
    st = rec.get("stats") or {}
    if not st.get("prefill_positions"):
        return None
    return 100.0 * st["prefill_tokens"] / st["prefill_positions"]
