"""Host milliseconds a decode step waits in its token read-back while the
device finishes the step: the window's change in
``ContinuousBatcher.stats`` ``step_sync_seconds`` over ``decode_steps``."""

UNIT, LAYER, MOVES = "ms", "decoder", "answer_tokens_per_s"


def read(rec: dict):
    st = rec.get("stats") or {}
    if "step_sync_seconds" not in st or st["decode_steps"] <= 0:
        return None
    return 1e3 * st["step_sync_seconds"] / st["decode_steps"]
