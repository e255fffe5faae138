"""Host milliseconds a decode step of the continuous batcher takes, its
token read-back included: the window's change in
``ContinuousBatcher.stats`` ``step_seconds`` over ``decode_steps``."""

UNIT, LAYER, MOVES = "ms", "slot scheduler", "answer_tokens_per_s"


def read(rec: dict):
    st = rec.get("stats")
    if not st or st["decode_steps"] <= 0:
        return None
    return 1e3 * st["step_seconds"] / st["decode_steps"]
