"""Host milliseconds of a decode step from its start (the upload of its
vectors) to the return of the step program, before the token read-back:
the window's change in ``ContinuousBatcher.stats`` ``step_launch_seconds``
over ``decode_steps``. With ``step_sync_ms.answer`` it sums to
``decode_step_ms.answer``."""

UNIT, LAYER, MOVES = "ms", "decoder", "answer_tokens_per_s"


def read(rec: dict):
    st = rec.get("stats") or {}
    if "step_launch_seconds" not in st or st["decode_steps"] <= 0:
        return None
    return 1e3 * st["step_launch_seconds"] / st["decode_steps"]
