"""Host milliseconds a decode step's boundary takes: the decode thread's
time in its loop outside steps and prefills (admission, building the
step's vectors, handing out tokens, finishing requests), over the
steps: the window's change in ``ContinuousBatcher.stats``
``loop_seconds - step_seconds - prefill_seconds`` over ``decode_steps``."""

UNIT, LAYER, MOVES = "ms", "slot scheduler", "answer_tokens_per_s"


def read(rec: dict):
    st = rec.get("stats") or {}
    if "loop_seconds" not in st or st["decode_steps"] <= 0:
        return None
    return 1e3 * (st["loop_seconds"] - st["step_seconds"] - st["prefill_seconds"]) / st["decode_steps"]
