"""Device milliseconds a traced decode step spends in its KDA layers: the
union of the device operations launched inside its ``lm.kda`` spans
(``rec["part_steps"]``, made by the generator ``chat_closed_kimi_linear``),
over the steps."""

UNIT, LAYER, MOVES = "ms", "linear attention", "answer_tokens_per_s"


def read(rec: dict):
    steps = [s for s in rec.get("part_steps") or () if s.get("kda_s", 0) > 0]
    if not steps:
        return None
    return 1e3 * sum(s["kda_s"] for s in steps) / len(steps)
