"""The traced decode steps' least time in their KDA layers over their
device time there: each step's least time is ``roofline_kda.kda_step`` of
its occupied rows (each KDA weight read once, each row's f32 state read
and written once, its conv tail); its device time is the union of the
device operations launched inside the step's ``lm.kda`` spans, put there
by the trace's correlation ids (``rec["part_steps"]``)."""

from benchmark import roofline_kda as rl

UNIT, LAYER, MOVES = "%", "linear attention", "answer_tokens_per_s"


def read(rec: dict):
    steps = [s for s in rec.get("part_steps") or () if s.get("kda_s", 0) > 0]
    if not steps:
        return None
    least = sum(rl.least_s(*rl.kda_step(s["rows"], rec["model"])) for s in steps)
    return 100.0 * least / sum(s["kda_s"] for s in steps)
