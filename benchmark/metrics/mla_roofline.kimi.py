"""The traced decode steps' least time in latent attention over their
device time there: each step's least time is ``roofline_kda.mla_step`` of
its rows and their real keys in the MLA layers alone (each row's latent
entries before its new token, not the whole cache); its device time is the
union of the device operations launched inside the step's ``lm.mla``
spans, put there by the trace's correlation ids (``rec["part_steps"]``)."""

from benchmark import roofline_kda as rl

UNIT, LAYER, MOVES = "%", "latent attention", "answer_tokens_per_s"


def read(rec: dict):
    steps = [s for s in rec.get("part_steps") or () if s.get("mla_s", 0) > 0]
    if not steps:
        return None
    least = sum(rl.least_s(*rl.mla_step(s["rows"], s["keys"], rec["model"])) for s in steps)
    return 100.0 * least / sum(s["mla_s"] for s in steps)
