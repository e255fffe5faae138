"""The traced decode steps' least time in the feed-forward layers over
their device time there: each step's least time is
``roofline_mla_moe.moe_step`` of its rows, token-expert choices and the
layer-expert pairs chosen (each expert hit read once; the dense layer,
the routers and the shared experts); its device time is the union of the
device operations launched inside the step's ``lm.moe`` spans, put there
by the trace's correlation ids (``rec["layer_steps"]``)."""

from benchmark import roofline_mla_moe as rl

UNIT, LAYER, MOVES = "%", "experts", "answer_tokens_per_s"


def read(rec: dict):
    steps = [s for s in rec.get("layer_steps") or () if s.get("moe_s", 0) > 0]
    if not steps:
        return None
    m = rec["model"]
    least = sum(
        rl.least_s(*rl.moe_step(s["rows"], s["moe_assignments"], s["moe_experts_hit"], m)) for s in steps
    )
    return 100.0 * least / sum(s["moe_s"] for s in steps)
