"""The traced decode steps' least time in the feed-forward layers over
their device time there: each step's least time is
``roofline_mla_moe.moe_step`` of its rows, the token-expert choices that
fell among the held experts and the layer-expert pairs of held experts
chosen (each read once; the dense layer, the routers over all experts and
the shared expert); its device time is the union of the device operations
launched inside the step's ``lm.moe`` spans (``rec["part_steps"]``)."""

from benchmark import roofline_mla_moe as rl

UNIT, LAYER, MOVES = "%", "experts", "answer_tokens_per_s"


def read(rec: dict):
    steps = [s for s in rec.get("part_steps") or () if s.get("moe_s", 0) > 0]
    if not steps:
        return None
    m = rec["model"]
    least = sum(
        rl.least_s(*rl.moe_step(s["rows"], s["moe_assignments"], s["moe_experts_hit"], m)) for s in steps
    )
    return 100.0 * least / sum(s["moe_s"] for s in steps)
