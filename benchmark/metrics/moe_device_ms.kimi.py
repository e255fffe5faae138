"""Device milliseconds a traced decode step spends in the feed-forward
layers (dense, routers, held and shared experts): the union of the device
operations launched inside its ``lm.moe`` spans (``rec["part_steps"]``),
over the steps."""

UNIT, LAYER, MOVES = "ms", "experts", "answer_tokens_per_s"


def read(rec: dict):
    steps = [s for s in rec.get("part_steps") or () if s.get("moe_s", 0) > 0]
    if not steps:
        return None
    return 1e3 * sum(s["moe_s"] for s in steps) / len(steps)
