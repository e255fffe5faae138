"""Device milliseconds a traced decode step spends in its latent
attention layers: the union of the device operations launched inside its
``lm.mla`` spans (``rec["part_steps"]``), over the steps."""

UNIT, LAYER, MOVES = "ms", "latent attention", "answer_tokens_per_s"


def read(rec: dict):
    steps = [s for s in rec.get("part_steps") or () if s.get("mla_s", 0) > 0]
    if not steps:
        return None
    return 1e3 * sum(s["mla_s"] for s in steps) / len(steps)
