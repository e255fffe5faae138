"""Model operations of the chunks embedded in the window, each counted at
its real token count (``roofline.encoder_flops``), over the window times
the bf16 peak."""

from benchmark import roofline

UNIT, LAYER, MOVES = "%", "encoder step", "embed_chunks_per_s"


def read(rec: dict):
    calls = rec.get("calls")
    if not calls:
        return None
    flops = sum(roofline.encoder_flops(int(n), rec["model"]) for lengths in calls for n in lengths)
    return 100.0 * flops / (rec["window_s"] * roofline.BF16_FLOPS)
