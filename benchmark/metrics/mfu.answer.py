"""Model operations of the window's answers (``roofline.answer_work``:
the real prompt tokens prefilled and the tokens decoded over their real
contexts) over the window times the bf16 peak."""

from benchmark import roofline

UNIT, LAYER, MOVES = "%", "decoder", "answer_tokens_per_s"


def read(rec: dict):
    if not rec.get("requests"):
        return None
    w = roofline.answer_work(rec["requests"], rec["window_s"], rec["new_tokens"], rec["model"])
    return 100.0 * (w["prefill_flops"] + w["decode_flops"]) / (rec["window_s"] * roofline.BF16_FLOPS)
