"""Model operations of the window's answers over the window times the
bf16 peak: ``roofline_kda.answer_work`` counts the real prompt tokens
prefilled and the tokens decoded over their real contexts, each token at
its active parameters (the held experts' share of its 8 choices and the
shared expert, the dense layer, KDA in 20 layers and latent attention in
7, the head), latent attention over its real context and KDA's state work
of each token. The whole step's share of the peak."""

from benchmark import roofline_kda as rl

UNIT, LAYER, MOVES = "%", "decoder", "answer_tokens_per_s"


def read(rec: dict):
    if not rec.get("requests") or "kda_layers" not in rec.get("model", {}):
        return None
    w = rl.answer_work(rec["requests"], rec["window_s"], rec["new_tokens"], rec["model"])
    return 100.0 * (w["prefill_flops"] + w["decode_flops"]) / (rec["window_s"] * rl.BF16_FLOPS)
