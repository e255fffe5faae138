"""Model operations of the window's answers over the window times the
bf16 peak: ``roofline_mla_moe.answer_work`` counts the real prompt tokens
prefilled and the tokens decoded over their real contexts, each token at
its active parameters (6 routed and 2 shared experts, the dense layer,
latent attention, the head). The whole step's share of the peak."""

from benchmark import roofline_mla_moe as rl

UNIT, LAYER, MOVES = "%", "decoder", "answer_tokens_per_s"


def read(rec: dict):
    if not rec.get("requests") or "kv_lora_rank" not in rec.get("model", {}):
        return None
    w = rl.answer_work(rec["requests"], rec["window_s"], rec["new_tokens"], rec["model"])
    return 100.0 * (w["prefill_flops"] + w["decode_flops"]) / (rec["window_s"] * rl.BF16_FLOPS)
