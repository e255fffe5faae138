"""Tiny sizes of the two cells, for runs of the harness on the CPU."""

from benchmark import harness

ENCODER = {
    "kind": "encoder", "vocab_size": 512, "d_model": 32, "n_heads": 4, "n_layers": 2,
    "d_ff": 64, "max_len": 64, "embed_dim": 32, "dtype": "bfloat16",
}
DECODER = {
    "kind": "decoder", "vocab_size": 256, "d_model": 32, "n_heads": 4, "n_layers": 2,
    "d_ff": 64, "max_len": 96, "dtype": "bfloat16",
}
# limits for these sizes, from tiny readings on the CPU: embed_gap sound
# <= 0.0072, fp8 control >= 0.095 (seeds 1, 2, 3, 2**31 + 5); logit_gap
# sound <= 0.0015, fp8 control >= 0.018 (seeds 2**31 + 11 to + 16), a
# step that leaves the KV cache unchanged >= 0.089 (ten runs). Random
# logits at d_model 32 spread over some 0.1, so the cells' own limits
# (set at full width) do not apply here.
LIMITS = {
    "minilm-l6.bulk-embed": {"embed_gap": {"limit": 0.03}},
    "gpt2-xl.rag-answer": {"logit_gap": {"limit": 0.005}},
}
EMBED_CELL = "minilm-l6.bulk-embed"
ANSWER_CELL = "gpt2-xl.rag-answer"


def embed_traffic() -> dict:
    t = harness.traffic_of("bulk-embed")
    t.update(
        chunks=96, slice_rows=32, check={"rows_per_call": 8},
        doc_words={"count": 128, "median": 200, "sigma": 1.0, "cap": 2000},
    )
    return t


def answer_traffic() -> dict:
    t = harness.traffic_of("rag-answer")
    t.update(
        count=16, prompt_tokens={"median": 55, "sigma": 0.3, "floor": 40, "cap": 70},
        new_tokens=16, slots=4, clients=4,
        settle_s=0.2, check={"requests": 4},
    )
    return t


def run(cell: str, seed: int = 2**31 + 11, seconds: float = 0.5, control: bool = False) -> dict:
    spec = harness.load_spec()
    if cell == EMBED_CELL:
        model, traffic = ENCODER, embed_traffic()
    else:
        model, traffic = DECODER, answer_traffic()
    return harness.run_cell(
        spec, cell, seed, seconds, False, device="cpu", model=model, traffic=traffic,
        limits=LIMITS[cell], control=control,
    )
