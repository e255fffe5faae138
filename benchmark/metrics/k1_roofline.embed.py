"""The attention kernel K1's least time over its device time in the
traced window. Least time: ``roofline.attention_least_s`` over each
call's rows at their real lengths, once a layer. Device time: the
profiler's kernels named as in ``pathway_tpu_torch/csrc/attention.cu``."""

from benchmark import roofline

UNIT, LAYER, MOVES = "%", "attention kernel K1", "embed_chunks_per_s"
KERNELS = (
    "fused_qkv_attention_kernel", "wgmma_attention_kernel", "tiled_f32_kernel", "any_width_",
)


def read(rec: dict):
    tr = rec.get("trace")
    if not tr:
        return None
    k1_s = sum(s for name, s in tr["kernel_s"].items() if any(k in name for k in KERNELS))
    if k1_s <= 0:
        return None
    m = rec["model"]
    dtype = {"bfloat16": "bf16", "float16": "f16", "float32": "f32"}[m["dtype"]]
    least = sum(
        m["n_layers"] * roofline.attention_least_s(lengths, m["d_model"], m["n_heads"], dtype)
        for lengths in rec["calls"]
    )
    return 100.0 * least / k1_s
