"""Seeded weights of the DeepSeek-V3 family, made on the device.

The tree has the layout ``pathway_tpu_torch/models/deepseek.py`` takes
(projections [d_in, d_out]; gate and up one matrix, gate columns first;
the experts [experts, d_in, d_out] as views of [experts, d_out, d_in]),
and the scales of its ``init_params``: projections N(0, 1/d_in),
embeddings N(0, 0.02^2). Norm scales are drawn N(1, 0.1^2), so that a
norm that dropped its scale would show, and the router's correction bias
N(0, BIAS_STD^2) in f32, so that a router that dropped it would choose
other experts. Each leaf group of one scale in one layer is one
``torch.randn`` in the served dtype on the generator's device, scaled in
place (about six calls a layer: the largest, one layer's experts' gate
and up, is 369 M numbers at Moonlight's widths).
"""

from __future__ import annotations

import math

import torch

from benchmark.weights import torch_dtype

BIAS_STD = 0.1


def make(cfg: dict, seed: int, device, dtype: torch.dtype | None = None) -> dict:
    """The parameter tree of `cfg` (a configuration file's ``model`` keys)
    from `seed`, in `dtype` (default the configuration's; the correction
    bias is f32 always)."""
    dtype = dtype or torch_dtype(cfg["dtype"])
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    d, h, r, vocab = cfg["d_model"], cfg["n_heads"], cfg["kv_lora_rank"], cfg["vocab_size"]
    nope, rd, dv = cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"], cfg["v_head_dim"]
    e, m = cfg["n_routed_experts"], cfg["moe_d_ff"]
    s = cfg["n_shared_experts"] * m

    def draw(shapes: list[tuple], std: float, mean: float = 0.0, dt: torch.dtype = dtype) -> list:
        n = sum(math.prod(sh) for sh in shapes)
        buf = torch.randn(n, generator=gen, device=device, dtype=dt).mul_(std)
        if mean:
            buf.add_(mean)
        out, at = [], 0
        for sh in shapes:
            k = math.prod(sh)
            out.append(buf[at:at + k].view(sh))
            at += k
        return out

    blocks = []
    for i in range(cfg["n_layers"]):
        dense = i < cfg["first_k_dense"]
        ln1, ln2, kvn = draw([(d,), (d,), (r,)], 0.1, mean=1.0)
        wq, wkv_a = draw([(d, h * (nope + rd)), (d, r + rd)], 1.0 / math.sqrt(d))
        (wkv_b,) = draw([(r, h * (nope + dv))], 1.0 / math.sqrt(r))
        (wo,) = draw([(h * dv, d)], 1.0 / math.sqrt(h * dv))
        blk = {"ln1_scale": ln1, "wq": wq, "wkv_a": wkv_a, "kv_norm": kvn, "wkv_b": wkv_b, "wo": wo, "ln2_scale": ln2}
        if dense:
            f = cfg["d_ff"]
            (blk["ff_gate_up"],) = draw([(d, 2 * f)], 1.0 / math.sqrt(d))
            (blk["ff_down"],) = draw([(f, d)], 1.0 / math.sqrt(f))
        else:
            router, gu, sgu = draw([(d, e), (e, 2 * m, d), (d, 2 * s)], 1.0 / math.sqrt(d))
            (down,) = draw([(e, d, m)], 1.0 / math.sqrt(m))
            (sdown,) = draw([(s, d)], 1.0 / math.sqrt(s))
            (bias,) = draw([(e,)], BIAS_STD, dt=torch.float32)
            blk.update(
                router=router, router_bias=bias, experts_gate_up=gu.transpose(1, 2),
                experts_down=down.transpose(1, 2), shared_gate_up=sgu, shared_down=sdown,
            )
        blocks.append(blk)
    embed, ln_f = draw([(vocab, d)], 0.02) + draw([(d,)], 0.1, mean=1.0)
    (head,) = draw([(d, vocab)], 1.0 / math.sqrt(d))
    return {"tok_embed": embed, "ln_f_scale": ln_f, "head": head, "blocks": blocks}
