"""Seeded weights of the Kimi Linear family, made on the device.

The tree has the layout ``pathway_tpu_torch/models/kimi_linear.py`` takes
(projections [d_in, d_out]; q, k and v one [d, 3 H K] matrix; the conv
taps [3 H K, kda_conv]; gate and up one matrix, gate columns first; the
held experts [experts, d_in, d_out] as views of [experts, d_out, d_in]),
and the scales of its ``init_params``: projections N(0, 1/d_in), conv
taps N(0, 1/kda_conv), embeddings N(0, 0.02^2). Norm scales (the blocks',
c_kv's and KDA's output norm) are drawn N(1, 0.1^2), so that a norm that
dropped its scale would show; the router's correction bias N(0, BIAS_STD^2)
in f32, as ``weights_mla_moe.py``'s. A_log is log(A), A uniform in [1, 16],
and dt_bias the inverse softplus of a rate log-uniform in [1e-3, 0.1], both
f32: the published model's initialisation of the decay. Only the experts
``experts_held`` are drawn. Each leaf group of one scale in one layer is
one ``torch.randn`` in the served dtype on the generator's device.
"""

from __future__ import annotations

import math

import torch

from benchmark.weights import torch_dtype
from benchmark.weights_mla_moe import BIAS_STD


def make(cfg: dict, seed: int, device, dtype: torch.dtype | None = None) -> dict:
    """The parameter tree of `cfg` (a configuration file's ``model`` keys)
    from `seed`, in `dtype` (default the configuration's; A_log, dt_bias
    and the correction bias are f32 always)."""
    dtype = dtype or torch_dtype(cfg["dtype"])
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    d, h, r, vocab = cfg["d_model"], cfg["n_heads"], cfg["kv_lora_rank"], cfg["vocab_size"]
    nope, rd, dv = cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"], cfg["v_head_dim"]
    kh, kd, rank, taps = cfg["kda_heads"], cfg["kda_head_dim"], cfg["kda_gate_rank"], cfg["kda_conv"]
    p = kh * kd
    start, stop = cfg["experts_held"]
    e, m = stop - start, cfg["moe_d_ff"]
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

    def uniform(n: int) -> torch.Tensor:
        return torch.rand(n, generator=gen, device=device, dtype=torch.float32)

    blocks = []
    for i in range(cfg["n_layers"]):
        ln1, ln2 = draw([(d,), (d,)], 0.1, mean=1.0)
        blk = {"ln1_scale": ln1, "ln2_scale": ln2}
        if i + 1 in cfg["kda_layers"]:
            wqkv, wbeta, wf_a, wg_a = draw([(d, 3 * p), (d, kh), (d, rank), (d, rank)], 1.0 / math.sqrt(d))
            wf_b, wg_b = draw([(rank, p), (rank, p)], 1.0 / math.sqrt(rank))
            (conv,) = draw([(3 * p, taps)], 1.0 / math.sqrt(taps))
            (wo,) = draw([(p, d)], 1.0 / math.sqrt(p))
            (o_norm,) = draw([(kd,)], 0.1, mean=1.0)
            a = 1.0 + 15.0 * uniform(kh)
            rate = torch.exp(math.log(1e-3) + (math.log(0.1) - math.log(1e-3)) * uniform(p))
            blk.update(
                wqkv=wqkv, conv=conv, wbeta=wbeta, wf_a=wf_a, wf_b=wf_b, A_log=torch.log(a),
                dt_bias=rate + torch.log(-torch.expm1(-rate)), wg_a=wg_a, wg_b=wg_b, o_norm=o_norm, wo=wo,
            )
        else:
            (kvn,) = draw([(r,)], 0.1, mean=1.0)
            wq, wkv_a = draw([(d, h * (nope + rd)), (d, r + rd)], 1.0 / math.sqrt(d))
            (wkv_b,) = draw([(r, h * (nope + dv))], 1.0 / math.sqrt(r))
            (wo,) = draw([(h * dv, d)], 1.0 / math.sqrt(h * dv))
            blk.update(wq=wq, wkv_a=wkv_a, kv_norm=kvn, wkv_b=wkv_b, wo=wo)
        if i < cfg["first_k_dense"]:
            f = cfg["d_ff"]
            (blk["ff_gate_up"],) = draw([(d, 2 * f)], 1.0 / math.sqrt(d))
            (blk["ff_down"],) = draw([(f, d)], 1.0 / math.sqrt(f))
        else:
            router, gu, sgu = draw([(d, cfg["n_routed_experts"]), (e, 2 * m, d), (d, 2 * s)], 1.0 / math.sqrt(d))
            (down,) = draw([(e, d, m)], 1.0 / math.sqrt(m))
            (sdown,) = draw([(s, d)], 1.0 / math.sqrt(s))
            (bias,) = draw([(cfg["n_routed_experts"],)], BIAS_STD, dt=torch.float32)
            blk.update(
                router=router, router_bias=bias, experts_gate_up=gu.transpose(1, 2),
                experts_down=down.transpose(1, 2), shared_gate_up=sgu, shared_down=sdown,
            )
        blocks.append(blk)
    embed, ln_f = draw([(vocab, d)], 0.02) + draw([(d,)], 0.1, mean=1.0)
    (head,) = draw([(d, vocab)], 1.0 / math.sqrt(d))
    return {"tok_embed": embed, "ln_f_scale": ln_f, "head": head, "blocks": blocks}
