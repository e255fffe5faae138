"""Plain causal forward of the DeepSeek-V3 family (Moonlight-16B-A3B), in f32.

Written from the published description (``modeling_deepseek.py`` of
``model_type`` ``deepseek_v3``, the keys of
``benchmark/configs/moonlight-16b-a3b.json``): pre-norm blocks of RMSNorm
(eps ``norm_eps``, a learned scale, no bias); latent attention with no q
compression, q = x W_q split per head into q_nope and q_pe, [c_kv, k_pe]
= x W_kva, c_kv RMS-normed, k_nope and v = c_kv W_kvb per head, k_pe one
for all heads, RoPE (base ``rope_theta``) on q_pe and k_pe rotating the
pairs (x0, x1), (x2, x3), ... and laid out as ``apply_rotary_pos_emb``
leaves them (the pairs' first elements, then their second), scores
q_nope.k_nope + q_pe.k_pe over sqrt(nope + rope), o = ctx W_o; a SwiGLU
of width ``d_ff`` in the first ``first_k_dense`` layers and in the others
a router (f32 logits, sigmoid, the top ``n_experts_per_tok`` of the score
plus the correction bias, weights the chosen scores over their sum plus
1e-20 times ``routed_scaling_factor``) over ``n_routed_experts`` SwiGLU
experts of width ``moe_d_ff``, plus the shared experts' SwiGLU of width
``n_shared_experts * moe_d_ff``; a final RMSNorm and an untied head. The
attention is the full decompressed form and the experts a loop over the
experts, with no cache, batching or kernels; every sequence routes on its
own f32 hidden states. The parameter tree is the one
``benchmark/weights_mla_moe.py`` makes (gate and up one matrix, gate
columns first).

Departures from the published model: token ids are the port's hash
tokenizer's (a class token, then one id a word) where Moonlight has its
tiktoken vocabulary, and the weights are random from the seed.

``fp8=True`` is the control of ``reference/transformer.py``: the operands
of every projection (weight per tensor, input per row) and attention's
q, k, v and probabilities (per row of a head) rounded to float8 e4m3, the
products summed in f32. The router stays in f32, as fp8 deployments of
these models keep it.

Sequences go through the model together, one layer at a time, and each
layer's weights are widened to f32 only while it runs: the whole tree in
f32 is 64 GB at Moonlight's widths. Attention takes the queries in blocks
(each row's softmax is whole in its block), so that an 8k sequence's
scores never stand in memory at once.
"""

from __future__ import annotations

import math

import torch

from .transformer import _fp8, linear, no_tf32

__all__ = ["lm_logits", "no_tf32", "route"]

# query rows a block of attention: an 8k sequence's scores over 16 heads
# are 4.3 GB in f32 in one piece, and the fp8 control copies them four times
QUERY_BLOCK = 1024


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps) * scale


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x [s, ..., rd] at positions 0..s-1: each pair (x[2i], x[2i+1])
    turned by the angle pos * theta^(-2i / rd), written as the pairs'
    first elements, then their second."""
    s, rd = x.shape[0], x.shape[-1]
    freq = theta ** (-torch.arange(0, rd, 2, device=x.device, dtype=torch.float32) / rd)
    ang = torch.arange(s, device=x.device, dtype=torch.float32)[:, None] * freq
    shape = (s,) + (1,) * (x.dim() - 2) + (rd // 2,)
    cos, sin = ang.cos().view(shape), ang.sin().view(shape)
    xe, xo = x[..., 0::2], x[..., 1::2]
    return torch.cat((xe * cos - xo * sin, xo * cos + xe * sin), dim=-1)


def swiglu(x: torch.Tensor, gate_up: torch.Tensor, down: torch.Tensor, fp8: bool) -> torch.Tensor:
    f = gate_up.shape[-1] // 2
    gu = linear(x, gate_up, fp8)
    g, u = gu[..., :f], gu[..., f:]
    return linear(g * torch.sigmoid(g) * u, down, fp8)


def attention(x: torch.Tensor, blk: dict, m: dict, fp8: bool) -> torch.Tensor:
    """Causal latent attention of one sequence x [s, d]."""
    s = x.shape[0]
    h, nope, rd, dv, r = m["n_heads"], m["qk_nope_head_dim"], m["qk_rope_head_dim"], m["v_head_dim"], m["kv_lora_rank"]
    q = linear(x, blk["wq"], fp8).view(s, h, nope + rd)
    q = torch.cat((q[..., :nope], rope(q[..., nope:], m["rope_theta"])), dim=-1)
    kva = linear(x, blk["wkv_a"], fp8)
    c = rmsnorm(kva[:, :r], blk["kv_norm"], m["norm_eps"])
    k_pe = rope(kva[:, r:], m["rope_theta"])
    kv = linear(c, blk["wkv_b"], fp8).view(s, h, nope + dv)
    k = torch.cat((kv[..., :nope], k_pe[:, None, :].expand(s, h, rd)), dim=-1)
    v = kv[..., nope:]
    q, k, v = q.transpose(0, 1), k.transpose(0, 1), v.transpose(0, 1)  # [h, s, .]
    if fp8:
        q, k, v = _fp8(q, -1), _fp8(k, -1), _fp8(v, -1)
    ctx = torch.empty((h, s, dv), device=x.device)
    pos = torch.arange(s, device=x.device)
    for i0 in range(0, s, QUERY_BLOCK):  # the queries in blocks, each over the keys up to its last
        i1 = min(s, i0 + QUERY_BLOCK)
        scores = (q[:, i0:i1] @ k[:, :i1].transpose(-1, -2)) / math.sqrt(nope + rd)
        causal = pos[i0:i1, None] >= pos[None, :i1]
        probs = torch.softmax(scores.masked_fill(~causal, float("-inf")), dim=-1)
        if fp8:
            probs = _fp8(probs, -1)
        ctx[:, i0:i1] = probs @ v[:, :i1]
    return linear(ctx.transpose(0, 1).reshape(s, h * dv), blk["wo"], fp8)


def route(x: torch.Tensor, blk: dict, m: dict) -> tuple[torch.Tensor, torch.Tensor]:
    """The chosen experts [t, k] of tokens x [t, d] and their weights."""
    scores = torch.sigmoid(x @ blk["router"])
    chosen = torch.topk(scores + blk["router_bias"], m["n_experts_per_tok"], dim=-1).indices
    w = torch.gather(scores, 1, chosen)
    return chosen, w / (w.sum(dim=-1, keepdim=True) + 1e-20) * m["routed_scaling_factor"]


def experts(x: torch.Tensor, blk: dict, m: dict, fp8: bool) -> torch.Tensor:
    """The routed experts' weighted sum plus the shared experts, of x [t, d]."""
    chosen, w = route(x, blk, m)
    out = torch.zeros_like(x)
    for e in range(m["n_routed_experts"]):
        tok, slot = torch.nonzero(chosen == e, as_tuple=True)
        if tok.numel():
            y = swiglu(x[tok], blk["experts_gate_up"][e], blk["experts_down"][e], fp8)
            out.index_add_(0, tok, w[tok, slot, None] * y)
    return out + swiglu(x, blk["shared_gate_up"], blk["shared_down"], fp8)


def lm_logits(
    params: dict, seqs: list[list[int]], m: dict, firsts: list[int], fp8: bool = False
) -> list[torch.Tensor]:
    """Next-token logits [len(seq) - first, vocab] of each sequence, from
    its position `first` on, each a full causal forward from position 0.
    `m` is a configuration's ``model`` keys; `params` may be in any
    dtype (each leaf is widened to f32 when used)."""
    dev = params["tok_embed"].device
    ids = [torch.tensor(s, dtype=torch.long, device=dev) for s in seqs]
    xs = [params["tok_embed"][t].float() for t in ids]
    eps = m["norm_eps"]
    for blk in params["blocks"]:
        blk = {k: v.float() for k, v in blk.items()}
        xs = [x + attention(rmsnorm(x, blk["ln1_scale"], eps), blk, m, fp8) for x in xs]
        flat = rmsnorm(torch.cat(xs), blk["ln2_scale"], eps)
        if "ff_gate_up" in blk:
            ff = swiglu(flat, blk["ff_gate_up"], blk["ff_down"], fp8)
        else:
            ff = experts(flat, blk, m, fp8)
        xs = [x + f for x, f in zip(xs, ff.split([x.shape[0] for x in xs]), strict=True)]
    head = params["head"].float()
    scale = params["ln_f_scale"].float()
    return [linear(rmsnorm(x[first:], scale, eps), head, fp8) for x, first in zip(xs, firsts, strict=True)]
