"""Plain causal forward of the Kimi Linear family (Kimi-Linear-48B-A3B), in f32.

Written from the published description (the Kimi Linear technical
report, arXiv:2510.26692, and the keys of
``benchmark/configs/kimi-linear-48b-a3b.json``): pre-norm blocks of
RMSNorm (eps ``norm_eps``, a learned scale, no bias). The layers named in
``kda_layers`` (1-indexed) mix tokens by Kimi Delta Attention, the others
by latent attention without RoPE. Feed-forward: a SwiGLU of width ``d_ff``
in the first ``first_k_dense`` layers, in the others the router of
``reference/mla_moe.py`` over ``n_routed_experts`` experts, of which the
experts ``experts_held`` ([start, stop)) are computed (the share one card
of an expert-parallel deployment holds; the weights' first axis), plus the
shared experts. A final RMSNorm and an untied head.

KDA of the normed hidden states x [s, d], H heads of K = V channels:

* q, k, v = SiLU(causal depthwise conv(x W_qkv)), ``kda_conv`` taps per
  channel, no bias, zeros before the first token; per head, q and k
  divided by sqrt(sum of squares + 1e-6), q by sqrt(K) besides;
* beta = sigmoid(x W_beta); g = -exp(A_log[h]) * softplus(x W_fa W_fb +
  dt_bias), per head and key channel;
* per head a state S [K, V], zero at the first token; each token, in
  order: S <- S * exp(g_t)[:, None]; u = beta_t (v_t - S^T k_t);
  S <- S + k_t u^T; o_t = S^T q_t;
* out = (RMSNorm over V of o_t, times ``o_norm``, times sigmoid(x W_ga
  W_gb)) W_o.

The recurrence runs token by token, as it is defined, over all sequences
and heads at once (a sequence drops out of the batch at its end). Latent attention: q = x W_q split
per head into q_nope and q_pe, [c_kv, k_pe] = x W_kva with c_kv
RMS-normed, k_nope and v = c_kv W_kvb per head, k_pe one for all heads,
never rotated; scores q_nope.k_nope + q_pe.k_pe over sqrt(nope + rope),
taken in query blocks; o = ctx W_o. The parameter tree is the one
``benchmark/weights_kimi_linear.py`` makes.

Departures from the published model: token ids are the port's hash
tokenizer's, the weights random from the seed, and only the held experts
are computed (what the others would add lies on other cards).

``fp8=True`` is the control of ``reference/mla_moe.py``: the operands of
every projection and attention's q, k, v and probabilities rounded to
float8 e4m3, the products summed in f32; the router, the conv taps and
the KDA recurrence stay f32.

Sequences go through the model together, one layer at a time, each
layer's weights widened to f32 only while it runs.
"""

from __future__ import annotations

import math

import torch

from .mla_moe import QUERY_BLOCK, rmsnorm, route, swiglu
from .transformer import _fp8, linear, no_tf32

__all__ = ["lm_logits", "no_tf32"]

L2_EPS = 1e-6


def _per_head(x: torch.Tensor, heads: int) -> torch.Tensor:
    return x.view(*x.shape[:-1], heads, x.shape[-1] // heads)


def _unit(x: torch.Tensor) -> torch.Tensor:
    return x / torch.sqrt((x * x).sum(dim=-1, keepdim=True) + L2_EPS)


def kda_inputs(x: torch.Tensor, blk: dict, m: dict, fp8: bool):
    """q (scaled), k, v, g [s, H, K] and beta [s, H] of one sequence x [s, d]."""
    h, kd, taps = m["kda_heads"], m["kda_head_dim"], m["kda_conv"]
    s = x.shape[0]
    proj = linear(x, blk["wqkv"], fp8)
    padded = torch.cat((torch.zeros((taps - 1, proj.shape[1]), device=x.device), proj))
    conv = sum(padded[i:i + s] * blk["conv"][:, i] for i in range(taps))
    act = conv * torch.sigmoid(conv)
    q, k, v = (_per_head(z, h) for z in act.split(h * kd, dim=-1))
    g = linear(linear(x, blk["wf_a"], fp8), blk["wf_b"], fp8) + blk["dt_bias"]
    g = -torch.exp(blk["A_log"])[:, None] * torch.nn.functional.softplus(_per_head(g, h))
    beta = torch.sigmoid(linear(x, blk["wbeta"], fp8))
    return _unit(q) / math.sqrt(kd), _unit(k), v, g, beta


def _stacked(parts: list[torch.Tensor], T: int) -> torch.Tensor:
    """[n, T, ...] of the sequences' [s_i, ...], zero past each one's end."""
    out = torch.zeros((len(parts), T, *parts[0].shape[1:]), device=parts[0].device)
    for j, p in enumerate(parts):
        out[j, : p.shape[0]] = p
    return out


def kda(xs: list[torch.Tensor], blk: dict, m: dict, fp8: bool) -> list[torch.Tensor]:
    """The KDA layer's output of each sequence x [s, d] (normed). The
    sequences run longest first, and at token t only those longer than t
    are updated (the first rows of the state)."""
    lens = [x.shape[0] for x in xs]
    order = sorted(range(len(xs)), key=lambda j: -lens[j])
    T = lens[order[0]]
    ins = [kda_inputs(xs[j], blk, m, fp8) for j in order]
    q, k, v, g, beta = (_stacked([z[i] for z in ins], T) for i in range(5))
    del ins
    decay = torch.exp(g)
    n, _, h, kd = k.shape
    state = torch.zeros((n, h, kd, v.shape[-1]), device=k.device)
    o = torch.empty_like(v)
    for t in range(T):
        a = sum(lens[j] > t for j in order)  # the sequences still running
        s = state[:a]
        s.mul_(decay[:a, t, :, :, None])
        u = beta[:a, t, :, None] * (v[:a, t] - (k[:a, t, :, None, :] @ s)[:, :, 0])
        s.add_(k[:a, t, :, :, None] * u[:, :, None, :])
        o[:a, t] = (q[:a, t, :, None, :] @ s)[:, :, 0]
    o = o[torch.argsort(torch.tensor(order))]
    out = []
    for j, x in enumerate(xs):
        oj = rmsnorm(o[j, : lens[j]], blk["o_norm"], m["norm_eps"])
        gate = torch.sigmoid(_per_head(linear(linear(x, blk["wg_a"], fp8), blk["wg_b"], fp8), h))
        out.append(linear((oj * gate).reshape(lens[j], -1), blk["wo"], fp8))
    return out


def attention(x: torch.Tensor, blk: dict, m: dict, fp8: bool) -> torch.Tensor:
    """Causal latent attention of one sequence x [s, d], the rope dims unrotated."""
    s = x.shape[0]
    h, nope, rd, dv, r = m["n_heads"], m["qk_nope_head_dim"], m["qk_rope_head_dim"], m["v_head_dim"], m["kv_lora_rank"]
    q = linear(x, blk["wq"], fp8).view(s, h, nope + rd)
    kva = linear(x, blk["wkv_a"], fp8)
    c = rmsnorm(kva[:, :r], blk["kv_norm"], m["norm_eps"])
    kv = linear(c, blk["wkv_b"], fp8).view(s, h, nope + dv)
    k = torch.cat((kv[..., :nope], kva[:, None, r:].expand(s, h, rd)), dim=-1)
    q, k, v = q.transpose(0, 1), k.transpose(0, 1), kv[..., nope:].transpose(0, 1)  # [h, s, .]
    if fp8:
        q, k, v = _fp8(q, -1), _fp8(k, -1), _fp8(v, -1)
    ctx = torch.empty((h, s, dv), device=x.device)
    pos = torch.arange(s, device=x.device)
    for i0 in range(0, s, QUERY_BLOCK):
        i1 = min(s, i0 + QUERY_BLOCK)
        scores = (q[:, i0:i1] @ k[:, :i1].transpose(-1, -2)) / math.sqrt(nope + rd)
        causal = pos[i0:i1, None] >= pos[None, :i1]
        probs = torch.softmax(scores.masked_fill(~causal, float("-inf")), dim=-1)
        if fp8:
            probs = _fp8(probs, -1)
        ctx[:, i0:i1] = probs @ v[:, :i1]
    return linear(ctx.transpose(0, 1).reshape(s, h * dv), blk["wo"], fp8)


def experts(x: torch.Tensor, blk: dict, m: dict, fp8: bool) -> torch.Tensor:
    """The held experts' weighted sum plus the shared experts, of x [t, d]:
    the router chooses among all ``n_routed_experts``."""
    chosen, w = route(x, blk, m)
    start, stop = m["experts_held"]
    out = torch.zeros_like(x)
    for e in range(start, stop):
        tok, slot = torch.nonzero(chosen == e, as_tuple=True)
        if tok.numel():
            y = swiglu(x[tok], blk["experts_gate_up"][e - start], blk["experts_down"][e - start], fp8)
            out.index_add_(0, tok, w[tok, slot, None] * y)
    return out + swiglu(x, blk["shared_gate_up"], blk["shared_down"], fp8)


def lm_logits(
    params: dict, seqs: list[list[int]], m: dict, firsts: list[int], fp8: bool = False
) -> list[torch.Tensor]:
    """Next-token logits [len(seq) - first, vocab] of each sequence, from
    its position `first` on, each a full causal forward from position 0.
    `m` is a configuration's ``model`` keys; `params` may be in any dtype."""
    dev = params["tok_embed"].device
    xs = [params["tok_embed"][torch.tensor(s, dtype=torch.long, device=dev)].float() for s in seqs]
    eps = m["norm_eps"]
    for li, blk in enumerate(params["blocks"]):
        blk = {k: v.float() for k, v in blk.items()}
        normed = [rmsnorm(x, blk["ln1_scale"], eps) for x in xs]
        if li + 1 in m["kda_layers"]:
            mixed = kda(normed, blk, m, fp8)
        else:
            mixed = [attention(x, blk, m, fp8) for x in normed]
        xs = [x + y for x, y in zip(xs, mixed, strict=True)]
        flat = rmsnorm(torch.cat(xs), blk["ln2_scale"], eps)
        if "ff_gate_up" in blk:
            ff = swiglu(flat, blk["ff_gate_up"], blk["ff_down"], fp8)
        else:
            ff = experts(flat, blk, m, fp8)
        xs = [x + f for x, f in zip(xs, ff.split([x.shape[0] for x in xs]), strict=True)]
    head = params["head"].float()
    scale = params["ln_f_scale"].float()
    return [linear(rmsnorm(x[first:], scale, eps), head, fp8) for x, first in zip(xs, firsts, strict=True)]
