"""Kimi Linear causal decoder: Kimi Delta Attention (KDA) layers and their
recurrent state beside latent attention (MLA) in one slot cache, and a
layer of routed and shared experts that holds a share of the experts.

The block of Kimi-Linear-48B-A3B (``model_type`` ``kimi_linear``; the Kimi
Linear technical report, arXiv:2510.26692), with the parameter layout and
rounding points of ``models/deepseek.py``, whose latent attention, router,
experts and head it reuses. Layers ``kda_layers`` (1-indexed, as
published) mix tokens by KDA; the others by MLA without RoPE
(``mla_use_nope``: the rope dims are projected, cached and scored, never
rotated). The first ``first_k_dense`` layers hold a dense SwiGLU, the
others the experts. Pre-norm blocks, RMSNorm eps ``norm_eps``.

**KDA** of the normed hidden states x [t, d], H heads of K = V channels:

* q, k, v = SiLU(causal depthwise conv(x W_q | x W_k | x W_v)), a conv of
  ``kda_conv`` taps without bias, in f32 over the projections; split into
  heads, q and k L2-normalized per head (x / sqrt(sum x^2 + 1e-6)), q
  scaled by 1/sqrt(K).
* beta = sigmoid(x W_beta) per head; the log-decay g = -exp(A_log[h]) *
  softplus(x W_fa W_fb + dt_bias) per head and key channel (W_fa [d, r],
  W_fb [r, H * K], r = ``kda_gate_rank``).
* Per head a state S [K, V] (key by value), f32; each token:
  S <- S * exp(g_t)[:, None];  u = beta_t (v_t - S^T k_t);
  S <- S + k_t u^T;  o_t = S^T q_t.
* out = (RMSNorm(o_t) * w_o_norm * sigmoid(x W_ga W_gb)) W_o, the norm per
  head over V (W_ga [d, r], W_gb [r, H * V]).

A decode step takes that update once a row (:func:`_kda_step`). A prefill
takes its chunked form (:func:`_kda_chunked`): in a chunk of ``CHUNK``
tokens with G the cumulative log-decay inside it, the state's updates are
U = (I + diag(beta) A)^-1 diag(beta) (V - (exp(G) * K) S0), A the strictly
lower k_t . k_j exp(G_t - G_j) (j < t), and O = (exp(G) * Q) S0 + B U, B
the lower q_t . k_j exp(G_t - G_j) (j <= t); the state leaves the chunk as
exp(G_C) * S0 + (exp(G_C - G) * K)^T U. Every exponent formed is G_t -
G_j with t at or after j, never -G alone (which overflows f32 at the
decays A_log allows), and it is summed from the g between j and t, never
taken as the difference of two long sums (which loses digits when the
decays are large): pairs inside a sub-chunk of ``SUB`` tokens sum their
own span ([SUB, SUB, K] a sub-chunk), pairs across sub-chunks go through
the boundary m between them, exp(G_t - G_m) exp(G_m - G_j). The chunks'
terms are computed together, a segment of ``SEGMENT`` tokens at a time,
and the state runs across the chunks in order.

**The slot cache** (:func:`init_kv_cache`) holds the MLA layers' latent
rows [mla layers, slots, max_len, kv_lora_rank + rope] in ``dtype``,
each KDA layer's state [kda layers, slots, H, K, V] in f32 and its conv
tail, the last ``kda_conv - 1`` projected inputs of q, k and v [kda
layers, slots, kda_conv - 1, 3 H K] in ``dtype``. A slot's prefill
overwrites its state and tail (the state starts from zero: a new request
never adds to the last one's) and writes its latent rows; decode reads a
slot's latent rows from its first real position, as ``deepseek`` does.

**Held experts.** ``experts_held`` is the range of routed experts whose
weights this model holds (the weights' first axis; default all): the
router keeps its ``n_routed_experts`` outputs and top-k, and
``deepseek._moe`` computes the choices that fall among the held experts
(a deployment by expert parallelism, each card its share, run here
without the exchange); the step's counters count those choices.

Each KDA layer runs inside the span ``lm.kda``, each MLA layer inside
``lm.mla`` and each feed-forward inside ``lm.moe`` (``internals/spans.py``).
The continuous batcher counts ``kda_tokens`` (``SCAN_COUNTER``: prompt
tokens scanned and decode rows) on the host.

Left out, as for ``deepseek``: sampled generation, the wave-aligned
serving path and the mesh-spanning slot pool (``TorchLMChat`` and the
batcher raise), tensor and sequence parallelism, training.
"""

from __future__ import annotations

import dataclasses
import math
from typing import ClassVar

import torch
import torch.nn.functional as F

from pathway_tpu_torch.engine.device_plane import resolve_device
from pathway_tpu_torch.internals import spans as _spans
from pathway_tpu_torch.models import deepseek
from pathway_tpu_torch.models.deepseek import _attend_absorbed, _attend_prefill, _ffn, _latent, _logits
from pathway_tpu_torch.models.transformer import Params, _f32_matmul, _normal, _rmsnorm

# the counters of cache["counts"], in order (over the held experts)
STEP_COUNTERS = deepseek.STEP_COUNTERS
# no phase is replayed from a CUDA graph: a replay runs none of the Python
# that opens the lm.kda, lm.mla and lm.moe spans
GRAPH_PHASES: dict = {}
# the batcher's count of tokens the KDA layers scan (prompt tokens, decode rows)
SCAN_COUNTER = "kda_tokens"

CHUNK = 64  # tokens a chunk of the prefill's chunked form
SUB = 8  # tokens a sub-chunk, whose pairs sum their own span of decays
SEGMENT = 2048  # tokens whose chunks' terms are computed together
L2_EPS = 1e-6
# parameters held in f32 whatever the serving dtype
F32_LEAVES = ("router_bias", "A_log", "dt_bias")

KDA_LAYERS = (1, 2, 3, 5, 6, 7, 9, 10, 11, 13, 14, 15, 17, 18, 19, 21, 22, 23, 25, 26)


@dataclasses.dataclass(frozen=True)
class KimiLinearConfig:
    """The published keys of a ``kimi_linear`` config (defaults:
    Kimi-Linear-48B-A3B's, all 256 experts held and 16,384 positions)."""

    vocab_size: int = 163840
    d_model: int = 2304
    n_heads: int = 32  # MLA heads
    n_layers: int = 27
    d_ff: int = 9216  # the dense layers' SwiGLU width (intermediate_size)
    max_len: int = 16384
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    mla_rope: ClassVar[bool] = False  # mla_use_nope: the rope dims are never rotated
    kda_layers: tuple[int, ...] = KDA_LAYERS  # 1-indexed; the others are MLA
    kda_heads: int = 32
    kda_head_dim: int = 128
    kda_conv: int = 4
    kda_gate_rank: int = 128  # the decay's and the output gate's low rank
    n_routed_experts: int = 256
    n_experts_per_tok: int = 8
    n_shared_experts: int = 1
    moe_d_ff: int = 1024
    first_k_dense: int = 1
    routed_scaling_factor: float = 2.446
    norm_eps: float = 1e-5
    experts_held: range | None = None  # None: all of them
    dtype: torch.dtype = torch.bfloat16

    @property
    def qk_head_dim(self) -> int:
        return self.qk_nope_head_dim + self.qk_rope_head_dim

    @property
    def latent_dim(self) -> int:
        """Width of a latent cache row: the normed c_kv, then k_pe."""
        return self.kv_lora_rank + self.qk_rope_head_dim

    @property
    def kda_width(self) -> int:
        return self.kda_heads * self.kda_head_dim

    @property
    def layer_slots(self) -> tuple[tuple[str, int], ...]:
        """Each layer's kind, ``"kda"`` or ``"mla"``, and its index among
        the layers of its kind (its row of the cache)."""
        seen = {"kda": 0, "mla": 0}
        out = []
        for li in range(self.n_layers):
            kind = "kda" if li + 1 in self.kda_layers else "mla"
            out.append((kind, seen[kind]))
            seen[kind] += 1
        return tuple(out)

    def __post_init__(self) -> None:
        if self.experts_held is None:
            object.__setattr__(self, "experts_held", range(self.n_routed_experts))
        held = self.experts_held
        if held.step != 1 or not 0 <= held.start < held.stop <= self.n_routed_experts:
            raise ValueError("experts_held must be a non-empty range inside [0, n_routed_experts)")
        if not all(1 <= i <= self.n_layers for i in self.kda_layers):
            raise ValueError("kda_layers are 1-indexed layers in [1, n_layers]")
        if not 0 <= self.first_k_dense <= self.n_layers:
            raise ValueError("first_k_dense must lie in [0, n_layers]")
        if not 1 <= self.n_experts_per_tok <= self.n_routed_experts:
            raise ValueError("n_experts_per_tok must lie in [1, n_routed_experts]")
        if self.kda_conv < 2:
            raise ValueError("kda_conv must be at least 2")


# ------------------------------------------------------------------ params


def _kda_block(gen: torch.Generator, cfg: KimiLinearConfig, dtype: torch.dtype) -> Params:
    d, h, r = cfg.d_model, cfg.kda_heads, cfg.kda_gate_rank
    p = cfg.kda_width
    dev = gen.device
    # the published initialisation of the decay: A in [1, 16], and dt_bias
    # the inverse softplus of a rate in [1e-3, 0.1] (log-uniform)
    a = 1.0 + 15.0 * torch.rand(h, generator=gen, device=dev)
    dt = torch.exp(math.log(1e-3) + (math.log(0.1) - math.log(1e-3)) * torch.rand(p, generator=gen, device=dev))
    return {
        "wqkv": _normal(gen, (d, 3 * p), 1.0 / math.sqrt(d), dtype),
        "conv": _normal(gen, (3 * p, cfg.kda_conv), 1.0 / math.sqrt(cfg.kda_conv), dtype),
        "wbeta": _normal(gen, (d, h), 1.0 / math.sqrt(d), dtype),
        "wf_a": _normal(gen, (d, r), 1.0 / math.sqrt(d), dtype),
        "wf_b": _normal(gen, (r, p), 1.0 / math.sqrt(r), dtype),
        "A_log": torch.log(a),
        "dt_bias": dt + torch.log(-torch.expm1(-dt)),
        "wg_a": _normal(gen, (d, r), 1.0 / math.sqrt(d), dtype),
        "wg_b": _normal(gen, (r, p), 1.0 / math.sqrt(r), dtype),
        "o_norm": torch.ones(cfg.kda_head_dim, device=dev, dtype=dtype),
        "wo": _normal(gen, (p, d), 1.0 / math.sqrt(p), dtype),
    }


def _mla_block(gen: torch.Generator, cfg: KimiLinearConfig, dtype: torch.dtype) -> Params:
    d, h, r = cfg.d_model, cfg.n_heads, cfg.kv_lora_rank
    return {
        "wq": _normal(gen, (d, h * cfg.qk_head_dim), 1.0 / math.sqrt(d), dtype),
        "wkv_a": _normal(gen, (d, cfg.latent_dim), 1.0 / math.sqrt(d), dtype),
        "kv_norm": torch.ones(r, device=gen.device, dtype=dtype),
        "wkv_b": _normal(gen, (r, h * (cfg.qk_nope_head_dim + cfg.v_head_dim)), 1.0 / math.sqrt(r), dtype),
        "wo": _normal(gen, (h * cfg.v_head_dim, d), 1.0 / math.sqrt(h * cfg.v_head_dim), dtype),
    }


def _ffn_block(gen: torch.Generator, cfg: KimiLinearConfig, dense: bool, dtype: torch.dtype) -> Params:
    d = cfg.d_model
    if dense:
        f = cfg.d_ff
        return {
            "ff_gate_up": _normal(gen, (d, 2 * f), 1.0 / math.sqrt(d), dtype),
            "ff_down": _normal(gen, (f, d), 1.0 / math.sqrt(f), dtype),
        }
    e, m, s = len(cfg.experts_held), cfg.moe_d_ff, cfg.n_shared_experts * cfg.moe_d_ff
    return {
        "router": _normal(gen, (d, cfg.n_routed_experts), 1.0 / math.sqrt(d), dtype),
        "router_bias": torch.zeros(cfg.n_routed_experts, device=gen.device, dtype=torch.float32),
        # the held experts, [experts, d_in, d_out] as views of [experts, d_out, d_in]
        "experts_gate_up": _normal(gen, (e, 2 * m, d), 1.0 / math.sqrt(d), dtype).transpose(1, 2),
        "experts_down": _normal(gen, (e, d, m), 1.0 / math.sqrt(m), dtype).transpose(1, 2),
        "shared_gate_up": _normal(gen, (d, 2 * s), 1.0 / math.sqrt(d), dtype),
        "shared_down": _normal(gen, (s, d), 1.0 / math.sqrt(s), dtype),
    }


def init_params(
    generator: torch.Generator, cfg: KimiLinearConfig, dtype: torch.dtype = torch.float32
) -> Params:
    """Random parameters on the generator's device, leaf by leaf (as
    ``deepseek.init_params``): projections N(0, 1/d_in), conv taps
    N(0, 1/kda_conv), embeddings N(0, 0.02^2), norm scales 1, the
    router's correction bias 0; A_log and dt_bias as published, in f32."""
    d = cfg.d_model
    blocks = []
    for li, (kind, _) in enumerate(cfg.layer_slots):
        blk = {
            "ln1_scale": torch.ones(d, device=generator.device, dtype=dtype),
            "ln2_scale": torch.ones(d, device=generator.device, dtype=dtype),
        }
        blk.update(_kda_block(generator, cfg, dtype) if kind == "kda" else _mla_block(generator, cfg, dtype))
        blk.update(_ffn_block(generator, cfg, li < cfg.first_k_dense, dtype))
        blocks.append(blk)
    return {
        "tok_embed": _normal(generator, (cfg.vocab_size, d), 0.02, dtype),
        "ln_f_scale": torch.ones(d, device=generator.device, dtype=dtype),
        "head": _normal(generator, (d, cfg.vocab_size), 1.0 / math.sqrt(d), dtype),
        "blocks": blocks,
    }


def cast_params(params: Params, dtype: torch.dtype = torch.bfloat16) -> Params:
    """Serving parameters: floating leaves cast once to `dtype`, but for
    the router's correction bias, A_log and dt_bias, which stay f32."""
    return deepseek.cast_params(params, dtype, keep=F32_LEAVES)


# --------------------------------------------------------------------- KDA


def _l2norm(x: torch.Tensor) -> torch.Tensor:
    return x * torch.rsqrt((x * x).sum(dim=-1, keepdim=True) + L2_EPS)


def _kda_inputs(x: torch.Tensor, blk: Params, cfg: KimiLinearConfig, tail: torch.Tensor):
    """The KDA layer's inputs of x [b, t, d] (normed), after the `tail` [b,
    kda_conv - 1, 3 H K] of projected inputs before it: q (scaled), k, v,
    g [b, t, H, K] and beta [b, t, H], in f32, and the new tail (the last
    kda_conv - 1 projected inputs)."""
    dt, h, kd = cfg.dtype, cfg.kda_heads, cfg.kda_head_dim
    c = cfg.kda_conv
    xp = torch.cat((tail, torch.matmul(x, blk["wqkv"].to(dt))), dim=1)  # [b, c - 1 + t, 3HK]
    t = xp.shape[1] - c + 1
    w = blk["conv"].float()
    conv = xp[:, :t].float() * w[:, 0]
    for i in range(1, c):
        conv = conv + xp[:, i:i + t].float() * w[:, i]
    q, k, v = F.silu(conv).unflatten(-1, (3, h, kd)).unbind(-3)
    q = _l2norm(q) / math.sqrt(kd)
    k = _l2norm(k)
    f = _f32_matmul(torch.matmul(x, blk["wf_a"].to(dt)), blk["wf_b"].to(dt)).unflatten(-1, (h, kd))
    g = -torch.exp(blk["A_log"].float())[:, None] * F.softplus(f + blk["dt_bias"].float().view(h, kd))
    beta = torch.sigmoid(_f32_matmul(x, blk["wbeta"].to(dt)))
    return q, k, v, g, beta, xp[:, t:]


def _kda_out(o: torch.Tensor, x: torch.Tensor, blk: Params, cfg: KimiLinearConfig) -> torch.Tensor:
    """The layer's output [..., d] of the heads' o [..., H, V] (f32) and
    its normed input x [..., d]: the gated per-head norm, then W_o."""
    dt = cfg.dtype
    gate = _f32_matmul(torch.matmul(x, blk["wg_a"].to(dt)), blk["wg_b"].to(dt))
    o = _rmsnorm(o, blk["o_norm"].float(), cfg.norm_eps) * torch.sigmoid(gate.unflatten(-1, o.shape[-2:]))
    return torch.matmul(o.flatten(-2).to(dt), blk["wo"].to(dt))


def _after(g: torch.Tensor) -> torch.Tensor:
    """sum of g over the positions after each one, along dim -2: summed from
    the end, so that a short sum is not the difference of two long ones."""
    rev = g.flip(-2).cumsum(dim=-2).flip(-2)
    return torch.cat((rev[..., 1:, :], torch.zeros_like(rev[..., :1, :])), dim=-2)


def _pairs(q: torch.Tensor, k: torch.Tensor, g: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The pair terms of each chunk, A of keys with keys and B of queries
    with keys: A_tj = sum_c k_t[c] k_j[c] exp(G_t[c] - G_j[c]) over j <= t
    and B_tj the same of q_t, else 0, [..., C, C] each, of q, k and the
    log-decays g [..., C, K]. (A's diagonal, k_t . k_t, is read by no
    caller: the triangular solve takes its unit diagonal as given.) Every
    exponent is a sum of the g between j and t, never a difference of two
    long sums (module docstring); the decays are formed once for both."""
    *lead, C, K = k.shape
    m = C // SUB
    q_, k_, g_ = (z.view(*lead, m, SUB, K) for z in (q, k, g))
    # across sub-chunks, through the boundary before the query's sub-chunk
    # u: exp(sum of g from u's start to t) exp(sum of g after j to u's start)
    into = g_.cumsum(dim=-2)  # [.., m, SUB, K]
    grow = torch.exp(into)
    total = into[..., -1, :]  # [.., m, K]: each sub-chunk's sum
    w = torch.arange(m, device=k.device)
    between = ((w[None, None, :] > w[None, :, None]) & (w[None, None, :] < w[:, None, None])).to(g.dtype)
    gap = torch.einsum("uvw,...wk->...uvk", between, total)  # the sub-chunks between v and u
    expo = _after(g_)[..., None, :, :, :] + gap[..., :, :, None, :]  # [.., m(u), m(v), SUB, K]
    earlier = (w[None, :] < w[:, None])[:, :, None, None]
    k_side = k_[..., None, :, :, :] * torch.exp(torch.where(earlier, expo, -torch.inf))
    rows = torch.cat((k_ * grow, q_ * grow), dim=-2)  # [.., m, 2 SUB, K]: A's rows, then B's
    cross = torch.matmul(rows, k_side.reshape(*lead, m, C, K).transpose(-1, -2))  # [.., m, 2 SUB, C]
    # inside a sub-chunk: each pair's exponent the sum of g over (j, t]
    i = torch.arange(SUB, device=k.device)
    after_j = (i[:, None] > i[None, :])[..., None]  # [t, j, 1]
    span = torch.where(after_j, g_[..., :, None, :], 0.0).cumsum(dim=-3)  # [.., m, t, j, K]
    decayed = torch.where((i[:, None] >= i[None, :])[..., None], span, -torch.inf).exp_()
    decayed.mul_(k_[..., None, :, :])  # k_j decayed to t
    n = decayed.numel() // (SUB * K)
    own = torch.bmm(decayed.view(n, SUB, K), torch.stack((k_, q_), dim=-1).view(n, K, 2))
    own = own.view(*lead, m, SUB, SUB, 2)  # [.., m, t, j, (A, B)]
    out = []
    for part, x in enumerate(cross.split(SUB, dim=-2)):
        x = x.contiguous().view(*lead, m, SUB, m, SUB)
        x.diagonal(dim1=-4, dim2=-2).add_(own[..., part].movedim(-3, -1))
        out.append(x.view(*lead, C, C))
    return out[0], out[1]


def _kda_chunked(q, k, v, g, beta, state: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The chunked form of the KDA recurrence over q, k, g [B, H, T, K], v
    [B, H, T, V], beta [B, H, T] (f32) from the state [B, H, K, V] (f32):
    returns o [B, H, T, V] and the state after the last token. A chunk
    that the sequence does not fill is padded with tokens of zero k, v,
    g and beta, which leave the state as it is."""
    B, H, T, K = k.shape
    V = v.shape[-1]
    pad = (-T) % CHUNK
    if pad:
        q, k, v, g = (F.pad(z, (0, 0, 0, pad)) for z in (q, k, v, g))
        beta = F.pad(beta, (0, pad))
    n = (T + pad) // CHUNK
    q, k, v, g = (z.reshape(B, H, n, CHUNK, -1) for z in (q, k, v, g))
    beta = beta.reshape(B, H, n, CHUNK, 1)
    outs = []
    per = SEGMENT // CHUNK
    for c0 in range(0, n, per):
        seg = slice(c0, min(n, c0 + per))
        o, state = _kda_segment(q[:, :, seg], k[:, :, seg], v[:, :, seg], g[:, :, seg], beta[:, :, seg], state)
        outs.append(o)
    o = torch.cat(outs, dim=2).view(B, H, n * CHUNK, V)
    return o[:, :, :T], state


def _kda_segment(q, k, v, g, beta, state):
    """:func:`_kda_chunked` over n whole chunks, [B, H, n, C, .]."""
    B, H, n, C, K = k.shape
    V = v.shape[-1]
    decay = torch.exp(g.cumsum(dim=-2))  # from the chunk's start to each token
    kk, qk = _pairs(q, k, g)
    A = beta * kk
    rhs = beta * torch.cat((decay * k, v), dim=-1)
    # (I + diag(beta) A) [W | U0] = diag(beta) [exp(G) K | V]; the unit diagonal is implied
    W, U0 = torch.linalg.solve_triangular(A, rhs, upper=False, unitriangular=True).split((K, V), dim=-1)
    k_end = (torch.exp(_after(g)) * k).transpose(-1, -2)  # [B, H, n, K, C]: each key decayed to the chunk's end
    # the state across the chunks, in order: chunk-major, heads flattened
    W, U0, k_end = (z.movedim(2, 0).reshape(n, B * H, *z.shape[-2:]) for z in (W, U0, k_end))
    g_end = decay[..., -1:, :].movedim(2, 0).reshape(n, B * H, K, 1)
    states = torch.empty((n + 1, B * H, K, V), dtype=torch.float32, device=k.device)
    states[0] = state.reshape(B * H, K, V)
    U = torch.empty_like(U0)
    for i in range(n):
        torch.baddbmm(U0[i], W[i], states[i], alpha=-1.0, out=U[i])
        torch.mul(states[i], g_end[i], out=states[i + 1])
        states[i + 1].baddbmm_(k_end[i], U[i])
    U = U.view(n, B, H, C, V).movedim(0, 2)
    before = states[:-1].view(n, B, H, K, V).movedim(0, 2)
    o = torch.matmul(decay * q, before) + torch.matmul(qk, U)
    return o, states[n].view(B, H, K, V)


def _kda_prefill(x: torch.Tensor, blk: Params, cfg: KimiLinearConfig):
    """A KDA layer over rows x [b, t, d] (normed, every token real) from a
    zero state and tail: (output [b, t, d], the state [b, H, K, V] f32 and
    the conv tail after the last token)."""
    b = x.shape[0]
    h, kd = cfg.kda_heads, cfg.kda_head_dim
    tail = torch.zeros((b, cfg.kda_conv - 1, 3 * cfg.kda_width), dtype=x.dtype, device=x.device)
    q, k, v, g, beta, tail = _kda_inputs(x, blk, cfg, tail)
    state = torch.zeros((b, h, kd, kd), dtype=torch.float32, device=x.device)
    heads = (z.transpose(1, 2) for z in (q, k, v, g, beta))
    o, state = _kda_chunked(*heads, state)
    return _kda_out(o.transpose(1, 2), x, blk, cfg), state, tail


def _kda_step(x: torch.Tensor, blk: Params, cfg: KimiLinearConfig, state: torch.Tensor, tail: torch.Tensor):
    """One token a row, x [b, d] (normed): the recurrence's update of the
    rows' `state` [b, H, K, V] and conv `tail` in place; returns the
    layer's output [b, d]."""
    b = x.shape[0]
    h, kd = cfg.kda_heads, cfg.kda_head_dim
    q, k, v, g, beta, new_tail = _kda_inputs(x[:, None], blk, cfg, tail)
    tail.copy_(new_tail)
    q, k, v, g = (z[:, 0] for z in (q, k, v, g))  # [b, H, K]
    state.mul_(torch.exp(g)[..., None])
    flat = state.view(b * h, kd, kd)
    kS = torch.bmm(k.reshape(b * h, 1, kd), flat).view(b, h, kd)
    u = beta[:, 0, :, None] * (v - kS)
    flat.baddbmm_(k.reshape(b * h, kd, 1), u.reshape(b * h, 1, kd))
    o = torch.bmm(q.reshape(b * h, 1, kd), flat).view(b, h, kd)
    return _kda_out(o, x, blk, cfg)


# ----------------------------------------------------------------- forward


def _prefill_hidden(
    params: Params, ids: torch.Tensor, cache: Params | None, cfg: KimiLinearConfig, start: int = 0
) -> torch.Tensor:
    """Final-normed hidden states [b, p, d] of rows ids [b, p], every
    token real: each KDA layer from a zero state, its state and conv tail
    written to ``cache["kda_state"]``/``["kda_conv"]``, each MLA layer's
    latent rows to positions start..start+p-1 of ``cache["latent"]``,
    when a cache is given."""
    b, p = ids.shape
    if start + p > cfg.max_len:
        raise ValueError(f"prompt length {start + p} exceeds max_len={cfg.max_len}")
    dt = cfg.dtype
    x = params["tok_embed"].to(dt)[ids]
    for blk, (kind, i) in zip(params["blocks"], cfg.layer_slots, strict=True):
        h = _rmsnorm(x, blk["ln1_scale"], cfg.norm_eps)
        if kind == "kda":
            with _spans.span("lm.kda"):
                out, state, tail = _kda_prefill(h, blk, cfg)
                if cache is not None:
                    cache["kda_state"][i].copy_(state)
                    cache["kda_conv"][i].copy_(tail)
                x = x + out
        else:
            with _spans.span("lm.mla"):
                q, rows = _latent(h, blk, cfg, None, None)
                if cache is not None:
                    cache["latent"][i, :, start:start + p].copy_(rows)
                x = x + torch.matmul(_attend_prefill(q, rows, None, blk, cfg), blk["wo"].to(dt))
        with _spans.span("lm.moe"):
            x = x + _ffn(_rmsnorm(x, blk["ln2_scale"], cfg.norm_eps), blk, cfg)[0]
    return _rmsnorm(x, params["ln_f_scale"], cfg.norm_eps)


def logits(params: Params, token_ids: torch.Tensor, cfg: KimiLinearConfig) -> torch.Tensor:
    """LM logits [b, s, vocab] (f32) of a full causal forward of rows
    [b, s] with no padding (KDA in its chunked form)."""
    return _logits(_prefill_hidden(params, token_ids.long(), None, cfg), params, cfg)


def init_kv_cache(
    cfg: KimiLinearConfig, batch: int, device: str | torch.device | None = None
) -> Params:
    """A zeroed slot cache for `batch` rows: the MLA layers' latent rows,
    the KDA layers' f32 states and conv tails, and the decode step's
    counters (int64 [3], ``STEP_COUNTERS``)."""
    dev = resolve_device(device)
    n_kda = sum(kind == "kda" for kind, _ in cfg.layer_slots)
    kd = cfg.kda_head_dim
    return {
        "latent": torch.zeros(
            (cfg.n_layers - n_kda, batch, cfg.max_len, cfg.latent_dim), dtype=cfg.dtype, device=dev
        ),
        "kda_state": torch.zeros((n_kda, batch, cfg.kda_heads, kd, kd), dtype=torch.float32, device=dev),
        "kda_conv": torch.zeros(
            (n_kda, batch, cfg.kda_conv - 1, 3 * cfg.kda_width), dtype=cfg.dtype, device=dev
        ),
        "counts": torch.zeros(len(STEP_COUNTERS), dtype=torch.int64, device=dev),
    }


def _decode(
    params: Params, cache: Params, token: torch.Tensor, pos: torch.Tensor, pad_len: torch.Tensor,
    cfg: KimiLinearConfig,
) -> torch.Tensor:
    """Logits [b, vocab] f32 of one token a row: row i consumes token[i],
    updates its KDA states and conv tails, writes its latent rows at
    pos[i] and attends over [pad_len[i], pos[i]] of them. The step's
    expert counters go to ``cache["counts"]``."""
    b = token.shape[0]
    dt = cfg.dtype
    x = params["tok_embed"].to(dt)[token]
    j = torch.arange(cfg.max_len, device=token.device)[None, :]
    key_ok = (j <= pos[:, None]) & (j >= pad_len[:, None])
    rows = torch.arange(b, device=token.device)
    counted = pos > 0  # a row at position 0 is an empty slot
    loads = []
    for blk, (kind, i) in zip(params["blocks"], cfg.layer_slots, strict=True):
        h = _rmsnorm(x, blk["ln1_scale"], cfg.norm_eps)
        if kind == "kda":
            with _spans.span("lm.kda"):
                x = x + _kda_step(h, blk, cfg, cache["kda_state"][i], cache["kda_conv"][i])
        else:
            with _spans.span("lm.mla"):
                q, row = _latent(h, blk, cfg, None, None)
                cache["latent"][i, rows, pos] = row
                ctx = _attend_absorbed(q, cache["latent"][i], key_ok, blk, cfg)
                x = x + torch.matmul(ctx, blk["wo"].to(dt))
        with _spans.span("lm.moe"):
            out, load = _ffn(_rmsnorm(x, blk["ln2_scale"], cfg.norm_eps), blk, cfg, counted)
            x = x + out
        if load is not None:
            loads.append(load)
    if loads:
        load = torch.stack(loads)  # [moe layers, held experts]
        cache["counts"].copy_(torch.stack((load.sum(), (load > 0).sum(), load.amax(dim=1).sum())))
    return _logits(_rmsnorm(x, params["ln_f_scale"], cfg.norm_eps), params, cfg)


def decode_step_slots(
    params: Params,
    cache: Params,
    token: torch.Tensor,  # [b] — the token each slot consumes this step
    pos: torch.Tensor,  # [b] — per-slot physical write position
    pad_len: torch.Tensor,  # [b] — per-slot left-pad length
    cfg: KimiLinearConfig,
) -> tuple[torch.Tensor, Params]:
    """One decode step of independent rows (continuous batching), as
    ``deepseek.decode_step_slots``: every slot's KDA states updated once,
    the absorbed latent attention. Returns (next token [b], cache); argmax
    over f32 logits."""
    return torch.argmax(_decode(params, cache, token, pos, pad_len, cfg), dim=-1), cache


def prefill_into_slot(
    params: Params,
    prompt_ids: torch.Tensor,  # [1, P] LEFT-padded (pad_left_rows convention)
    prompt_mask: torch.Tensor,  # [1, P] 1/0
    cache: Params,  # multi-slot serving cache (init_kv_cache shape)
    slot: int | torch.Tensor,  # which cache row this request owns (a host scalar)
    cfg: KimiLinearConfig,
) -> tuple[torch.Tensor, Params]:
    """Prefill ONE request into row `slot`: the prompt's real tokens alone,
    its latent rows written from its first real position on, its KDA
    states and conv tails overwritten (never added to what the slot's
    last request left). Returns (first token [1], cache); argmax."""
    slot = int(slot)
    if not 0 <= slot < cache["latent"].shape[1]:
        raise ValueError(f"slot {slot} is outside the cache's {cache['latent'].shape[1]} rows")
    start = prompt_ids.shape[1] - int(prompt_mask.sum())
    rows = {name: cache[name][:, slot:slot + 1] for name in ("latent", "kda_state", "kda_conv")}
    h = _prefill_hidden(params, prompt_ids.long()[:, start:], rows, cfg, start)
    return torch.argmax(_logits(h[:, -1], params, cfg), dim=-1), cache


class KimiLinearLM(deepseek.DeepseekLM):
    """The decoder as a module, as :class:`deepseek.DeepseekLM`: parameters
    in ``cfg.dtype`` (the router's correction bias, A_log and dt_bias in
    f32) on `device`, random from `generator` without `params`."""

    _init_params = staticmethod(init_params)
    _cast_params = staticmethod(cast_params)
