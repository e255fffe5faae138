"""DeepSeek-V3-family causal decoder: latent attention (MLA) over a
compressed cache and a layer of routed and shared experts.

The block of ``modeling_deepseek.py`` (``model_type`` ``deepseek_v3``),
as Moonlight-16B-A3B publishes it, with the parameter layout and rounding
points of ``models/transformer.py``: projections laid out [d_in, d_out]
(every product is ``x @ W``), products in ``cfg.dtype`` with f32 sums
rounded once, norms and softmax in f32. No q compression (``q_lora_rank``
null) and one expert group (``n_group`` = ``topk_group`` = 1).

* **Latent attention.** q = x W_q splits per head into q_nope and q_pe;
  [c_kv, k_pe] = x W_kva, c_kv is RMS-normed and RoPE rotates q_pe and
  k_pe (one k_pe for every head). The cache holds only the normed c_kv and
  the rotated k_pe: [layers, batch, max_len, kv_lora_rank + rope] (576
  a token a layer at Moonlight's widths, 8.9x less than head-major K/V).
  Scores are q_nope.k_nope + q_pe.k_pe over sqrt(nope + rope). Prefill
  decompresses the latent through W_kvb into per-head keys and values and
  attends through ``F.scaled_dot_product_attention`` (``_attend_prefill``;
  a slot's one left-padded row is cut to its real tokens first); a decode
  step absorbs W_kvb's key half into q and its value half after the
  context (``_attend_absorbed``), so it reads only the latent rows. At
  f32 the two agree.
* **RoPE** on the rope dims in the published pair layout
  (``apply_rotary_pos_emb`` de-interleaves the pairs before
  ``rotate_half``), base ``rope_theta``, positions counted from each
  row's first real token; the rotation is taken in f32 and rounded once.
* **Experts.** The first ``first_k_dense`` layers hold a dense SwiGLU of
  width ``d_ff``; the others route each token to ``n_experts_per_tok`` of
  ``n_routed_experts`` SwiGLU experts of width ``moe_d_ff`` and add
  ``n_shared_experts`` shared ones (one SwiGLU of their summed width). The
  router (``noaux_tc``): f32 logits, a sigmoid, the top-k of the score
  plus ``router_bias`` (the correction bias, which picks and never
  weighs), weights the chosen scores renormalized and scaled by
  ``routed_scaling_factor``. The experts run as one grouped product a
  projection (``torch._grouped_mm``) over the tokens sorted by expert;
  the weighted sum is taken in f32 and rounded once, then the shared
  experts are added. Gate and up are one [d, 2 * width] matrix (gate
  columns first).

Every layer's attention and feed-forward run inside the spans ``lm.mla``
and ``lm.moe`` (``internals/spans.py``: recorded with the observability
plane on; an annotation under ``torch.profiler``). A decode step also
counts, on the device and for the rows past position 0 (a row at 0 is an
empty slot), its token-expert choices, the layer-expert pairs that got at
least one token and the busiest expert's tokens summed over layers, into
``cache["counts"]`` (int64 [3]), which the continuous batcher reads back
with the step's tokens in one copy.

What the GPT-2-style family has and this one leaves out: tensor and
sequence parallelism, training, sampled generation and the wave-aligned
serving path (``TorchLMChat`` raises for those).
"""

from __future__ import annotations

import dataclasses
import math
from typing import ClassVar

import torch
import torch.nn.functional as F
from torch import nn

from pathway_tpu_torch.engine.device_plane import resolve_device
from pathway_tpu_torch.internals import spans as _spans
from pathway_tpu_torch.models.transformer import Params, _f32_matmul, _normal, _rmsnorm

# the counters of cache["counts"], in order
STEP_COUNTERS = ("moe_assignments", "moe_experts_hit", "moe_max_load")
# no recurrent layer, so no scan counter (``kimi_linear.SCAN_COUNTER``)
SCAN_COUNTER = None

# the phases the continuous batcher may replay from CUDA graphs
# (``transformer.GRAPH_PHASES``): none yet. A replay runs none of the
# Python that opens the ``lm.mla`` and ``lm.moe`` spans, so a trace could
# not part a graphed step's kernels between them.
GRAPH_PHASES: dict = {}


@dataclasses.dataclass(frozen=True)
class DeepseekConfig:
    """The published keys of a ``deepseek_v3`` config (defaults:
    Moonlight-16B-A3B's)."""

    vocab_size: int = 163840
    d_model: int = 2048
    n_heads: int = 16
    n_layers: int = 27
    d_ff: int = 11264  # the dense layers' SwiGLU width (intermediate_size)
    max_len: int = 8192
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    n_routed_experts: int = 64
    n_experts_per_tok: int = 6
    n_shared_experts: int = 2
    moe_d_ff: int = 1408
    first_k_dense: int = 1
    routed_scaling_factor: float = 2.446
    rope_theta: float = 50000.0
    norm_eps: float = 1e-5
    dtype: torch.dtype = torch.bfloat16
    # RoPE on the rope dims of q and of the cache row (Kimi Linear's config has none)
    mla_rope: ClassVar[bool] = True

    @property
    def experts_held(self) -> range:
        """The routed experts whose weights this model holds: all of them."""
        return range(self.n_routed_experts)

    @property
    def qk_head_dim(self) -> int:
        return self.qk_nope_head_dim + self.qk_rope_head_dim

    @property
    def latent_dim(self) -> int:
        """Width of a cache row: the normed c_kv, then the rotated k_pe."""
        return self.kv_lora_rank + self.qk_rope_head_dim

    def __post_init__(self) -> None:
        if self.qk_rope_head_dim % 2:
            raise ValueError("qk_rope_head_dim must be even (RoPE rotates pairs)")
        if not 0 <= self.first_k_dense <= self.n_layers:
            raise ValueError("first_k_dense must lie in [0, n_layers]")
        if not 1 <= self.n_experts_per_tok <= self.n_routed_experts:
            raise ValueError("n_experts_per_tok must lie in [1, n_routed_experts]")


# ------------------------------------------------------------------ params


def _block(gen: torch.Generator, cfg: DeepseekConfig, dense: bool, dtype: torch.dtype) -> Params:
    d, h, r = cfg.d_model, cfg.n_heads, cfg.kv_lora_rank
    dev = gen.device
    blk = {
        "ln1_scale": torch.ones(d, device=dev, dtype=dtype),
        "wq": _normal(gen, (d, h * cfg.qk_head_dim), 1.0 / math.sqrt(d), dtype),
        "wkv_a": _normal(gen, (d, cfg.latent_dim), 1.0 / math.sqrt(d), dtype),
        "kv_norm": torch.ones(r, device=dev, dtype=dtype),
        "wkv_b": _normal(gen, (r, h * (cfg.qk_nope_head_dim + cfg.v_head_dim)), 1.0 / math.sqrt(r), dtype),
        "wo": _normal(gen, (h * cfg.v_head_dim, d), 1.0 / math.sqrt(h * cfg.v_head_dim), dtype),
        "ln2_scale": torch.ones(d, device=dev, dtype=dtype),
    }
    if dense:
        f = cfg.d_ff
        blk["ff_gate_up"] = _normal(gen, (d, 2 * f), 1.0 / math.sqrt(d), dtype)
        blk["ff_down"] = _normal(gen, (f, d), 1.0 / math.sqrt(f), dtype)
        return blk
    e, m, s = cfg.n_routed_experts, cfg.moe_d_ff, cfg.n_shared_experts * cfg.moe_d_ff
    blk.update(
        router=_normal(gen, (d, e), 1.0 / math.sqrt(d), dtype),
        router_bias=torch.zeros(e, device=dev, dtype=torch.float32),
        # [experts, d_in, d_out] as views of [experts, d_out, d_in]: the
        # grouped product's second operand, column-major
        experts_gate_up=_normal(gen, (e, 2 * m, d), 1.0 / math.sqrt(d), dtype).transpose(1, 2),
        experts_down=_normal(gen, (e, d, m), 1.0 / math.sqrt(m), dtype).transpose(1, 2),
        shared_gate_up=_normal(gen, (d, 2 * s), 1.0 / math.sqrt(d), dtype),
        shared_down=_normal(gen, (s, d), 1.0 / math.sqrt(s), dtype),
    )
    return blk


def init_params(
    generator: torch.Generator, cfg: DeepseekConfig, dtype: torch.dtype = torch.float32
) -> Params:
    """Random parameters on the generator's device, leaf by leaf (as
    ``transformer.init_params``): projections N(0, 1/d_in), embeddings
    N(0, 0.02^2), norm scales 1, the router's correction bias 0 and f32."""
    d = cfg.d_model
    return {
        "tok_embed": _normal(generator, (cfg.vocab_size, d), 0.02, dtype),
        "ln_f_scale": torch.ones(d, device=generator.device, dtype=dtype),
        "head": _normal(generator, (d, cfg.vocab_size), 1.0 / math.sqrt(d), dtype),
        "blocks": [_block(generator, cfg, i < cfg.first_k_dense, dtype) for i in range(cfg.n_layers)],
    }


def cast_params(
    params: Params, dtype: torch.dtype = torch.bfloat16, keep: tuple[str, ...] = ("router_bias",)
) -> Params:
    """Serving parameters: floating leaves cast once to `dtype`, but for
    the leaves named in `keep`, which stay f32 (the router's correction
    bias: the router is f32)."""
    def cast(k: str, v: torch.Tensor) -> torch.Tensor:
        return v.to(dtype) if v.is_floating_point() and k not in keep else v

    out = {k: cast(k, v) for k, v in params.items() if k != "blocks"}
    out["blocks"] = [{k: cast(k, v) for k, v in blk.items()} for blk in params["blocks"]]
    return out


# ----------------------------------------------------------------- forward


def _rope_tables(positions: torch.Tensor, cfg: DeepseekConfig) -> tuple[torch.Tensor, torch.Tensor]:
    """cos and sin [*positions.shape, rope] in f32, the published
    ``DeepseekV3RotaryEmbedding``'s (each frequency twice, halves
    concatenated)."""
    rd = cfg.qk_rope_head_dim
    inv_freq = 1.0 / (cfg.rope_theta ** (torch.arange(0, rd, 2, device=positions.device).float() / rd))
    ang = positions.float()[..., None] * inv_freq
    ang = torch.cat((ang, ang), dim=-1)
    return ang.cos(), ang.sin()


def _rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """``apply_rotary_pos_emb``: the pairs (x0, x1), (x2, x3), ...
    de-interleaved into [x0, x2, ..., x1, x3, ...], then x cos +
    rotate_half(x) sin, in f32 and rounded once to x's dtype."""
    d = x.shape[-1]
    y = x.float().unflatten(-1, (d // 2, 2)).transpose(-1, -2).flatten(-2)
    rot = torch.cat((-y[..., d // 2:], y[..., : d // 2]), dim=-1)
    return (y * cos + rot * sin).to(x.dtype)


def _swiglu(x: torch.Tensor, gate_up: torch.Tensor, down: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
    gu = torch.matmul(x, gate_up.to(dt))
    g, u = gu.chunk(2, dim=-1)
    return torch.matmul((F.silu(g.float()) * u.float()).to(dt), down.to(dt))


def route(x: torch.Tensor, blk: Params, cfg: DeepseekConfig) -> tuple[torch.Tensor, torch.Tensor]:
    """The router of tokens x [t, d]: the chosen experts [t, k] and their
    f32 weights [t, k]. Logits in f32, a sigmoid score, the top-k of the
    score plus the correction bias; the weights are the chosen scores
    without the bias, renormalized (+1e-20, as published) and scaled."""
    scores = torch.sigmoid(torch.matmul(x.float(), blk["router"].float()))
    idx = torch.topk(scores + blk["router_bias"].float(), cfg.n_experts_per_tok, dim=-1).indices
    w = scores.gather(1, idx)
    w = w / (w.sum(dim=-1, keepdim=True) + 1e-20) * cfg.routed_scaling_factor
    return idx, w


def _moe(
    x: torch.Tensor, blk: Params, cfg: DeepseekConfig, counted: torch.Tensor | None = None
) -> tuple[torch.Tensor, torch.Tensor | None]:
    """Routed plus shared experts of tokens x [t, d]. The t * k choices
    are sorted by expert and each projection is one grouped product over
    the experts (``offs``: each expert's end in the sorted rows). Where
    the model holds a share of the experts (``cfg.experts_held``, the
    weights' first axis), the router still chooses among all of them with
    the weights renormalized over all k choices, and a choice of an expert
    held elsewhere is dropped: it sorts after every held expert's rows,
    past the last offset, and adds nothing; the shared experts are always
    added. With `counted` [t] bool, also returns each held expert's tokens
    among those rows ([held experts] int64), never read on the host here."""
    dt = cfg.dtype
    t, k = x.shape[0], cfg.n_experts_per_tok
    idx, w = route(x, blk, cfg)
    held = cfg.experts_held
    n = len(held)
    if n < cfg.n_routed_experts:  # the held experts' own numbers; the rest sort last, as n
        idx = torch.where((idx >= held.start) & (idx < held.stop), idx - held.start, n)
    flat = idx.reshape(-1)
    order = torch.argsort(flat, stable=True)
    experts = torch.arange(n, device=x.device)
    offs = torch.searchsorted(flat[order], experts, right=True, out_int32=True)
    tok = order // k
    gu = torch._grouped_mm(x[tok], blk["experts_gate_up"].to(dt), offs=offs)
    g, u = gu.chunk(2, dim=-1)
    y = torch._grouped_mm((F.silu(g.float()) * u.float()).to(dt), blk["experts_down"].to(dt), offs=offs)
    part = y.float() * w.reshape(-1)[order, None]
    if n < cfg.n_routed_experts:  # rows past the last offset hold no product
        part = torch.where(flat[order, None] < n, part, 0.0)
    routed = torch.zeros((t, x.shape[1]), dtype=torch.float32, device=x.device)
    routed.index_add_(0, tok, part)
    out = routed.to(dt) + _swiglu(x, blk["shared_gate_up"], blk["shared_down"], dt)
    load = None
    if counted is not None:
        chosen = torch.where(counted[:, None], idx, n).reshape(-1)
        load = torch.zeros(n + 1, dtype=torch.int64, device=x.device)
        load = load.index_add_(0, chosen, torch.ones_like(chosen))[:-1]
    return out, load


def _ffn(x: torch.Tensor, blk: Params, cfg: DeepseekConfig, counted=None):
    """The block's feed-forward of x [..., d]: the dense SwiGLU, or the
    experts (with their load, see :func:`_moe`)."""
    if "ff_gate_up" in blk:
        return _swiglu(x, blk["ff_gate_up"], blk["ff_down"], cfg.dtype), None
    out, load = _moe(x.reshape(-1, x.shape[-1]), blk, cfg, counted)
    return out.view(x.shape), load


def _latent(x: torch.Tensor, blk: Params, cfg: DeepseekConfig, cos, sin):
    """q [..., h, nope + rope] (q_pe rotated) and the cache row [...,
    kv_lora_rank + rope] (normed c_kv, rotated k_pe) of x [..., d]. Where
    ``cfg.mla_rope`` is False, q_pe and k_pe stay as the projections give
    them (`cos` and `sin` unused)."""
    dt, r = cfg.dtype, cfg.kv_lora_rank
    q = torch.matmul(x, blk["wq"].to(dt)).unflatten(-1, (cfg.n_heads, cfg.qk_head_dim))
    if cfg.mla_rope:
        q_pe = _rope(q[..., cfg.qk_nope_head_dim:], cos[..., None, :], sin[..., None, :])
        q = torch.cat((q[..., : cfg.qk_nope_head_dim], q_pe), dim=-1)
    kva = torch.matmul(x, blk["wkv_a"].to(dt))
    c = _rmsnorm(kva[..., :r], blk["kv_norm"], cfg.norm_eps)
    k_pe = _rope(kva[..., r:], cos, sin) if cfg.mla_rope else kva[..., r:]
    return q, torch.cat((c, k_pe), dim=-1)


def _kv_b(blk: Params, cfg: DeepseekConfig) -> tuple[torch.Tensor, torch.Tensor]:
    """W_kvb's key and value halves, [r, h, nope] and [r, h, v] views."""
    w = blk["wkv_b"].to(cfg.dtype).view(cfg.kv_lora_rank, cfg.n_heads, -1)
    return w[..., : cfg.qk_nope_head_dim], w[..., cfg.qk_nope_head_dim:]


def _attend_prefill(
    q: torch.Tensor, rows: torch.Tensor, allowed: torch.Tensor | None, blk: Params, cfg: DeepseekConfig
) -> torch.Tensor:
    """Attention of q [b, p, h, nope + rope] over the cache rows [b, p,
    latent] decompressed through W_kvb into per-head keys and values, by
    ``F.scaled_dot_product_attention`` (scores over sqrt(nope + rope); on
    the card a fused kernel, products in cfg.dtype with f32 sums): causal
    when `allowed` is None, else under the bool mask [b, p, p] (query,
    key). Returns ctx [b, p, h * v] in cfg.dtype."""
    dt, r = cfg.dtype, cfg.kv_lora_rank
    b, p, h, _ = q.shape
    nope = cfg.qk_nope_head_dim
    kv = torch.matmul(rows[..., :r], blk["wkv_b"].to(dt)).unflatten(-1, (h, -1))
    k_pe = rows[..., None, r:].expand(b, p, h, cfg.qk_rope_head_dim)
    keys = torch.cat((kv[..., :nope], k_pe), dim=-1).transpose(1, 2)
    ctx = F.scaled_dot_product_attention(
        q.transpose(1, 2), keys, kv[..., nope:].transpose(1, 2),
        attn_mask=None if allowed is None else allowed[:, None], is_causal=allowed is None,
    )
    return ctx.transpose(1, 2).reshape(b, p, h * cfg.v_head_dim)


def _attend_absorbed(
    q: torch.Tensor, cache_l: torch.Tensor, key_ok: torch.Tensor, blk: Params, cfg: DeepseekConfig
) -> torch.Tensor:
    """One query a row, q [b, h, nope + rope], over the latent cache rows
    cache_l [b, S, latent] as they are: q_nope times W_kvb's key half
    gives a latent query, so a score is one product with a cache row; the
    context over c_kv goes through W_kvb's value half. `key_ok` [b, S]
    bool. Returns ctx [b, h * v] in cfg.dtype."""
    dt, r = cfg.dtype, cfg.kv_lora_rank
    b, h, _ = q.shape
    w_uk, w_uv = _kv_b(blk, cfg)
    # [h, b, nope] x [h, nope, r]: the latent query of every head
    q_lat = torch.matmul(q[..., : cfg.qk_nope_head_dim].transpose(0, 1), w_uk.permute(1, 2, 0))
    qq = torch.cat((q_lat.transpose(0, 1), q[..., cfg.qk_nope_head_dim:]), dim=-1)
    s = _f32_matmul(qq, cache_l.transpose(1, 2)) / math.sqrt(cfg.qk_head_dim)
    probs = torch.softmax(torch.where(key_ok[:, None, :], s, -1e30), dim=-1).to(dt)
    ctx = _f32_matmul(probs, cache_l[..., :r]).to(dt)  # [b, h, r]
    out = torch.matmul(ctx.transpose(0, 1), w_uv.permute(1, 0, 2))  # [h, b, v]
    return out.transpose(0, 1).reshape(b, h * cfg.v_head_dim)


def _prefill_hidden(
    params: Params, ids: torch.Tensor, mask: torch.Tensor | None, cache: Params | None,
    cfg: DeepseekConfig, start: int = 0,
) -> torch.Tensor:
    """Final-normed hidden states [b, p, d] of rows ids [b, p], writing
    each layer's latent rows into positions start..start+p-1 of
    ``cache["latent"]`` when a cache is given. `mask` None: every token is
    real, at positions 0..p-1; else the rows are left-padded (mask 1/0)
    and a pad query attends to itself alone, so that no row is empty."""
    b, p = ids.shape
    if start + p > cfg.max_len:
        raise ValueError(f"prompt length {start + p} exceeds max_len={cfg.max_len}")
    dt = cfg.dtype
    if mask is None:
        positions, allowed = torch.arange(p, device=ids.device)[None], None
    else:
        positions = torch.clamp(torch.cumsum(mask, dim=1) - 1, min=0)
        causal = torch.ones((p, p), dtype=torch.bool, device=ids.device).tril()
        allowed = (mask.bool()[:, None, :] & causal) | torch.eye(p, dtype=torch.bool, device=ids.device)
    cos, sin = _rope_tables(positions, cfg)
    x = params["tok_embed"].to(dt)[ids]
    for li, blk in enumerate(params["blocks"]):
        with _spans.span("lm.mla"):
            q, rows = _latent(_rmsnorm(x, blk["ln1_scale"], cfg.norm_eps), blk, cfg, cos, sin)
            if cache is not None:
                cache["latent"][li, :, start:start + p].copy_(rows)
            ctx = _attend_prefill(q, rows, allowed, blk, cfg)
            x = x + torch.matmul(ctx, blk["wo"].to(dt))
        with _spans.span("lm.moe"):
            x = x + _ffn(_rmsnorm(x, blk["ln2_scale"], cfg.norm_eps), blk, cfg)[0]
    return _rmsnorm(x, params["ln_f_scale"], cfg.norm_eps)


def _logits(h: torch.Tensor, params: Params, cfg: DeepseekConfig) -> torch.Tensor:
    """Logits [..., vocab] f32 from the untied head."""
    return _f32_matmul(h, params["head"].to(cfg.dtype))


def logits(
    params: Params, token_ids: torch.Tensor, token_mask: torch.Tensor, cfg: DeepseekConfig
) -> torch.Tensor:
    """LM logits [b, s, vocab] (f32) of a full causal forward (the
    decompressed attention); rows may be left-padded."""
    h = _prefill_hidden(params, token_ids.long(), token_mask, None, cfg)
    return _logits(h, params, cfg)


def init_kv_cache(
    cfg: DeepseekConfig, batch: int, device: str | torch.device | None = None
) -> Params:
    """A zeroed latent cache for `batch` rows, [n_layers, batch, max_len,
    kv_lora_rank + rope], and the decode step's counters (int64 [3],
    ``STEP_COUNTERS``)."""
    dev = resolve_device(device)
    return {
        "latent": torch.zeros(
            (cfg.n_layers, batch, cfg.max_len, cfg.latent_dim), dtype=cfg.dtype, device=dev
        ),
        "counts": torch.zeros(len(STEP_COUNTERS), dtype=torch.int64, device=dev),
    }


def prefill(
    params: Params,
    prompt_ids: torch.Tensor,
    cache: Params,
    cfg: DeepseekConfig,
    prompt_mask: torch.Tensor | None = None,
) -> tuple[torch.Tensor, Params]:
    """One causal forward over the prompt [b, p], writing every layer's
    latent rows into positions 0..p-1 of the cache in place. Returns
    (last-position logits [b, vocab] f32, cache). With `prompt_mask` the
    batch is LEFT-padded, as ``transformer.prefill`` takes it."""
    h = _prefill_hidden(params, prompt_ids.long(), prompt_mask, cache, cfg)
    return _logits(h[:, -1], params, cfg), cache


def _decode(
    params: Params, cache: Params, token: torch.Tensor, pos: torch.Tensor, pad_len: torch.Tensor,
    cfg: DeepseekConfig,
) -> torch.Tensor:
    """Logits [b, vocab] f32 of one token a row: row i consumes token[i],
    writes its latent row at pos[i] and attends over [pad_len[i], pos[i]]
    of its own cache row. The step's expert counters go to
    ``cache["counts"]``."""
    b = token.shape[0]
    dt = cfg.dtype
    x = params["tok_embed"].to(dt)[token]
    cos, sin = _rope_tables(pos - pad_len, cfg)
    j = torch.arange(cfg.max_len, device=token.device)[None, :]
    key_ok = (j <= pos[:, None]) & (j >= pad_len[:, None])
    rows = torch.arange(b, device=token.device)
    counted = pos > 0  # a row at position 0 is an empty slot
    loads = []
    for li, blk in enumerate(params["blocks"]):
        with _spans.span("lm.mla"):
            q, row = _latent(_rmsnorm(x, blk["ln1_scale"], cfg.norm_eps), blk, cfg, cos, sin)
            cache["latent"][li, rows, pos] = row
            ctx = _attend_absorbed(q, cache["latent"][li], key_ok, blk, cfg)
            x = x + torch.matmul(ctx, blk["wo"].to(dt))
        with _spans.span("lm.moe"):
            out, load = _ffn(_rmsnorm(x, blk["ln2_scale"], cfg.norm_eps), blk, cfg, counted)
            x = x + out
        if load is not None:
            loads.append(load)
    if loads:
        load = torch.stack(loads)  # [moe layers, experts]
        cache["counts"].copy_(torch.stack((load.sum(), (load > 0).sum(), load.amax(dim=1).sum())))
    return _logits(_rmsnorm(x, params["ln_f_scale"], cfg.norm_eps), params, cfg)


def decode_step_slots(
    params: Params,
    cache: Params,
    token: torch.Tensor,  # [b] — the token each slot consumes this step
    pos: torch.Tensor,  # [b] — per-slot physical write position
    pad_len: torch.Tensor,  # [b] — per-slot left-pad length
    cfg: DeepseekConfig,
) -> tuple[torch.Tensor, Params]:
    """One decode step of independent rows (continuous batching), as
    ``transformer.decode_step_slots`` takes it, through the absorbed
    latent attention; the step's expert counters are left in
    ``cache["counts"]``. Returns (next token [b], cache); argmax."""
    lg = _decode(params, cache, token, pos, pad_len, cfg)
    return torch.argmax(lg, dim=-1), cache


def prefill_into_slot(
    params: Params,
    prompt_ids: torch.Tensor,  # [1, P] LEFT-padded (pad_left_rows convention)
    prompt_mask: torch.Tensor,  # [1, P] 1/0
    cache: Params,  # multi-slot serving cache (init_kv_cache shape)
    slot: int | torch.Tensor,  # which cache row this request owns (a host scalar)
    cfg: DeepseekConfig,
) -> tuple[torch.Tensor, Params]:
    """Prefill ONE request into row `slot` of a multi-slot latent cache,
    as ``transformer.prefill_into_slot``: the prompt's real tokens alone,
    written from its first real position on, since decode never reads a
    slot's pad positions. Returns (first token [1], cache); argmax."""
    slot = int(slot)
    if not 0 <= slot < cache["latent"].shape[1]:
        raise ValueError(f"slot {slot} is outside the cache's {cache['latent'].shape[1]} rows")
    start = prompt_ids.shape[1] - int(prompt_mask.sum())
    rows = {"latent": cache["latent"][:, slot:slot + 1]}
    h = _prefill_hidden(params, prompt_ids.long()[:, start:], None, rows, cfg, start)
    return torch.argmax(_logits(h[:, -1], params, cfg), dim=-1), cache


def generate(
    params: Params,
    prompt_ids: torch.Tensor,  # [b, p]
    n_steps: int,
    cfg: DeepseekConfig,
    temperature: float = 0.0,
    generator: torch.Generator | None = None,
    prompt_mask: torch.Tensor | None = None,  # [b, p] 1/0, LEFT-padded batches
) -> torch.Tensor:
    """Batched prefill and greedy decode loop (``transformer.generate``'s
    signature; sampling is not supported). Returns [b, p + n_steps]."""
    if temperature > 0.0:
        raise NotImplementedError("sampled generation is not supported for the DeepSeek-V3 family")
    b, p = prompt_ids.shape
    if p + n_steps > cfg.max_len:
        raise ValueError(f"prompt ({p}) + n_steps ({n_steps}) exceeds max_len ({cfg.max_len})")
    prompt_ids = prompt_ids.long()
    cache = init_kv_cache(cfg, b, prompt_ids.device)
    lg, cache = prefill(params, prompt_ids, cache, cfg, prompt_mask)
    pad = torch.zeros_like(prompt_ids[:, 0]) if prompt_mask is None else p - prompt_mask.sum(dim=1)
    toks = [torch.argmax(lg, dim=-1)]
    for i in range(n_steps - 1):
        pos = torch.full_like(pad, p + i)
        toks.append(torch.argmax(_decode(params, cache, toks[-1], pos, pad, cfg), dim=-1))
    return torch.cat([prompt_ids, torch.stack(toks, dim=1)[:, :n_steps]], dim=1)


class DeepseekLM(nn.Module):
    """The decoder as a module: parameters in ``cfg.dtype`` (the router's
    correction bias in f32) on `device` (default: the CUDA card; raises
    when there is none). Without `params` they are random from
    `generator` (default seed 0)."""

    # the family's parameter makers (``kimi_linear.KimiLinearLM`` has its own)
    _init_params = staticmethod(init_params)
    _cast_params = staticmethod(cast_params)

    def __init__(
        self,
        cfg: DeepseekConfig,
        params: Params | None = None,
        *,
        device: str | torch.device | None = None,
        generator: torch.Generator | None = None,
    ):
        super().__init__()
        dev = resolve_device(device)
        if params is None:
            params = self._init_params(generator or torch.Generator().manual_seed(0), cfg, dtype=cfg.dtype)
        params = self._cast_params(params, cfg.dtype)
        self.cfg = cfg

        def held(t: torch.Tensor) -> nn.Parameter:
            return nn.Parameter(t.to(dev), requires_grad=False)

        self.top = nn.ParameterDict({k: held(v) for k, v in params.items() if k != "blocks"})
        self.blocks = nn.ModuleList(
            nn.ParameterDict({k: held(v) for k, v in blk.items()}) for blk in params["blocks"]
        )

    @property
    def params(self) -> Params:
        """The parameter tree the functional API takes."""
        return {**dict(self.top.items()), "blocks": [dict(b.items()) for b in self.blocks]}

    @property
    def device(self) -> torch.device:
        return self.top["tok_embed"].device
