"""Transformer: bidirectional encoder (mean-pooled text embedder) and
causal decoder LM with a KV cache.

Counterpart of ``pathway_tpu/models/transformer.py``: the same parameter
tree (a dict of tensors, weights laid out [d_in, d_out] so every
projection is ``x @ W``), the same forward and the same rounding points.
Every projection multiplies in ``cfg.dtype`` with f32 sums and rounds
once, as the JAX package's einsums with ``preferred_element_type=float32``
do. The encoder's attention is ``ops.attention.fused_qkv_attention``: the
CUDA kernel on the card, the plain version on the CPU. The decoder's
causal and cached attention is plain PyTorch (:func:`_attend`), as the
JAX package leaves it to XLA.

The decoder's KV cache is head-major, [layers, batch, heads, max_len,
head_dim] (the JAX package keeps [layers, batch, max_len, heads,
head_dim]): one row's keys of one head are contiguous, so q.kᵀ and p.v
run as strided batched products straight over the cache, with no
permuted copy of a layer. Cache updates are in-place writes into the
tensor the caller passes, where the JAX package returns a new array.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import torch
import torch.nn.functional as F
from torch import nn

from pathway_tpu_torch.engine.device_plane import resolve_device
from pathway_tpu_torch.ops.attention import fused_qkv_attention
from pathway_tpu_torch.ops.distances import normalize

Params = dict[str, Any]


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    vocab_size: int = 32768
    d_model: int = 512
    n_heads: int = 8
    n_layers: int = 6
    d_ff: int = 2048
    max_len: int = 512
    causal: bool = False  # False: bi-directional encoder; True: decoder LM
    pool: str = "mean"  # encoder pooling: mean | cls | last
    dtype: torch.dtype = torch.bfloat16
    embed_dim: int | None = None  # projection head dim (None = d_model)

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    def __post_init__(self) -> None:
        if self.pool not in ("mean", "cls", "last"):
            raise ValueError(f"pool must be mean|cls|last, got {self.pool!r}")
        if self.d_model % self.n_heads != 0:
            raise ValueError("d_model must be divisible by n_heads")


def embedder_config(**kw) -> TransformerConfig:
    """SBERT-class text encoder."""
    return TransformerConfig(causal=False, **kw)


def lm_config(**kw) -> TransformerConfig:
    """Gemma-class causal decoder."""
    kw.setdefault("pool", "last")
    return TransformerConfig(causal=True, **kw)


# ------------------------------------------------------------------ params


def _normal(
    gen: torch.Generator, shape: tuple[int, ...], std: float, dtype: torch.dtype
) -> torch.Tensor:
    x = torch.randn(shape, generator=gen, dtype=torch.float32, device=gen.device) * std
    return x.to(dtype)


def _init_block(gen: torch.Generator, cfg: TransformerConfig, dtype: torch.dtype) -> Params:
    d, f = cfg.d_model, cfg.d_ff
    s = 1.0 / math.sqrt(d)
    return {
        "qkv": _normal(gen, (d, 3 * d), s, dtype),
        "o": _normal(gen, (d, d), s, dtype),
        "ff_in": _normal(gen, (d, f), s, dtype),
        "ff_out": _normal(gen, (f, d), 1.0 / math.sqrt(f), dtype),
        "ln1_scale": torch.ones(d, device=gen.device, dtype=dtype),
        "ln2_scale": torch.ones(d, device=gen.device, dtype=dtype),
    }


def init_params(
    generator: torch.Generator, cfg: TransformerConfig, dtype: torch.dtype = torch.float32
) -> Params:
    """Random parameters on the generator's device, with the JAX
    package's shapes and scales (not its numbers: ``jax.random`` and a
    ``torch.Generator`` draw differently; ``models.convert`` carries JAX
    parameters across). Each leaf is drawn in f32 and cast to `dtype`
    before the next is drawn, so a bf16 tree at full width never holds
    more than one f32 leaf beside it (the 2.1 GB embedding of a
    256k-token vocabulary at d_model 2048, where the whole f32 tree would
    be about 8 GB)."""
    e = cfg.embed_dim or cfg.d_model
    return {
        "tok_embed": _normal(generator, (cfg.vocab_size, cfg.d_model), 0.02, dtype),
        "pos_embed": _normal(generator, (cfg.max_len, cfg.d_model), 0.02, dtype),
        "ln_f_scale": torch.ones(cfg.d_model, device=generator.device, dtype=dtype),
        "head": _normal(generator, (cfg.d_model, e), 1.0 / math.sqrt(cfg.d_model), dtype),
        "blocks": [_init_block(generator, cfg, dtype) for _ in range(cfg.n_layers)],
    }


def tree_map(fn: Callable[[torch.Tensor], torch.Tensor], params: Params) -> Params:
    return {
        k: [{bk: fn(bv) for bk, bv in blk.items()} for blk in v] if k == "blocks" else fn(v)
        for k, v in params.items()
    }


def cast_params(params: Params, dtype: torch.dtype = torch.bfloat16) -> Params:
    """Serving parameters: floating leaves cast once to `dtype`."""
    return tree_map(lambda x: x.to(dtype) if x.is_floating_point() else x, params)


def count_params(params: Params) -> int:
    top = sum(v.numel() for k, v in params.items() if k != "blocks")
    return top + sum(v.numel() for blk in params["blocks"] for v in blk.values())


# ----------------------------------------------------------------- forward


def _rmsnorm(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + 1e-6) * scale).to(x.dtype)


def _f32_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` with products in the operands' dtype and sums in f32,
    returned in f32: the JAX package's einsum with
    ``preferred_element_type=float32``. On the card one cuBLAS call writes
    f32 straight from bf16 operands, strided views included, so neither
    operand is widened or copied (`b` may be a transposed view of the KV
    cache or of the embedding). The CPU has no such overload: there the
    operands widen to f32 first, which gives the same exact products."""
    if a.device.type != "cuda" or a.dtype == torch.float32:
        return torch.matmul(a.float(), b.float())
    if b.dim() == 2:
        out = torch.mm(a.reshape(-1, a.shape[-1]), b, out_dtype=torch.float32)
        return out.reshape(*a.shape[:-1], b.shape[-1])
    return torch.bmm(a, b, out_dtype=torch.float32)


def _attend(
    q: torch.Tensor, keys: torch.Tensor, vals: torch.Tensor, mask: torch.Tensor,
    cfg: TransformerConfig,
) -> torch.Tensor:
    """Masked softmax attention: q [b, h, t, dh] over keys and vals
    [b, h, S, dh] (views of the KV cache are taken as they are); `mask`
    is bool, broadcastable to [b, h, t, S]. Returns ctx [b, t, d] in
    cfg.dtype, rounded where the JAX package rounds: f32 scores over
    sqrt(dh), -1e30 where the mask is False, an f32 softmax, the
    probabilities rounded to cfg.dtype, p.v summed in f32 and rounded
    once. A masked key's probability is exactly 0, so whatever a masked
    cache row holds never reaches ctx."""
    b, h, t, dh = q.shape
    s = keys.shape[2]
    scores = _f32_matmul(
        q.reshape(b * h, t, dh), keys.reshape(b * h, s, dh).transpose(1, 2)
    ).view(b, h, t, s) / math.sqrt(dh)
    probs = torch.softmax(torch.where(mask, scores, -1e30), dim=-1).to(cfg.dtype)
    ctx = _f32_matmul(probs.view(b * h, t, s), vals.reshape(b * h, s, dh)).to(cfg.dtype)
    return ctx.view(b, h, t, dh).transpose(1, 2).reshape(b, t, h * dh)


def _qkv_heads(
    x: torch.Tensor, block: Params, cfg: TransformerConfig
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The fused projection of x [b, t, d], split into head-major
    q, k, v views [b, h, t, dh]."""
    b, t, _ = x.shape
    qkv = torch.matmul(x, block["qkv"].to(cfg.dtype))
    q, k, v = qkv.view(b, t, 3, cfg.n_heads, cfg.head_dim).unbind(2)
    return q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)


def _attention(
    x: torch.Tensor, block: Params, cfg: TransformerConfig, token_mask: torch.Tensor
) -> torch.Tensor:
    if cfg.causal:
        q, k, v = _qkv_heads(x, block, cfg)
        ctx = _attend(q, k, v, _build_mask(token_mask, causal=True), cfg)
    else:
        qkv = torch.matmul(x, block["qkv"].to(cfg.dtype))
        ctx = fused_qkv_attention(qkv, token_mask, cfg.n_heads)
    return torch.matmul(ctx, block["o"].to(cfg.dtype))


def _ffn(x: torch.Tensor, block: Params, cfg: TransformerConfig) -> torch.Tensor:
    # jax.nn.gelu defaults to the tanh form; torch's default is erf. The
    # JAX package applies it to the f32 sum before rounding, the port to
    # the product rounded to cfg.dtype (computed in f32 inside F.gelu).
    hline = F.gelu(torch.matmul(x, block["ff_in"].to(cfg.dtype)), approximate="tanh")
    return torch.matmul(hline, block["ff_out"].to(cfg.dtype))


def _block_fwd(
    x: torch.Tensor, block: Params, cfg: TransformerConfig, token_mask: torch.Tensor
) -> torch.Tensor:
    x = x + _attention(_rmsnorm(x, block["ln1_scale"]), block, cfg, token_mask)
    return x + _ffn(_rmsnorm(x, block["ln2_scale"]), block, cfg)


def _build_mask(token_mask: torch.Tensor, causal: bool) -> torch.Tensor:
    # token_mask: [b, s] 1/0 valid; returns [b, 1, q, k] bool
    s = token_mask.shape[1]
    attend = token_mask[:, None, None, :].bool()
    if causal:
        attend = attend & torch.ones((s, s), dtype=torch.bool, device=token_mask.device).tril()
    return attend


def forward(
    params: Params, token_ids: torch.Tensor, token_mask: torch.Tensor,
    cfg: TransformerConfig,
) -> torch.Tensor:
    """Hidden states [b, s, d_model] in cfg.dtype."""
    s = token_ids.shape[1]
    if s > cfg.max_len:
        raise ValueError(f"sequence length {s} exceeds max_len={cfg.max_len}")
    x = params["tok_embed"].to(cfg.dtype)[token_ids]
    x = x + params["pos_embed"].to(cfg.dtype)[None, :s, :]
    for block in params["blocks"]:
        x = _block_fwd(x, block, cfg, token_mask)
    return _rmsnorm(x, params["ln_f_scale"])


def encode(
    params: Params, token_ids: torch.Tensor, token_mask: torch.Tensor,
    cfg: TransformerConfig,
) -> torch.Tensor:
    """Pooled, L2-normalized embeddings [b, embed_dim] (f32)."""
    h = forward(params, token_ids, token_mask, cfg)
    if cfg.pool == "mean":
        # mask-and-sum in cfg.dtype, divide in f32 (as the JAX package)
        m16 = token_mask.to(cfg.dtype)[:, :, None]
        part = torch.sum(h * m16, dim=1).float()
        cnt = torch.sum(token_mask, dim=1, keepdim=True).float()
        pooled = part / torch.clamp(cnt, min=1.0)
    elif cfg.pool == "cls":
        pooled = h[:, 0, :].float()
    else:  # last valid token
        idx = torch.clamp(torch.sum(token_mask, dim=1) - 1, min=0)
        pooled = h[torch.arange(h.shape[0], device=h.device), idx, :].float()
    return normalize(pooled @ params["head"].float())


def _tied_logits(h: torch.Tensor, params: Params, cfg: TransformerConfig) -> torch.Tensor:
    """Logits [..., vocab] f32 against the tied embedding: one product
    with a transposed view of ``tok_embed``, never a transposed copy."""
    return _f32_matmul(h, params["tok_embed"].to(cfg.dtype).t())


def logits(
    params: Params, token_ids: torch.Tensor, token_mask: torch.Tensor,
    cfg: TransformerConfig,
) -> torch.Tensor:
    """LM logits [b, s, vocab] (f32) via the tied embedding."""
    return _tied_logits(forward(params, token_ids, token_mask, cfg), params, cfg)


# ---------------------------------------------------------------- decoding


def init_kv_cache(
    cfg: TransformerConfig, batch: int, device: str | torch.device | None = None
) -> Params:
    """A zeroed KV cache for `batch` rows, head-major
    [n_layers, batch, n_heads, max_len, head_dim] (module docstring)."""
    dev = resolve_device(device)
    shape = (cfg.n_layers, batch, cfg.n_heads, cfg.max_len, cfg.head_dim)
    return {
        "k": torch.zeros(shape, dtype=cfg.dtype, device=dev),
        "v": torch.zeros(shape, dtype=cfg.dtype, device=dev),
    }


def decode_step(
    params: Params,
    cache: Params,
    token: torch.Tensor,  # [b] current token ids
    pos: int,  # the position every row writes
    cfg: TransformerConfig,
    pad_len: torch.Tensor | None = None,  # [b] left-pad lengths (batched serving)
) -> tuple[torch.Tensor, Params]:
    """One autoregressive step with the KV cache; returns ([b, vocab] f32
    logits, cache). Writes this step's K/V at `pos` of every row in place
    and attends over the whole max_len cache under the mask, as the JAX
    package does.

    With `pad_len` the batch is LEFT-padded: each row's logical position
    is pos - pad_len (continuing the prefill's mask-cumsum positions) and
    pad cache slots never enter attention — a row's tokens match what an
    unpadded single-prompt run would produce."""
    if not 0 <= pos < cfg.max_len:
        raise ValueError(f"position {pos} is outside the cache (max_len={cfg.max_len})")
    dt = cfg.dtype
    x = params["tok_embed"].to(dt)[token][:, None, :]  # [b, 1, d]
    j = torch.arange(cfg.max_len, device=token.device)
    if pad_len is None:
        x = x + params["pos_embed"].to(dt)[pos]
        kmask = (j <= pos)[None, None, None, :]
    else:
        x = x + params["pos_embed"].to(dt)[pos - pad_len][:, None, :]
        kmask = ((j[None, :] <= pos) & (j[None, :] >= pad_len[:, None]))[:, None, None, :]
    for li, block in enumerate(params["blocks"]):
        q, k, v = _qkv_heads(_rmsnorm(x, block["ln1_scale"]), block, cfg)
        cache["k"][li, :, :, pos] = k[:, :, 0]
        cache["v"][li, :, :, pos] = v[:, :, 0]
        ctx = _attend(q, cache["k"][li], cache["v"][li], kmask, cfg)
        x = x + torch.matmul(ctx, block["o"].to(dt))
        x = x + _ffn(_rmsnorm(x, block["ln2_scale"]), block, cfg)
    return _tied_logits(_rmsnorm(x, params["ln_f_scale"])[:, 0], params, cfg), cache


def prefill(
    params: Params,
    prompt_ids: torch.Tensor,
    cache: Params,
    cfg: TransformerConfig,
    prompt_mask: torch.Tensor | None = None,
) -> tuple[torch.Tensor, Params]:
    """One batched causal forward over the whole prompt, writing every
    layer's K/V into positions 0..p-1 of the cache in place. Returns
    (last-position logits [b, vocab] f32, cache).

    With `prompt_mask` the batch is LEFT-padded (pad tokens first, real
    tokens end at p-1 so the last-position logits are every row's next-
    token logits): real tokens take positions 0..len-1 via the mask
    cumsum and pad keys are masked out, so a padded row's outputs equal
    an unpadded single-prompt run.
    """
    b, p = prompt_ids.shape
    if p > cfg.max_len:
        raise ValueError(f"prompt length {p} exceeds max_len={cfg.max_len}")
    dt = cfg.dtype
    x = params["tok_embed"].to(dt)[prompt_ids]
    if prompt_mask is None:
        x = x + params["pos_embed"].to(dt)[None, :p, :]
        mask = _build_mask(torch.ones_like(prompt_ids), causal=True)
    else:
        pos_idx = torch.clamp(torch.cumsum(prompt_mask, dim=1) - 1, min=0)
        x = x + params["pos_embed"].to(dt)[pos_idx]
        mask = _build_mask(prompt_mask, causal=True)
    for li, block in enumerate(params["blocks"]):
        q, k, v = _qkv_heads(_rmsnorm(x, block["ln1_scale"]), block, cfg)
        keys, vals = cache["k"][li, :, :, :p], cache["v"][li, :, :, :p]
        keys.copy_(k)
        vals.copy_(v)
        ctx = _attend(q, keys, vals, mask, cfg)
        x = x + torch.matmul(ctx, block["o"].to(dt))
        x = x + _ffn(_rmsnorm(x, block["ln2_scale"]), block, cfg)
    return _tied_logits(_rmsnorm(x[:, -1], params["ln_f_scale"]), params, cfg), cache


def generate(
    params: Params,
    prompt_ids: torch.Tensor,  # [b, p]
    n_steps: int,
    cfg: TransformerConfig,
    temperature: float = 0.0,
    generator: torch.Generator | None = None,
    prompt_mask: torch.Tensor | None = None,  # [b, p] 1/0, LEFT-padded batches
) -> torch.Tensor:
    """Batched prefill + decode loop. Returns [b, p + n_steps].

    `prompt_mask` enables serving-style batching of heterogeneous
    prompts: left-pad every prompt to a common length, pass the validity
    mask, and each row generates exactly what an unpadded single-prompt
    run would (mask-cumsum positions; pad slots never attend)."""
    toks, _cache = generate_serving(
        params, prompt_ids, init_kv_cache(cfg, prompt_ids.shape[0], prompt_ids.device),
        n_steps, cfg, temperature=temperature, generator=generator,
        prompt_mask=prompt_mask,
    )
    return toks


def generate_serving(
    params: Params,
    prompt_ids: torch.Tensor,  # [b, p]
    cache: Params,  # KV cache for batch b (init_kv_cache shape)
    n_steps: int,
    cfg: TransformerConfig,
    temperature: float = 0.0,
    generator: torch.Generator | None = None,
    prompt_mask: torch.Tensor | None = None,
) -> tuple[torch.Tensor, Params]:
    """`generate` for the serving loop: the KV cache is an ARGUMENT,
    written in place and returned, so a dispatch site keeps one
    persistent cache per batch bucket (a device-plane lease) instead of
    allocating one per call. Stale cache contents from a previous wave
    are harmless: prefill rewrites positions 0..p-1, decode writes
    p..p+n-2, and the attention masks never read past the current
    position. The tokens stay on the device until the caller reads them:
    the loop never waits for the card.

    Sampling (temperature > 0) draws from `generator`; its stream is not
    the JAX package's, greedy decoding (temperature 0) is. The last
    token comes from the (n_steps-1)-th decode step: the JAX package's
    scan runs one more step whose token it drops."""
    b, p = prompt_ids.shape
    if p + n_steps > cfg.max_len:
        raise ValueError(
            f"prompt ({p}) + n_steps ({n_steps}) exceeds max_len ({cfg.max_len})"
        )
    if temperature > 0.0 and generator is None:
        raise ValueError("sampled generation (temperature > 0) requires a generator")
    prompt_ids = prompt_ids.long()
    first_logits, cache = prefill(params, prompt_ids, cache, cfg, prompt_mask)
    pad_len = None if prompt_mask is None else p - prompt_mask.sum(dim=1)

    def pick(lg: torch.Tensor) -> torch.Tensor:
        if temperature > 0.0:
            probs = torch.softmax(lg / temperature, dim=-1)
            return torch.multinomial(probs, 1, generator=generator)[:, 0]
        return torch.argmax(lg, dim=-1)

    toks = [pick(first_logits)]
    for i in range(n_steps - 1):
        lg, cache = decode_step(params, cache, toks[-1], p + i, cfg, pad_len=pad_len)
        toks.append(pick(lg))
    return torch.cat([prompt_ids, torch.stack(toks, dim=1)[:, :n_steps]], dim=1), cache


def prefill_into_slot(
    params: Params,
    prompt_ids: torch.Tensor,  # [1, P] LEFT-padded (pad_left_rows convention)
    prompt_mask: torch.Tensor,  # [1, P] 1/0
    cache: Params,  # multi-slot serving cache (init_kv_cache shape)
    slot: int | torch.Tensor,  # which cache row this request owns (a host scalar)
    cfg: TransformerConfig,
) -> tuple[torch.Tensor, Params]:
    """Prefill ONE request into row `slot` of a multi-slot serving cache
    (continuous batching). The b=1 left-padded prefill writes straight
    into the slot's rows (the JAX package prefills a scratch one-row
    cache and copies it in, 151 MB a request at Gemma-2B widths). The
    slot may hold a longer earlier request's K/V past this prompt: decode
    masks every key past a row's position, so that stale K/V never
    reaches an output. `slot` may be a 0-d CPU tensor, so that a
    program's shape ledger sees one signature for every slot, as the JAX
    package traces it. Returns (first decoded token [1], cache); argmax
    decoding, equal per row to the temperature-0 `generate_serving`."""
    slot = int(slot)
    if not 0 <= slot < cache["k"].shape[1]:
        raise ValueError(f"slot {slot} is outside the cache's {cache['k'].shape[1]} rows")
    rows = {n: c[:, slot:slot + 1] for n, c in cache.items()}
    lg, _ = prefill(params, prompt_ids.long(), rows, cfg, prompt_mask)
    return torch.argmax(lg, dim=-1), cache


def decode_step_slots(
    params: Params,
    cache: Params,
    token: torch.Tensor,  # [b] — the token each slot consumes this step
    pos: torch.Tensor,  # [b] — per-slot physical write position
    pad_len: torch.Tensor,  # [b] — per-slot left-pad length
    cfg: TransformerConfig,
) -> tuple[torch.Tensor, Params]:
    """One decode step where every batch row is an INDEPENDENT request at
    its own sequence position (continuous batching). Row i consumes
    ``token[i]``, writes its K/V at ``pos[i]`` of its own cache row, and
    attends over ``[pad_len[i], pos[i]]`` — its left-padded prompt plus
    the tokens it has decoded so far. Rows never read each other's rows,
    so a freshly prefilled request is correct from its first step even
    though its neighbours are mid-generation. `pos` must lie in
    [0, max_len): the caller bounds it (on the card an out-of-range
    write is a device-side fault, where the JAX package drops it).
    Returns (next token [b], cache); argmax decoding, equal per row to
    the wave-aligned path."""
    b = token.shape[0]
    dt = cfg.dtype
    x = params["tok_embed"].to(dt)[token][:, None, :]
    x = x + params["pos_embed"].to(dt)[pos - pad_len][:, None, :]
    j = torch.arange(cfg.max_len, device=token.device)[None, :]
    kmask = ((j <= pos[:, None]) & (j >= pad_len[:, None]))[:, None, None, :]
    rows = torch.arange(b, device=token.device)
    for li, block in enumerate(params["blocks"]):
        q, k, v = _qkv_heads(_rmsnorm(x, block["ln1_scale"]), block, cfg)
        cache["k"][li, rows, :, pos] = k[:, :, 0]
        cache["v"][li, rows, :, pos] = v[:, :, 0]
        ctx = _attend(q, cache["k"][li], cache["v"][li], kmask, cfg)
        x = x + torch.matmul(ctx, block["o"].to(dt))
        x = x + _ffn(_rmsnorm(x, block["ln2_scale"]), block, cfg)
    lg = _tied_logits(_rmsnorm(x, params["ln_f_scale"])[:, 0], params, cfg)
    return torch.argmax(lg, dim=-1), cache


class TransformerEncoder(nn.Module):
    """The encoder as a module: parameters cast to ``cfg.dtype`` and held
    on `device` (default: the CUDA card; raises when there is none)."""

    def __init__(
        self,
        cfg: TransformerConfig,
        params: Params | None = None,
        *,
        device: str | torch.device | None = None,
        generator: torch.Generator | None = None,
    ):
        super().__init__()
        dev = resolve_device(device)
        if params is None:
            # drawn leaf by leaf in f32 and cast at once: the same numbers
            # as an f32 tree cast after, without holding that tree
            params = init_params(
                generator or torch.Generator().manual_seed(0), cfg, dtype=cfg.dtype
            )
        params = cast_params(params, cfg.dtype)
        self.cfg = cfg

        def held(t: torch.Tensor) -> nn.Parameter:
            return nn.Parameter(t.to(dev), requires_grad=False)

        self.top = nn.ParameterDict(
            {k: held(v) for k, v in params.items() if k != "blocks"}
        )
        self.blocks = nn.ModuleList(
            nn.ParameterDict({k: held(v) for k, v in blk.items()})
            for blk in params["blocks"]
        )

    @property
    def params(self) -> Params:
        """The parameter tree the functional API takes."""
        return {**dict(self.top.items()), "blocks": [dict(b.items()) for b in self.blocks]}

    @property
    def device(self) -> torch.device:
        return self.top["tok_embed"].device

    def forward(self, token_ids: torch.Tensor, token_mask: torch.Tensor) -> torch.Tensor:
        return encode(self.params, token_ids, token_mask, self.cfg)


class TransformerLM(TransformerEncoder):
    """A model of either kind (encoder or causal LM) with the JAX
    package's ``TransformerLM`` surface: ``encode`` and ``logits``. Its
    tensor-parallel ``shard`` waits for the multi-device port."""

    def encode(self, token_ids: torch.Tensor, token_mask: torch.Tensor) -> torch.Tensor:
        return encode(self.params, token_ids, token_mask, self.cfg)

    def logits(self, token_ids: torch.Tensor, token_mask: torch.Tensor) -> torch.Tensor:
        return logits(self.params, token_ids, token_mask, self.cfg)
